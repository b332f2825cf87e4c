"""Where a Monte-Carlo round's time goes on the GPU, against the least time
the card could take (the port of scripts/roofline.py and
scripts/pipeline_breakdown.py; their VPU model does not transfer).

    python -m faid_tpu_torch.scripts.roofline [--batch 2048] [--reps 5]
        [--snr 4.0] [--trace-dir DIR] -> docs/torch_h100/roofline.json

The JAX script's three levels, each timed with CUDA events:

1. the decoder with a fixed iteration count (``stop_early=False``, no BF
   tail: kernel E), every frame ``--max-iter`` full MP sweeps;
2. the production decode at ``--snr`` (FAID_DTBF, group stop mode:
   kernel B on kernel A's LLRs), early stop and the DTBF tail;
3. the whole round: kernel F, kernels A then B, and ``build_sim_loop``
   (the main path, the all-zero word).

Then the round's stages one by one: the message stream and the encoder
(real codewords), the float chain's noise draw, modem and quantizer, the
channel kernels A, C and G (16-QAM), the decoders B and E, and F.  Each
stage's time (CUDA events), the device kernels one call launches and the
device's busy time and idle share (``torch.profiler``), its bound (the
larger of the bytes it must move over the card's memory rate and the
operations of the model below over the card's peak rate for their type,
counted on this run's inputs) and share = bound / time.  Every row names
the card.  A measurement needs the card: ``main`` refuses the CPU.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from . import _common

# The H100 SXM's peaks (NVIDIA's data sheet, at the 700 W limit): HBM
# bytes per second, and int32 operations per second: 64 INT32 lanes per
# SM (Hopper white paper) x 132 SMs x the 1.98 GHz boost clock that the
# published 67 TFLOP/s float32 rate (128 lanes, 2 per FMA) implies.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9
# the peak int8 tensor-core rate of the H100 SXM at 700 W, dense (NVIDIA's
# data sheet): the encoder's product
PEAK_INT8_OPS_PER_S = 1979e12

# Operation model of the functions' arithmetic, in int32 operations; it
# counts what the function needs, not what a kernel spends on addressing:
#   Philox4x32-10, per call: 10 rounds of 2 mul-hi, 2 mul-lo, 4 xor = 80,
#     shared by the 4 bits the call feeds; its 9 x 2 key-schedule adds
#     depend on the seed alone, so they count once per launch;
#   staircase, per bit: the mask xor, 2L compares and 2L adds, the sign
#     restore (xor, sub), the clip (min, max), the error compare = 4L + 6;
#   row update, per edge and MP iteration (ops/cn_update.py), FAID: pass
#     1 subtract, the clip to +-31 (max, min), sign with backtrack
#     (select, compare), parity xor, magnitude (abs, min, table) and the
#     min1/min2 update (max, min, min) = 1 + 2 + 2 + 1 + 3 + 3 = 12 (en is
#     within +-31 and a message within +-7, so the int8 saturation of
#     en - msg never binds and is not counted); pass 2 compare with min1
#     and select, 2 sign xors, negate, add, clip (max, min) = 8;
#     NMS: pass 1 subtract, the lower clip (max), sign compare, parity
#     xor, abs, min1/min2 (3) = 8; pass 2 as FAID's plus the abs of the
#     raw compare = 9; selective and simple-offset OMS: NMS's plus the
#     clip of |v| to 7 in pass 1 = 9 + 9;
#   row update, per check and MP iteration: the two message magnitudes,
#     FAID and simple-offset OMS (subtract, min) x 2 = 4; EF 1 and EF 2
#     add the floor gate (2 ands) and the swap of the LUT row (select) =
#     7; NMS (multiply, shift, min) x 2 = 6 (the int8 saturation cannot
#     bind); selective OMS the gate (2 ands) and, per minimum, the raised
#     and the lowered offsets (2 compares, 2 adds each), the select and
#     the clip to 7 = 2 + 2 x 10;
#   EF 2's erasure, per edge that starts a weight-3 column and MP
#     iteration in the floor window: the VN's 3 votes (2 adds), the
#     compare, the frame gate (and) and the select = 5;
#   syndrome sweep: one xor per edge, and one hard decision (en > 0) per
#     VN where en changed since the last sweep (every MP sweep, and once
#     as a BF tail starts; its sweeps read the hard bits); the
#     map-keeping styles (EF 1, EF 2, selective OMS) add each frame's
#     count, one add per check; NMS runs no sweep;
#   DTBF flip, per weight-gamma bit and round: gamma vote adds, the
#     disagreement xor, multiply-add, compare, flip xor = gamma + 4; 2B1C
#     adds the reliability test and the demote select (+2), and seeds the
#     reliability bits once (2 compares, an or: +3 per VN);
#   static BF, per round: the votes of every column (one add per edge),
#     and per VN the frame's max, the compare and the flip xor (+3);
#   kernel B's error count: one add per info bit;
#   the message stream, per bit: a 128th of a Philox call and its
#     unpacking (shift, and);
#   the float chain's noise draw, per sample: a quarter of one Philox call
#     and the mantissa's shift and or; its float work (the uniform's affine
#     map, erfinv, the scale) is not counted, so its bound is a lower one.
PHILOX_OPS = 10 * 8
PHILOX_KEY_OPS = 9 * 2
ROW_OPS = {   # style -> (per edge, per check) of one row update
    "faid": (12 + 8, 4), "faid_ef1": (12 + 8, 7), "faid_ef2": (12 + 8, 7),
    "nms": (8 + 9, 6), "oms_selective": (9 + 9, 2 + 2 * 10),
    "oms_offset": (9 + 9, 4)}
EF2_OPS_PER_ERASING_EDGE = 5
KEEPS_MAP = ("faid_ef1", "faid_ef2", "oms_selective")
SYNDROME_OPS_PER_EDGE = 1
HARD_OPS_PER_VN = 1
MESSAGE_OPS_PER_BIT = PHILOX_OPS / 128 + 2
NOISE_INT_OPS = PHILOX_OPS / 4 + 2
# the 4-bit quantizer's L: 2L + 1 thresholds
QUANT_L = 7


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_INT32_OPS_PER_S):
    """(least ms, what bounds it) for work that moves ``n_bytes`` and does
    ``n_ops`` operations at ``peak_ops`` a second (int32 by default)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def channel_ops(batch: int, n_var: int, quant_bits_l: int) -> float:
    return (batch * n_var * (PHILOX_OPS / 4 + 4 * quant_bits_l + 6)
            + PHILOX_KEY_OPS)


def style_key(dcfg) -> str:
    if dcfg.method == 0:
        return "nms"
    if dcfg.method in (1, 3, 4):
        return "oms_selective" if dcfg.oms_mode == 1 else "oms_offset"
    return ("faid", "faid_ef1", "faid_ef2")[dcfg.ef_elimination]


def decoder_ops(code, tables, mp_iters: torch.Tensor,
                bf_rounds: torch.Tensor) -> float:
    """The decoder's arithmetic for this run's per-frame iteration counts:
    each MP iteration's syndrome sweep and row updates, the sweep that
    finds a word clean, and, where MP ran out, the hard decisions that
    open the BF tail and each of its sweeps and flip rounds (a sweep that
    finds the word clean ends the tail before its round cap)."""
    dcfg, bfc = tables.dcfg, tables.dcfg.bf
    edges = int(code.degrees_np.sum()) * code.z
    style = style_key(dcfg)
    per_edge, per_check = ROW_OPS[style]
    mp = mp_iters.to(torch.float64)
    bf = bf_rounds.to(torch.float64)
    zero = torch.zeros_like(mp)
    sweeps = (mp + (mp_iters < dcfg.max_iter).to(torch.float64)
              if dcfg.stop_early else zero)
    tail = tail_sweeps = zero
    if bfc.kind != "none":
        tail = (mp_iters == dcfg.max_iter).to(torch.float64)
        tail_sweeps = tail * (bf + (bf_rounds < bfc.max_iter).to(torch.float64))
    vote_bits = int(tables.vote_col.numel()) * code.z
    if bfc.kind == "static":
        per_round = int(tables.vote_ptr[-1]) * code.z + 3 * vote_bits
    else:
        per_round = vote_bits * (bfc.gamma + 4 + 2 * (bfc.kind == "dtbf2b1c"))
    keeps_map = style in KEEPS_MAP
    if style == "faid_ef2" and dcfg.stop_early:
        # the iterations in the floor window: index >= max_iter - 1 - thresh
        first = max(0, dcfg.max_iter - 1 - dcfg.floor_iter_thresh)
        window = torch.clamp(mp - first, min=0)
        erasing = int((tables.ef_ptr >= 0).sum()) * code.z
        ops_ef2 = window * erasing * EF2_OPS_PER_ERASING_EDGE
    else:
        ops_ef2 = zero
    ops = (mp * (edges * per_edge + code.n_chk * per_check) + ops_ef2
           + sweeps * (edges * SYNDROME_OPS_PER_EDGE
                       + code.n_var * HARD_OPS_PER_VN + code.n_chk * keeps_map)
           + tail * code.n_var * (HARD_OPS_PER_VN + 3 * (bfc.kind == "dtbf2b1c"))
           + tail_sweeps * edges * SYNDROME_OPS_PER_EDGE
           + bf * per_round)
    return float(ops.sum())


def qam_rail_ops(mod_type: int, quant_bits: int, scale: float) -> float:
    """Kernel G's int32 work per rail as counted from the plan's size alone
    (its bound until the count of the inputs, ``qam_least_ops``): a
    quarter of one Philox call, the mirror xor, the magnitude index (a
    shift-add per magnitude bit), then a binary search of the word among
    the 2 nparam + 1 cells that row m's sorted thresholds and their points
    cut the words into (a compare and a select a step: every level's LLR
    and hard decision are step functions of the word, constant on each
    cell), and per level a read of the cell's (q, hard) from a per-row
    table, the clip (min, max), level 0's sign restore (xor, sub) and each
    other level's error xor.  It counts more than the function needs: the
    rows repeat values, one packed read serves every level, and the map's
    xor and the symmetric widths' clip fold into the table."""
    from ..ops import qam_plan

    h = mod_type // 2
    _, defs = qam_plan._plan(mod_type, quant_bits, float(scale))
    search = math.ceil(math.log2(2 * len(defs) + 1))
    return PHILOX_OPS / 4 + 1 + (h - 1) + 2 * search + 3 * h + 2 + (h - 1)


def qam_walk_ops(mod_type: int, quant_bits: int, scale: float) -> float:
    """The work of kernel G's former interval walk (the cell table's search
    replaced it), per rail: the same draw, mirror, index and per-level
    tail, but the walk over every interval of the plan (2 compares, an and
    and an add; one compare and an add for a half-line) in place of the
    search.  The walk is the same for every rail."""
    from ..ops import qam_plan

    h = mod_type // 2
    table = qam_plan.plan_table(mod_type, quant_bits, scale).tolist()
    ent = table[4 * h + 1:]
    walk = sum(2 if (v & 0xFFFF) == 0 or (v >> 16) == 0 else 4 for v in ent)
    return PHILOX_OPS / 4 + 1 + (h - 1) + walk + 2 * h + 2 + (h - 1)


def qam_least_ops(params, m, mod_type: int, quant_bits: int) -> float:
    """The least int32 work of kernel G's function on these inputs: per
    rail (``m`` [batch, rails], each rail's row) a quarter of one Philox
    call, the mirror xor, the magnitude index (a shift-add per magnitude
    bit), a binary search of the word among the 2 |U_m| + 1 cells that
    row m's distinct thresholds U_m cut the words into (a compare and a
    select a step), one read of the rail's packed cell (every level's LLR
    and map bit; the map's magnitude xor is folded into the table), level
    0's sign restore (xor, sub) and, for the asymmetric widths only, its
    clip (min, max); and the key schedule once."""
    from ..ops.fixed_point import _QUANT_LIMITS

    lo, hi = _QUANT_LIMITS[quant_bits]
    steps = torch.tensor([math.ceil(math.log2(2 * len(torch.unique(row)) + 1))
                          for row in params.cpu()])
    per_row = torch.bincount(m.reshape(-1).cpu(), minlength=len(steps))
    per_rail = PHILOX_OPS / 4 + 1 + (mod_type // 2 - 1) + 1 + 2 + (2 if -lo != hi else 0)
    return m.numel() * per_rail + 2 * int((steps * per_row).sum()) + PHILOX_KEY_OPS


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(kernel, plain, reps_kernel: int, reps_plain: int):
    """(kernel ms, plain ms), each the mean of two timings taken in the
    order plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps_plain)
    k1 = cuda_ms(kernel, reps_kernel)
    k2 = cuda_ms(kernel, reps_kernel)
    p2 = cuda_ms(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_profile(what: str, fn, rounds: int, card: str) -> dict:
    """torch.profiler over one call of fn, which runs ``rounds`` rounds:
    per round, the wall time, the device's busy time and idle share, the
    device kernels launched and those that took the most device time
    (kernels only: an operator's entry repeats its kernels' time);
    printed, and returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3 / rounds, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    idle = 1 - busy * rounds / wall_ms
    print(f"profile of {what} ({card}), per round: wall {wall_ms / rounds:.4f} ms, "
          f"device busy {busy:.4f} ms (idle {idle:.1%} of the "
          f"wall time); top: " + "; ".join(
              f"{k[:48]} x{c // rounds} {ms:.4f} ms" for ms, c, k in rows[:8]))
    return {"wall_ms": wall_ms / rounds, "device_busy_ms": busy, "idle_share": idle,
            "device_kernels": sum(c for _, c, _ in rows) / rounds,
            "top": [[k, c / rounds, ms] for ms, c, k in rows[:8]]}


def kernel_device_ms(fn, reps: int):
    """(device ms, host ms) per call of fn() over reps calls: the device
    time of the kernels it launches (torch.profiler), and the host's time
    to issue one call (without the profiler, whose tracing slows it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return busy / 1e3 / reps, host


# the 16-QAM stage: the speed point of chip_smoke.py (7.5 dB, the float
# chain's waterfall point at depth 2, + 0.4 dB), 4-bit, the zero word
QAM_STAGE = (4, 2, 7.9)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faid_tpu_torch.scripts.roofline",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--snr", type=float, default=4.0)
    ap.add_argument("--max-iter", type=int, default=6)
    ap.add_argument("--trace-dir", type=str, default=None,
                    help="write a torch.profiler chrome trace of the fixed and "
                         "the production decode to DIR/trace.json")
    ap.add_argument("--out", type=str, default=None,
                    help="default docs/torch_h100/roofline.json")
    ap.add_argument("--device", type=str, default="cuda",
                    help="a CUDA device: the measurement refuses the CPU")
    return ap


def stage_work(code, device, batch: int, snr: float, max_iter: int, seed: int):
    """{name: (fn, bytes, ops, peak ops, what it runs)}: each stage of the
    round as one call, with the bytes it must move and the operations of
    the model, counted on this run's inputs; and the decode levels' own
    counts (iterations, ops) for the levels."""
    import dataclasses

    from ..code.encoder import make_encode_fn
    from ..config import BFConfig, DecodeMethod, SimConfig
    from ..ops import channel as fch
    from ..ops import cuda_channel as cc
    from ..ops import cuda_decoder as cd
    from ..ops import cuda_sim as cs
    from ..ops import modem, philox
    from ..ops.fixed_point import quantize_llr
    from ..ops.qam_plan import plan_threshold_ints

    n, n_info, B = code.n_var, code.n_info, batch
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, max_iteration=max_iter,
                    mod_type=2, quant_bits=4, scale=13.0, batch_per_device=B,
                    fake_encode=True, channel_backend="fused", stop_mode="group",
                    seed=seed)
    sigma = cfg.sigma_at(snr)
    params = cc.threshold_ints(cfg, sigma).to(device)
    ch = dict(seed=seed, rnd=9, batch=B, n_var=n, quant_bits=4)
    llr, _, _ = cc.quantile_channel(params, n_info=n_info, mod_type=2, **ch)
    tables = cd.decoder_tables(code, cfg.decoder(), device)
    fixed = cd.decoder_tables(code, dataclasses.replace(
        cfg.decoder(), stop_early=False, bf=BFConfig()), device)
    _, iters, rounds = cd.stats_decode(llr, tables)
    _, f_iters = cd.mp_decode(llr, fixed)
    ops_b = decoder_ops(code, tables, iters, rounds) + B * n_info
    ops_e = decoder_ops(code, fixed, f_iters, torch.zeros_like(f_iters))
    ops_ch = channel_ops(B, n, QUANT_L)

    encode = make_encode_fn(code, device)
    u = philox.message_bits(seed, 5, 0, B, n_info, device)
    samples = fch.noise_samples(n, 2)
    noise = philox.normal_noise(seed, 9, 0, B, samples, device)
    cw = encode(u)
    sig = torch.full((), sigma, dtype=torch.float32, device=device)

    def modem_chain():
        sym = modem.modulate_qam(cw, 2)
        return modem.demodulate_qam(fch.awgn_complex(sym, noise.view(sym.shape),
                                                     sig), 2)

    soft = modem_chain()
    qmod, qdepth, qsnr = QAM_STAGE
    qcfg = SimConfig(mod_type=qmod, quant_bits=4, scale=13.0,
                     interleave_depth=qdepth)
    qparams = plan_threshold_ints(qcfg, qcfg.sigma_at(qsnr))
    qtab = cc.qam_tables(qparams, qmod, 4, 13.0)
    qtab = qtab._replace(params=qtab.params.to(device), cells=qtab.cells.to(device))
    rails = 2 * (n // qmod)
    g_ops = qam_least_ops(qparams, torch.zeros((B, rails), dtype=torch.int64),
                          qmod, 4)
    sim_kw = dict(seed=seed, rnd=9, batch=B, mod_type=2, quant_bits=4)
    i32 = PEAK_INT32_OPS_PER_S
    stages = {
        "message stream": (lambda: philox.message_bits(seed, 5, 0, B, n_info, device),
                           B * n_info, B * n_info * MESSAGE_OPS_PER_BIT + PHILOX_KEY_OPS,
                           i32, "philox.message_bits (plain torch)"),
        "encoder": (lambda: encode(u), B * n_info + code.n_chk * n_info + B * n,
                    2 * B * n_info * code.n_chk, PEAK_INT8_OPS_PER_S,
                    "code/encoder.py: torch._int_mm + parity (a library call)"),
        "noise": (lambda: philox.normal_noise(seed, 9, 0, B, samples, device),
                  4 * B * samples, B * samples * NOISE_INT_OPS + PHILOX_KEY_OPS, i32,
                  "philox.normal_noise (plain torch); float work not counted"),
        "modem": (modem_chain, B * n + 4 * B * samples + 4 * B * n, 0, i32,
                  "modulate + AWGN + demap (plain torch); bytes only"),
        "quantizer": (lambda: quantize_llr(soft, 13.0, 4), 4 * B * n + B * n, 0, i32,
                      "fixed_point.quantize_llr (plain torch); bytes only"),
        "A": (lambda: cc.quantile_channel(params, n_info=n_info, mod_type=2, **ch),
              B * n + 2 * 4 * B, ops_ch, i32, "kernel A"),
        "C": (lambda: cc.quantile_channel_map(params, **ch), 2 * B * n, ops_ch, i32,
              "kernel C"),
        "G": (lambda: cc.quantile_channel_qam(qtab, seed=seed, rnd=9, batch=B,
                                              n_var=n, mod_type=qmod, depth=qdepth,
                                              quant_bits=4, scale=13.0),
              2 * B * n, g_ops, i32,
              f"kernel G, 16-QAM depth {qdepth} {qsnr} dB, zero word"),
        "B": (lambda: cd.stats_decode(llr, tables), B * n + 3 * 4 * B, ops_b, i32,
              f"kernel B, FAID_DTBF group, {snr} dB"),
        "E": (lambda: cd.mp_decode(llr, fixed), 2 * B * n + 4 * B, ops_e, i32,
              f"kernel E, FAID, {max_iter} fixed iterations"),
        "F": (lambda: cs.fused_sim(params, tables, **sim_kw), 5 * 4 * B,
              ops_ch + ops_b, i32, f"kernel F, FAID_DTBF group, {snr} dB"),
    }
    levels = {"fixed_iters": int(f_iters.sum()), "ops_fixed": ops_e,
              "mp_iters": int(iters.sum()), "bf_rounds": int(rounds.sum()),
              "ops_production": ops_b, "ops_channel": ops_ch}
    return cfg, stages, levels


def measure(code, device, batch: int = 2048, snr: float = 4.0, max_iter: int = 6,
            reps: int = 5, seed: int = 0, time_ms=cuda_ms, profile=device_profile,
            card: str | None = None) -> dict:
    """The three levels and every stage's row.  ``time_ms(fn, reps)`` and
    ``profile(what, fn, rounds, card)`` are the card's clocks (CUDA events,
    torch.profiler)."""
    from ..sim.pipeline import build_sim_loop

    card = card or _common.card_line(device)
    cfg, stages, lv = stage_work(code, device, batch, snr, max_iter, seed)
    edges = int(code.degrees_np.sum()) * code.z
    rows = {}
    for name, (fn, n_bytes, n_ops, peak, what) in stages.items():
        before = _common.launch_counts()
        fn()
        launched = {k: v for k, v in _common.launches_since(before).items() if v}
        ms = time_ms(fn, reps)
        bnd = bound(n_bytes, n_ops, peak)
        prof = profile(f"stage {name}", fn, 1, card)
        busy = prof.get("device_busy_ms")
        rows[name] = {"what": what, "ms": ms, "bytes": n_bytes, "ops": n_ops,
                      "bound_ms": bnd[0], "bound_by": bnd[1], "share": bnd[0] / ms,
                      "kernel_launches": launched, **prof,
                      # how much of the events' time the profiler saw: a
                      # session that lost kernels reads low
                      "busy_over_events": None if busy is None else busy / ms,
                      "card": card}
        print(f"stage {name:15s} ({what}): {ms:.4f} ms, bound {bnd[0]:.4f} ms by "
              f"{bnd[1]} ({bnd[0] / ms:.1%}), launches {launched} ({card})",
              flush=True)

    e, b = rows["E"], rows["B"]
    fixed_ops_s = lv["ops_fixed"] / (e["ms"] * 1e-3)
    levels = {
        "fixed": {"per_decode_ms": e["ms"], "frames_per_s": batch / (e["ms"] * 1e-3),
                  "mp_iters_per_s": lv["fixed_iters"] / (e["ms"] * 1e-3),
                  "edge_msgs_per_s": lv["fixed_iters"] * edges / (e["ms"] * 1e-3),
                  "int32_ops_per_s": fixed_ops_s,
                  "share_of_int32_peak": fixed_ops_s / PEAK_INT32_OPS_PER_S,
                  "info_mbit_s": batch * code.n_info / (e["ms"] * 1e-3) / 1e6},
        "early_stop": {"per_decode_ms": b["ms"],
                       "frames_per_s": batch / (b["ms"] * 1e-3),
                       "avg_mp_iters": lv["mp_iters"] / batch,
                       "avg_bf_rounds": lv["bf_rounds"] / batch,
                       "share": b["share"],
                       "info_mbit_s": batch * code.n_info / (b["ms"] * 1e-3) / 1e6,
                       "speedup_vs_fixed": e["ms"] / b["ms"]},
    }
    rounds = 5
    loop = build_sim_loop(code, cfg, rounds, device)
    sigma = cfg.sigma_at(snr)
    ms_loop = time_ms(lambda: loop(seed, sigma, 100), reps) / rounds
    ms_ab = time_ms(lambda: (stages["A"][0](), stages["B"][0]()), reps)
    levels["pipeline"] = {
        "round_ms": ms_loop, "kernel_f_ms": rows["F"]["ms"], "a_then_b_ms": ms_ab,
        "frames_per_s": batch / (ms_loop * 1e-3),
        "info_mbit_s": batch * code.n_info / (ms_loop * 1e-3) / 1e6,
        "profile": profile(f"the round ({rounds} rounds of build_sim_loop)",
                           lambda: loop(seed, sigma, 200), rounds, card)}
    return {"card": card, "batch": batch, "snr_db": snr, "max_iter": max_iter,
            "n_edges": edges // code.z, "z": code.z, "reps": reps,
            "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                      "int32_ops_per_s": PEAK_INT32_OPS_PER_S,
                      "int8_ops_per_s": PEAK_INT8_OPS_PER_S},
            "levels": levels, "stages": rows}


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..cli import _device
    from ..code.qc_matrix import load_code

    device = _device(args.device)
    if device.type != "cuda":
        raise SystemExit("faid_tpu_torch.scripts.roofline measures the card: "
                         "its times are CUDA events and its idle shares "
                         "torch.profiler's; pass a CUDA --device")
    code = load_code("50gpon")
    res = measure(code, device, args.batch, args.snr, args.max_iter, args.reps)
    if args.trace_dir:
        from pathlib import Path

        from torch.profiler import ProfilerActivity, profile

        _, stages, _ = stage_work(code, device, args.batch, args.snr,
                                  args.max_iter, 0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stages["E"][0]()
            stages["B"][0]()
            torch.cuda.synchronize()
        trace = Path(args.trace_dir)
        trace.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace / "trace.json"))
        res["trace_dir"] = str(trace)
    out = _common.write_json(args.out or _common.OUT_DIR / "roofline.json", res)
    f = res["levels"]["fixed"]
    print(f"kernel E, fixed iterations: {f['mp_iters_per_s']:.4g} MP iters/s, "
          f"{f['edge_msgs_per_s']:.4g} edge msgs/s, "
          f"{f['share_of_int32_peak']:.1%} of the int32 peak ({res['card']}); "
          f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
