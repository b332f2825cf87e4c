#!/usr/bin/env python3
"""Smoke run of the PyTorch port (faid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from faid_tpu_torch/csrc, then:
  1. prints the card's name and power limit, the kernel build time with
     each source's nvcc time, and each of the 216 decoder instances'
     registers, spills and static shared memory from the build log
     (ptxas);
  2. kernel A (quantile channel + ModCalErr counts) against its plain
     PyTorch twin, bit for bit, on the full 50G-PON code at batch 2048,
     3.6 and 4.0 dB;
  3. kernel B (stats decoder) against its plain twin, bit for bit, on
     kernel A's 3.6 dB LLRs, and on the toy code at batch 64;
  4. the main path, build_sim_loop at 3.6 dB, batch 2048, 8 rounds: kernel
     F launched (not A or B), noise flowed, FER z-test against the
     reference simulator's FAID_DTBF QPSK 3.6 dB row
     (docs/refcheck_fer_compare.json); the same loop composed from A and
     B (fuse=False) gives the same counters;
  5. CUDA-event timings at 4.0 dB, batch 2048: the main path's
     decoded-info Mbit/s, fused (F) and composed (A + B) in turns;
  6. kernel C (quantile channel + ModCalErr map) and kernel D (full
     decoder) against their plain twins, bit for bit, at batch 2048 on
     the full code and at batch 64 on the toy code; C's LLRs equal A's,
     D's info-bit error counts equal B's;
  7. the campaign path, `python -m faid_tpu_torch.cli` as a user calls it:
     a 3.6/3.7 dB sweep at batch 2048 with --collect-errors (F, then C
     through fused_sim_emit and D launched, FER z-test, frames dumped),
     the same command again (it resumes from checkpoint.json: no kernel F
     launch, the same table), and the replay of one error round against
     build_sim_step;
  8. CUDA-event timings at 4.0 dB, batch 2048, each kernel and its plain
     twin in turns (kernel E on OMS), kernel B per method, the replay
     rate, and each kernel's bound;
  9. every other method (NMS at 1/6 and 26/32, OMS, OMS+BF, OMS+DTBF,
     FAID-2B1C) at 3.6 dB, batch 2048: kernel B against its twin, and
     kernel D (BF tail) or E (none) against its twin, bit for bit on
     kernel A's LLRs and on the toy code at batch 64; each BF method's
     tail engaged; build_sim_loop (kernel F) for 8 rounds with the FER
     z-test against that method's reference row (NMS at 1/6: every frame
     in error); each method's decoded-info Mbit/s at 4.0 dB;
 10. the campaign path of a method without BF: the CLI with --method 1
     (OMS) at 3.6 dB with --collect-errors (F, C and E launched, frames
     dumped), and the replay of one error round against build_sim_step;
 11. the encoder at batch 2048: bit-equal to the CPU encode of the same
     message bits, H c = 0 for every frame, its CUDA-event time (a
     library call, torch._int_mm) beside its bound;
 12. kernel F against its plain twin and against kernel A then kernel B,
     per frame and counter, for every method, both stop modes, fake and
     real codewords, at 3.6 dB on the full code at batch 2048 and on the
     toy code; the BF rounds per word; then the 8-bit message width (a
     FAID offset of 8 bounds a message by 8, not 7): kernels F, B and D
     against their twins the same way, and each launch plan's shared
     bytes and active clusters against the card's;
 13. fused_sim_emit (kernel C) then D (FAID_DTBF) or E (OMS) gives F's
     err_bits frame by frame, and emit's LLRs are kernel C's;
 14. frame stop mode: kernels B, D and E against their twins for every
     method at batch 2048, and build_sim_loop (kernel F) for 8 rounds per
     method at 3.6 dB, FER z-test against the JAX package's frame-mode
     rows;
 15. the main path with real codewords: FER z-test at 3.6 dB (FAID_DTBF,
     group) against the reference's all-zero-word row (no codeword row in
     group mode is committed: a different workload, held to the same
     bound), Mbit/s at 4.0 dB beside the all-zero word's, and kernel F
     against A + B in turns;
 16. the campaign path with real codewords: the CLI without --fake-encode
     at 3.6/3.7 dB with --collect-errors, its resume, the dumped frame's
     positions against the replay, whose codeword is the encoder's of the
     regenerated message, and the replayed round against the step; and
     the same CLI in frame stop mode at 3.6 dB, its FER z-test against
     docs/channel_parity.json's QPSK 3.6 dB row (real codewords, frame
     mode, the quantile channel);
 17. kernel G (16/64/256-QAM quantile channel) against its plain twin, bit
     for bit, LLRs and map, at batch 2048 on the full code (mod 4/6/8 x
     4/6-bit x depth 1-3, and 3/5/2-bit cases, codewords and the all-zero
     word), at batch 64 on the toy code, on shapes neither code reaches
     (rail counts not a multiple of 4, depths 4-6, an unaligned codeword),
     and on tie thresholds: the plan's at each speed point with entries of
     every row replaced by the launch's own mirrored words (and +- 1,
     INT_MIN), 16/64/256-QAM x depth 1-3 x codewords and the zero word, on
     both codes, each printing how many rails sit on a threshold (the
     phase fails if none);
 18. kernel G's law: channel_parity's histogram row (faid_tpu_torch/
     scripts/channel_parity.py ``hist_row``), 30 launches of 16-QAM at 8.1
     dB (depth 1, 4-bit, scale 13, all-zero word), each level's LLR
     histogram against the float64 erfc law, every bin |z| <= 5;
 19. the float chain (channel_backend xla) on the card: one CPU noise
     tensor through it on cuda and on cpu, bit for bit (mod 1/2/4/6/8 x
     1/4/6-bit x depth 1-3); build_sim_loop FER z-tests against the xla
     rows of docs/channel_parity.json (QPSK, BPSK 3.6 dB, 16-QAM depth 2
     7.5 dB) and kernel G against the fused row; 64- and 256-QAM: kernel
     G against the float chain (FER and pre-decoder BER) at a waterfall
     point; kernel F never launched on these rounds, G on every QAM one;
 20. the 16-QAM campaign (depth 2, 7.5 dB, --collect-errors) on the
     default float chain and on kernel G: launches, resume, and the
     replay of one error round against the step (the float chain's
     replay gives the float LLRs);
then CUDA-event timings of kernel G against its twin, of the float
chain's parts, and of the QAM rounds on both channels, and G's bound;
 21. every decoder configuration of pallas_decoder.supports: kernels B,
     D (BF tail) and E (none) for each of the 24 (style, BF kind) pairs
     (NMS, selective OMS, simple-offset OMS, FAID with EF 0, 1 or 2, times
     none / static / DTBF / 2B1C), both stop modes, against their plain
     twins bit for bit on kernel A's LLRs at 3.6 and 4.0 dB (50G-PON,
     batch 2048) and on the toy code at batch 64; every group-mode
     launch plan against the card's active clusters; the new styles' 8-bit
     instances (an offset of 8); the frames EF 2 decodes otherwise than
     EF 0 and EF 1 at 3.6 dB (the phase fails if none); kernel B's EF 2
     and offset-mode-0 instances timed at 4.0 dB beside their bound.
     `python3 chip_smoke.py --coverage-only` runs the build and this
     phase alone;
 22. the sharded path (parallel/mesh.py) in worlds of processes started
     here (tests/_torch_dist.py, torch and the port only, each with a
     timeout): (a) `python -m faid_tpu_torch.cli --multihost` in a world
     of 1 under nccl on phase 7's campaign: Result.txt equal to phase 7's
     in every column but Time(s), demod.txt, iterCount.txt and the dumps
     byte for byte, kernel F launched; then, in a world of 1 under nccl,
     build_sharded_sim_loop against build_sim_loop in turns at 4.0 dB
     (within 2%) and one all-reduce of a call's counters timed; (b) two
     ranks on the one card over gloo (nccl takes one rank a device), batch
     1024 each: build_sharded_sim_loop's counters on both ranks equal the
     one-rank loop's at batch 2048, counter for counter, on F (all-zero
     word, group mode; codewords, frame mode) and G then B (16-QAM), each
     rank launching those kernels, and the gloo all-reduce timed; (c) in
     the same world, MonteCarloRunner on phase 7's campaign: Result.txt
     (all but Time(s)), demod.txt and iterCount.txt equal phase 7's, rank 0
     alone writing, its dump (C and D at frame0 1024) phase 7's frame for
     frame under dev d / frame f <-> frame 1024 d + f, the rerun resumed
     on both ranks;
 23. the bench as a user runs it, `python -m faid_tpu_torch.bench
     --encode fake` and `--encode random`: the line's keys, its rate
     within 10% of phase 5's (all-zero word) and phase 15's (codewords)
     in the same call;
 24. the port's scripts (faid_tpu_torch/scripts/), each ``main(argv)`` in
     this process at full width, writing to a temporary directory: (a)
     fer_validation's six 3.6 dB rows in group mode, each held to its TPU
     row (docs/validation_group.json) and run on kernel F; (b)
     channel_parity's QPSK 4.0 dB histogram, 30 launches of kernel C at
     batch 2048 (~1.1e9 draws) against the float64 erfc law; (c)
     floor_campaign, FAID_DTBF at 3.9 dB, run to half of a 1,024,000-frame
     budget and rerun to the whole, equal counter for counter to one run
     of the whole, and held to docs/floor_group.json; (d) roofline at
     batch 2048, every stage present with its share <= 1.05; (e)
     backend_parity at batch 128, two words: the six methods' kernels D
     and E equal to their plain twin.
The bounds, timers and profiles are faid_tpu_torch/scripts/roofline.py's
(its op model), the z tests and the readers of the JAX package's
artifacts faid_tpu_torch/scripts/_common.py's.
Any failed phase exits non-zero before the last line, which is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch and numpy, never JAX.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

try:
    from faid_tpu_torch.scripts import _common, channel_parity
    from faid_tpu_torch.scripts._common import (METHOD_NAMES, fer_z, reference_fer,
                                                two_prop_z)
    from faid_tpu_torch.scripts.roofline import (PEAK_BYTES_PER_S, PEAK_INT8_OPS_PER_S,
                                                 PHILOX_KEY_OPS, NOISE_INT_OPS, bound,
                                                 channel_ops, cuda_ms, decoder_ops,
                                                 device_profile, in_turns,
                                                 kernel_device_ms, qam_least_ops,
                                                 qam_rail_ops, qam_walk_ops)
except ImportError as e:
    print(f"FAIL: the faid_tpu_torch package is not importable here: {e}", flush=True)
    sys.exit(1)

REPO = Path(__file__).resolve().parent
BATCH = 2048
SEED = 20261016
FER_ROUNDS = 8
Z_LIMIT = 4.0

# Every decode method besides the main path's, as (label, method,
# factor_1, factor_2): DecoderConfig.for_method's, and NMS also at the
# factors its reference row uses.
OTHER_METHODS = (("NMS 1/6", 0, 1, 6), ("NMS 26/32", 0, 26, 32),
                 ("OMS", 1, 1, 6), ("OMS_BF", 3, 1, 6), ("OMS_DTBF", 4, 1, 6),
                 ("FAID_2B1C", 5, 1, 6))
# Configurations whose message bound is above 7 (a FAID offset of 8: a
# check-node constant reaches -8, a message 8), which the kernels run
# with 8-bit messages, two frames a block and clusters of 16, as
# (label, method, DecoderConfig fields)
WIDE_CONFIGS = (("FAID_DTBF offset 8", 2, {"oms_offset": 8}),
                ("FAID_2B1C offset 8", 5, {"oms_offset": 8}))


# the decoder template's ids (csrc/decoder.cuh Out, Style, Bf)
KERNEL_OF_OUT = {0: "B", 1: "D", 2: "E", 3: "F"}
STYLE_NAMES = {0: "NMS", 1: "OMS", 2: "FAID", 3: "FAID_EF1", 4: "OMS_OFFSET",
               5: "FAID_EF2"}
BF_NAMES = {0: "none", 1: "static", 2: "DTBF", 3: "2B1C"}
_INSTANCE = re.compile(r"decoder_kernelILi(\d)ELi(\d)ELi(\d)ELb(\d)ELi(\d)E")


def kernel_ptxas(log: str) -> dict:
    """Each kernel's ptxas report from the build log: registers, spill
    store and load bytes, static shared bytes.  A decoder instance is
    keyed by (kernel, style, BF kind, stop mode, message bits), another
    kernel by its mangled name."""
    rows, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            m = _INSTANCE.search(name)
            cur = name if m is None else (
                KERNEL_OF_OUT[int(m[1])], STYLE_NAMES[int(m[2])], BF_NAMES[int(m[3])],
                "frame" if m[4] == "1" else "group", int(m[5]))
            rows.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows[cur]["spill"] = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            rows[cur]["regs"] = int(m[1])
            rows[cur]["smem"] = int(sm[1]) if sm else 0
    return rows


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def max_abs_diff(pairs) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in pairs)


def check_fer(out: dict, method: str, factor_1: int, factor_2: int, label: str,
              source: str = "ref"):
    """The FER z-test of a loop's counters; a row of exactly 1.0 (NMS at
    1/6) asks for every frame in error, where z divides by zero."""
    if reference_fer(method, factor_1, factor_2, source)[0] == 1.0:
        check(out["error_frames"] == out["test_frames"],
              f"{label}: FER {out['error_frames'] / out['test_frames']} where "
              f"the {source} row's is 1.0")
        print(f"{label} FER 1.0 over {out['test_frames']} frames, as the {source} row's")
        return
    z = fer_z(out["error_frames"], out["test_frames"], method, factor_1, factor_2,
              source)
    check(abs(z) <= Z_LIMIT, f"{label}: |z| = {abs(z):.2f} > {Z_LIMIT}")


# ---- phases 17-20: kernel G (16/64/256-QAM) and the float channel chain ----
# Each QAM configuration's waterfall point (FER 0.01-0.5 with FAID_DTBF,
# frame stop mode, real codewords; found with the float chain), tried in
# order until the float chain's FER at the first falls there; the speed
# point is 0.4 dB above it, as 4.0 dB is above QPSK's 3.6.  256-QAM takes
# the 6-bit quantizer: at 4 bits and scale 13 its level-3 LLRs, at most
# |c_3| * 13 = 1.99 before noise, truncate to 0 or +-1, and the code
# never converges (FER 1.0 up to 19.5 dB on the CPU).
QAM_POINTS = {4: (4, (7.5, 7.3, 7.7)), 6: (4, (12.5, 12.3, 12.7)),
              8: (6, (16.6, 16.4, 16.8))}
SPEED_OFFSET_DB = 0.4
QAM_NAMES = {1: "BPSK", 2: "QPSK", 4: "16-QAM", 6: "64-QAM", 8: "256-QAM"}


def sm_clock() -> str:
    """The card's SM clock and its maximum, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def mirrored_rails(c, cw, words):
    """(ixe, m), each [batch, rails]: every rail's mirrored word and Gray
    magnitude index for the channel words ``words`` [batch, rails] and the
    codeword ``cw`` (decoder order; None for the all-zero word, where
    every rail has row 0 and ixe is its word)."""
    from faid_tpu_torch.ops import modem

    if cw is None:
        return words, torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    h, batch = c.mod_type // 2, words.shape[0]
    grp = (modem.interleave(cw, c.interleave_depth).to(torch.int64)
           .reshape(batch, -1, h, 2))
    m = torch.zeros_like(grp[:, :, 0, :])
    for lev in range(1, h):
        m = 2 * m + grp[:, :, lev, :]
    sign = grp[:, :, 0, :].reshape(batch, -1).to(torch.int32)
    return words ^ -sign, m.reshape(batch, -1)


def tie_thresholds(params, ixe, m, gen):
    """``params`` with 10 entries of every row m replaced: 5 by mirrored
    words of rails of row m (of any rail where none has it), 2 by such
    words + 1, 2 by such words - 1, 1 by INT_MIN."""
    out = params.clone()
    nmag, nparam = params.shape
    for row in range(nmag):
        pool = ixe[m == row]
        if pool.numel() == 0:
            pool = ixe.reshape(-1)
        pick = torch.randint(pool.numel(), (10,), generator=gen).to(pool.device)
        vals = pool[pick].to(torch.int64).cpu()
        vals[5:7] += 1
        vals[7:9] -= 1
        vals[9] = -(2**31)
        cols = torch.randperm(nparam, generator=gen)[:10]
        out[row, cols.to(out.device)] = vals.clamp(-(2**31), 2**31 - 1).to(
            torch.int32).to(out.device)
    return out


def qam_and_float_chain(code, toy, dev, card, encode, toy_encode, reset_counts,
                        counts):
    """Phases 17-20 and the timings of kernel G and the float chain.
    Returns kernel G's entry fields for the kernels line."""
    from faid_tpu_torch import (build_debug_step, build_sim_loop, build_sim_step,
                                cli, sigma_for)
    from faid_tpu_torch.config import DecodeMethod, SimConfig
    from faid_tpu_torch.ops import channel as fch
    from faid_tpu_torch.ops import cuda_channel as cc
    from faid_tpu_torch.ops import modem, philox, qam_plan
    from faid_tpu_torch.ops.fixed_point import quantize_llr

    n, n_info = code.n_var, code.n_info
    t_phase = time.perf_counter()

    def qcfg(mod, **kw):
        base = dict(decode_method=DecodeMethod.FAID_DTBF, max_iteration=6,
                    mod_type=mod, quant_bits=QAM_POINTS.get(mod, (4,))[0],
                    interleave_depth=2 if mod >= 4 else 1, scale=13.0,
                    batch_per_device=BATCH, fake_encode=False,
                    channel_backend="xla", stop_mode="frame", seed=SEED)
        base.update(kw)
        return SimConfig(**base)

    def g_kw(c, cw, rnd, batch=BATCH, n_var=n):
        return dict(seed=SEED, rnd=rnd, batch=batch, n_var=n_var,
                    mod_type=c.mod_type, depth=c.interleave_depth,
                    quant_bits=c.quant_bits, scale=c.scale, cw=cw)

    def run_g(params, **kw):
        """Kernel G on ``params`` with the cell table made for this call."""
        tables = cc.qam_tables(params, kw["mod_type"], kw["quant_bits"], kw["scale"])
        return cc.quantile_channel_qam(tables, **kw)

    # ---- phase 17: kernel G against its twin, bit for bit -------------------
    cw17 = encode(philox.message_bits(SEED, 17, 0, BATCH, n_info, dev))
    err_g = 0
    cases = ([(m, qb, d) for m in (4, 6, 8) for qb in (4, 6) for d in (1, 2, 3)]
             + [(4, 3, 2), (8, 5, 1), (6, 2, 3)])
    for mod, qb, depth in cases:
        c = qcfg(mod, quant_bits=qb, interleave_depth=depth)
        params = qam_plan.plan_threshold_ints(
            c, sigma_for(c, QAM_POINTS[mod][1][0])).to(dev)
        for cw in (cw17, None):
            kw = g_kw(c, cw, philox.stream_round(17, 1))
            got = run_g(params, **kw)
            want = cc.quantile_channel_qam_plain(params, **kw)
            torch.cuda.synchronize()
            d_llr = max_abs_diff([(got[0], want[0])])
            d_map = max_abs_diff([(got[1], want[1])])
            frac = float(got[1][:, :n_info].float().mean())
            print(f"kernel G vs plain, mod {mod}, {qb}-bit, depth "
                  f"{depth}, {'codewords' if cw is not None else 'zero word'}: "
                  f"llr max_abs_err {d_llr}, map max_abs_err {d_map} (info-bit "
                  f"errors {frac:.5f})")
            check(d_llr == 0 and d_map == 0,
                  f"kernel G differs from its twin: mod {mod}, {qb}-bit, depth {depth}")
            check(frac > 0, "kernel G drew no channel errors")
            err_g = max(err_g, d_llr, d_map)
    tcw = toy_encode(philox.message_bits(SEED, 3, 0, 64, toy.n_info, dev))
    for mod in (4, 6, 8):
        c = qcfg(mod, quant_bits=4)
        params = qam_plan.plan_threshold_ints(c, sigma_for(c, 8.0)).to(dev)
        for cw in (tcw, None):
            kw = g_kw(c, cw, 5, batch=64, n_var=toy.n_var)
            kw["frame0"] = 7
            got = run_g(params, **kw)
            want = cc.quantile_channel_qam_plain(params, **kw)
            d = max_abs_diff(zip(got, want))
            print(f"kernel G vs plain, toy code batch 64, mod {mod}, depth 2, "
                  f"{'codewords' if cw is not None else 'zero word'}: max_abs_err {d}")
            check(d == 0, f"kernel G differs from its twin on the toy code, mod {mod}")
            err_g = max(err_g, d)
    # shapes neither code reaches: a rail count that is not a multiple of 4
    # (the r < rails guard), depths past 3 (the interleaver's index map a
    # byte at a time), a frame's last unit cut short, and a codeword 1 byte
    # off 16-byte alignment (byte loads)
    gen = torch.Generator().manual_seed(SEED)
    for mod, nv, depth in ((4, 100, 1), (4, 100, 2), (4, 100, 5), (6, 90, 3),
                           (6, 90, 5), (8, 104, 4), (8, 96, 6), (4, n, 4),
                           (6, n, 6)):
        c = qcfg(mod, quant_bits=4, interleave_depth=depth)
        params = qam_plan.plan_threshold_ints(c, sigma_for(c, QAM_POINTS[mod][1][0])).to(dev)
        rcw = torch.randint(0, 2, (64, nv), generator=gen, dtype=torch.int8).to(dev)
        for cw in (rcw, None):
            kw = dict(g_kw(c, cw, 6, batch=64, n_var=nv), frame0=3)
            d = max_abs_diff(zip(run_g(params, **kw),
                                 cc.quantile_channel_qam_plain(params, **kw)))
            print(f"kernel G vs plain, n {nv}, mod {mod}, depth {depth}, "
                  f"{'codewords' if cw is not None else 'zero word'}: max_abs_err {d}")
            check(d == 0, f"kernel G differs from its twin: n {nv}, mod {mod}, depth {depth}")
            err_g = max(err_g, d)
    buf = torch.zeros(BATCH * n + 1, dtype=torch.int8, device=dev)
    buf[1:] = cw17.reshape(-1)
    cw_odd = buf[1:].view(BATCH, n)
    for mod in (4, 6, 8):
        c = qcfg(mod, quant_bits=4, interleave_depth=2)
        params = qam_plan.plan_threshold_ints(c, sigma_for(c, QAM_POINTS[mod][1][0])).to(dev)
        kw = g_kw(c, cw_odd, 8)
        d = max_abs_diff(zip(run_g(params, **kw),
                             cc.quantile_channel_qam_plain(params, **kw)))
        print(f"kernel G vs plain, mod {mod}, depth 2, codewords at an odd address: "
              f"max_abs_err {d}")
        check(d == 0, f"kernel G differs from its twin on an unaligned codeword, mod {mod}")
        err_g = max(err_g, d)
    # ties: the plan's thresholds at each speed point, several entries of
    # every row replaced by the mirrored words of rails of that row in this
    # very launch, others by those words +- 1 and by INT_MIN; a random word
    # ties with probability |U| / 2^32, so only words chosen so hold the
    # equality test
    for code_name, nv, batch, frame0, cw_t in (("50G-PON", n, BATCH, 0, cw17),
                                                ("toy code", toy.n_var, 64, 7, tcw)):
        for mod in (4, 6, 8):
            for depth in (1, 2, 3):
                c = qcfg(mod, interleave_depth=depth)
                params = qam_plan.plan_threshold_ints(
                    c, sigma_for(c, QAM_POINTS[mod][1][0] + SPEED_OFFSET_DB)).to(dev)
                for cw in (cw_t, None):
                    kw = dict(g_kw(c, cw, philox.stream_round(17, 2), batch=batch,
                                   n_var=nv), frame0=frame0)
                    words = philox.channel_words(SEED, kw["rnd"], frame0, batch,
                                                 2 * (nv // mod), dev)
                    ixe, m = mirrored_rails(c, cw, words)
                    tp = tie_thresholds(params, ixe, m, gen)
                    ties = sum(int((torch.isin(ixe, tp[r]) & (m == r)).sum())
                               for r in range(tp.shape[0]))
                    d = max_abs_diff(zip(run_g(tp, **kw),
                                         cc.quantile_channel_qam_plain(tp, **kw)))
                    print(f"kernel G vs plain on tie thresholds, {code_name} batch "
                          f"{batch}, mod {mod}, {c.quant_bits}-bit, depth {depth}, "
                          f"{'codewords' if cw is not None else 'zero word'}: "
                          f"max_abs_err {d}, {ties} rails on a threshold")
                    check(d == 0, f"kernel G differs from its twin on tie thresholds: "
                                  f"{code_name}, mod {mod}, depth {depth}")
                    check(ties > 0, f"no rail tied: {code_name}, mod {mod}, depth {depth}")
                    err_g = max(err_g, d)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 18: kernel G's law against the analytic histogram ------------
    t_phase = time.perf_counter()
    reset_counts()
    h = channel_parity.hist_row(code, dev, "16qam", 4, 8.1, batch=BATCH,
                                launches=channel_parity.HIST_ROUNDS, seed=SEED)
    k = counts()
    for lv in h["levels"]:
        print(f"kernel G's law, 16-QAM 8.1 dB, depth 1, 4-bit, scale 13, all-zero "
              f"word, level {lv['level']}: {lv['draws']} draws in {h['launches']} "
              f"launches, worst bin |z| {lv['max_abs_z']} (chi2 {lv['chi2']} over "
              f"{lv['ndof']} bins) against the float64 erfc law of "
              f"faid_tpu_torch/scripts/channel_parity.py (limit "
              f"{channel_parity.HIST_Z}); {lv['outside']} draws outside its bins")
    check(h["consistent"], f"kernel G's 16-QAM law: {h['levels']}")
    check(k["G"] == channel_parity.HIST_ROUNDS,
          f"the 16-QAM histogram launched {k}")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 19: the float chain on the card ------------------------------
    t_phase = time.perf_counter()
    nb = min(256, BATCH)
    cw_cpu = cw17[:nb].cpu()
    noise_cuda_cpu = None
    for mod in (1, 2, 4, 6, 8):
        samples = fch.noise_samples(n, mod)
        noise = philox.normal_noise(SEED, 19, 0, nb, samples, "cpu")
        if mod == 4:
            on_card = philox.normal_noise(SEED, 19, 0, nb, samples, dev).cpu()
            diff = (on_card.view(torch.int32).to(torch.int64)
                    - noise.view(torch.int32).to(torch.int64)).abs()
            noise_cuda_cpu = (int((diff > 0).sum()), int(diff.max()), diff.numel())
        for qb in (1, 4, 6):
            for depth in (1, 2, 3):
                c = qcfg(mod, quant_bits=qb, interleave_depth=depth)
                sigma = sigma_for(c, QAM_POINTS[mod][1][0] if mod >= 4 else 3.6)
                a = fch.float_channel(cw_cpu, noise, sigma, c)
                b = fch.float_channel(cw_cpu.to(dev), noise.to(dev), sigma, c)
                same = all(torch.equal(x.view(torch.int8) if x.dtype != torch.float32
                                       else x.view(torch.int32),
                                       y.cpu().view(torch.int8) if y.dtype != torch.float32
                                       else y.cpu().view(torch.int32))
                           for x, y in zip(a, b))
                check(same, f"the float chain on the card differs from the CPU's: "
                            f"mod {mod}, {qb}-bit, depth {depth}")
    print("float chain, one CPU noise tensor on cuda and on cpu, mod 1/2/4/6/8 x "
          f"1/4/6-bit x depth 1-3, {nb} frames: LLRs, float LLRs and maps bit for "
          "bit equal")
    print(f"the noise drawn on the card against the CPU's (16-QAM's shape): "
          f"{noise_cuda_cpu[0]} of {noise_cuda_cpu[2]} samples differ, by at most "
          f"{noise_cuda_cpu[1]} ulp (erfinv is each device's)")

    def run_loop(c, snr, rounds=FER_ROUNDS, round0=0):
        loop = build_sim_loop(code, c, rounds, dev)
        reset_counts()
        out = loop(SEED, sigma_for(c, snr), round0)
        torch.cuda.synchronize()
        k = counts()
        out = {key: v.tolist() for key, v in out.items()}
        quantile = c.channel_backend == "fused"
        check(k["F"] == 0, f"kernel F ran a {c.channel_backend} round: {k}")
        check(k["B"] == rounds, f"kernel B launched {k['B']} times in {rounds} rounds")
        check(k["G"] == (rounds if quantile and c.mod_type >= 4 else 0),
              f"kernel G launched {k['G']} times in {rounds} "
              f"{c.channel_backend} rounds at mod {c.mod_type}")
        check(out["test_frames"] == rounds * BATCH, "wrong frame count")
        check(sum(out["mp_hist"]) == sum(out["bf_hist"]) == out["test_frames"],
              "histograms do not cover every frame")
        return out, k

    g_launches = 0
    prow = {(r["label"], r["snr_db"]): r
            for r in _common.channel_parity_rows()["points"]}
    for label, mod, snr, backend in (("qpsk", 2, 3.6, "xla"), ("bpsk", 1, 3.6, "xla"),
                                     ("16qam-d2", 4, 7.5, "xla"),
                                     ("16qam-d2", 4, 7.5, "fused")):
        c = qcfg(mod, quant_bits=4, interleave_depth=2 if mod == 4 else 1,
                 channel_backend=backend)
        out, k = run_loop(c, snr)
        if backend == "fused":
            g_launches = k["G"]
        ref = prow[label, snr][backend]
        z = two_prop_z(out["error_frames"], out["test_frames"], ref["errors"], ref["frames"])
        print(f"{label} {backend} {snr} dB, build_sim_loop {FER_ROUNDS} rounds: FER "
              f"{out['error_frames'] / out['test_frames']:.6f} vs the JAX package's "
              f"{ref['fer']} over {ref['frames']}: z = {z:.3f}; launches {k}")
        check(abs(z) <= Z_LIMIT, f"{label} {backend}: |z| = {abs(z):.2f} > {Z_LIMIT}")
    waterfall = {4: 7.5}
    for mod in (6, 8):
        qb, snrs = QAM_POINTS[mod]
        for snr in snrs:
            c = qcfg(mod, quant_bits=qb)
            out_x, _ = run_loop(c, snr, rounds=2, round0=100)
            fer = out_x["error_frames"] / out_x["test_frames"]
            if 0.02 <= fer <= 0.45:
                break
        check(0.01 <= fer <= 0.5, f"no waterfall point for {QAM_NAMES[mod]} in {snrs}")
        waterfall[mod] = snr
        res = {}
        for backend in ("xla", "fused"):
            res[backend], k = run_loop(dataclasses.replace(c, channel_backend=backend), snr)
        x, f = res["xla"], res["fused"]
        zf = two_prop_z(x["error_frames"], x["test_frames"], f["error_frames"], f["test_frames"])
        nb = x["test_frames"] * n_info
        zb = two_prop_z(x["mod_error_bits"], nb, f["mod_error_bits"], nb)
        print(f"{QAM_NAMES[mod]} depth 2, {qb}-bit, {snr} dB, {FER_ROUNDS} rounds each: float "
              f"chain FER {x['error_frames'] / x['test_frames']:.6f}, pre-decoder BER "
              f"{x['mod_error_bits'] / nb:.6e}; kernel G FER "
              f"{f['error_frames'] / f['test_frames']:.6f}, BER "
              f"{f['mod_error_bits'] / nb:.6e}: z FER {zf:.3f}, z BER {zb:.3f}")
        check(abs(zf) <= Z_LIMIT and abs(zb) <= Z_LIMIT,
              f"{QAM_NAMES[mod]}: kernel G and the float chain disagree (z {zf:.2f}, {zb:.2f})")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 20: the campaign path on the float chain and on kernel G -----
    t_phase = time.perf_counter()
    for label, extra in (("float chain (default)", []),
                         ("kernel G", ["--channel-backend", "fused"])):
        with tempfile.TemporaryDirectory() as tmp:
            outdir = Path(tmp) / "qam"
            argv = ["--method", "2", "--mod-type", "4", "--interleave", "2",
                    "--batch", str(BATCH), "--snr-start", "7.5", "--snr-pass", "0.1",
                    "--snr-end", "7.55", "--min-frames", str(FER_ROUNDS * BATCH),
                    "--seed", str(SEED), "--collect-errors", "--quiet", "--device",
                    str(dev), "--out", str(outdir), *extra]
            ccfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
            fused = ccfg.channel_backend == "fused"
            reset_counts()
            check(cli.main(argv) == 0, f"the 16-QAM campaign ({label}) failed")
            torch.cuda.synchronize()
            k = counts()
            print(f"16-QAM campaign, {label}, 7.5 dB: launches {k}")
            print("\n".join("  " + r for r in
                            (outdir / "Result.txt").read_text().splitlines()))
            check(k["F"] == 0 and k["A"] == 0 and k["B"] > 0 and k["D"] > 0
                  and (k["G"] > 0) == fused,
                  f"the 16-QAM campaign ({label}) launched {k}")
            dumped = (outdir / "errorindex.txt").read_text().splitlines()
            check(len(dumped) >= 1, f"the 16-QAM campaign ({label}) dumped no frame")
            table = (outdir / "Result.txt").read_text()
            ck = json.loads((outdir / "checkpoint.json").read_text())
            r0 = ck["results"][0]["err_chunks"][0][0]
            reset_counts()
            check(cli.main(argv) == 0, "the resumed 16-QAM campaign failed")
            check(counts()["B"] == 0, "the 16-QAM rerun did not resume")
            check([r.split()[:7] for r in (outdir / "Result.txt").read_text().splitlines()]
                  == [r.split()[:7] for r in table.splitlines()],
                  "the resumed 16-QAM Result.txt differs")
        sr = philox.stream_round(0, r0)
        sigma = sigma_for(ccfg, 7.5)
        step = build_sim_step(code, ccfg, dev)(SEED, sr, sigma)
        reset_counts()
        dbg = build_debug_step(code, ccfg, dev)(SEED, sr, sigma)
        torch.cuda.synchronize()
        kd = counts()
        eb, ef = int(dbg["err_bits"].sum()), int((dbg["err_bits"] > 0).sum())
        requant = quantize_llr(dbg["soft"], ccfg.scale, ccfg.quant_bits)
        dequant = dbg["llr"].float() / torch.tensor(ccfg.scale, device=dev)
        is_float = (torch.equal(requant, dbg["llr"])
                    and not torch.equal(dbg["soft"], dequant))
        print(f"16-QAM {label} replay of round {r0}: step error_bits "
              f"{int(step['error_bits'])} frames {int(step['error_frames'])}, debug "
              f"{eb} / {ef}; launches {kd}; soft is the float LLR: {is_float}")
        check(int(step["error_bits"]) == eb and int(step["error_frames"]) == ef > 0,
              f"the 16-QAM {label} replay's error counts differ from the step's")
        check(is_float != fused and (not fused or torch.equal(dbg["soft"], dequant)),
              f"the 16-QAM {label} replay's soft values are not the channel's")
        check((kd["G"] == 1) == fused and kd["D"] == 1,
              f"the 16-QAM {label} replay launched {kd}")
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")

    # ---- timings of kernel G and the float chain at the speed points --------
    t_phase = time.perf_counter()
    cw_t = encode(philox.message_bits(SEED, 33, 0, BATCH, n_info, dev))
    g_times = {}
    for mod in (4, 6, 8):
        c = qcfg(mod)
        snr = waterfall[mod] + SPEED_OFFSET_DB
        params = qam_plan.plan_threshold_ints(c, sigma_for(c, snr)).to(dev)
        kw = g_kw(c, cw_t, 9)
        # the tables as the sim loop has them: made once per sigma, not timed
        tables = cc.qam_tables(params, mod, c.quant_bits, c.scale)
        run = lambda: cc.quantile_channel_qam(tables, **kw)  # noqa: E731
        ms, plain = in_turns(run, lambda: cc.quantile_channel_qam_plain(params, **kw),
                             20, 2)
        rails = 2 * (n // mod)
        _, m = mirrored_rails(c, cw_t, torch.zeros((BATCH, rails), dtype=torch.int32,
                                                   device=dev))
        bnd = bound(3 * BATCH * n, qam_least_ops(params, m, mod, c.quant_bits))
        plan_bnd = bound(3 * BATCH * n, BATCH * rails * qam_rail_ops(mod, c.quant_bits, c.scale)
                         + PHILOX_KEY_OPS)
        g_times[mod] = (ms, plain, bnd)
        width = tables.cells.shape[1]
        print(f"kernel G, {QAM_NAMES[mod]} depth 2, {c.quant_bits}-bit, {snr:.1f} dB, batch "
              f"{BATCH} ({card}), in turns with its twin: {ms:.4f} ms (plain "
              f"{plain:.4f}); bound {bnd[0]:.4f} ms by {bnd[1]} ({bnd[0] / ms:.1%}; the "
              f"least work of these inputs, "
              f"{qam_least_ops(params, m, mod, c.quant_bits) / (BATCH * rails):.1f} int32 "
              f"ops a rail; the plan-size count of qam_rail_ops, "
              f"{qam_rail_ops(mod, c.quant_bits, c.scale):.0f} a rail, gives "
              f"{plan_bnd[0]:.4f} ms by {plan_bnd[1]}; the interval walk the cell table "
              f"replaced did {qam_walk_ops(mod, c.quant_bits, c.scale):.0f}); cell table "
              f"{width} entries a row ({width.bit_length() - 1} search steps, "
              f"{max(len(u) for u in qam_plan.cell_rows(params))} cell bounds in the "
              f"longest row)")
        # the spread of G's time: 8 timings of 20 launches back to back, the
        # kernel's own device time, and the host's time per call
        reps = sorted(cuda_ms(run, 20) for _ in range(8))
        dev_ms, host_ms = kernel_device_ms(run, 20)
        print(f"kernel G, {QAM_NAMES[mod]}, 8 timings of 20 launches ({card}): "
              + " ".join(f"{t:.4f}" for t in reps)
              + f" ms (spread {reps[-1] / reps[0] - 1:.1%}); the kernel alone "
              f"{dev_ms:.4f} ms on the device (torch.profiler), the wrapper "
              f"{host_ms:.4f} ms a call on the host; SM clock {sm_clock()}")
    for mod in (2, 4, 6, 8):
        c = qcfg(mod)
        snr = waterfall.get(mod, 3.6) + SPEED_OFFSET_DB
        sig = torch.full((), sigma_for(c, snr), dtype=torch.float32, device=dev)
        samples = fch.noise_samples(n, mod)
        noise = philox.normal_noise(SEED, 9, 0, BATCH, samples, dev)

        def chain():
            tx = modem.interleave(cw_t, c.interleave_depth)
            if mod == 1:
                soft = fch.awgn_real(modem.modulate_bpsk(tx), noise, sig)
            else:
                sym = modem.modulate_qam(tx, mod)
                soft = modem.demodulate_qam(
                    fch.awgn_complex(sym, noise.view(sym.shape), sig), mod)
            return modem.deinterleave(soft, c.interleave_depth)

        soft = chain()
        ms_noise = cuda_ms(lambda: philox.normal_noise(SEED, 9, 0, BATCH, samples, dev), 5)
        ms_chain = cuda_ms(chain, 5)
        ms_quant = cuda_ms(lambda: quantize_llr(soft, c.scale, c.quant_bits), 10)
        nb_ = bound(4 * BATCH * samples, BATCH * samples * NOISE_INT_OPS + PHILOX_KEY_OPS)
        print(f"float chain, {QAM_NAMES[mod]}, depth {c.interleave_depth}, {snr:.1f} dB, batch "
              f"{BATCH} ({card}): noise draw {ms_noise:.4f} ms (bound {nb_[0]:.4f} ms by "
              f"{nb_[1]}, {nb_[0] / ms_noise:.1%}), modulate + AWGN + demap + interleave "
              f"pair {ms_chain:.4f} ms, quantizer {ms_quant:.4f} ms")
    rounds = 5
    for mod in (2, 4, 6, 8):
        c = qcfg(mod, stop_mode="group")
        snr = waterfall.get(mod, 3.6) + SPEED_OFFSET_DB
        lx = build_sim_loop(code, c, rounds, dev)
        lf = build_sim_loop(code, dataclasses.replace(c, channel_backend="fused"),
                            rounds, dev)
        sg = sigma_for(c, snr)
        ms_x, ms_f = in_turns(lambda: lx(SEED, sg, 200), lambda: lf(SEED, sg, 200), 2, 2)
        rate = lambda ms: rounds * BATCH * n_info / (ms * 1e-3) / 1e6  # noqa: E731
        print(f"round, {QAM_NAMES[mod]}, depth {c.interleave_depth}, {c.quant_bits}-bit, "
              f"{snr:.1f} dB, group mode, codewords, batch {BATCH} ({card}), in turns: "
              f"float chain {ms_x / rounds:.4f} ms = {rate(ms_x):.1f} Mbit/s, "
              f"{'kernel F' if mod == 2 else 'kernel G + B'} {ms_f / rounds:.4f} ms "
              f"= {rate(ms_f):.1f} Mbit/s")
        if mod >= 4:
            for name, lp in (("float chain", lx), ("kernel G + B", lf)):
                device_profile(f"the {QAM_NAMES[mod]} {name} loop at {snr:.1f} dB",
                               lambda: lp(SEED, sg, 200), rounds, card)
    print(f"timings: {time.perf_counter() - t_phase:.1f} s")
    ms, plain, bnd = g_times[4]
    return dict(launches=g_launches, err=err_g, ms=ms, plain_ms=plain, bound=bnd)

# ---- phase 21: every decoder configuration of pallas_decoder.supports -------

# Each kernel style as (DecodeMethod of for_method, its knobs replaced), and
# each BF kind as the method whose parameters it takes: NMS at its own
# factors, OMS offset mode 0 with offset 1, EF 2 on tests/test_ef2.py's
# pattern (FAID base, the floor window open from the second of 6
# iterations, no frame gate), so that the erasure fires.
COVER_STYLES = {0: (0, {"factor_1": 26, "factor_2": 32}), 1: (1, {}),
                4: (1, {"oms_mode": 0, "oms_offset": 1}), 2: (2, {}), 3: (5, {}),
                5: (2, {"ef_elimination": 2, "floor_err_count": 100000,
                        "floor_iter_thresh": 4})}
COVER_BF = {"none": None, "static": 3, "dtbf": 2, "dtbf2b1c": 5}
# the 8-bit message width of the two new styles: an offset of 8
COVER_WIDE = ((5, "dtbf"), (5, "none"), (4, "none"), (4, "static"))


def pair_config(style: int, kind: str, stop_mode: str, **fields):
    """The DecoderConfig of a (style id, BF kind) pair."""
    from faid_tpu_torch.config import BFConfig, DecodeMethod, DecoderConfig

    method, knobs = COVER_STYLES[style]
    base = DecoderConfig.for_method(DecodeMethod(method), stop_mode=stop_mode)
    bf = (BFConfig() if COVER_BF[kind] is None
          else DecoderConfig.for_method(DecodeMethod(COVER_BF[kind])).bf)
    return dataclasses.replace(base, bf=bf, **{**knobs, **fields})


def decoder_coverage(code, toy, dev, card, reset_counts, counts) -> dict:
    """Phase 21: kernels B, D and E for every (style, BF kind) pair against
    their plain twins, both stop modes, on kernel A's LLRs at 3.6 and 4.0
    dB (50G-PON, batch 2048) and at 2.0 and 3.6 dB (the toy code, batch
    64); the launch plans against the card; the 8-bit width of the two new
    styles; EF 2 against EF 0 and EF 1 on the same frames; and kernel B's
    EF 2 and OMS offset-mode-0 instances timed at 4.0 dB beside their
    bound.  Returns each kernel's largest difference from its twin."""
    from faid_tpu_torch import sigma_for
    from faid_tpu_torch.config import SimConfig
    from faid_tpu_torch.ops import cuda_channel as cc
    from faid_tpu_torch.ops import cuda_decoder as cd

    t_phase = time.perf_counter()
    qcfg = SimConfig(mod_type=2, quant_bits=4, scale=13.0)

    def llrs(c, batch, snrs):
        out = {}
        for rnd, snr in enumerate(snrs):
            params = cc.threshold_ints(qcfg, sigma_for(qcfg, snr)).to(dev)
            out[snr] = cc.quantile_channel(
                params, seed=SEED, rnd=21 + rnd, batch=batch, n_var=c.n_var,
                n_info=c.n_info, mod_type=2, quant_bits=4)[0]
        return out

    inputs = ((code, "50G-PON", llrs(code, BATCH, (3.6, 4.0))),
              (toy, "toy", llrs(toy, 64, (2.0, 3.6))))
    err = {"B": 0, "D": 0, "E": 0}
    seen = {"B": set(), "D": set(), "E": set()}

    def against_twins(dcfg, c, what, llr_by_snr):
        t = cd.decoder_tables(c, dcfg, dev)
        k2 = "E" if dcfg.bf.kind == "none" else "D"
        line = []
        for snr, llr in llr_by_snr.items():
            got_b = cd.stats_decode(llr, t)
            if k2 == "E":
                got2, want2 = cd.mp_decode(llr, t), cd.mp_decode_plain(llr, c, dcfg)
                hard, rounds = want2[0] > 0, torch.zeros_like(want2[1])
            else:
                got2, want2 = cd.full_decode(llr, t), cd.full_decode_plain(llr, c, dcfg)
                hard, rounds = want2[0] != 0, want2[2]
            # kernel B's twin, stats_decode_plain, is this same plain decode
            # and its info-bit error count: taken from it, not decoded again
            want_b = (hard[:, :c.n_info].sum(dim=1, dtype=torch.int32), want2[1], rounds)
            torch.cuda.synchronize()
            db, d2 = max_abs_diff(zip(got_b, want_b)), max_abs_diff(zip(got2, want2))
            check(db == 0 and d2 == 0, f"kernel B or {k2} differs from its twin: {what}, "
                                       f"{snr} dB (B {db}, {k2} {d2})")
            err["B"], err[k2] = max(err["B"], db), max(err[k2], d2)
            line.append(f"{snr} dB: frames in error {int((got_b[0] > 0).sum())}, mp_iters "
                        f"{int(got_b[1].sum())}, bf_rounds {int(got_b[2].sum())}, B and "
                        f"{k2} max_abs_err {db} {d2}")
        print(f"  {what}: " + "; ".join(line))
        return t, k2

    reset_counts()
    for style in COVER_STYLES:
        for kind in COVER_BF:
            for mode in ("group", "frame"):
                dcfg = pair_config(style, kind, mode)
                pair = cd.kernel_ids(dcfg)
                check(pair == (style, cd.BF_IDS[kind]), f"{dcfg}: kernel ids {pair}")
                for c, name, lls in inputs:
                    what = f"{STYLE_NAMES[style]}/{kind} {mode}, {name}"
                    t, k2 = against_twins(dcfg, c, what, lls)
                    check(t.plan.msg_bits == 4, f"{what}: plan {t.plan}")
                seen["B"].add((style, kind, mode))
                seen[k2].add((style, kind, mode))
    launched = counts()
    print(f"phase 21: kernels B, D and E against their twins for every (style, BF "
          f"kind) pair and stop mode: instances checked B {len(seen['B'])}, D "
          f"{len(seen['D'])}, E {len(seen['E'])}; launches {launched}; max_abs_err {err}")
    check(len(seen["B"]) == 48 and len(seen["D"]) == 36 and len(seen["E"]) == 12,
          f"phase 21 missed an instance: {seen}")
    check(all(launched[k] > 0 for k in ("B", "D", "E")), f"phase 21 launched {launched}")

    # the launch plans of every group-mode instance against the card's
    # answer (frame mode launches unclustered blocks of the same plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for style in COVER_STYLES:
        for kind in COVER_BF:
            t = cd.decoder_tables(code, pair_config(style, kind, "group"), dev)
            row = []
            for k in ("B", "E" if kind == "none" else "D"):
                info = cd.launch_info(k, t, BATCH)
                check(info["smem_bytes"] == t.plan.smem_bytes and info["active"] > 0
                      and info["frames"] == t.plan.frames
                      and info["cluster"] == t.plan.cluster,
                      f"kernel {k}'s launch differs from its plan: {info}, {t.plan}")
                row.append(f"{k} {info['active']} clusters of {info['cluster']} "
                           f"({info['active'] * info['cluster']} of {sms} SMs)")
            print(f"  launch {STYLE_NAMES[style]}/{kind} group on {card}: "
                  f"{t.plan.smem_bytes} B a block, {t.plan.frames} frames; "
                  + ", ".join(row))

    # the 8-bit width of the two new styles
    for style, kind in COVER_WIDE:
        for mode in ("group", "frame"):
            dcfg = pair_config(style, kind, mode, oms_offset=8)
            for c, name, lls in inputs:
                what = f"{STYLE_NAMES[style]}/{kind} offset 8 {mode}, {name}"
                t, _ = against_twins(dcfg, c, what, {s_: l for s_, l in lls.items()
                                                     if s_ == 3.6})
                check(t.plan.msg_bits == 8, f"{what}: plan {t.plan}")
        t = cd.decoder_tables(code, pair_config(style, kind, "group", oms_offset=8), dev)
        info = cd.launch_info("B", t, BATCH)
        print(f"  launch {STYLE_NAMES[style]}/{kind} offset 8 group on {card}: kernel B "
              f"{info['frames']} frames a block, clusters of {info['cluster']}, "
              f"{info['smem_bytes']} B; cudaOccupancyMaxActiveClusters {info['active']}")
        check(info["active"] > 0, "no cluster of an 8-bit launch fits")

    # EF 2's erasure changes frames: kernel B's counters against EF 0 (no
    # swap, no erasure) and EF 1 (the swap alone) on the same frames
    llr36 = inputs[0][2][3.6]
    ef2 = pair_config(5, "dtbf", "group")
    outs = {ef: cd.stats_decode(llr36, cd.decoder_tables(
                code, dataclasses.replace(ef2, ef_elimination=ef), dev))
            for ef in (0, 1, 2)}
    torch.cuda.synchronize()

    def differ(a, b):
        return int(torch.stack([x != y for x, y in zip(a, b)]).any(dim=0).sum())

    d0, d1 = differ(outs[2], outs[0]), differ(outs[2], outs[1])
    print(f"EF 2 at 3.6 dB, 50G-PON, {BATCH} frames (kernel B, FAID3/DTBF, group): "
          f"frames whose (err_bits, mp_iters, bf_rounds) differ from EF 0's {d0}, "
          f"from EF 1's {d1}; frames in error EF 0 {int((outs[0][0] > 0).sum())}, "
          f"EF 1 {int((outs[1][0] > 0).sum())}, EF 2 {int((outs[2][0] > 0).sum())}")
    check(d0 > 0 and d1 > 0, "EF 2 decoded every frame as EF 0 or EF 1 did")
    # kernel F keeps for_method's pairs, and refuses another before a launch
    from faid_tpu_torch.ops import cuda_sim as csim

    params36 = cc.threshold_ints(qcfg, sigma_for(qcfg, 3.6)).to(dev)
    try:
        csim.fused_sim(params36, cd.decoder_tables(code, ef2, dev), seed=SEED, rnd=1,
                       batch=BATCH, mod_type=2, quant_bits=4)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "kernel F ran EF 2, for which it has no instance")

    # kernel B's new styles at 4.0 dB: time, twin, bound
    llr40 = inputs[0][2][4.0]
    times = {}
    for label, dcfg in (("FAID_EF2/DTBF", ef2),
                        ("OMS_OFFSET/none", pair_config(4, "none", "group"))):
        t = cd.decoder_tables(code, dcfg, dev)
        ms, plain_ms = in_turns(lambda: cd.stats_decode(llr40, t),
                                lambda: cd.stats_decode_plain(llr40, code, dcfg), 10, 2)
        _, iters, rounds = cd.stats_decode(llr40, t)
        bnd = bound(BATCH * code.n_var + 3 * 4 * BATCH,
                    decoder_ops(code, t, iters, rounds) + BATCH * code.n_info)
        times[label] = (ms, plain_ms, bnd)
        print(f"kernel B {label} at 4.0 dB, batch {BATCH}, group mode ({card}): "
              f"{ms:.4f} ms, plain twin {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms by "
              f"{bnd[1]} ({bnd[0] / ms:.1%}); mp_iters {int(iters.sum())}, bf_rounds "
              f"{int(rounds.sum())}")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return err


# ---- phases 22-23: the sharded path (parallel/mesh.py) and the bench -------
# the files phase 7's campaign writes, compared with the sharded runs'
CAMPAIGN_FILES = ("Result.txt", "demod.txt", "iterCount.txt", "errorindex.txt",
                  "errordecode.txt", "errorllr.txt", "errorfloat.txt")
WORLD_TIMEOUT_S = 300
# the bench as a user runs it, against phase 5's (fake) and phase 15's
# (random) rates in the same call
BENCH_TOLERANCE = 0.10


def sharded_path(code, cfg, card, campaign, mbit_zero: float, mbit_codewords: float):
    """Phase 22: the sharded path on the card, in worlds of processes
    (tests/_torch_dist.py, torch and the port only); phase 23: the bench."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_dist as td
    from faid_tpu_torch import build_sim_loop, sigma_for

    t_phase = time.perf_counter()
    half = BATCH // 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) world 1 under nccl: phase 7's campaign with --multihost
        t0 = time.perf_counter()
        res = td.launch({"device": "cuda:0", "out": str(tmp / "a"), "cli": {
            "toy": False, "argv": [*campaign["argv"], "--multihost"]}}, 1,
            WORLD_TIMEOUT_S)[0]["cli"]
        out_a = tmp / "a" / "rank0"
        print(f"phase 22(a): the CLI with --multihost, world 1 under nccl: rc "
              f"{res['rc']}, launches {res['launches']}, "
              f"{time.perf_counter() - t0:.1f} s")
        check(res["rc"] == 0, "the --multihost CLI failed")
        check(res["launches"]["F"] > 0 and res["launches"]["A"] == 0,
              f"the --multihost campaign launched {res['launches']}")
        check(td.result_rows((out_a / "Result.txt").read_text())
              == td.result_rows(campaign["files"]["Result.txt"].decode()),
              "the --multihost Result.txt differs from the plain CLI's")
        for name in CAMPAIGN_FILES[1:]:
            check((out_a / name).read_bytes() == campaign["files"][name],
                  f"the --multihost {name} differs from the plain CLI's")
        print("  Result.txt (all but Time(s)), demod.txt, iterCount.txt and the "
              "dumps equal the plain CLI's")

        # (a') world 1 under nccl: the sharded loop, build_sim_loop and one
        # all-reduce of a call's counters, timed
        main_fields = dataclasses.asdict(cfg)
        t0 = time.perf_counter()
        tim = td.launch({"device": "cuda:0", "backend": "nccl",
                         "out": str(tmp / "t"), "timing": {
                             "code": "50gpon", "cfg": main_fields,
                             "rounds": FER_ROUNDS, "snr": 4.0, "calls": 5}}, 1,
                        WORLD_TIMEOUT_S)[0]["timing"]
        plain_ms = sum(tim["plain_ms"]) / 2
        sharded_ms = sum(tim["sharded_ms"]) / 2
        mbit = lambda ms: FER_ROUNDS * BATCH * code.n_info / (ms * 1e-3) / 1e6
        print(f"phase 22(a'): world 1 under nccl at 4.0 dB, batch {BATCH}, "
              f"{FER_ROUNDS} rounds a call ({card}), in turns: build_sim_loop "
              f"{tim['plain_ms']} ms = {mbit(plain_ms):.1f} Mbit/s, sharded loop "
              f"{tim['sharded_ms']} ms = {mbit(sharded_ms):.1f} Mbit/s "
              f"({sharded_ms / plain_ms - 1:+.3%}); one nccl all-reduce of "
              f"{tim['values']} int64 counters {tim['all_reduce_ms']:.4f} ms "
              f"(device), {tim['all_reduce_host_ms']:.4f} ms with its host "
              f"read, {tim['all_reduce_ms'] / plain_ms:.3%} of a call; "
              f"{time.perf_counter() - t0:.1f} s")
        check(abs(sharded_ms / plain_ms - 1) <= 0.02,
              "the world-1 sharded loop is not within 2% of build_sim_loop")

        # (b) and (c): two ranks on the one card over gloo, b = 1024
        loops = {
            "main": dict(main_fields, batch_per_device=half),
            "codewords_frame": dict(main_fields, batch_per_device=half,
                                    fake_encode=False, stop_mode="frame"),
            "qam16": dict(main_fields, batch_per_device=half, fake_encode=False,
                          mod_type=4, interleave_depth=2),
        }
        snrs = {"main": 3.6, "codewords_frame": 3.6, "qam16": 7.5}
        runner_cfg = dataclasses.asdict(campaign["cfg"])
        spec = {"device": "cuda:0", "out": str(tmp / "b"),
                "loops": [{"name": k, "code": "50gpon", "cfg": f,
                           "rounds": FER_ROUNDS, "snr": snrs[k], "round0": 0}
                          for k, f in loops.items()],
                "runner": {"code": "50gpon",
                           "cfg": dict(runner_cfg, batch_per_device=half),
                           "max_rounds": 100000, "collect": True},
                "timing": {"code": "50gpon",
                           "cfg": dict(main_fields, batch_per_device=half),
                           "rounds": FER_ROUNDS, "snr": 4.0, "calls": 3}}
        t0 = time.perf_counter()
        ranks = td.launch(spec, 2, WORLD_TIMEOUT_S)
        print(f"phase 22(b, c): two ranks on cuda:0 over gloo, batch {half} "
              f"each: {time.perf_counter() - t0:.1f} s")
        check([r["size"] for r in ranks] == [2, 2], "the world is not of 2")
        for name, fields in loops.items():
            one = td.sim_config(dict(fields, batch_per_device=BATCH))
            want = {k: v.tolist() for k, v in build_sim_loop(
                code, one, FER_ROUNDS, "cuda")(one.seed,
                                                sigma_for(one, snrs[name]), 0).items()}
            kernels_used = ("G", "B") if one.mod_type == 4 else ("F",)
            for r in ranks:
                got = r["loops"][name]
                print(f"  rank {r['rank']}, {name} at {snrs[name]} dB: error_frames "
                      f"{got['counters']['error_frames']} of "
                      f"{got['counters']['test_frames']}, launches {got['launches']}")
                check(got["counters"] == want,
                      f"rank {r['rank']}'s {name} counters differ from the "
                      f"one-rank loop's at batch {BATCH}")
                check(all(got["launches"][k] > 0 for k in kernels_used),
                      f"rank {r['rank']}'s {name} did not launch {kernels_used}")
                check(got["counters"]["error_frames"] > 0 and
                      got["counters"]["mod_error_bits"] > 0,
                      f"no noise or no errors in {name}")
        print(f"  each rank's counters equal build_sim_loop's at batch {BATCH}, "
              "counter for counter, on F (zero word, group; codewords, frame) "
              "and G then B (16-QAM)")
        for r in ranks:
            t = r["timing"]
            print(f"  rank {r['rank']}: one gloo all-reduce of {t['values']} "
                  f"int64 counters on cuda:0 {t['all_reduce_ms']:.4f} ms "
                  f"(device), {t['all_reduce_host_ms']:.4f} ms with its host "
                  f"read; the sharded loop {t['sharded_ms']} ms a call of "
                  f"{FER_ROUNDS} rounds, two ranks sharing the card")

        lead, other = (r["runner"] for r in ranks)
        out_c = tmp / "b" / "rank0"
        print(f"phase 22(c): the runner at world 2: sweep {lead['sweep_s']:.3f} s, "
              f"launches {lead['sweep_launches']} / {other['sweep_launches']}; "
              f"replay on rank 0 {lead['replay_launches']}, {lead['dumped']} "
              f"frames dumped; the rerun's rounds {lead['resume_calls']} / "
              f"{other['resume_calls']}")
        check(not (tmp / "b" / "rank1").exists(), "rank 1 wrote files")
        check(lead["counters"] == other["counters"] == campaign["counters"],
              "the world-2 runner's counters differ from the plain CLI's")
        check(td.result_rows((out_c / "Result.txt").read_text())
              == td.result_rows(campaign["files"]["Result.txt"].decode()),
              "the world-2 Result.txt differs from the world-1 one")
        for name in ("demod.txt", "iterCount.txt"):
            check((out_c / name).read_bytes() == campaign["files"][name],
                  f"the world-2 {name} differs from the world-1 one")
        for name in CAMPAIGN_FILES[3:]:
            check(td.dump_as_world1((out_c / name).read_text(), half)
                  == campaign["files"][name].decode().splitlines(),
                  f"the world-2 {name} does not map onto the world-1 dump")
        devs = {ln.split()[3] for ln in (out_c / "errorindex.txt").read_text()
                .splitlines()}
        check(lead["dumped"] > 0 and other["dumped"] == 0 and devs == {"0", "1"},
              f"rank 0 dumped {lead['dumped']} frames of devs {devs}")
        check(all(lead["replay_launches"][k] > 0 for k in ("C", "D", "emit")),
              f"the replay launched {lead['replay_launches']}")
        check(lead["resume_calls"] == other["resume_calls"] == 0
              and lead["resume_launches"]["F"] == 0,
              "the world-2 rerun did not resume from rank 0's checkpoint")
        print("  rank 0 alone wrote files; Result.txt (all but Time(s)), "
              "demod.txt and iterCount.txt equal the world-1 campaign's; the "
              f"dump's dev d frame f is its frame d * {half} + f (devs {sorted(devs)})")
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 23: the bench as a user runs it ------------------------------
    t_phase = time.perf_counter()
    for encode, phase_rate in (("fake", mbit_zero), ("random", mbit_codewords)):
        p = subprocess.run([sys.executable, "-m", "faid_tpu_torch.bench",
                            "--encode", encode], cwd=REPO, capture_output=True,
                           text=True, timeout=WORLD_TIMEOUT_S)
        check(p.returncode == 0, f"the bench --encode {encode} failed:\n"
                                 f"{p.stderr[-3000:]}")
        line = json.loads(p.stdout.strip().splitlines()[-1])
        print(f"phase 23: python -m faid_tpu_torch.bench --encode {encode} "
              f"({card}): {json.dumps(line)}\n  {p.stderr.strip()}")
        check({"metric", "value", "unit", "vs_baseline", "encode",
               "baseline_same_workload"} <= set(line)
              and line["unit"] == "Mbit/s" and line["encode"] == encode
              and line["metric"] != "decoded_info_throughput_faid_dtbf_qpsk_4dB",
              "the bench's line lacks a key or has the TPU metric's name")
        check(line["device"]["name"] == torch.cuda.get_device_name(0),
              "the bench names another device")
        ratio = line["value"] / phase_rate
        print(f"  {line['value']} Mbit/s against the in-script rate "
              f"{phase_rate:.1f} Mbit/s: {ratio:.4f}")
        check(abs(ratio - 1) <= BENCH_TOLERANCE,
              f"the bench's {encode} rate is not within "
              f"{BENCH_TOLERANCE:.0%} of the in-script rate")
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")



# ---- phase 24: the port's scripts (faid_tpu_torch/scripts/) on the card -----
# the floor campaign's frame budget, run to half of it and then resumed
FLOOR_FRAMES = 1_024_000
ROOFLINE_STAGES = ("message stream", "encoder", "noise", "modem", "quantizer", "A",
                   "C", "G", "B", "E", "F")


def scripts_on_card(card, reset_counts, counts):
    """Phase 24: each script's ``main(argv)`` in this process at full width,
    its artifacts in a temporary directory, every row held to its check."""
    from faid_tpu_torch.scripts import (backend_parity, fer_validation,
                                        floor_campaign, roofline)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        # (a) the FER waterfall's 3.6 dB rows, group mode, against the TPU's
        t0 = time.perf_counter()
        reset_counts()
        rc = fer_validation.main(["--snrs", "3.6", "--stop-mode", "group",
                                  "--out", str(tmp / "V.md"),
                                  "--json-out", str(tmp / "v.json")])
        k = counts()
        rows = json.loads((tmp / "v.json").read_text())
        print(f"phase 24(a): fer_validation --snrs 3.6 --stop-mode group ({card}): rc "
              f"{rc}, launches {k}, {time.perf_counter() - t0:.1f} s")
        check(rc == 0 and len(rows) == 6 and all(r["consistent"] for r in rows),
              f"fer_validation: a row is inconsistent with its TPU row: {rows}")
        check(all(r["launches"]["F"] > 0
                  and r["launches"]["A"] == r["launches"]["B"] == 0 for r in rows),
              "fer_validation: a row did not run on kernel F alone")
        table = (tmp / "V.md").read_text().splitlines()
        check(sum(line.startswith("| ") for line in table) == 1 + len(rows),
              "fer_validation's table lacks a row")

        # (b) the QPSK 4.0 dB law of kernel C over ~1.1e9 draws
        t0 = time.perf_counter()
        reset_counts()
        rc = channel_parity.main(["--fer-rows", "none", "--hist-rows", "qpsk@4.0",
                                  "--out", str(tmp / "cp.json")])
        k = counts()
        cp = json.loads((tmp / "cp.json").read_text())
        h = cp["histograms"][0]
        print(f"phase 24(b): channel_parity, QPSK 4.0 dB histogram ({card}): rc {rc}, "
              f"{h['draws']} draws, worst bin |z| {h['max_abs_z']}, launches {k}, "
              f"{time.perf_counter() - t0:.1f} s")
        check(rc == 0 and cp["all_consistent"], f"kernel C's QPSK law: {h}")
        check(k["C"] == channel_parity.HIST_ROUNDS and h["launches"] == k["C"],
              f"the histogram launched {k}")

        # (c) the floor campaign at 3.9 dB: half the budget, then the whole
        # resumed, against one run of the whole
        t0 = time.perf_counter()
        argv = ["--methods", "2", "--snr", "3.9", "--calls", "2"]
        runs = {}
        for name, frames, out in (("half", FLOOR_FRAMES // 2, "resumed"),
                                  ("resumed", FLOOR_FRAMES, "resumed"),
                                  ("whole", FLOOR_FRAMES, "whole")):
            reset_counts()
            rc = floor_campaign.main([*argv, "--max-frames", str(frames),
                                      "--out", str(tmp / out / "floor.json")])
            row = json.loads((tmp / out / "floor.json").read_text())[0]
            runs[name] = (rc, counts(), row)
            print(f"phase 24(c): floor_campaign FAID_DTBF 3.9 dB, --max-frames {frames} "
                  f"({name}, {card}): rc {rc}, {row['error_frames']} errors in "
                  f"{row['frames']} frames, z {row.get('z')} against "
                  f"docs/floor_group.json, launches {runs[name][1]}")
        rows = {n: r for n, (_, _, r) in runs.items()}
        keys = ("frames", "error_frames", "fer", "ber", "avg_mp_iters", "avg_bf_rounds")
        check(all(rc == 0 for rc, _, _ in runs.values()),
              "floor_campaign failed, or a row is inconsistent with "
              "docs/floor_group.json")
        check({k_: rows["resumed"][k_] for k_ in keys}
              == {k_: rows["whole"][k_] for k_ in keys},
              f"the resumed floor row differs from one run of the whole budget: {rows}")
        rounds = {n: r["frames"] // BATCH for n, r in rows.items()}
        launched = {n: k_["F"] for n, (_, k_, _) in runs.items()}
        check(launched["half"] == rounds["half"] and launched["whole"] == rounds["whole"]
              and launched["resumed"] == rounds["whole"] - rounds["half"] > 0,
              f"the floor campaign's launches of F: {runs}")
        check(not any(r.get("partial") for r in rows.values()),
              "a floor row stayed partial")
        print(f"phase 24(c): the resumed row equals one run of {FLOOR_FRAMES} frames "
              f"counter for counter; {time.perf_counter() - t0:.1f} s")

        # (d) the roofline at batch 2048
        t0 = time.perf_counter()
        rc = roofline.main(["--batch", str(BATCH), "--out", str(tmp / "r.json")])
        rl = json.loads((tmp / "r.json").read_text())
        print(f"phase 24(d): roofline ({card}): rc {rc}, "
              + ", ".join(f"{n} {s['ms']:.4f} ms ({s['share']:.1%})"
                          for n, s in rl["stages"].items())
              + f"; {time.perf_counter() - t0:.1f} s")
        check(rc == 0 and tuple(rl["stages"]) == ROOFLINE_STAGES,
              f"roofline's stages: {list(rl['stages'])}")
        check(all(0 < s["share"] <= 1.05 and s["ms"] > 0
                  for s in rl["stages"].values()),
              "a roofline stage's share lies outside (0, 1.05]")

        # (e) the decoder kernels against their plain twin, six methods
        t0 = time.perf_counter()
        reset_counts()
        rc = backend_parity.main(["--batch", "128", "--words", "2",
                                  "--out", str(tmp / "bp.json")])
        k = counts()
        bp = json.loads((tmp / "bp.json").read_text())
        print(f"phase 24(e): backend_parity --batch 128 --words 2 ({card}): rc {rc}, "
              + ", ".join(f"{r['method']} {'MATCH' if r['match'] else 'MISMATCH'}"
                          for r in bp["rows"])
              + f", launches {k}; {time.perf_counter() - t0:.1f} s")
        check(rc == 0 and bp["all_match"] and len(bp["rows"]) == 6,
              "backend_parity: a kernel differs from its plain twin")
        check(k["D"] > 0 and k["E"] > 0, f"backend_parity launched {k}")
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s")


def main():
    # --coverage-only: the build, its ptxas report and phase 21 alone
    coverage_only = sys.argv[1:] == ["--coverage-only"]
    if sys.argv[1:] and not coverage_only:
        fail(f"unknown arguments {sys.argv[1:]}: none, or --coverage-only")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    try:
        from faid_tpu_torch import (build_debug_step, build_sim_loop,
                                    build_sim_step, cli, load_code, sigma_for)
        from faid_tpu_torch.code.encoder import make_encode_fn, syndrome_weight
        from faid_tpu_torch.code.toy import toy_code
        from faid_tpu_torch.config import DecodeMethod, SimConfig
        from faid_tpu_torch.decoders.core import build_decoder
        from faid_tpu_torch.ops import cuda_channel as cc
        from faid_tpu_torch.ops import cuda_decoder as cd
        from faid_tpu_torch.ops import cuda_sim as cs
        from faid_tpu_torch.ops import philox
        from faid_tpu_torch.utils import kernels
    except ImportError as e:
        fail(f"the faid_tpu_torch package is not importable here: {e}")
    check(not any(m.split(".")[0] in ("jax", "faid_tpu") for m in sys.modules),
          "JAX or faid_tpu was imported")
    wrappers = _common.kernel_wrappers()

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    counts = _common.launch_counts

    dev = torch.device("cuda:0")
    try:
        card = _common.card_line(dev)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi could not read the card: {e}")
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"({kernels.library_path().name})")
    print("  " + ", ".join(line for line in kernels.build_log().splitlines()
                           if line.startswith("nvcc ")))
    ptxas = kernel_ptxas(kernels.build_log())
    decoders = {k: r for k, r in ptxas.items() if isinstance(k, tuple)}
    # B for 24 (style, BF kind) pairs, D for 18, E for 6, F for 6; each in
    # two widths and two stop modes
    check(len(decoders) == 4 * (24 + 18 + 6 + 6)
          and all("regs" in r for r in ptxas.values()),
          f"the build log reports {len(decoders)} decoder instances, not 216")
    for key, r in sorted(ptxas.items(), key=str):
        what = (f"kernel {key[0]} {key[1]}/{key[2]} {key[3]} {key[4]}-bit"
                if key in decoders else key[:60])
        print(f"  ptxas: {what}: {r['regs']} registers, spill stores "
              f"{r.get('spill', (0, 0))[0]} B, loads {r.get('spill', (0, 0))[1]} B, "
              f"static smem {r['smem']} B")
    check(max(r["smem"] for r in decoders.values()) <= cd.STATIC_SMEM,
          f"a decoder instance's static shared memory exceeds the plan's "
          f"{cd.STATIC_SMEM} B")

    code = load_code("50gpon")
    if coverage_only:
        decoder_coverage(code, toy_code(), dev, card, reset_counts, counts)
        print("coverage-only run: every check passed")
        return
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, max_iteration=6,
                    mod_type=2, quant_bits=4, scale=13.0,
                    batch_per_device=BATCH, fake_encode=True,
                    channel_backend="fused", stop_mode="group", seed=SEED)
    dcfg = cfg.decoder()
    L = 7                                   # 4-bit quantizer: 2L+1 thresholds
    ch = dict(batch=BATCH, n_var=code.n_var, n_info=code.n_info, mod_type=2,
              quant_bits=4)
    chm = dict(batch=BATCH, n_var=code.n_var, quant_bits=4)

    # ---- phase 2: kernel A vs its plain twin --------------------------------
    err_a = 0
    llr_a = {}
    for snr, rnd in ((3.6, 1), (4.0, 2)):
        params = cc.threshold_ints(cfg, sigma_for(cfg, snr)).to(dev)
        got = cc.quantile_channel(params, seed=SEED, rnd=rnd, **ch)
        want = cc.quantile_channel_plain(params, seed=SEED, rnd=rnd, **ch)
        torch.cuda.synchronize()
        diff = max_abs_diff(zip(got, want))
        err_a = max(err_a, diff)
        print(f"kernel A vs plain, {snr} dB: llr {tuple(got[0].shape)} "
              f"mod_error_bits {int(got[1].sum())} symbols {int(got[2].sum())} "
              f"max_abs_err {diff}")
        check(diff == 0, f"kernel A differs from its plain twin at {snr} dB")
        check(int(got[1].sum()) > 0, "kernel A drew no channel errors")
        llr_a[snr] = got
    # the paths the main path does not take: a codeword mask, BPSK, the
    # asymmetric 3/5-bit clips, 6 bits, a frame offset
    gen = torch.Generator(device=dev).manual_seed(SEED)
    variants = []
    for mod, qb, with_cw in ((2, 4, True), (1, 3, False), (2, 5, True),
                             (2, 6, False)):
        gcfg = SimConfig(mod_type=mod, quant_bits=qb)
        params = cc.threshold_ints(gcfg, sigma_for(gcfg, 2.0)).to(dev)
        cw = (torch.randint(0, 2, (64, code.n_var), generator=gen, device=dev,
                            dtype=torch.int8) if with_cw else None)
        kw = dict(seed=SEED, rnd=3, batch=64, n_var=code.n_var,
                  quant_bits=qb, frame0=5, cw=cw)
        variants.append((params, kw, mod, with_cw))
        got = cc.quantile_channel(params, n_info=code.n_info, mod_type=mod, **kw)
        want = cc.quantile_channel_plain(params, n_info=code.n_info,
                                         mod_type=mod, **kw)
        diff = max_abs_diff(zip(got, want))
        print(f"kernel A vs plain, mod {mod}, {qb}-bit, codeword "
              f"{'random' if with_cw else 'zero'}: max_abs_err {diff}")
        check(diff == 0, "kernel A differs from its plain twin")
        err_a = max(err_a, diff)

    # ---- phase 3: kernel B vs its plain twin --------------------------------
    llr36 = llr_a[3.6][0]
    tables = cd.decoder_tables(code, dcfg, dev)
    got_b = cd.stats_decode(llr36, tables)
    want = cd.stats_decode_plain(llr36, code, dcfg)
    torch.cuda.synchronize()
    err_b = max_abs_diff(zip(got_b, want))
    print(f"kernel B vs plain, full code 3.6 dB: frames with errors "
          f"{int((got_b[0] > 0).sum())}, mp_iters {int(got_b[1].sum())}, "
          f"bf_rounds {int(got_b[2].sum())}, max_abs_err {err_b}")
    check(err_b == 0, "kernel B differs from its plain twin on the full code")
    check(int(got_b[2].sum()) > 0, "the DTBF tail was not engaged")

    toy = toy_code()
    tcfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, mod_type=2,
                     batch_per_device=64, fake_encode=True,
                     channel_backend="fused", stop_mode="group")
    ttables = cd.decoder_tables(toy, tcfg.decoder(), dev)
    tparams = cc.threshold_ints(tcfg, sigma_for(tcfg, 2.0)).to(dev)
    tch = dict(seed=SEED, rnd=0, batch=64, n_var=toy.n_var, quant_bits=4)
    tllr, _, _ = cc.quantile_channel(tparams, n_info=toy.n_info, mod_type=2,
                                     **tch)
    tgot = cd.stats_decode(tllr, ttables)
    twant = cd.stats_decode_plain(tllr, toy, tcfg.decoder())
    torch.cuda.synchronize()
    terr = max_abs_diff(zip(tgot, twant))
    print(f"kernel B vs plain, toy code batch 64: bf_rounds "
          f"{int(tgot[2].sum())}, max_abs_err {terr}")
    check(terr == 0, "kernel B differs from its plain twin on the toy code")
    err_b = max(err_b, terr)

    # ---- phase 4: the main path ---------------------------------------------
    loop = build_sim_loop(code, cfg, FER_ROUNDS, "cuda")   # as a user calls it
    reset_counts()
    out = loop(SEED, sigma_for(cfg, 3.6), 0)
    torch.cuda.synchronize()
    main_counts = counts()
    out = {k: v.tolist() for k, v in out.items()}
    print("main path, 3.6 dB:", json.dumps(out), "launches", main_counts)
    check(main_counts["F"] > 0 and main_counts["A"] == main_counts["B"] == 0,
          f"main path launched kernels {main_counts}, not F alone")
    check(out["test_frames"] == FER_ROUNDS * BATCH, "wrong frame count")
    check(out["mod_error_bits"] > 0, "no channel noise reached the decoder")
    check(sum(out["mp_hist"]) == sum(out["bf_hist"]) == out["test_frames"],
          "histograms do not cover every frame")
    z = fer_z(out["error_frames"], out["test_frames"])
    check(abs(z) <= Z_LIMIT, f"|z| = {abs(z):.2f} > {Z_LIMIT}")
    # the composed path, kernel A then kernel B, on the same stream rounds
    loop_ab = build_sim_loop(code, cfg, FER_ROUNDS, "cuda", fuse=False)
    reset_counts()
    out_ab = loop_ab(SEED, sigma_for(cfg, 3.6), 0)
    torch.cuda.synchronize()
    ab_counts = counts()
    out_ab = {k: v.tolist() for k, v in out_ab.items()}
    print(f"composed path (fuse=False), 3.6 dB: launches {ab_counts}; counters "
          f"equal to the main path's: {out_ab == out}")
    check(ab_counts["A"] > 0 and ab_counts["B"] > 0 and ab_counts["F"] == 0,
          f"the composed path launched kernels {ab_counts}")
    check(out_ab == out, "kernels A then B count other than kernel F")

    # ---- phase 5: the main path's rate at 4.0 dB ----------------------------
    e2e_rounds = 10
    e2e = build_sim_loop(code, cfg, e2e_rounds, "cuda")
    e2e_ab = build_sim_loop(code, cfg, e2e_rounds, "cuda", fuse=False)
    ms_e2e, ms_e2e_ab = in_turns(lambda: e2e(SEED, sigma_for(cfg, 4.0), 100),
                                 lambda: e2e_ab(SEED, sigma_for(cfg, 4.0), 100), 3, 3)
    mbit_s = e2e_rounds * BATCH * code.n_info / (ms_e2e * 1e-3) / 1e6
    mbit_s_ab = e2e_rounds * BATCH * code.n_info / (ms_e2e_ab * 1e-3) / 1e6
    print(f"main path at 4.0 dB, batch {BATCH} ({card}), in turns: kernel F "
          f"{ms_e2e / e2e_rounds:.4f} ms/round = {mbit_s:.1f} Mbit/s decoded "
          f"info; kernels A + B {ms_e2e_ab / e2e_rounds:.4f} ms/round = "
          f"{mbit_s_ab:.1f} Mbit/s")

    # ---- phase 6: kernels C and D vs their plain twins ----------------------
    err_c = 0
    llr_c = {}
    for snr, rnd in ((3.6, 1), (4.0, 2)):
        params = cc.threshold_ints(cfg, sigma_for(cfg, snr)).to(dev)
        got = cc.quantile_channel_map(params, seed=SEED, rnd=rnd, **chm)
        want = cc.quantile_channel_map_plain(params, seed=SEED, rnd=rnd, **chm)
        torch.cuda.synchronize()
        diff = max_abs_diff(zip(got, want))
        same_a = max_abs_diff([(got[0], llr_a[snr][0])])
        info_bits = int(got[1][:, :code.n_info].sum())
        print(f"kernel C vs plain, {snr} dB: llr and mod_err "
              f"{tuple(got[1].shape)}, max_abs_err {diff}; llr vs kernel A "
              f"max_abs_err {same_a}; info-bit map sum {info_bits} vs A's "
              f"{int(llr_a[snr][1].sum())}")
        check(diff == 0, f"kernel C differs from its plain twin at {snr} dB")
        check(same_a == 0, f"kernel C's LLRs differ from kernel A's at {snr} dB")
        check(info_bits == int(llr_a[snr][1].sum()),
              "kernel C's map disagrees with kernel A's counts")
        err_c = max(err_c, diff)
        llr_c[snr] = got[0]
    for params, kw, mod, with_cw in variants:
        diff = max_abs_diff(zip(cc.quantile_channel_map(params, **kw),
                                cc.quantile_channel_map_plain(params, **kw)))
        print(f"kernel C vs plain, mod {mod}, {kw['quant_bits']}-bit, codeword "
              f"{'random' if with_cw else 'zero'}: max_abs_err {diff}")
        check(diff == 0, "kernel C differs from its plain twin")
        err_c = max(err_c, diff)

    got_d = cd.full_decode(llr_c[3.6], tables)
    plain_dec = build_decoder(code, dcfg, backend="plain")
    want = plain_dec(llr_c[3.6])
    torch.cuda.synchronize()
    err_d = max_abs_diff(zip(got_d, (want["hard"], want["mp_iters"],
                                     want["bf_rounds"])))
    d_err_bits = got_d[0][:, :code.n_info].sum(dim=1, dtype=torch.int32)
    vs_b = max_abs_diff([(d_err_bits, got_b[0])] + list(zip(got_d[1:], got_b[1:])))
    print(f"kernel D vs plain, full code 3.6 dB: hard {tuple(got_d[0].shape)}, "
          f"mp_iters {int(got_d[1].sum())}, bf_rounds {int(got_d[2].sum())}, "
          f"max_abs_err {err_d}; info-bit errors and counts vs kernel B "
          f"max_abs_err {vs_b}")
    check(err_d == 0, "kernel D differs from its plain twin on the full code")
    check(int(got_d[2].sum()) > 0, "kernel D's DTBF tail was not engaged")
    check(vs_b == 0, "kernel D's error counts differ from kernel B's")

    tllr_c, tmap = cc.quantile_channel_map(tparams, **tch)
    tdiff = max_abs_diff(zip((tllr_c, tmap),
                             cc.quantile_channel_map_plain(tparams, **tch)))
    tdiff = max(tdiff, max_abs_diff([(tllr_c, tllr)]))
    tgot = cd.full_decode(tllr_c, ttables)
    tw = build_decoder(toy, tcfg.decoder(), backend="plain")(tllr_c)
    terr = max_abs_diff(zip(tgot, (tw["hard"], tw["mp_iters"], tw["bf_rounds"])))
    print(f"kernels C and D vs plain, toy code batch 64: C max_abs_err "
          f"{tdiff}, D bf_rounds {int(tgot[2].sum())} max_abs_err {terr}")
    check(tdiff == 0 and terr == 0, "kernel C or D differs on the toy code")
    err_c, err_d = max(err_c, tdiff), max(err_d, terr)

    # ---- phase 7: the campaign path -----------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        outdir = Path(tmp) / "campaign"
        argv = ["--method", "2", "--fake-encode", "--channel-backend", "fused",
                "--stop-mode", "group", "--batch", str(BATCH),
                "--snr-start", "3.6", "--snr-pass", "0.1", "--snr-end", "3.8",
                "--min-frames", str(FER_ROUNDS * BATCH), "--seed", str(SEED),
                "--collect-errors", "--quiet", "--out", str(outdir)]
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        cli_counts = counts()
        check(rc == 0, f"the CLI returned {rc}")
        campaign = {"argv": argv[:-2],
                    "cfg": cli.config_from_args(cli.build_argparser().parse_args(argv)),
                    "files": {n: (outdir / n).read_bytes() for n in CAMPAIGN_FILES}}
        print(f"CLI sweep 3.6-3.7 dB: {sweep_s:.3f} s wall, launches "
              f"{cli_counts}")
        check(all(cli_counts[k] > 0 for k in ("F", "C", "D", "emit"))
              and cli_counts["A"] == cli_counts["B"] == cli_counts["E"] == 0,
              f"the campaign path did not launch F, C and D only: {cli_counts}")
        table = (outdir / "Result.txt").read_text().splitlines()
        print("\n".join("  " + r for r in table))
        rows = [r.split() for r in table[1:]]
        check([r[0] for r in rows] == ["3.60", "3.70"],
              f"Result.txt rows are {[r[0] for r in rows]}")
        check(all(int(r[1]) >= FER_ROUNDS * BATCH for r in rows),
              "too few frames per point")
        ck = json.loads((outdir / "checkpoint.json").read_text())
        res36 = ck["results"][0]
        c36 = res36["counters"]
        check(c36 == out, "the CLI's 3.6 dB counters differ from the main "
                          "path's for the same seed and stream rounds")
        campaign["counters"] = [r["counters"] for r in ck["results"]]
        z = fer_z(c36["error_frames"], c36["test_frames"])
        check(abs(z) <= Z_LIMIT, f"CLI |z| = {abs(z):.2f} > {Z_LIMIT}")
        dumped = (outdir / "errorindex.txt").read_text().splitlines()
        print(f"dumped frames: {len(dumped)}; first: {dumped[0][:100] if dumped else ''}")
        check(len(dumped) >= 1, "no failing frame was dumped")
        sweep_seconds = [r["seconds"] for r in ck["results"]]

        reset_counts()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        resume_counts = counts()
        check(rc == 0, f"the resumed CLI returned {rc}")
        table2 = (outdir / "Result.txt").read_text().splitlines()
        print(f"CLI rerun: launches {resume_counts}")
        check(resume_counts["F"] == 0 and resume_counts["A"] == 0,
              "the rerun did not resume from checkpoint.json")
        check([r.split()[:7] for r in table2] == [r.split()[:7] for r in table],
              "the resumed Result.txt differs")

    r0 = res36["err_chunks"][0][0]
    sr = philox.stream_round(0, r0)
    sigma36 = sigma_for(cfg, 3.6)
    debug = build_debug_step(code, cfg, "cuda")
    a = build_sim_step(code, cfg, "cuda")(SEED, sr, sigma36)
    b = debug(SEED, sr, sigma36)
    eb, ef = int(b["err_bits"].sum()), int((b["err_bits"] > 0).sum())
    print(f"replay of round {r0} at 3.6 dB: step error_bits "
          f"{int(a['error_bits'])} frames {int(a['error_frames'])}, debug "
          f"{eb} / {ef}")
    check(int(a["error_bits"]) == eb and int(a["error_frames"]) == ef > 0,
          "the replay's error counts differ from the step's")

    # ---- phase 8: timings at 4.0 dB and bounds ------------------------------
    sigma40 = sigma_for(cfg, 4.0)
    params40 = cc.threshold_ints(cfg, sigma40).to(dev)
    ms_a, plain_a = in_turns(
        lambda: cc.quantile_channel(params40, seed=SEED, rnd=9, **ch),
        lambda: cc.quantile_channel_plain(params40, seed=SEED, rnd=9, **ch),
        20, 3)
    ms_c, plain_c = in_turns(
        lambda: cc.quantile_channel_map(params40, seed=SEED, rnd=9, **chm),
        lambda: cc.quantile_channel_map_plain(params40, seed=SEED, rnd=9, **chm),
        20, 3)
    llr40, _, _ = cc.quantile_channel(params40, seed=SEED, rnd=9, **ch)
    ms_b, plain_b = in_turns(lambda: cd.stats_decode(llr40, tables),
                             lambda: cd.stats_decode_plain(llr40, code, dcfg),
                             10, 2)
    ms_d, plain_d = in_turns(lambda: cd.full_decode(llr40, tables),
                             lambda: plain_dec(llr40), 10, 2)
    # kernel F on the same frames, against kernel A then kernel B
    sim_kw = dict(seed=SEED, rnd=9, batch=BATCH, mod_type=2, quant_bits=4)
    f40 = cs.fused_sim(params40, tables, **sim_kw)
    ab40 = (*cd.stats_decode(llr40, tables),
            *cc.quantile_channel(params40, seed=SEED, rnd=9, **ch)[1:])
    torch.cuda.synchronize()
    check(max_abs_diff(zip((f40[k] for k in cs.COUNTERS), ab40)) == 0,
          "kernel F differs from kernels A then B at 4.0 dB")
    ms_f, ms_ab = in_turns(
        lambda: cs.fused_sim(params40, tables, **sim_kw),
        lambda: cd.stats_decode(cc.quantile_channel(
            params40, seed=SEED, rnd=9, **ch)[0], tables), 10, 10)
    plain_f = cuda_ms(lambda: cs.fused_sim_plain(params40, code, dcfg, **sim_kw), 2)
    ms_emit, plain_emit = in_turns(
        lambda: cs.fused_sim_emit(params40, seed=SEED, rnd=9, **chm),
        lambda: cc.quantile_channel_map_plain(params40, seed=SEED, rnd=9, **chm),
        20, 3)
    print(f"kernel F at 4.0 dB, batch {BATCH} ({card}), in turns with kernel A "
          f"then kernel B on the same frames: F {ms_f:.4f} ms, A + B "
          f"{ms_ab:.4f} ms ({ms_f / ms_ab:.4f} x); F's plain twin "
          f"{plain_f:.4f} ms; emit (kernel C) {ms_emit:.4f} ms, plain "
          f"{plain_emit:.4f} ms")
    replay_ms = cuda_ms(lambda: debug(SEED, philox.stream_round(1, 0), sigma40), 5)
    print(f"timings at 4.0 dB, batch {BATCH} ({card}), kernel vs plain twin "
          f"in turns: A {ms_a:.4f} ms (plain {plain_a:.4f}), C {ms_c:.4f} ms "
          f"(plain {plain_c:.4f}), B {ms_b:.4f} ms (plain {plain_b:.4f}), "
          f"D {ms_d:.4f} ms (plain {plain_d:.4f}); replay "
          f"{replay_ms:.4f} ms/round = {BATCH / (replay_ms * 1e-3):.1f} "
          f"frames/s; sweep {sweep_s:.3f} s wall, points "
          f"{[round(s, 3) for s in sweep_seconds]} s")

    # every other method's configuration and its tables on the card
    mcfgs = {label: dataclasses.replace(cfg, decode_method=DecodeMethod(m),
                                        factor_1=f1, factor_2=f2)
             for label, m, f1, f2 in OTHER_METHODS}
    mtables = {label: cd.decoder_tables(code, c.decoder(), dev)
               for label, c in mcfgs.items()}
    oms_dcfg = mcfgs["OMS"].decoder()
    ms_e, plain_e = in_turns(lambda: cd.mp_decode(llr40, mtables["OMS"]),
                             lambda: cd.mp_decode_plain(llr40, code, oms_dcfg),
                             10, 2)
    print(f"kernel E (OMS) at 4.0 dB, batch {BATCH} ({card}): {ms_e:.4f} ms "
          f"(plain {plain_e:.4f})")
    for k, t in (("F", tables), ("B", tables), ("D", tables), ("E", mtables["OMS"])):
        info = cd.launch_info(k, t, BATCH)
        print(f"kernel {k} ({t.dcfg.method.name}, group mode) launch on {card}: "
              f"{info['frames']} frames a block, clusters of {info['cluster']}, "
              f"{info['smem_bytes']} B of dynamic shared memory a block, "
              f"{t.plan.msg_bits}-bit messages; cudaOccupancyMaxActiveClusters "
              f"{info['active']} ({info['active'] * info['cluster']} of the card's "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs), "
              f"{BATCH // (info['frames'] * info['cluster'])} clusters a launch")
        check(info["smem_bytes"] == t.plan.smem_bytes and info["active"] > 0,
              f"kernel {k}'s launch differs from its plan: {info}, {t.plan}")

    nbytes = BATCH * code.n_var
    b_bytes = nbytes + 3 * 4 * BATCH

    def b_bound(t, llr):
        _, iters, rounds = cd.stats_decode(llr, t)
        return bound(b_bytes, decoder_ops(code, t, iters, rounds)
                     + BATCH * code.n_info)

    for label, t in mtables.items():
        ms_m = cuda_ms(lambda: cd.stats_decode(llr40, t), 5)
        bm = b_bound(t, llr40)
        print(f"kernel B {label} at 4.0 dB ({card}): {ms_m:.4f} ms, bound "
              f"{bm[0]:.4f} ms by {bm[1]} ({bm[0] / ms_m:.1%})")

    _, iters40, rounds40 = cd.stats_decode(llr40, tables)
    dec_ops = decoder_ops(code, tables, iters40, rounds40)
    _, e_iters40 = cd.mp_decode(llr40, mtables["OMS"])
    e_ops = decoder_ops(code, mtables["OMS"], e_iters40,
                        torch.zeros_like(e_iters40))
    bounds = {
        "A": bound(nbytes + 2 * 4 * BATCH, channel_ops(BATCH, code.n_var, L)),
        "C": bound(2 * nbytes, channel_ops(BATCH, code.n_var, L)),
        "B": bound(b_bytes, dec_ops + BATCH * code.n_info),
        "D": bound(2 * nbytes + 2 * 4 * BATCH, dec_ops),
        "E": bound(2 * nbytes + 4 * BATCH, e_ops),
        # F: A's work and B's, its only traffic the five counters out
        "F": bound(5 * 4 * BATCH, channel_ops(BATCH, code.n_var, L) + dec_ops
                   + BATCH * code.n_info),
    }
    bounds["emit"] = bounds["C"]
    times = {"A": ms_a, "B": ms_b, "C": ms_c, "D": ms_d, "E": ms_e, "F": ms_f,
             "emit": ms_emit}
    print(f"bounds at 4.0 dB (decoder work: mp_iters {int(iters40.sum())}, "
          f"bf_rounds {int(rounds40.sum())}, {dec_ops:.4g} int32 ops; E on "
          f"OMS: mp_iters {int(e_iters40.sum())}, {e_ops:.4g} ops), share "
          f"= bound / time: " + ", ".join(
              f"{k} {v[0]:.4f} ms by {v[1]} ({v[0] / times[k]:.1%})"
              for k, v in bounds.items()))

    # ---- phase 9: every other method on the card ----------------------------
    err_e = 0
    for label, mcfg in mcfgs.items():
        mdcfg, t = mcfg.decoder(), mtables[label]
        has_bf = mdcfg.bf.kind != "none"
        ttab = cd.decoder_tables(toy, dataclasses.replace(
            tcfg, decode_method=mcfg.decode_method, factor_1=mcfg.factor_1,
            factor_2=mcfg.factor_2).decoder(), dev)
        for where, llr, c, tb in (("full code 3.6 dB", llr36, code, t),
                                  ("toy code batch 64", tllr, toy, ttab)):
            got = cd.stats_decode(llr, tb)
            want = cd.stats_decode_plain(llr, c, tb.dcfg)
            if has_bf:
                got2 = cd.full_decode(llr, tb)
                want2 = cd.full_decode_plain(llr, c, tb.dcfg)
                hard = got2[0]
            else:
                got2 = cd.mp_decode(llr, tb)
                want2 = cd.mp_decode_plain(llr, c, tb.dcfg)
                hard = got2[0] > 0
            torch.cuda.synchronize()
            eb = max_abs_diff(zip(got, want))
            e2 = max_abs_diff(zip(got2, want2))
            # the second kernel's info-bit errors and counts are B's
            vs_b = max_abs_diff(
                [(hard[:, :c.n_info].sum(dim=1, dtype=torch.int32), got[0]),
                 (got2[1], got[1])] + ([(got2[2], got[2])] if has_bf else []))
            k2 = "D" if has_bf else "E"
            print(f"{label}, {where}: kernel B vs plain max_abs_err {eb} "
                  f"(frames with errors {int((got[0] > 0).sum())}, mp_iters "
                  f"{int(got[1].sum())}, bf_rounds {int(got[2].sum())}); "
                  f"kernel {k2} vs plain max_abs_err {e2}; {k2}'s errors and "
                  f"counts vs B max_abs_err {vs_b}")
            check(eb == 0, f"kernel B differs from its plain twin: {label}, {where}")
            check(e2 == 0, f"kernel {k2} differs from its plain twin: {label}, {where}")
            check(vs_b == 0, f"kernel {k2}'s counts differ from B's: {label}, {where}")
            check(not has_bf or c is toy or int(got[2].sum()) > 0,
                  f"{label}'s BF tail was not engaged, {where}")
            err_b = max(err_b, eb)
            if has_bf:
                err_d = max(err_d, e2)
            else:
                err_e = max(err_e, e2)

        if has_bf:
            # where kernel B's time goes at 3.6 dB: MP, and the BF tail
            # (the same launch with the tail's round cap at 0)
            no_tail = cd.decoder_tables(code, dataclasses.replace(
                mdcfg, bf=dataclasses.replace(mdcfg.bf, max_iter=0)), dev)
            ms_all = cuda_ms(lambda: cd.stats_decode(llr36, t), 3)
            ms_mp = cuda_ms(lambda: cd.stats_decode(llr36, no_tail), 3)
            rounds = cd.stats_decode(llr36, t)[2].view(-1, 32)[:, 0]
            print(f"{label} kernel B at 3.6 dB ({card}): {ms_all:.4f} ms, of "
                  f"which MP {ms_mp:.4f} ms and the BF tail "
                  f"{ms_all - ms_mp:.4f} ms; BF rounds per word: mean "
                  f"{float(rounds.float().mean()):.2f}, max "
                  f"{int(rounds.max())}, words at the cap "
                  f"{int((rounds == mdcfg.bf.max_iter).sum())} of "
                  f"{rounds.numel()}")

        loop = build_sim_loop(code, mcfg, FER_ROUNDS, "cuda")
        reset_counts()
        out = loop(SEED, sigma36, 0)
        torch.cuda.synchronize()
        m_counts = counts()
        out = {k: v.tolist() for k, v in out.items()}
        print(f"{label} build_sim_loop, 3.6 dB: {json.dumps(out)} launches "
              f"{m_counts}")
        check(m_counts["F"] > 0 and m_counts["A"] == m_counts["B"] == 0,
              f"{label}'s loop launched kernels {m_counts}")
        check(out["test_frames"] == FER_ROUNDS * BATCH, "wrong frame count")
        check(sum(out["mp_hist"]) == sum(out["bf_hist"]) == out["test_frames"],
              "histograms do not cover every frame")
        check_fer(out, METHOD_NAMES[int(mcfg.decode_method)], mcfg.factor_1,
                  mcfg.factor_2, label)

        e2e_m = build_sim_loop(code, mcfg, 5, "cuda")
        ms_m = cuda_ms(lambda: e2e_m(SEED, sigma40, 100), 2)
        print(f"{label} main path at 4.0 dB, batch {BATCH} ({card}): "
              f"{ms_m / 5:.4f} ms/round = "
              f"{5 * BATCH * code.n_info / (ms_m * 1e-3) / 1e6:.1f} Mbit/s "
              "decoded info")

    # ---- phase 10: the campaign path of a method without BF (OMS) ----------
    with tempfile.TemporaryDirectory() as tmp:
        outdir = Path(tmp) / "oms"
        argv = ["--method", "1", "--fake-encode", "--channel-backend", "fused",
                "--stop-mode", "group", "--batch", str(BATCH),
                "--snr-start", "3.6", "--snr-pass", "0.1", "--snr-end", "3.65",
                "--min-frames", str(FER_ROUNDS * BATCH), "--seed", str(SEED),
                "--collect-errors", "--quiet", "--out", str(outdir)]
        reset_counts()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        oms_counts = counts()
        check(rc == 0, f"the OMS campaign returned {rc}")
        print(f"OMS campaign, 3.6 dB: launches {oms_counts}")
        print("\n".join("  " + r for r in
                        (outdir / "Result.txt").read_text().splitlines()))
        check(all(oms_counts[k] > 0 for k in ("F", "C", "E", "emit"))
              and oms_counts["A"] == oms_counts["B"] == oms_counts["D"] == 0,
              f"the OMS campaign did not launch F, C and E only: {oms_counts}")
        dumped = (outdir / "errorindex.txt").read_text().splitlines()
        print(f"OMS dumped frames: {len(dumped)}")
        check(len(dumped) >= 1, "the OMS campaign dumped no failing frame")
        ck = json.loads((outdir / "checkpoint.json").read_text())
        r0 = ck["results"][0]["err_chunks"][0][0]
    oms_cfg = mcfgs["OMS"]
    sr = philox.stream_round(0, r0)
    a = build_sim_step(code, oms_cfg, "cuda")(SEED, sr, sigma36)
    b = build_debug_step(code, oms_cfg, "cuda")(SEED, sr, sigma36)
    eb, ef = int(b["err_bits"].sum()), int((b["err_bits"] > 0).sum())
    print(f"OMS replay of round {r0} at 3.6 dB: step error_bits "
          f"{int(a['error_bits'])} frames {int(a['error_frames'])}, debug "
          f"{eb} / {ef}")
    check(int(a["error_bits"]) == eb and int(a["error_frames"]) == ef > 0,
          "the OMS replay's error counts differ from the step's")

    # ---- phase 11: the encoder ------------------------------------------------
    n_info = code.n_info
    u_cpu = philox.message_bits(SEED, 5, 0, BATCH, n_info, "cpu")
    cw_cpu = make_encode_fn(code, "cpu")(u_cpu)
    encode = make_encode_fn(code, dev)
    u = philox.message_bits(SEED, 5, 0, BATCH, n_info, dev)
    cw5 = encode(u)
    torch.cuda.synchronize()
    msg_diff = max_abs_diff([(u.cpu(), u_cpu)])
    enc_diff = max_abs_diff([(cw5.cpu(), cw_cpu)])
    syn = syndrome_weight(code, cw5)
    print(f"encoder, batch {BATCH}: message bits vs CPU max_abs_err {msg_diff}, "
          f"codewords vs CPU max_abs_err {enc_diff}, unsatisfied checks: max "
          f"{int(syn.max())} over {BATCH} frames; ones {float(cw5.float().mean()):.4f}")
    check(msg_diff == 0 and enc_diff == 0, "the encoder on the card differs from the CPU's")
    check(int(syn.max()) == 0, "a codeword has an unsatisfied check")
    ms_enc = cuda_ms(lambda: encode(u), 20)
    ms_msg = cuda_ms(lambda: philox.message_bits(SEED, 5, 0, BATCH, n_info, dev), 10)
    enc_bytes = BATCH * n_info + code.n_chk * n_info + BATCH * code.n_var
    enc_ops = 2 * BATCH * n_info * code.n_chk
    enc_bound = max(enc_bytes / PEAK_BYTES_PER_S, enc_ops / PEAK_INT8_OPS_PER_S) * 1e3
    print(f"encoder at batch {BATCH} ({card}): torch._int_mm + parity {ms_enc:.4f} "
          f"ms (a library call), bound {enc_bound:.4f} ms by operations "
          f"({enc_bound / ms_enc:.1%}; {enc_ops:.4g} int8 ops at "
          f"{PEAK_INT8_OPS_PER_S:.4g}/s); message bits (plain Philox) "
          f"{ms_msg:.4f} ms")

    # ---- phase 12: kernel F against its twin and against A then B -----------
    sigma36 = sigma_for(cfg, 3.6)
    params36 = cc.threshold_ints(cfg, sigma36).to(dev)
    cw36 = encode(philox.message_bits(SEED, 1, 0, BATCH, n_info, dev))
    toy_encode = make_encode_fn(toy, dev)
    tcw = toy_encode(philox.message_bits(SEED, 0, 0, 64, toy.n_info, dev))
    all_methods = (("FAID_DTBF", 2, 1, 6),) + OTHER_METHODS
    err_f = 0
    t_phase = time.perf_counter()
    for label, m, f1, f2 in all_methods:
        for mode in ("group", "frame"):
            for c, prm, cwx, batch, kind in (
                    (code, params36, None, BATCH, "full code, zero word"),
                    (code, params36, cw36, BATCH, "full code, codewords"),
                    (toy, tparams, None, 64, "toy code, zero word"),
                    (toy, tparams, tcw, 64, "toy code, codewords")):
                mcfg = dataclasses.replace(cfg, decode_method=DecodeMethod(m),
                                           factor_1=f1, factor_2=f2, stop_mode=mode)
                t = cd.decoder_tables(c, mcfg.decoder(), dev)
                kw = dict(seed=SEED, rnd=1, batch=batch, mod_type=2, quant_bits=4,
                          cw=cwx)
                got = cs.fused_sim(prm, t, **kw)
                a_out = cc.quantile_channel(prm, seed=SEED, rnd=1, batch=batch,
                                            n_var=c.n_var, n_info=c.n_info,
                                            mod_type=2, quant_bits=4, cw=cwx)
                b_out = cd.stats_decode(a_out[0], t, cwx)
                want = cs.fused_sim_plain(prm, c, t.dcfg, **kw)
                torch.cuda.synchronize()
                f = [got[k] for k in cs.COUNTERS]
                d_twin = max_abs_diff(zip(f, (want[k] for k in cs.COUNTERS)))
                d_ab = max_abs_diff(zip(f, (*b_out, *a_out[1:])))
                d_b = max_abs_diff(zip(b_out, (want[k] for k in cs.COUNTERS[:3])))
                rounds = got["bf_rounds"].view(-1, 32).amax(dim=1).float()
                print(f"{label} {mode}, {kind}: kernel F vs twin max_abs_err "
                      f"{d_twin}, vs A then B {d_ab}; B vs twin {d_b}; frames in "
                      f"error {int((f[0] > 0).sum())}, mp_iters {int(f[1].sum())}, "
                      f"BF rounds per word mean {float(rounds.mean()):.2f} max "
                      f"{int(rounds.max())}")
                check(d_twin == 0 and d_ab == 0 and d_b == 0,
                      f"kernel F or B disagrees: {label} {mode}, {kind}")
                check(m in (0, 1) or c is toy or int(f[2].sum()) > 0,
                      f"{label}'s BF tail was not engaged in kernel F, {mode}")
                err_f = max(err_f, d_twin, d_ab)
                err_b = max(err_b, d_b)
    # the 8-bit message width: kernels F, B and D against their twins
    for label, m, fields in WIDE_CONFIGS:
        for mode in ("group", "frame"):
            for c, prm, cwx, batch, kind in (
                    (code, params36, None, BATCH, "full code, zero word"),
                    (code, params36, cw36, BATCH, "full code, codewords"),
                    (toy, tparams, None, 64, "toy code, zero word"),
                    (toy, tparams, tcw, 64, "toy code, codewords")):
                wcfg = dataclasses.replace(cfg, decode_method=DecodeMethod(m), stop_mode=mode)
                wdcfg = dataclasses.replace(wcfg.decoder(), **fields)
                t = cd.decoder_tables(c, wdcfg, dev)
                check(t.plan.msg_bits == 8, f"{label}: plan {t.plan}")
                kw = dict(seed=SEED, rnd=1, batch=batch, mod_type=2, quant_bits=4, cw=cwx)
                reset_counts()
                got = cs.fused_sim(prm, t, **kw)
                a_out = cc.quantile_channel(prm, seed=SEED, rnd=1, batch=batch,
                                            n_var=c.n_var, n_info=c.n_info,
                                            mod_type=2, quant_bits=4, cw=cwx)
                b_out = cd.stats_decode(a_out[0], t, cwx)
                d_out = cd.full_decode(a_out[0], t)
                k = counts()
                want = cs.fused_sim_plain(prm, c, wdcfg, **kw)
                want_d = cd.full_decode_plain(a_out[0], c, wdcfg)
                torch.cuda.synchronize()
                f = [got[k_] for k_ in cs.COUNTERS]
                d_twin = max_abs_diff(zip(f, (want[k_] for k_ in cs.COUNTERS)))
                d_ab = max_abs_diff(zip(f, (*b_out, *a_out[1:])))
                d_b = max_abs_diff(zip(b_out, (want[k_] for k_ in cs.COUNTERS[:3])))
                d_d = max_abs_diff(zip(d_out, want_d))
                print(f"{label} {mode}, {kind}, 8-bit messages, {t.plan.frames} frames a "
                      f"block: kernel F vs twin max_abs_err {d_twin}, vs A then B {d_ab}; "
                      f"B vs twin {d_b}; D vs twin {d_d}; frames in error "
                      f"{int((f[0] > 0).sum())}, mp_iters {int(f[1].sum())}, bf_rounds "
                      f"{int(f[2].sum())}; launches {k}")
                check(d_twin == 0 and d_ab == 0 and d_b == 0 and d_d == 0,
                      f"the 8-bit instance disagrees: {label} {mode}, {kind}")
                check(k["F"] == k["B"] == k["D"] == 1, f"{label}: launches {k}")
                err_f = max(err_f, d_twin, d_ab)
                err_b = max(err_b, d_b)
                err_d = max(err_d, d_d)
        if m == 2:
            for k in ("F", "B", "D"):
                info = cd.launch_info(k, cd.decoder_tables(code, dataclasses.replace(
                    cfg.decoder(), **fields), dev), BATCH)
                print(f"kernel {k} ({label}, group mode) launch on {card}: {info['frames']} "
                      f"frames a block, clusters of {info['cluster']}, "
                      f"{info['smem_bytes']} B of dynamic shared memory a block; "
                      f"cudaOccupancyMaxActiveClusters {info['active']}")
                check(info["active"] > 0, f"no cluster of kernel {k}'s 8-bit launch fits")
    # what the 8-bit width costs: kernel F at 4.0 dB in turns with the
    # main path's 4-bit instance (the offset-8 decode runs every MP
    # iteration and BF round, so compare per frame-iteration)
    wt = cd.decoder_tables(code, dataclasses.replace(dcfg, **WIDE_CONFIGS[0][2]), dev)
    skw = dict(seed=SEED, rnd=9, batch=BATCH, mod_type=2, quant_bits=4)
    ms8, ms4 = in_turns(lambda: cs.fused_sim(params40, wt, **skw),
                        lambda: cs.fused_sim(params40, tables, **skw), 5, 5)
    (i8, r8), (i4, r4) = ((int(o["mp_iters"].sum()), int(o["bf_rounds"].sum()))
                          for o in (cs.fused_sim(params40, wt, **skw),
                                    cs.fused_sim(params40, tables, **skw)))
    print(f"kernel F at 4.0 dB, batch {BATCH} ({card}), in turns: 8-bit messages "
          f"({WIDE_CONFIGS[0][0]}) {ms8:.4f} ms for {i8} frame-iterations and {r8} "
          f"BF rounds ({ms8 / i8 * 1e6:.2f} ns a frame-iteration); 4-bit (FAID_DTBF) "
          f"{ms4:.4f} ms for {i4} and {r4} ({ms4 / i4 * 1e6:.2f} ns)")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 13: emit, then D or E, gives F's errors ----------------------
    err_emit = 0
    for label, m in (("FAID_DTBF", 2), ("OMS", 1)):
        for cwx in (None, cw36):
            mcfg = dataclasses.replace(cfg, decode_method=DecodeMethod(m),
                                       fake_encode=cwx is None)
            got = cs.build_fused_sim(code, mcfg, "cuda")(cwx, SEED, 1, sigma36)
            llr_e, map_e = cs.build_fused_sim_emit(code, mcfg, "cuda")(
                cwx, SEED, 1, sigma36)
            llr_k, map_k = cc.quantile_channel_map(params36, seed=SEED, rnd=1,
                                                   cw=cwx, **chm)
            hard = build_decoder(code, mcfg.decoder())(llr_e)["hard"]
            ref = torch.zeros_like(llr_e) if cwx is None else cwx
            err = (hard[:, :n_info] ^ (ref[:, :n_info] != 0)).sum(dim=1, dtype=torch.int32)
            torch.cuda.synchronize()
            d_c = max_abs_diff([(llr_e, llr_k), (map_e, map_k)])
            d_err = max_abs_diff([(err, got["err_bits"])])
            print(f"emit + {'D' if m == 2 else 'E'} ({label}, "
                  f"{'zero word' if cwx is None else 'codewords'}): err_bits vs "
                  f"kernel F max_abs_err {d_err} ({int(err.sum())} bits); emit vs "
                  f"kernel C max_abs_err {d_c}")
            check(d_err == 0 and d_c == 0, f"the emit replay of {label} disagrees")
            err_emit = max(err_emit, d_c)

    # ---- phase 14: frame stop mode ------------------------------------------
    for label, m, f1, f2 in all_methods:
        mcfg = dataclasses.replace(cfg, decode_method=DecodeMethod(m), factor_1=f1,
                                   factor_2=f2, stop_mode="frame")
        mdcfg = mcfg.decoder()
        t = cd.decoder_tables(code, mdcfg, dev)
        if mdcfg.bf.kind != "none":
            got2, want2, k2 = (cd.full_decode(llr36, t),
                               cd.full_decode_plain(llr36, code, mdcfg), "D")
        else:
            got2, want2, k2 = (cd.mp_decode(llr36, t),
                               cd.mp_decode_plain(llr36, code, mdcfg), "E")
        torch.cuda.synchronize()
        e2 = max_abs_diff(zip(got2, want2))
        print(f"{label} frame mode, full code 3.6 dB: kernel {k2} vs plain "
              f"max_abs_err {e2}, mp_iters {int(got2[1].sum())}")
        check(e2 == 0, f"kernel {k2} differs from its twin in frame mode: {label}")
        if k2 == "D":
            err_d = max(err_d, e2)
        else:
            err_e = max(err_e, e2)
        loop = build_sim_loop(code, mcfg, FER_ROUNDS, "cuda")
        reset_counts()
        fout = {k: v.tolist() for k, v in loop(SEED, sigma36, 0).items()}
        f_counts = counts()
        print(f"{label} frame mode build_sim_loop, 3.6 dB: {json.dumps(fout)} "
              f"launches {f_counts}")
        check(f_counts["F"] > 0 and f_counts["A"] == f_counts["B"] == 0,
              f"{label}'s frame-mode loop launched kernels {f_counts}")
        check(sum(fout["mp_hist"]) == sum(fout["bf_hist"]) == fout["test_frames"],
              "histograms do not cover every frame")
        check_fer(fout, METHOD_NAMES[m], f1, f2, f"{label} frame mode", "frame")
        # kernel F's time in the two stop modes, in turns, on the same frames
        gt = cd.decoder_tables(code, dataclasses.replace(mdcfg, stop_mode="group"), dev)
        for snr, prm in ((3.6, params36), (4.0, params40)):
            ms_fr, ms_gr = in_turns(
                lambda: cs.fused_sim(prm, t, seed=SEED, rnd=9, batch=BATCH,
                                     mod_type=2, quant_bits=4),
                lambda: cs.fused_sim(prm, gt, seed=SEED, rnd=9, batch=BATCH,
                                     mod_type=2, quant_bits=4), 3, 3)
            print(f"{label} kernel F at {snr} dB ({card}), in turns: frame mode "
                  f"{ms_fr:.4f} ms, group mode {ms_gr:.4f} ms ({ms_fr / ms_gr:.4f} x)")

    # ---- phase 15: the main path with real codewords ------------------------
    rcfg = dataclasses.replace(cfg, fake_encode=False)
    reset_counts()
    rout = build_sim_loop(code, rcfg, FER_ROUNDS, "cuda")(SEED, sigma36, 0)
    torch.cuda.synchronize()
    r_counts = counts()
    rout = {k: v.tolist() for k, v in rout.items()}
    print(f"main path with codewords, 3.6 dB: {json.dumps(rout)} launches {r_counts}")
    check(r_counts["F"] > 0 and r_counts["A"] == r_counts["B"] == 0,
          f"the codeword path launched kernels {r_counts}")
    print("the reference's FAID_DTBF 3.6 dB group row below is an all-zero-word "
          "row, a different workload from these real codewords (no codeword row "
          "in group mode is committed); it is held to the same bound")
    check_fer(rout, "FAID_DTBF", 1, 6, "main path with codewords")
    e2e_r = build_sim_loop(code, rcfg, e2e_rounds, "cuda")
    ms_r, ms_z = in_turns(lambda: e2e_r(SEED, sigma_for(cfg, 4.0), 100),
                          lambda: e2e(SEED, sigma_for(cfg, 4.0), 100), 3, 3)
    mbit_r = e2e_rounds * BATCH * n_info / (ms_r * 1e-3) / 1e6
    mbit_z = e2e_rounds * BATCH * n_info / (ms_z * 1e-3) / 1e6
    print(f"main path at 4.0 dB, batch {BATCH} ({card}), in turns: codewords "
          f"{ms_r / e2e_rounds:.4f} ms/round = {mbit_r:.1f} Mbit/s, zero word "
          f"{ms_z / e2e_rounds:.4f} ms/round = {mbit_z:.1f} Mbit/s")
    # the same frames decoded as codewords and as the all-zero word
    c40, z40 = (dict((k, v.tolist()) for k, v in f(SEED, sigma_for(cfg, 4.0), 100).items())
                for f in (e2e_r, e2e))
    print("10 rounds at 4.0 dB, codewords / zero word: " + ", ".join(
        f"{k} {c40[k]} / {z40[k]}" for k in ("error_frames", "error_bits", "mp_iters",
                                            "bf_rounds")))
    # where a round's device time goes, after the timings above warmed
    # the loops up
    device_profile("the codewords loop at 4.0 dB",
                   lambda: e2e_r(SEED, sigma_for(cfg, 4.0), 100), e2e_rounds, card)
    device_profile("the zero word loop at 4.0 dB",
                   lambda: e2e(SEED, sigma_for(cfg, 4.0), 100), e2e_rounds, card)

    # ---- phase 16: the campaign path with real codewords --------------------
    with tempfile.TemporaryDirectory() as tmp:
        outdir = Path(tmp) / "codewords"
        argv = ["--method", "2", "--channel-backend", "fused", "--stop-mode",
                "group", "--batch", str(BATCH), "--snr-start", "3.6",
                "--snr-pass", "0.1", "--snr-end", "3.8", "--min-frames",
                str(FER_ROUNDS * BATCH), "--seed", str(SEED), "--collect-errors",
                "--quiet", "--out", str(outdir)]
        reset_counts()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        rc_counts = counts()
        check(rc == 0, f"the codeword campaign returned {rc}")
        print(f"CLI sweep with codewords 3.6-3.7 dB: launches {rc_counts}")
        check(all(rc_counts[k] > 0 for k in ("F", "C", "D", "emit"))
              and rc_counts["A"] == rc_counts["B"] == 0,
              f"the codeword campaign did not launch F, C and D: {rc_counts}")
        table = (outdir / "Result.txt").read_text().splitlines()
        print("\n".join("  " + r for r in table))
        ck = json.loads((outdir / "checkpoint.json").read_text())
        c36 = ck["results"][0]["counters"]
        check(c36 == rout, "the codeword campaign's 3.6 dB counters differ from "
                           "the main path's")
        dumped = (outdir / "errorindex.txt").read_text().splitlines()
        check(len(dumped) >= 1, "the codeword campaign dumped no failing frame")
        reset_counts()
        check(cli.main(argv) == 0, "the resumed codeword campaign failed")
        check(counts()["F"] == 0, "the codeword rerun did not resume")
        check([r.split()[:7] for r in (outdir / "Result.txt").read_text().splitlines()]
              == [r.split()[:7] for r in table], "the resumed Result.txt differs")
    tag, pos = dumped[0].split(" : ")
    words = tag.split()
    check(words[1] == "3.60", f"the first dumped frame is not at 3.6 dB: {tag}")
    r0, f0 = int(words[5]), int(words[7])
    sr = philox.stream_round(0, r0)
    dbg = build_debug_step(code, rcfg, "cuda")(SEED, sr, sigma36)
    step = build_sim_step(code, rcfg, "cuda")(SEED, sr, sigma36)
    want_cw = encode(philox.message_bits(SEED, sr, 0, BATCH, n_info, dev))
    torch.cuda.synchronize()
    bad = torch.nonzero(dbg["hard"][f0, :n_info] != (dbg["cw"][f0, :n_info] != 0))
    positions = " ".join(f"b{p // code.z + 1}+{p % code.z}" for p in bad.view(-1).tolist())
    eb, ef = int(dbg["err_bits"].sum()), int((dbg["err_bits"] > 0).sum())
    print(f"codeword replay of round {r0} at 3.6 dB: step error_bits "
          f"{int(step['error_bits'])} frames {int(step['error_frames'])}, debug "
          f"{eb} / {ef}; the replay's codewords are the encoder's: "
          f"{torch.equal(dbg['cw'], want_cw)}, unsatisfied checks "
          f"{int(syndrome_weight(code, dbg['cw']).max())}; frame {f0}'s dumped "
          f"positions equal the replay's: {positions == pos}")
    check(torch.equal(dbg["cw"], want_cw) and int(dbg["cw"].sum()) > 0,
          "the replay's codewords are not the encoder's")
    check(positions == pos, "the dumped error positions differ from the replay's")
    check(int(step["error_bits"]) == eb and int(step["error_frames"]) == ef > 0,
          "the codeword replay's error counts differ from the step's")

    fcfg = dataclasses.replace(rcfg, stop_mode="frame")
    with tempfile.TemporaryDirectory() as tmp:
        outdir = Path(tmp) / "frame"
        argv = ["--method", "2", "--channel-backend", "fused", "--stop-mode",
                "frame", "--batch", str(BATCH), "--snr-start", "3.6",
                "--snr-pass", "0.1", "--snr-end", "3.65", "--min-frames",
                str(FER_ROUNDS * BATCH), "--seed", str(SEED), "--collect-errors",
                "--quiet", "--out", str(outdir)]
        reset_counts()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        fr_counts = counts()
        check(rc == 0, f"the frame-mode campaign returned {rc}")
        ck = json.loads((outdir / "checkpoint.json").read_text())
        cf = ck["results"][0]["counters"]
        print(f"CLI frame mode with codewords, 3.6 dB: launches {fr_counts}")
        print("\n".join("  " + r for r in
                        (outdir / "Result.txt").read_text().splitlines()))
        check(fr_counts["F"] > 0 and fr_counts["D"] > 0,
              f"the frame-mode campaign launched {fr_counts}")
        # the codeword row: docs/channel_parity.json, QPSK 3.6 dB, FAID_DTBF,
        # real codewords, frame mode, the quantile channel
        prow = next(r for r in _common.channel_parity_rows()["points"]
                    if r["label"] == "qpsk" and r["snr_db"] == 3.6)["fused"]
        z = two_prop_z(cf["error_frames"], cf["test_frames"], prow["errors"],
                       prow["frames"])
        print(f"CLI frame mode with codewords FER "
              f"{cf['error_frames'] / cf['test_frames']:.6f} over {cf['test_frames']} "
              f"frames vs docs/channel_parity.json's QPSK 3.6 dB fused row "
              f"{prow['fer']} over {prow['frames']} (real codewords, frame mode): "
              f"z = {z:.3f}")
        check(abs(z) <= Z_LIMIT, f"CLI frame mode with codewords: |z| = {abs(z):.2f}")
        r0 = ck["results"][0]["err_chunks"][0][0]
    sr = philox.stream_round(0, r0)
    a = build_sim_step(code, fcfg, "cuda")(SEED, sr, sigma36)
    b = build_debug_step(code, fcfg, "cuda")(SEED, sr, sigma36)
    eb, ef = int(b["err_bits"].sum()), int((b["err_bits"] > 0).sum())
    print(f"frame-mode codeword replay of round {r0}: step error_bits "
          f"{int(a['error_bits'])} frames {int(a['error_frames'])}, debug {eb} / {ef}")
    check(int(a["error_bits"]) == eb and int(a["error_frames"]) == ef > 0,
          "the frame-mode replay's error counts differ from the step's")

    g = qam_and_float_chain(code, toy, dev, card, encode, toy_encode, reset_counts,
                            counts)
    bounds["G"] = g["bound"]
    cov = decoder_coverage(code, toy, dev, card, reset_counts, counts)
    err_b, err_d, err_e = (max(err_b, cov["B"]), max(err_d, cov["D"]),
                           max(err_e, cov["E"]))
    sharded_path(code, cfg, card, campaign, mbit_s, mbit_r)
    scripts_on_card(card, reset_counts, counts)

    def entry(name, key, source, replaces, launches, err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("quantile_channel", "A", "faid_tpu_torch/csrc/quantile_channel.cu",
              "faid_tpu/ops/pallas_channel.py:515", ab_counts["A"], err_a,
              ms_a, plain_a),
        entry("stats_decoder", "B", "faid_tpu_torch/csrc/stats_decoder.cu",
              "faid_tpu/ops/pallas_decoder.py:875", ab_counts["B"], err_b,
              ms_b, plain_b),
        entry("quantile_channel_map", "C",
              "faid_tpu_torch/csrc/quantile_channel.cu",
              "faid_tpu/ops/pallas_channel.py:474", cli_counts["C"], err_c,
              ms_c, plain_c),
        entry("full_decoder", "D", "faid_tpu_torch/csrc/full_decoder.cu",
              "faid_tpu/ops/pallas_decoder.py:797", cli_counts["D"], err_d,
              ms_d, plain_d),
        entry("mp_decoder", "E", "faid_tpu_torch/csrc/mp_decoder.cu",
              "faid_tpu/ops/pallas_decoder.py:728", oms_counts["E"], err_e,
              ms_e, plain_e),
        entry("fused_sim", "F", "faid_tpu_torch/csrc/fused_sim.cu",
              "faid_tpu/ops/pallas_decoder.py:975", main_counts["F"], err_f,
              ms_f, plain_f),
        entry("fused_sim_emit", "emit", "faid_tpu_torch/csrc/quantile_channel.cu",
              "faid_tpu/ops/pallas_decoder.py:1098", cli_counts["emit"], err_emit,
              ms_emit, plain_emit),
        entry("quantile_channel_qam", "G", "faid_tpu_torch/csrc/qam_channel.cu",
              "faid_tpu/ops/pallas_channel.py:659", g["launches"], g["err"],
              g["ms"], g["plain_ms"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
