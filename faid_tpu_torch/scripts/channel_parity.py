"""The quantile channel against the float chain on the GPU, two
independent ways (the port of scripts/channel_parity.py):

1. FER rows: the same configuration on both channel backends, ``xla``
   (the float chain) and ``fused`` (the quantile channel: kernel F at
   BPSK/QPSK, kernel G then B at 16-QAM), real codewords, FAID_DTBF,
   frame stop mode, independent streams.  Each row's FER and pre-decoder
   BER (ModCalErr bits over the info bits) are held by the two-proportion
   z, |z| <= 4, between the two backends and against the same backend's
   TPU row of docs/channel_parity.json.  The float chain's noise is each
   device type's (erfinv), so its rows are compared by z only.

2. Histogram rows: the quantile channel's LLRs at the all-zero word over
   30 launches at batch 2048 (~1.1e9 draws a row),
   kernel C at BPSK/QPSK (the draw of kernel A and of F's prologue) and
   kernel G at 16-QAM, counted on the device and read once, against the
   float64 ``math.erfc`` probabilities of each quantizer bin
   (``analytic_bin_probs``, ``analytic_level_probs``: an oracle
   independent of the float32 threshold construction).  Every bin with
   >= 25 expected draws is held to |z| <= 5; a bin with fewer to at most
   expected + 5 sqrt(expected) + 1; no draw may fall outside the
   quantizer's range.  This pins the deep tail (|q| = 7 wrong-sign at 4.0
   dB has p ~ 1e-7) that no FER row resolves.

    python -m faid_tpu_torch.scripts.channel_parity
        [--fer-rows qpsk@3.6,...|none] [--hist-rows qpsk@4.0,...|none]
        -> docs/torch_h100/channel_parity.json (exit 1 unless all_consistent)
"""

from __future__ import annotations

import argparse
import math
import time

from . import _common

MIN_ERRORS = 60
MAX_ROUNDS = 600
BATCH = 2048
ROUNDS_PER_CALL = 25
Z_THRESHOLD = 4.0
HIST_Z = 5.0
# (label, mod_type, snr_db, max_iteration, interleave_depth)
FER_ROWS = [
    ("qpsk", 2, 3.6, 6, 1),
    ("qpsk", 2, 3.7, 6, 1),
    ("bpsk", 1, 3.6, 6, 1),
    ("qpsk-floor-sigma", 2, 4.0, 2, 1),   # weak decoder: countable FER
    # 16-QAM depth 2: the shared-draw joint law and the interleaver
    ("16qam-d2", 4, 7.5, 6, 2),
]
HIST_ROWS = [("qpsk", 2, 3.6), ("qpsk", 2, 4.0), ("bpsk", 1, 4.0),
             ("16qam", 4, 8.1)]
HIST_ROUNDS = 30            # x BATCH x n_var draws ~ 1.1e9 a row


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faid_tpu_torch.scripts.channel_parity",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--fer-rows", default="all",
                    help="label@snr entries of FER_ROWS, 'all' or 'none'")
    ap.add_argument("--hist-rows", default="all",
                    help="label@snr entries of HIST_ROWS, 'all' or 'none'")
    ap.add_argument("--seed", type=int, default=0,
                    help="the stream's seed: another draws every row anew")
    ap.add_argument("--out", default=None,
                    help="default docs/torch_h100/channel_parity.json")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    return ap


def _pick(rows, spec: str):
    if spec == "all":
        return list(rows)
    if spec == "none":
        return []
    want = spec.split(",")
    picked = [r for r in rows if f"{r[0]}@{r[2]}" in want]
    if len(picked) != len(want):
        raise SystemExit(f"unknown rows in {spec!r}; choose from "
                         + ", ".join(f"{r[0]}@{r[2]}" for r in rows))
    return picked


def analytic_bin_probs(cfg, sigma: float) -> dict:
    """float64 P(q = m) for a sent 0-bit, m in [lo, hi]: the truncating
    quantizer law q = clip(trunc(scale (-a + s_rail z)), lo, hi) with
    math.erfc, independent of the float32 thresholds of the kernels."""
    from ..ops.cuda_channel import _AMPLITUDE
    from ..ops.fixed_point import _QUANT_LIMITS

    lo, hi = _QUANT_LIMITS[cfg.quant_bits]
    a = _AMPLITUDE[cfg.mod_type]
    srail = sigma / math.sqrt(2.0) if cfg.mod_type == 2 else sigma

    def p_soft_ge(x):            # P(-a + srail z >= x)
        return 0.5 * math.erfc((x + a) / srail / math.sqrt(2.0))

    probs = {}
    for m in range(lo, hi + 1):
        # q >= m  <=>  soft >= m (m >= 1);  q <= m  <=>  soft <= m (m <= -1)
        if m > 0:
            probs[m] = (p_soft_ge(m / cfg.scale)
                        - (p_soft_ge((m + 1) / cfg.scale) if m < hi else 0.0))
        elif m < 0:
            lo_edge = 1.0 - p_soft_ge(m / cfg.scale)
            hi_edge = 1.0 - p_soft_ge((m - 1) / cfg.scale) if m > lo else 0.0
            probs[m] = lo_edge - hi_edge
        else:
            probs[m] = p_soft_ge(-1.0 / cfg.scale) - p_soft_ge(1.0 / cfg.scale)
    return probs


def analytic_level_probs(cfg, sigma: float, level: int) -> dict:
    """float64 P(q_level = m) for the all-zero codeword (every rail sends
    sign 0, magnitude index 0), over the plan's static interval expansion
    of the folded demap (ops/qam_plan.py), with math.erfc."""
    from ..ops import modem
    from ..ops.fixed_point import _QUANT_LIMITS
    from ..ops.qam_plan import _INF, _MAGNITUDES, _expand_ge, _expand_le

    lo, hi = _QUANT_LIMITS[cfg.quant_bits]
    if -lo != hi:
        raise ValueError("asymmetric clip not folded here")
    L = hi
    folds = tuple(modem._FOLD[cfg.mod_type])
    s = -float(_MAGNITUDES[cfg.mod_type][0])
    srail = sigma / math.sqrt(2.0)

    def p_gt(x):                 # P(y > x), y ~ N(s, srail)
        return 0.5 * math.erfc((x - s) / srail / math.sqrt(2.0))

    def p_event(intervals):
        return sum((p_gt(a) if a != -_INF else 1.0)
                   - (p_gt(b) if b != _INF else 0.0)
                   for a, b in intervals)

    p_ge = {k: p_event(_expand_ge(level, k / cfg.scale, folds))
            for k in range(1, L + 1)}
    p_le = {k: p_event(_expand_le(level, -k / cfg.scale, folds))
            for k in range(1, L + 1)}
    probs = {}
    for v in range(1, L + 1):
        probs[v] = p_ge[v] - (p_ge[v + 1] if v < L else 0.0)
        probs[-v] = p_le[v] - (p_le[v + 1] if v < L else 0.0)
    probs[0] = 1.0 - sum(probs.values())
    return probs


def _sigma32(cfg, snr: float) -> float:
    """sigma as the kernels take it, rounded to float32 (the JAX script's
    oracle takes this value too)."""
    import numpy as np

    return float(np.float32(cfg.sigma_at(snr)))


def hist_counts(code, device, mod: int, snr: float, batch: int, launches: int,
                seed: int, stream: int):
    """[levels, 16] int64 CPU counts of the LLRs + 8 over ``launches``
    launches of the quantile channel at the all-zero word (kernel C at
    BPSK/QPSK, G at 16/64/256-QAM on a CUDA device; their plain twins on
    the CPU), depth 1, 4-bit, scale 13; the counts stay on the device until
    the end.  Position p's level is (p % mod) // 2."""
    import torch

    from ..config import SimConfig
    from ..ops import cuda_channel as cc
    from ..ops import philox
    from ..ops.qam_plan import plan_threshold_ints

    cfg = SimConfig(mod_type=mod, batch_per_device=batch, channel_backend="fused")
    sigma = _sigma32(cfg, snr)
    nlev = max(mod // 2, 1)
    if mod in (1, 2):
        params = cc.threshold_ints(cfg, sigma).to(device)

        def draw(rnd):
            return cc.quantile_channel_map(params, seed=seed, rnd=rnd, batch=batch,
                                           n_var=code.n_var,
                                           quant_bits=cfg.quant_bits)[0]
    else:
        tables = cc.qam_tables(plan_threshold_ints(cfg, sigma), mod,
                               cfg.quant_bits, cfg.scale)
        tables = tables._replace(params=tables.params.to(device),
                                 cells=tables.cells.to(device))

        def draw(rnd):
            return cc.quantile_channel_qam(tables, seed=seed, rnd=rnd, batch=batch,
                                           n_var=code.n_var, mod_type=mod,
                                           depth=cfg.interleave_depth,
                                           quant_bits=cfg.quant_bits,
                                           scale=cfg.scale)[0]
    counts = torch.zeros((nlev, 16), dtype=torch.int64, device=device)
    for r in range(launches):
        v = draw(philox.stream_round(stream, r)).to(torch.int64) + 8
        v = v.view(batch, code.n_var // (2 * nlev), nlev, 2)
        for lev in range(nlev):
            counts[lev] += torch.bincount(v[:, :, lev, :].reshape(-1), minlength=16)
    return counts.cpu(), cfg, sigma


def judge_level(counts, probs: dict) -> dict:
    """One level's bins against its law: observed, expected, z where >= 25
    draws are expected (|z| <= HIST_Z), the low-mass bound elsewhere, and
    no draw outside the law's bins."""
    total = int(counts.sum())
    bins, max_z, chi2, ndof, ok = [], 0.0, 0.0, 0, True
    for m, p in sorted(probs.items()):
        obs = int(counts[m + 8])
        exp = p * total
        z = (obs - exp) / math.sqrt(max(exp * (1 - p), 1e-30)) if exp else 0.0
        if exp >= 25:                     # the normal approximation holds
            max_z = max(max_z, abs(z))
            chi2 += z * z
            ndof += 1
            ok &= abs(z) <= HIST_Z
        else:
            ok &= obs <= exp + HIST_Z * math.sqrt(exp) + 1
        bins.append({"q": m, "observed": obs, "expected": round(exp, 3),
                     "z": round(z, 2) if exp >= 25 else None})
    outside = total - sum(int(counts[m + 8]) for m in probs)
    ok &= outside == 0
    return {"draws": total, "bins": bins, "max_abs_z": round(max_z, 2),
            "chi2": round(chi2, 1), "ndof": ndof, "outside": outside,
            "consistent": ok}


def hist_row(code, device, label: str, mod: int, snr: float, batch: int = BATCH,
             launches: int = HIST_ROUNDS, seed: int = 0) -> dict:
    """A histogram row in the JAX artifact's shape, with its launches and
    the kernels that ran them."""
    before = _common.launch_counts()
    t0 = time.perf_counter()
    counts, cfg, sigma = hist_counts(code, device, mod, snr, batch, launches, seed,
                                     _common.stream_id("hist", label, snr))
    levels = []
    for lev in range(counts.shape[0]):
        probs = (analytic_bin_probs(cfg, sigma) if mod in (1, 2)
                 else analytic_level_probs(cfg, sigma, lev))
        levels.append(dict(level=lev, **judge_level(counts[lev], probs)))
    rec = {"label": label, "mod_type": mod, "snr_db": snr, "levels": levels,
           "max_abs_z": max(lv["max_abs_z"] for lv in levels),
           "consistent": all(lv["consistent"] for lv in levels),
           "launches": launches, "kernels": _common.launches_since(before),
           "seconds": time.perf_counter() - t0}
    if len(levels) == 1:        # the flat shape of a single-level row
        rec.update({k: v for k, v in levels[0].items() if k != "level"})
    return rec


def fer_counts(code, cfg, snr: float, device, stream: int, rounds_per_call: int,
               min_errors: int, max_rounds: int) -> dict:
    """Calls of ``build_sim_loop`` on stream point ``stream`` until
    ``min_errors`` frame errors or ``max_rounds`` rounds: (frames, errors,
    pre-decoder error bits) as Python ints, with the launches and seconds."""
    from ..ops import philox
    from ..sim.pipeline import build_sim_loop

    loop = build_sim_loop(code, cfg, rounds_per_call, device)
    sigma = cfg.sigma_at(snr)
    before = _common.launch_counts()
    t0 = time.perf_counter()
    frames = errors = mbits = rounds = 0
    while errors < min_errors and rounds < max_rounds:
        out = loop(cfg.seed, sigma, philox.stream_round(stream, rounds))
        rounds += rounds_per_call
        frames += int(out["test_frames"])
        errors += int(out["error_frames"])
        mbits += int(out["mod_error_bits"])
    return {"frames": frames, "errors": errors, "fer": errors / frames,
            "mod_error_bits": mbits, "launches": _common.launches_since(before),
            "seconds": time.perf_counter() - t0}


def z_pair(a: dict, b: dict, n_info: int) -> dict:
    """FER and pre-decoder BER z of two backends' counts, and whether both
    hold |z| <= Z_THRESHOLD."""
    z_fer = _common.two_prop_z(a["errors"], a["frames"], b["errors"], b["frames"])
    z_ber = _common.two_prop_z(a["mod_error_bits"], a["frames"] * n_info,
                               b["mod_error_bits"], b["frames"] * n_info)
    return {"z_fer": round(z_fer, 3), "z_mod_ber": round(z_ber, 3),
            "consistent": abs(z_fer) <= Z_THRESHOLD and abs(z_ber) <= Z_THRESHOLD}


def fer_row(code, device, label: str, mod: int, snr: float, max_it: int,
            depth: int, batch: int = BATCH, rounds_per_call: int = ROUNDS_PER_CALL,
            min_errors: int = MIN_ERRORS, max_rounds: int = MAX_ROUNDS,
            seed: int = 0, tpu_rows: dict | None = None) -> dict:
    """One FER row on both backends, held between them and, where
    ``tpu_rows`` has the (label, snr) row, against it backend by backend."""
    from ..config import DecodeMethod, SimConfig

    res = {}
    for chan in ("xla", "fused"):
        cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, max_iteration=max_it,
                        mod_type=mod, interleave_depth=depth, batch_per_device=batch,
                        seed=seed, channel_backend=chan)
        res[chan] = fer_counts(code, cfg, snr, device,
                               _common.stream_id(chan, label, snr), rounds_per_call,
                               min_errors, max_rounds)
        r = res[chan]
        print(f"{label:16s} {chan:5s} {snr} dB: {r['errors']}/{r['frames']} "
              f"FER={r['fer']:.3e} modBER-bits={r['mod_error_bits']} "
              f"({r['seconds']:.1f}s) launches {r['launches']}", flush=True)
    between = z_pair(res["xla"], res["fused"], code.n_info)
    row = {"label": label, "mod_type": mod, "snr_db": snr, "max_iteration": max_it,
           "interleave_depth": depth, **res, **between}
    tpu = (tpu_rows or {}).get((label, snr))
    if tpu is not None:
        row["vs_tpu"] = {chan: z_pair(res[chan], tpu[chan], code.n_info)
                         for chan in ("xla", "fused")}
        row["consistent"] &= all(v["consistent"] for v in row["vs_tpu"].values())
    print(f"{label} {snr} dB: z_fer = {row['z_fer']:+.2f}  z_modber = "
          f"{row['z_mod_ber']:+.2f}; against the TPU rows "
          f"{row.get('vs_tpu')} ({'ok' if row['consistent'] else 'FAIL'})",
          flush=True)
    return row


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..cli import _device
    from ..code.qc_matrix import load_code

    device = _device(args.device)
    code = load_code("50gpon")
    card = _common.card_line(device)
    tpu_rows = {(p["label"], p["snr_db"]): p
                for p in _common.channel_parity_rows()["points"]}
    points = [fer_row(code, device, *r, seed=args.seed, tpu_rows=tpu_rows)
              for r in _pick(FER_ROWS, args.fer_rows)]
    hists = []
    for label, mod, snr in _pick(HIST_ROWS, args.hist_rows):
        h = hist_row(code, device, label, mod, snr, seed=args.seed)
        hists.append(h)
        print(f"hist {label} {snr} dB: {sum(lv['draws'] for lv in h['levels'])} "
              f"draws in {h['launches']} launches ({h['kernels']}), "
              f"max|z|={h['max_abs_z']} ({'ok' if h['consistent'] else 'FAIL'})",
              flush=True)
    ok = all(p["consistent"] for p in points + hists)
    out = _common.write_json(args.out or _common.OUT_DIR / "channel_parity.json", {
        "config": f"method2 batch={BATCH} real-codeword, frame stop mode; "
                  f"hist rows all-zero cw, {HIST_ROUNDS} launches",
        "card": card, "seed": args.seed, "z_threshold": Z_THRESHOLD,
        "hist_z_threshold": HIST_Z,
        "points": points, "histograms": hists, "all_consistent": ok})
    print(f"wrote {out}; all_consistent={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
