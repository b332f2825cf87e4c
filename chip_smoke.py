#!/usr/bin/env python3
"""Smoke run of the PyTorch port (faid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from faid_tpu_torch/csrc, then:
  1. prints the card's name and power limit and the kernel build time;
  2. kernel A (quantile channel) against its plain PyTorch twin, bit for
     bit, on the full 50G-PON code at batch 2048, 3.6 and 4.0 dB;
  3. kernel B (stats decoder) against its plain twin, bit for bit, on
     kernel A's 3.6 dB LLRs, and on the toy code at batch 64;
  4. the main path, build_sim_loop at 3.6 dB, batch 2048, 8 rounds: both
     kernels launched, noise flowed, FER z-test against the reference
     simulator's FAID_DTBF QPSK 3.6 dB row (docs/refcheck_fer_compare.json);
  5. CUDA-event timings at 4.0 dB, batch 2048: each kernel beside its
     plain twin, and the main path's decoded-info Mbit/s.
Any failed phase exits non-zero before the last line, which is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch and numpy, never JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
BATCH = 2048
SEED = 20261016
FER_ROUNDS = 8
Z_LIMIT = 4.0


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def max_abs_diff(pairs) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in pairs)


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


def reference_fer() -> tuple[float, int]:
    rows = json.loads((REPO / "docs" / "refcheck_fer_compare.json").read_text())
    for r in rows["rows"]:
        if (r["method"] == "FAID_DTBF" and r["snr_db"] == 3.6
                and r["mod_type"] == 2 and r["lut"] == "faid3"
                and r["scale"] == 13.0):
            return r["ref_fer"], r["ref_frames"]
    fail("no FAID_DTBF QPSK 3.6 dB row in docs/refcheck_fer_compare.json")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    try:
        from faid_tpu_torch import build_sim_loop, load_code, sigma_for
        from faid_tpu_torch.code.toy import toy_code
        from faid_tpu_torch.config import DecodeMethod, SimConfig
        from faid_tpu_torch.ops import cuda_channel as cc
        from faid_tpu_torch.ops import cuda_decoder as cd
        from faid_tpu_torch.utils import kernels
    except ImportError as e:
        fail(f"the faid_tpu_torch package is not importable here: {e}")
    check(not any(m.split(".")[0] in ("jax", "faid_tpu") for m in sys.modules),
          "JAX or faid_tpu was imported")

    dev = torch.device("cuda:0")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi could not read the card: {e}")
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"({kernels.library_path().name})")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    code = load_code("50gpon")
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, max_iteration=6,
                    mod_type=2, quant_bits=4, scale=13.0,
                    batch_per_device=BATCH, fake_encode=True,
                    channel_backend="fused", stop_mode="group", seed=SEED)
    dcfg = cfg.decoder()
    ch = dict(batch=BATCH, n_var=code.n_var, n_info=code.n_info, mod_type=2,
              quant_bits=4)

    # ---- phase 2: kernel A vs its plain twin --------------------------------
    err_a = 0
    llr36 = None
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
        if snr == 3.6:
            llr36 = got[0]
    # the paths the main path does not take: a codeword mask, BPSK, the
    # asymmetric 3/5-bit clips, 6 bits, a frame offset
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for mod, qb, with_cw in ((2, 4, True), (1, 3, False), (2, 5, True),
                             (2, 6, False)):
        gcfg = SimConfig(mod_type=mod, quant_bits=qb)
        params = cc.threshold_ints(gcfg, sigma_for(gcfg, 2.0)).to(dev)
        cw = (torch.randint(0, 2, (64, code.n_var), generator=gen, device=dev,
                            dtype=torch.int8) if with_cw else None)
        kw = dict(seed=SEED, rnd=3, batch=64, n_var=code.n_var,
                  n_info=code.n_info, mod_type=mod, quant_bits=qb, frame0=5,
                  cw=cw)
        diff = max_abs_diff(zip(cc.quantile_channel(params, **kw),
                                cc.quantile_channel_plain(params, **kw)))
        print(f"kernel A vs plain, mod {mod}, {qb}-bit, codeword "
              f"{'random' if with_cw else 'zero'}: max_abs_err {diff}")
        check(diff == 0, "kernel A differs from its plain twin")
        err_a = max(err_a, diff)

    # ---- phase 3: kernel B vs its plain twin --------------------------------
    tables = cd.decoder_tables(code, dcfg, dev)
    got = cd.stats_decode(llr36, tables)
    want = cd.stats_decode_plain(llr36, code, dcfg)
    torch.cuda.synchronize()
    err_b = max_abs_diff(zip(got, want))
    print(f"kernel B vs plain, full code 3.6 dB: frames with errors "
          f"{int((got[0] > 0).sum())}, mp_iters {int(got[1].sum())}, "
          f"bf_rounds {int(got[2].sum())}, max_abs_err {err_b}")
    check(err_b == 0, "kernel B differs from its plain twin on the full code")
    check(int(got[2].sum()) > 0, "the DTBF tail was not engaged")

    toy = toy_code()
    tcfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, mod_type=2,
                     batch_per_device=64, fake_encode=True,
                     channel_backend="fused", stop_mode="group")
    tparams = cc.threshold_ints(tcfg, sigma_for(tcfg, 2.0)).to(dev)
    tllr, _, _ = cc.quantile_channel(tparams, seed=SEED, rnd=0, batch=64,
                                     n_var=toy.n_var, n_info=toy.n_info,
                                     mod_type=2, quant_bits=4)
    tgot = cd.stats_decode(tllr, cd.decoder_tables(toy, tcfg.decoder(), dev))
    twant = cd.stats_decode_plain(tllr, toy, tcfg.decoder())
    torch.cuda.synchronize()
    terr = max_abs_diff(zip(tgot, twant))
    print(f"kernel B vs plain, toy code batch 64: bf_rounds "
          f"{int(tgot[2].sum())}, max_abs_err {terr}")
    check(terr == 0, "kernel B differs from its plain twin on the toy code")
    err_b = max(err_b, terr)

    # ---- phase 4: the main path ---------------------------------------------
    loop = build_sim_loop(code, cfg, FER_ROUNDS, "cuda")   # as a user calls it
    cc.quantile_channel.launches = 0
    cd.stats_decode.launches = 0
    out = loop(SEED, sigma_for(cfg, 3.6), 0)
    torch.cuda.synchronize()
    launches_a = cc.quantile_channel.launches
    launches_b = cd.stats_decode.launches
    out = {k: v.tolist() for k, v in out.items()}
    print("main path, 3.6 dB:", json.dumps(out))
    check(launches_a > 0 and launches_b > 0,
          f"main path launched kernel A {launches_a}x, kernel B {launches_b}x")
    check(out["test_frames"] == FER_ROUNDS * BATCH, "wrong frame count")
    check(out["mod_error_bits"] > 0, "no channel noise reached the decoder")
    check(sum(out["mp_hist"]) == sum(out["bf_hist"]) == out["test_frames"],
          "histograms do not cover every frame")
    fer = out["error_frames"] / out["test_frames"]
    ref_fer, ref_n = reference_fer()
    n = out["test_frames"]
    pbar = (out["error_frames"] + ref_fer * ref_n) / (n + ref_n)
    z = (fer - ref_fer) / math.sqrt(pbar * (1 - pbar) * (1 / n + 1 / ref_n))
    print(f"FER {fer:.6f} over {n} frames vs reference {ref_fer} over "
          f"{ref_n}: z = {z:.3f}")
    check(abs(z) <= Z_LIMIT, f"|z| = {abs(z):.2f} > {Z_LIMIT}")

    # ---- phase 5: timings at 4.0 dB -----------------------------------------
    params40 = cc.threshold_ints(cfg, sigma_for(cfg, 4.0)).to(dev)
    ms_a = cuda_ms(lambda: cc.quantile_channel(params40, seed=SEED, rnd=9, **ch), 20)
    plain_a = cuda_ms(lambda: cc.quantile_channel_plain(params40, seed=SEED,
                                                        rnd=9, **ch), 3)
    llr40, _, _ = cc.quantile_channel(params40, seed=SEED, rnd=9, **ch)
    ms_b = cuda_ms(lambda: cd.stats_decode(llr40, tables), 10)
    plain_b = cuda_ms(lambda: cd.stats_decode_plain(llr40, code, dcfg), 2)
    e2e_rounds = 10
    e2e = build_sim_loop(code, cfg, e2e_rounds, "cuda")
    ms_e2e = cuda_ms(lambda: e2e(SEED, sigma_for(cfg, 4.0), 100), 3)
    mbit_s = e2e_rounds * BATCH * code.n_info / (ms_e2e * 1e-3) / 1e6
    print(f"timings at 4.0 dB, batch {BATCH} ({card}): kernel A {ms_a:.4f} ms "
          f"(plain {plain_a:.4f} ms), kernel B {ms_b:.4f} ms (plain "
          f"{plain_b:.4f} ms), main path {ms_e2e / e2e_rounds:.4f} ms/round = "
          f"{mbit_s:.1f} Mbit/s decoded info")

    print(json.dumps({"kernels": [
        {"name": "quantile_channel", "route": "cuda",
         "source": "faid_tpu_torch/csrc/quantile_channel.cu",
         "replaces": "faid_tpu/ops/pallas_channel.py:515",
         "launches": launches_a, "max_abs_err": err_a,
         "ms": ms_a, "plain_ms": plain_a},
        {"name": "stats_decoder", "route": "cuda",
         "source": "faid_tpu_torch/csrc/stats_decoder.cu",
         "replaces": "faid_tpu/ops/pallas_decoder.py:875",
         "launches": launches_b, "max_abs_err": err_b,
         "ms": ms_b, "plain_ms": plain_b},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
