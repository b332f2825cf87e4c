"""FER validation sweep on the GPU: every decode method at a few SNR
points, each row z-tested against the JAX package's row on the TPU, in a
JSON file and a markdown table (the port of scripts/fer_validation.py).

    python -m faid_tpu_torch.scripts.fer_validation [--stop-mode group]
        [--snrs 3.6,3.8,4.0] [--methods 0,1,2,3,4,5] [--min-errors 30]
        -> docs/torch_h100/validation_{frame,group}.json and
           VALIDATION_{frame,group}.md

The JAX script's flags, defaults and stop rule: per (method, SNR) point,
calls of ``build_sim_loop`` (4 rounds of ``--batch`` frames, QPSK, the
all-zero codeword, 6 MP iterations) until ``--min-frames`` and
``--min-errors`` hold or ``--max-rounds`` rounds ran.  The round draws
the quantile channel, so on the card kernel F runs it whole.  The JAX
rows were drawn by the float chain (its default channel); the two
channels draw one law (``channel_parity``), so a row is held to its JAX
row by the two-proportion z, |z| <= 4 (a row of FER 1.0, or two without
an error, by equality).  A point's rounds are stream rounds
``stream_round(point, r)`` with point = 1000 m + s (method m, SNR index
s), so no two points share a stream; one warm call per point, on a
stream no point draws, counts nothing.  Exits 1 when a row is
inconsistent with its JAX row.
"""

from __future__ import annotations

import argparse
import time

from . import _common

ROUNDS = 4                      # rounds a build_sim_loop call
WARM_POINT = 2**32 - 1          # the warm call's stream: no point's
COUNTERS = ("test_frames", "error_frames", "error_bits", "lt3_frames",
            "mp_iters", "bf_rounds")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faid_tpu_torch.scripts.fer_validation",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, default=None,
                    help="markdown table (default docs/torch_h100/"
                         "VALIDATION_<stop mode>.md)")
    ap.add_argument("--json-out", type=str, default=None,
                    help="rows (default docs/torch_h100/validation_<stop mode>.json)")
    ap.add_argument("--snrs", type=str, default="3.6,3.8,4.0")
    ap.add_argument("--methods", type=str, default="0,1,2,3,4,5")
    ap.add_argument("--min-errors", type=int, default=30)
    ap.add_argument("--min-frames", type=int, default=2048)
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--stop-mode", choices=["frame", "group"], default="frame",
                    help="early-stop granularity; 'group' = reference "
                         "32-frame-word emulation")
    ap.add_argument("--backend", default="auto", choices=["auto", "plain"],
                    help="decoder backend (plain: --device cpu only)")
    ap.add_argument("--factors", type=str, default="1,6",
                    help="Factor_1,Factor_2 (reference Profile defaults)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    return ap


def validation_config(method: int, batch: int, stop_mode: str, factors=(1, 6),
                      seed: int = 0, backend: str = "auto"):
    """The JAX script's SimConfig of ``method``, on the quantile channel."""
    from ..config import DecodeMethod, SimConfig

    return SimConfig(decode_method=DecodeMethod(method), max_iteration=6,
                     mod_type=2, batch_per_device=batch, seed=seed,
                     factor_1=factors[0], factor_2=factors[1],
                     stop_mode=stop_mode, backend=backend,
                     channel_backend="fused", fake_encode=True)


def point_of(method: int, snr_idx: int) -> int:
    """The stream point of (method, SNR index): its rounds are
    ``philox.stream_round(point, r)``."""
    return method * 1000 + snr_idx


def run_point(loop, cfg, sigma: float, point: int, min_frames: int,
              min_errors: int, max_rounds: int, device) -> dict:
    """The stop rule on one point: calls of ``loop`` (``ROUNDS`` rounds
    each) until >= min_frames and >= min_errors, or max_rounds rounds.
    Returns the counters (Python ints), the rounds run, the wall seconds
    of the counted calls and the kernels they launched."""
    import torch

    from ..ops import philox

    loop(cfg.seed, sigma, philox.stream_round(WARM_POINT, 0))     # warm
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    c = dict.fromkeys(COUNTERS, 0)
    before = _common.launch_counts()
    t0 = time.perf_counter()
    rnd = 0
    while ((c["test_frames"] < min_frames or c["error_frames"] < min_errors)
           and rnd < max_rounds):
        out = loop(cfg.seed, sigma, philox.stream_round(point, rnd))
        for k in c:
            c[k] += int(out[k])
        rnd += ROUNDS
    return {"counters": c, "rounds": rnd, "seconds": time.perf_counter() - t0,
            "launches": _common.launches_since(before)}


def make_row(method_name: str, snr: float, point: int, res: dict, n_info: int,
             card: str) -> dict:
    """The JAX script's row of one point, with its stream point, launches
    and card."""
    c, dt = res["counters"], res["seconds"]
    tf = max(c["test_frames"], 1)
    return {"method": method_name, "snr_db": snr, "frames": c["test_frames"],
            "error_frames": c["error_frames"], "fer": c["error_frames"] / tf,
            "ber": c["error_bits"] / (tf * n_info),
            "avg_mp_iters": c["mp_iters"] / tf,
            "avg_bf_rounds": c["bf_rounds"] / tf,
            "mbit_s": tf * n_info / dt / 1e6, "seconds": dt, "card": card,
            "stream_point": point, "rounds": res["rounds"],
            "launches": res["launches"]}


def run_validation(code, device, snrs, methods, batch: int, stop_mode: str,
                   min_frames: int, min_errors: int, max_rounds: int,
                   factors=(1, 6), seed: int = 0,
                   backend: str = "auto") -> list[dict]:
    """Every (method, SNR) point's row, in the JAX script's order."""
    from ..sim.pipeline import build_sim_loop

    card = _common.card_line(device)
    rows = []
    for m in methods:
        cfg = validation_config(m, batch, stop_mode, factors, seed, backend)
        loop = build_sim_loop(code, cfg, ROUNDS, device)
        for si, snr in enumerate(snrs):
            point = point_of(m, si)
            res = run_point(loop, cfg, cfg.sigma_at(snr), point, min_frames,
                            min_errors, max_rounds, device)
            row = make_row(_common.METHOD_NAMES[m], snr, point, res, code.n_info,
                           card)
            rows.append(row)
            print(f"{row['method']:10s} {snr:4.1f} dB  FER {row['fer']:.3e}  "
                  f"BER {row['ber']:.3e}  frames {row['frames']}  "
                  f"{row['mbit_s']:.0f} Mbit/s ({card})  {row['seconds']:.1f}s  "
                  f"launches {row['launches']}", flush=True)
    return rows


def hold_to(rows: list[dict], ref: dict) -> bool:
    """Adds each row's ``z`` and ``consistent`` against ``ref``'s row of its
    (method, snr_db) (``_common.validation_rows``); True where all hold.  A
    point the JAX package did not run keeps ``consistent`` None."""
    ok = True
    for r in rows:
        j = ref.get((r["method"], r["snr_db"]))
        if j is None:
            r["z"] = r["consistent"] = r["jax_row"] = None
            continue
        z, r["consistent"] = _common.consistent(
            r["error_frames"], r["frames"], j["error_frames"], j["frames"])
        r["z"] = None if z is None else round(z, 3)
        r["jax_row"] = {"frames": j["frames"], "error_frames": j["error_frames"]}
        ok &= r["consistent"]
    return ok


def markdown(rows: list[dict], card: str, stop_mode: str) -> str:
    lines = [
        f"# FER validation ({card}, QPSK, 6 MP iterations, all-zero codeword, "
        f"scale 13, 4-bit channel LLRs, {stop_mode} stop mode)\n\n",
        "Generated by `python -m faid_tpu_torch.scripts.fer_validation "
        f"--stop-mode {stop_mode}` (the quantile channel). Each row is "
        "held to the JAX package's row of the same method, SNR and stop mode "
        "(docs/validation.json frame, docs/validation_group.json group) by the "
        "two-proportion z, |z| <= 4; a row of FER 1.0, or two rows without an "
        "error, by equality (z -).\n\n",
        "| method | SNR(dB) | frames | errFrames | FER | BER | avg MP it | "
        "avg BF rounds | Mbit/s | JAX frames | JAX errFrames | z | consistent |\n",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|\n",
    ]
    for r in rows:
        j = r.get("jax_row") or {}
        z = "-" if r.get("z") is None else f"{r['z']:.2f}"
        lines.append(
            f"| {r['method']} | {r['snr_db']:.1f} | {r['frames']} | "
            f"{r['error_frames']} | {r['fer']:.3e} | {r['ber']:.3e} | "
            f"{r['avg_mp_iters']:.2f} | {r['avg_bf_rounds']:.2f} | "
            f"{r['mbit_s']:.0f} | {j.get('frames', '-')} | "
            f"{j.get('error_frames', '-')} | {z} | {r.get('consistent', '-')} |\n")
    return "".join(lines)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..cli import _device
    from ..code.qc_matrix import load_code

    device = _device(args.device)
    snrs = [float(s) for s in args.snrs.split(",")]
    methods = [int(m) for m in args.methods.split(",")]
    factors = tuple(int(x) for x in args.factors.split(","))
    rows = run_validation(load_code("50gpon"), device, snrs, methods, args.batch,
                          args.stop_mode, args.min_frames, args.min_errors,
                          args.max_rounds, factors, args.seed, args.backend)
    ok = hold_to(rows, _common.validation_rows(args.stop_mode))
    for r in rows:
        if r["consistent"] is False:
            print(f"INCONSISTENT: {r['method']} {r['snr_db']} dB: "
                  f"{r['error_frames']}/{r['frames']} against the JAX row's "
                  f"{r['jax_row']['error_frames']}/{r['jax_row']['frames']}, "
                  f"z {r['z']}")
    md = _common.write_artifact(
        args.out or _common.OUT_DIR / f"VALIDATION_{args.stop_mode}.md",
        markdown(rows, _common.card_line(device), args.stop_mode))
    js = _common.write_json(
        args.json_out or _common.OUT_DIR / f"validation_{args.stop_mode}.json", rows)
    print(f"wrote {md} and {js}; all rows consistent: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
