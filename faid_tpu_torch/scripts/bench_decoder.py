"""The decoder kernel against its plain twin on the card, timed in turns
(the port of scripts/bench_decoder.py).

    python -m faid_tpu_torch.scripts.bench_decoder [--batch 512] [--method 2]
        [--iters 6] [--snr 4.0] [--reps 10] [--stop-mode frame] [--check]

The JAX script's inputs: ``--reps`` distinct [batch, n_var] LLR batches
of the all-zero word at ``--snr`` (or ``--sigma``), truncated and clipped
to +-7, from numpy seeded 0.  ``build_decoder(backend="auto")`` (kernel D
for a method with a BF tail, kernel E for one without) and the plain twin
(``backend="plain"``, the JAX script's xla backend) decode them on the
card, timed with CUDA events in the order plain, kernel, kernel, plain;
``--check`` compares their hard bits, mp_iters and bf_rounds on the first
batch and exits 1 on a mismatch.  There is no kernel on the CPU: ``main``
refuses it.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np

from . import _common
from .backend_parity import KEYS, require_card


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faid_tpu_torch.scripts.bench_decoder",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--method", type=int, default=2)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--snr", type=float, default=4.0)
    ap.add_argument("--sigma", type=float, default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--stop-mode", default="frame", choices=["frame", "group"])
    ap.add_argument("--check", action="store_true",
                    help="compare the kernel's outputs with the plain twin's")
    ap.add_argument("--device", type=str, default="cuda",
                    help="a CUDA device: there is no kernel on the CPU")
    return ap


def bench_inputs(batch: int, n_var: int, sigma: float, reps: int) -> list[np.ndarray]:
    """``reps`` [batch, n_var] int8 LLR batches, drawn as
    scripts/bench_decoder.py draws them (numpy seeded 0, truncated)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(reps):
        y = -1.0 + sigma * rng.standard_normal((batch, n_var))
        out.append(np.clip(np.trunc(y * 13.0), -7, 7).astype(np.int8))
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import torch

    from ..cli import _device
    from ..code.qc_matrix import load_code
    from ..config import DecodeMethod, DecoderConfig, SimConfig
    from ..decoders.core import build_decoder
    from .roofline import in_turns

    device = _device(args.device)
    require_card(device)
    code = load_code("50gpon")
    dcfg = DecoderConfig.for_method(DecodeMethod(args.method), max_iter=args.iters,
                                    stop_mode=args.stop_mode)
    sigma = args.sigma if args.sigma is not None else SimConfig().sigma_at(args.snr)
    llrs = [torch.from_numpy(x).to(device)
            for x in bench_inputs(args.batch, code.n_var, sigma, args.reps)]
    decoders = {"plain": build_decoder(code, dcfg, backend="plain"),
                "auto": build_decoder(code, dcfg, backend="auto")}
    cycles = {k: itertools.cycle(llrs) for k in decoders}
    ms = dict(zip(("auto", "plain"), in_turns(
        lambda: decoders["auto"](next(cycles["auto"])),
        lambda: decoders["plain"](next(cycles["plain"])), args.reps, args.reps)))
    card = _common.card_line(device)
    outs = {k: dec(llrs[0]) for k, dec in decoders.items()}
    for k in ("plain", "auto"):
        out = outs[k]
        mbps = args.batch * code.n_info / (ms[k] * 1e-3) / 1e6
        print(f"{k:6s} step {ms[k]:9.4f} ms  {mbps:9.1f} Mbit/s  "
              f"FER~{float(out['hard'].any(dim=1).float().mean()):.3f}  "
              f"avg_it {float(out['mp_iters'].float().mean()):.2f}  ({card})")
    ok = True
    if args.check:
        for k in KEYS:
            same = torch.equal(outs["plain"][k], outs["auto"][k])
            ok &= same
            print(f"  {k}: {'MATCH' if same else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
