"""The decoder kernels against their plain twin on the full 50G-PON code,
all six decode methods, on the card (the port of
scripts/backend_parity.py).

    python -m faid_tpu_torch.scripts.backend_parity [--batch 128] [--words 2]
        [--seed 20260817] -> docs/torch_h100/backend_parity.json

The JAX script's inputs, from one numpy generator seeded with ``--seed``:
for each method, ``--words`` batches of mixed-SNR LLRs (3.3 / 3.7 / 4.1
dB in turn, rounded, clipped to +-7; NMS at 26/32).  Each batch goes
through ``build_decoder(backend="auto")`` on the card (kernel D for a
method with a BF tail, kernel E for one without) and through the plain
twin (``backend="plain"``) on the same card, and every hard bit, mp_iters
and bf_rounds is compared.  There is no kernel on the CPU: ``main``
refuses it.  Exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from . import _common

SNRS = (3.3, 3.7, 4.1)
KEYS = ("hard", "mp_iters", "bf_rounds")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faid_tpu_torch.scripts.backend_parity",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--words", type=int, default=2,
                    help="input batches per method (mixed SNRs)")
    ap.add_argument("--methods", type=str, default="0,1,2,3,4,5")
    ap.add_argument("--seed", type=int, default=20260817)
    ap.add_argument("--out", type=str, default=None,
                    help="default docs/torch_h100/backend_parity.json")
    ap.add_argument("--device", type=str, default="cuda",
                    help="a CUDA device: there is no kernel on the CPU")
    return ap


def inputs(rng: np.random.Generator, w: int, batch: int, n_var: int) -> np.ndarray:
    """Word ``w``'s [batch, n_var] int8 LLRs, drawn from ``rng`` as
    scripts/backend_parity.py draws them."""
    snr = SNRS[w % 3]
    sigma = 1.0 / np.sqrt(0.8444444 * 2 * 10 ** (snr / 10))
    y = -1.0 + sigma * rng.standard_normal((batch, n_var))
    return np.clip(np.round(y * 13.0), -7, 7).astype(np.int8)


def method_config(method: int):
    """The JAX script's DecoderConfig of ``method``: NMS at 26/32."""
    from ..config import DecodeMethod, DecoderConfig

    m = DecodeMethod(method)
    f1, f2 = (26, 32) if m == DecodeMethod.NMS else (1, 6)
    return DecoderConfig.for_method(m, max_iter=6, factor_1=f1, factor_2=f2)


def require_card(device) -> None:
    import torch

    if torch.device(device).type != "cuda":
        raise SystemExit("there is no decoder kernel on the CPU to compare with "
                         "its plain twin: pass a CUDA --device")


def run_parity(code, device, batch: int, words: int, methods, seed: int) -> dict:
    """Every method's mismatches between the kernel and the plain twin on
    the same inputs."""
    import torch

    from ..decoders.core import build_decoder

    require_card(device)
    rng = np.random.default_rng(seed)
    rows, ok_all = [], True
    for m in methods:
        dcfg = method_config(m)
        t0 = time.monotonic()
        kernel = build_decoder(code, dcfg, backend="auto")
        plain = build_decoder(code, dcfg, backend="plain")
        mism = dict.fromkeys(KEYS, 0)
        before = _common.launch_counts()
        for w in range(words):
            llr = torch.from_numpy(inputs(rng, w, batch, code.n_var)).to(device)
            a, b = kernel(llr), plain(llr)
            for k in KEYS:
                mism[k] += int((a[k] != b[k]).sum())
        row = {"method": _common.METHOD_NAMES[m], "frames": words * batch,
               "mismatches": mism, "match": not any(mism.values()),
               "launches": {k: v for k, v in _common.launches_since(before).items()
                            if v},
               "seconds": round(time.monotonic() - t0, 1)}
        ok_all &= row["match"]
        rows.append(row)
        print(f"{row['method']:10s} {'MATCH' if row['match'] else 'MISMATCH'} "
              f"({row['frames']} frames, launches {row['launches']}, "
              f"{row['seconds']}s)", flush=True)
    return {"card": _common.card_line(device), "batch": batch, "words": words,
            "seed": seed, "all_match": ok_all, "rows": rows}


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..cli import _device
    from ..code.qc_matrix import load_code

    device = _device(args.device)
    require_card(device)
    rec = run_parity(load_code("50gpon"), device, args.batch, args.words,
                     [int(x) for x in args.methods.split(",")], args.seed)
    out = _common.write_json(args.out or _common.OUT_DIR / "backend_parity.json", rec)
    print(f"wrote {out}; all_match={rec['all_match']}")
    return 0 if rec["all_match"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
