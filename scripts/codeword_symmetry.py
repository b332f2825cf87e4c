#!/usr/bin/env python3
"""Does a decoder treat a real codeword as it treats the all-zero word?

    python3 scripts/codeword_symmetry.py [--device cuda] [--method 2]
        [--stop-mode group] [--snr 3.6] [--batch 2048] [--rounds 8]

Each round draws real codewords (the message stream through the
encoder) and their channel LLRs, and builds the all-zero word's LLRs
under the same noise: with a symmetric quantizer (4 or 6 bits) the
channel's mirror of a 1-bit is an exact negation, so llr * (1 - 2 cw) is
what the all-zero word receives when each 1-bit's stream word is
complemented.  A decoder that commutes with that sign flip makes the
same errors on both; one whose ties (an LLR or a contribution of 0)
lean to one bit does not.  The script counts each side's frame and bit
errors and the frames where the two differ, and prints one JSON line.
``--no-puncture`` decodes the code's punctured tail (the last 384 bits
of 50G-PON) from its channel LLRs instead of from LLR 0, which takes
that tie out.
On a CUDA device the decoder is kernel B, on the CPU its plain twin;
the counts are the same on both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from faid_tpu_torch import load_code, sigma_for  # noqa: E402
from faid_tpu_torch.code.encoder import make_encode_fn  # noqa: E402
from faid_tpu_torch.config import DecodeMethod, SimConfig  # noqa: E402
from faid_tpu_torch.ops import cuda_channel as cc  # noqa: E402
from faid_tpu_torch.ops import cuda_decoder as cd  # noqa: E402
from faid_tpu_torch.ops import philox  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--method", type=int, default=2, choices=range(6))
    ap.add_argument("--stop-mode", default="group", choices=["group", "frame"])
    ap.add_argument("--snr", type=float, default=3.6)
    ap.add_argument("--quant-bits", type=int, default=4, choices=[4, 6])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-puncture", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    card = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("--device cuda asks for a GPU and none is available")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True).stdout.strip()
    code = load_code("50gpon")
    if args.no_puncture:
        code = dataclasses.replace(code, puncture_tail=0)
    f1, f2 = (26, 32) if args.method == 0 else (1, 6)
    cfg = SimConfig(decode_method=DecodeMethod(args.method), mod_type=2,
                    quant_bits=args.quant_bits, batch_per_device=args.batch,
                    channel_backend="fused", stop_mode=args.stop_mode,
                    factor_1=f1, factor_2=f2)
    tables = cd.decoder_tables(code, cfg.decoder(), dev)
    params = cc.threshold_ints(cfg, sigma_for(cfg, args.snr)).to(dev)
    encode = make_encode_fn(code, dev)
    out = dict(method=DecodeMethod(args.method).name, stop_mode=args.stop_mode,
               snr_db=args.snr, quant_bits=args.quant_bits,
               punctured=code.puncture_tail, frames=0,
               codeword_error_frames=0, zero_word_error_frames=0,
               codeword_error_bits=0, zero_word_error_bits=0, frames_differ=0)
    for rnd in range(args.rounds):
        cw = encode(philox.message_bits(args.seed, rnd, 0, args.batch, code.n_info, dev))
        llr, _, _ = cc.quantile_channel(
            params, seed=args.seed, rnd=rnd, batch=args.batch, n_var=code.n_var,
            n_info=code.n_info, mod_type=2, quant_bits=args.quant_bits, cw=cw)
        flip = 1 - 2 * cw.to(torch.int16)
        llr_zero = (llr.to(torch.int16) * flip).to(torch.int8)
        err_cw = cd.stats_decode(llr, tables, cw)[0]
        err_zero = cd.stats_decode(llr_zero, tables)[0]
        out["frames"] += args.batch
        out["codeword_error_frames"] += int((err_cw > 0).sum())
        out["zero_word_error_frames"] += int((err_zero > 0).sum())
        out["codeword_error_bits"] += int(err_cw.sum())
        out["zero_word_error_bits"] += int(err_zero.sum())
        out["frames_differ"] += int(((err_cw > 0) != (err_zero > 0)).sum())
    out["device"] = card or "cpu"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
