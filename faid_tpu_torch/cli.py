"""Command-line entry point: the reference's ``main()`` (reference
main.cpp:17-231), ``faid_tpu.cli`` for the PyTorch port.

    python -m faid_tpu_torch.cli --method 2 \\
        --channel-backend fused --stop-mode group --batch 2048 \\
        --snr-start 3.6 --snr-pass 0.1 --snr-end 3.8 --min-frames 16384 \\
        --collect-errors --out OUT

On N GPUs of one host, one process a GPU, each drawing ``--batch``
frames a round (parallel/mesh.py):

    torchrun --nproc-per-node N -m faid_tpu_torch.cli --multihost ...

Reads a Profile.txt (or flag overrides), sweeps SNR with the reference's
stopping rule, prints a live progress row per step (main.cpp:212-213),
and writes Result.txt / demod.txt / iterCount.txt / Temp.txt /
checkpoint.json into --out; a rerun resumes from the checkpoint.  It
runs on ``cuda`` unless ``--device cpu`` is given, and fails when the
device asked for is not there.  The flags are the JAX CLI's, with
``--device`` in place of ``--platform``, and the same defaults: the
float channel chain (``--channel-backend xla``), QPSK, real codewords.
``--multihost`` joins the ``torch.distributed`` world that ``torchrun``
describes in its environment (nccl on ``cuda``, each rank on
``cuda:LOCAL_RANK``; gloo on ``--device cpu``), or exits within
``--dist-timeout`` seconds when it cannot; rank 0 alone writes the files
and prints.  A value outside the JAX package's configurations raises
ValueError naming the flag to change.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faid_tpu_torch",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=str, default=None,
                    help="reference-format Profile.txt to load")
    ap.add_argument("--out", type=str, default="results")
    ap.add_argument("--snr-start", type=float)
    ap.add_argument("--snr-pass", type=float)
    ap.add_argument("--snr-end", type=float)
    ap.add_argument("--method", type=int, choices=range(6))
    ap.add_argument("--max-iter", type=int)
    ap.add_argument("--mod-type", type=int, choices=[1, 2, 4, 6, 8])
    ap.add_argument("--interleave", type=int)
    ap.add_argument("--factor1", type=int)
    ap.add_argument("--factor2", type=int)
    ap.add_argument("--scale", type=float)
    ap.add_argument("--quant-bits", type=int, choices=[1, 2, 3, 4, 5, 6],
                    help="channel LLR quantizer width (reference "
                         "float2LimitChar_{n}bit; default 4 = the reference "
                         "run path)")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--batch", type=int, help="frames per device per step")
    ap.add_argument("--min-frames", type=int)
    ap.add_argument("--min-frame-errors", type=int)
    ap.add_argument("--fake-encode", action="store_true",
                    help="all-zero codeword path (reference FAKE_ENCODE); "
                         "without it each round encodes random messages")
    ap.add_argument("--lut-family", type=str, default=None,
                    choices=["faid3", "faid32", "faid2"],
                    help="FAID V2C LUT family for method 2 "
                         "(reference #define FAID3/FAID32/FAID2)")
    ap.add_argument("--max-rounds", type=int, default=100000,
                    help="safety cap on MC rounds per SNR point")
    ap.add_argument("--max-frames-per-snr", type=int, default=None,
                    help="hard per-SNR-point frame budget (sweep economics)")
    ap.add_argument("--giveup-zero-error-frames", type=int, default=None,
                    help="abandon an SNR point still at zero errors after "
                         "this many frames (records an FER upper bound)")
    ap.add_argument("--stop-mode", type=str, default="group",
                    choices=["frame", "group"],
                    help="early-stop granularity. Default 'group' = the "
                         "reference's 32-frame-SIMD-word semantics; "
                         "'frame' freezes each frame individually")
    ap.add_argument("--itercount-ref-format", action="store_true",
                    help="write iterCount.txt as the reference's "
                         "'rounds: count' lines (CSimulate.cpp:171-179) "
                         "for byte-compatible tooling")
    ap.add_argument("--collect-errors", action="store_true",
                    help="always dump failing-frame forensics (otherwise "
                         "auto when FER < 1e-5, the reference collectflag)")
    ap.add_argument("--trace-dir", type=str, default=None,
                    help="write a torch.profiler chrome trace of the first "
                         "SNR point run to DIR/trace.json (its faid.* ranges "
                         "are the campaign's spans, tagged with their sync), "
                         "and each sync's span and counter totals to "
                         "DIR/syncs.json at the end of the run")
    ap.add_argument("--backend", type=str, default=None,
                    choices=["auto", "plain"],
                    help="decoder backend: auto (the CUDA kernels on a GPU, "
                         "the plain PyTorch path on the CPU) or plain "
                         "(--device cpu only)")
    ap.add_argument("--channel-backend", type=str, default=None,
                    choices=["xla", "fused"],
                    help="channel backend: xla, the float chain "
                         "(modulate, AWGN, demap, quantize; the default) or "
                         "fused, the quantile channel (kernel F for "
                         "BPSK/QPSK, kernel G for 16/64/256-QAM on a GPU; "
                         "a 1-bit quantizer falls back to the float chain)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the plain PyTorch twins of the kernels)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the torch.distributed world of torchrun's "
                         "environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                         "MASTER_ADDR, MASTER_PORT): nccl on cuda, one GPU "
                         "a rank (cuda:LOCAL_RANK), gloo on --device cpu; "
                         "--batch frames a round on each rank, rank 0 "
                         "writes the files")
    ap.add_argument("--dist-timeout", type=float, default=300.0,
                    help="seconds --multihost waits for the world to form, "
                         "and for a collective, before it fails")
    ap.add_argument("--quiet", action="store_true")
    return ap


def config_from_args(args):
    from .config import DecodeMethod, SimConfig
    from .utils.profile import parse_profile

    if args.profile:
        try:
            cfg = parse_profile(args.profile)
        except FileNotFoundError:
            # Reference prints "Cannot open Profile" (CTool.cpp:591).
            raise SystemExit(
                f"faid_tpu_torch: cannot open profile: {args.profile}")
        except (StopIteration, ValueError) as e:
            raise SystemExit(
                f"faid_tpu_torch: malformed profile {args.profile}: {e!r}")
    else:
        cfg = SimConfig()
    over = {}
    amap = {
        "snr_start": args.snr_start, "snr_pass": args.snr_pass,
        "snr_end": args.snr_end, "max_iteration": args.max_iter,
        "mod_type": args.mod_type, "interleave_depth": args.interleave,
        "factor_1": args.factor1, "factor_2": args.factor2,
        "scale": args.scale, "quant_bits": args.quant_bits,
        "seed": args.seed,
        "batch_per_device": args.batch, "min_frames": args.min_frames,
        "min_frame_errors": args.min_frame_errors,
        "max_frames_per_snr": args.max_frames_per_snr,
        "giveup_zero_error_frames": args.giveup_zero_error_frames,
        "stop_mode": args.stop_mode,
    }
    for k, v in amap.items():
        if v is not None:
            over[k] = v
    if args.method is not None:
        over["decode_method"] = DecodeMethod(args.method)
    if args.fake_encode:
        over["fake_encode"] = True
    if args.backend is not None:
        over["backend"] = args.backend
    if args.channel_backend is not None:
        over["channel_backend"] = args.channel_backend
    if args.lut_family is not None:
        over["faid_lut"] = args.lut_family
    return dataclasses.replace(cfg, **over)


def _device(name: str):
    """The torch device asked for; exits when it is a GPU that is not
    there (the run never falls back to the CPU)."""
    import torch

    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise SystemExit(f"faid_tpu_torch: bad --device {name!r}: {e}")
    if dev.type == "cuda" and (not torch.cuda.is_available() or (
            dev.index is not None and dev.index >= torch.cuda.device_count())):
        raise SystemExit(
            f"faid_tpu_torch: --device {name} asks for a CUDA device and "
            "none is available here; pass --device cpu to run the plain "
            "PyTorch path on the CPU")
    return dev


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def _join_world(device, timeout_s: float):
    """Initializes the default process group from torchrun's environment:
    nccl on ``cuda`` (this rank on ``cuda:LOCAL_RANK``), gloo on the CPU.
    Returns the rank's device.  Exits when the environment is missing or
    the world does not form within ``timeout_s`` seconds."""
    import datetime

    import torch
    import torch.distributed as dist

    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise SystemExit(
            f"faid_tpu_torch: --multihost reads torchrun's environment and "
            f"{', '.join(missing)} is not set: start the ranks with "
            "torchrun --nproc-per-node N -m faid_tpu_torch.cli --multihost")
    backend = "gloo"
    if device.type == "cuda":
        device = _device(f"cuda:{os.environ['LOCAL_RANK']}")
        torch.cuda.set_device(device)
        backend = "nccl"
    try:
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:       # torch's DistError family
        raise SystemExit(
            f"faid_tpu_torch: --multihost: rank {os.environ['RANK']} of "
            f"{os.environ['WORLD_SIZE']} could not join the {backend} world "
            f"at {os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']} "
            f"within {timeout_s:g} s: {e}")
    if backend == "nccl" and dist.get_world_size() > 1:
        # one build of the kernels a host, not one a rank
        from .utils import kernels

        if os.environ["LOCAL_RANK"] == "0":
            kernels.library()
        dist.barrier()
    return device


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    device = _device(args.device)

    from .parallel.mesh import Mesh, make_mesh

    if not args.multihost:
        return _run(args, cfg, Mesh(0, 1, device))
    device = _join_world(device, args.dist_timeout)
    import torch.distributed as dist

    try:
        return _run(args, cfg, make_mesh(device))
    finally:
        dist.destroy_process_group()


def _run(args, cfg, mesh) -> int:
    import torch

    from .sim.runner import MonteCarloRunner
    from .utils import trace

    device = mesh.device
    lead = mesh.rank == 0
    out = Path(args.out)
    if lead:
        out.mkdir(parents=True, exist_ok=True)
    runner = MonteCarloRunner(cfg, mesh=mesh,
                              checkpoint_path=out / "checkpoint.json",
                              max_rounds_per_snr=args.max_rounds,
                              temp_txt_path=out / "Temp.txt")

    def progress(snr_db, c):
        if args.quiet or not lead:
            return
        tf = max(c["test_frames"], 1)
        sys.stdout.write(
            f"\rSNR {snr_db:5.2f}  frames {c['test_frames']:>9}  "
            f"errFrames {c['error_frames']:>6}  errBits {c['error_bits']:>9}  "
            f"FER {c['error_frames'] / tf:.3e}")
        sys.stdout.flush()

    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # shapes recorded: the ranges' sync tags reach the trace with them
        with profile(activities=acts, record_shapes=True) as prof:
            runner.run_point(progress=progress)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if lead:
            trace_dir = Path(args.trace_dir)
            trace_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace_dir / "trace.json"))
    runner.run(progress=progress)
    if not lead:
        return 0
    if args.trace_dir:
        (Path(args.trace_dir) / "syncs.json").write_text(
            json.dumps(trace.recent()))
    if not args.quiet:
        sys.stdout.write("\n")

    runner.write_result_txt(out / "Result.txt")
    runner.write_demod_txt(out / "demod.txt")
    runner.write_itercount_txt(out / "iterCount.txt",
                               ref_format=args.itercount_ref_format)
    rows = runner.report_rows()
    collect = args.collect_errors or any(
        r["fer"] < 1e-5 for r in rows)  # reference collectflag main.cpp:190
    if collect:
        n = runner.collect_error_frames(out)
        if not args.quiet and n:
            print(f"dumped {n} failing frames to {out}/errorindex.txt")
    for row in rows:
        print(f"SNR {row['snr_db']:.2f}  FER {row['fer']:.4e}  "
              f"BER {row['ber']:.4e}  frames {row['test_frames']}  "
              f"time {row['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
