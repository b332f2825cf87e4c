"""The benchmark of faid_tpu_torch, the PyTorch and CUDA port: one run of
one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--rehearse]

Runs the port's campaign runner (``MonteCarloRunner``) at the cell's SNR
point for a window of ``--seconds`` on as many CUDA devices as the cell
names, checks the counters of syncs drawn from the seed against the
plain reference in ``benchmark/reference/``, and prints one JSON line as
the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, last, ``checked``
(each number compared, with its limit; standard error ends with the
same).  Without the CUDA devices the cell asks for it prints no result
and exits 2.

``--rehearse`` runs the same flow on the CPU on the toy code
(faid_tpu_torch/code/toy.py) and the kernels' plain twins, at 64 frames
a round; its line carries no device metric.  See benchmark/README.md.
"""

import time

T_START = time.perf_counter()   # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, in place of this script's folder
sys.path[0] = str(ROOT)
# where torch keeps what it compiles: fixed folders inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="benchmark/run.py",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, help="the cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the CPU rehearsal on the toy code; no device metric")
    # a rank of a cell of several chips, started by rank 0
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rundir", default="", help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from benchmark import harness
    from benchmark.registry import Registry

    cell = Registry().cell(args.workload)
    chips = cell["chips"]
    opts = harness.Options(
        workload=args.workload, seed=args.seed % 2**64, seconds=args.seconds,
        trace=bool(args.trace), rank=args.rank, world=args.world or chips,
        port=args.port, rundir=args.rundir, rehearse=args.rehearse)
    if args.rank:
        return harness.child_main(opts, T_START)
    if not args.rehearse:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); this machine "
                  f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    rc, line, gaps = harness.lead_main(opts, T_START)
    if line is None:
        return rc or 1
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: nothing it runs may import "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    for name, gap in gaps.items():
        if gap:
            print(f"gap {name} {gap}", file=sys.stderr)
    print(f"syncs {line['syncs']}, checked syncs "
          f"{harness.sample_syncs(opts.seed, line['syncs'], harness.CHECK_SYNCS)}, "
          f"the reference's seconds {line.pop('reference_s')}", file=sys.stderr)
    window_ms = line.pop("window_sync_ms")
    if "profile_sync_ms" in line:
        print(f"a profiled sync took {line.pop('profile_sync_ms')} ms, a sync of "
              f"the window {window_ms} ms", file=sys.stderr)
    for name, c in line["checked"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
