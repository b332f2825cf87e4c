"""Runs cells of the benchmark several times, one process a run as the
check runs them, and reports each metric's spread: the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``) as
a share of the median, for each set of runs and each metric.

    python3 benchmark/spread.py --workload <cell> [--workload ...] \\
        --seeds 11,12,13 [--sets 2] [--seconds 20] [--trace 0] \\
        [--out chiprun_out/spread.jsonl]

Each set runs the same seeds in order.  Every result line is appended to
``--out`` with its cell, seed, set and exit code; standard error keeps the
end of each run's standard error.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float | None:
    """(Q3 - Q1) / median, or None for fewer than two values."""
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def run_once(workload: str, seed: int, seconds: float, trace: int) -> tuple[int, dict | None, str, float]:
    t = time.perf_counter()
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       capture_output=True, text=True, cwd=ROOT, check=False)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    line = None
    if p.returncode == 0 and lines:
        line = json.loads(lines[-1])
    return p.returncode, line, p.stderr, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "spread.jsonl"))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    failed = 0
    for wl in args.workload:
        values: dict[str, list[list[float]]] = {}
        for k in range(args.sets):
            for seed in seeds:
                rc, line, err, wall = run_once(wl, seed, args.seconds, args.trace)
                rec = {"workload": wl, "seed": seed, "set": k, "rc": rc,
                       "wall_s": wall, "line": line}
                with out.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
                ok = line is not None and line["correct"]
                failed += not ok
                summary = ({m: v["value"] for m, v in line["metrics"].items()}
                           if line else None)
                print(f"{wl} set {k} seed {seed}: rc {rc} correct "
                      f"{line and line['correct']} wall {wall:.1f} s {summary}",
                      flush=True)
                if not ok:
                    print(err[-3000:], file=sys.stderr, flush=True)
                if line:
                    for m, v in line["metrics"].items():
                        values.setdefault(m, [[] for _ in range(args.sets)])[k].append(
                            v["value"])
        for m, sets in values.items():
            spreads = [spread(s) for s in sets]
            medians = [statistics.median(s) for s in sets if s]
            print(f"{wl} {m}: medians {medians} spreads {spreads}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
