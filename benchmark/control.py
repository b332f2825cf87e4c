"""The control of a cell's check: the reference put in the program's
place, its channel thresholds taken from bfloat16 probabilities, the
precision next below the float32 the configurations state, and judged
as a run's counters are.  The check has to call it not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--rehearse]

For each seed it draws the checked sync as a run of ``--syncs`` syncs
would, computes every rank's frames of it twice on one device (float32
and bfloat16 thresholds) and prints the check's numbers: the control's
``counter_gap`` (its upper reading) and the gaps by counter.  A run's
own reading of the same number is 0 on every seed (the lower reading).
The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.registry import Registry  # noqa: E402

# syncs of a nominal window, to draw the checked sync from
NOMINAL_SYNCS = 400


def control_gaps(workload: str, seed: int, rehearse: bool, device=None) -> dict:
    """{"counter_gap": the control's reading, "gaps": by counter} of one
    seed: the bfloat16 reference in the program's place."""
    import torch

    reg = Registry()
    cell = reg.cell(workload)
    config = reg.config(cell["config"])
    if device is None:
        device = torch.device("cpu" if rehearse else "cuda")
    _, ref_code = harness._codes(config, rehearse)
    from benchmark.reference.round import add

    checked = harness.sample_syncs(seed, NOMINAL_SYNCS, harness.CHECK_SYNCS)
    ranks = []
    for rank in range(cell["chips"]):
        opts = harness.Options(workload, seed, 0, False, rank=rank,
                               world=cell["chips"], rehearse=rehearse)
        ranks.append({"checked_syncs": checked, "reference": [
            harness.reference_counters(ref_code, config, cell, opts, device,
                                       checked, dtype)
            for dtype in (None, torch.bfloat16)]})
    # the bfloat16 counters, summed over the ranks, stand where a run's
    # runner sums would
    program = [functools.reduce(add, (r["reference"][1][i] for r in ranks))
               for i in range(len(checked))]
    batch = (harness.REHEARSAL_BATCH if rehearse
             else config["settings"]["batch_per_device"])
    lead = {"checked_syncs": checked, "program": program, "syncs": 1,
            "rounds_per_sync": cell["rounds_per_sync"], "batch": batch,
            "window_counters": {"test_frames": program[0]["test_frames"]}}
    gap, gaps = harness.judge([{**lead, "reference": ranks[0]["reference"][0]}]
                              + [{**r, "reference": r["reference"][0]}
                                 for r in ranks[1:]])
    return {"counter_gap": gap, "gaps": {k: v for k, v in gaps.items() if v}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    for wl in args.workload:
        for seed in (int(s) for s in args.seeds.split(",")):
            res = control_gaps(wl, seed, args.rehearse)
            print(json.dumps({"workload": wl, "seed": seed, **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
