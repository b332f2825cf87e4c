"""runner.checkpoint_ms: the host's milliseconds of one checkpoint write
inside a sync (sim/runner.py ``_save_checkpoint``, every 8th sync: the
state's JSON and its atomic rename), the mean over the window's syncs
that wrote one.  The program's own span ``runner.checkpoint``."""

from benchmark.metrics._program_spans import window


def read(r):
    recs = window(r)
    spans = [x["spans"]["runner.checkpoint"] for x in recs or ()
             if "runner.checkpoint" in x["spans"]]
    if not spans:
        return None
    return sum(ns for _, ns in spans) / sum(n for n, _ in spans) / 1e6
