"""runner.temp_txt_ms_per_sync: the host's milliseconds a sync of the
``Temp.txt`` rewrite (sim/runner.py ``_write_temp_txt``), over the
window's syncs.  The program's own span ``runner.temp_txt``."""

from benchmark.metrics._program_spans import span_ns, window


def read(r):
    recs = window(r)
    if not recs or not any("runner.temp_txt" in x["spans"] for x in recs):
        return None
    return sum(span_ns(x, "runner.temp_txt") for x in recs) / len(recs) / 1e6
