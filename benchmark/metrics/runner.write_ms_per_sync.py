"""runner.write_ms_per_sync: the host's milliseconds a sync from the
runner's progress call to its next loop call, over the window's syncs.
That is the runner's bookkeeping after it has read the counters: the
``Temp.txt`` rewrite every sync and the checkpoint every 8th.  Benchmark
spans only (``harness.Syncs``)."""

import statistics


def read(r):
    writes = r.lead["writes_s"]
    return statistics.fmean(writes) * 1e3 if writes else None
