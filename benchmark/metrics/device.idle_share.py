"""device.idle_share: the share of a sync of the window in which no
operation ran on the device, 100 (1 - busy / sync), averaged over the
ranks.  ``busy`` is a profiled sync's device busy time (CUDA-only
profile); ``sync`` is a sync of the window itself, its seconds over its
syncs.  The profiler slows a host-paced round, so the profiled syncs'
own wall time would read the profiler's overhead as idle time; the
device's busy time a sync it does not stretch."""

import statistics


def read(r):
    if not r.profiled:
        return None
    shares = []
    for x in r.ranks:
        p = x["profile"]
        if p["busy_s"] <= 0 or not x["syncs"]:
            return None
        busy = p["busy_s"] / (p["stop"] - p["first"])
        shares.append(1 - busy / (x["window_s"] / x["syncs"]))
    return 100 * statistics.fmean(shares)
