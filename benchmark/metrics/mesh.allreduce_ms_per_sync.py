"""mesh.allreduce_ms_per_sync: the counters' all-reduce of a sync
(parallel/mesh.py ``all_reduce_counters``): the host's milliseconds in
the call (its pack, launch and unpack) over the window's syncs, plus the
device time of its nccl kernels a sync in the profiled syncs, each
averaged over the ranks.  Only a world of several ranks has one."""

import statistics

from benchmark import tracing


def read(r):
    if not r.profiled or len(r.ranks) < 2:
        return None
    host = [statistics.fmean(x["allreduce_host_s"]) for x in r.ranks
            if x["allreduce_host_s"]]
    n, seconds = r.ops(lambda name: tracing.kernel_class(name) == "nccl")
    if len(host) != len(r.ranks) or not n:
        return None
    p = r.lead["profile"]
    device = seconds / len(r.ranks) / (p["stop"] - p["first"])
    return (statistics.fmean(host) + device) * 1e3
