"""pipeline.launches_per_round: the device kernels of one rank a round in
the profiled syncs (CUDA-only profile; memcpy and memset are no
kernels).  A count that repeats from run to run."""

from benchmark import tracing


def read(r):
    if not r.profiled:
        return None
    ops = r.lead["profile"]["ops"]
    kernels = sum(c for name, (c, _) in ops.items() if not tracing.is_copy(name))
    return kernels / r.profile_rounds() if kernels else None
