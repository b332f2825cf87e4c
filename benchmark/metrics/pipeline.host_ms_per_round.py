"""pipeline.host_ms_per_round: the host's milliseconds inside the
runner's loop calls over the window, per round: what the host pays to
enqueue a round (``build_sharded_sim_loop``'s call returns once its
rounds are queued).  Benchmark spans only (``harness.Syncs``)."""


def read(r):
    lead = r.lead
    rounds = lead["syncs"] * lead["rounds_per_sync"]
    return sum(lead["loop_s"]) / rounds * 1e3 if rounds else None
