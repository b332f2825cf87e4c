"""runner.device_gap_ms_per_sync: the device's idle milliseconds at a sync
boundary, from the end of a sync's work to the first launch of the next,
on the CUDA events the runner records around its loop call
(sim/runner.py ``run_snr``, the record's ``device_gap_ns``).  The mean
over the window's syncs after its first, which has no sync before it in
its run; None on the CPU, where the runner records no events."""

from benchmark.metrics._program_spans import window


def read(r):
    recs = window(r)
    gaps = [x["device_gap_ns"] for x in (recs or ())[1:]]
    if not gaps or None in gaps:
        return None
    return sum(gaps) / len(gaps) / 1e6
