"""The window's records of the program's own spans, for the readers of
the ``program_span`` metrics.

The program keeps one record a sync of its campaign runner
(faid_tpu_torch/utils/trace.py ``recent``): the sync's SNR point, first
round and rounds, each span's ``[count, ns]`` and the device's idle gap
before the sync.  The readers run in rank 0's process after the run and
read rank 0's records.

The window runs rounds 0 .. syncs x rounds_per_sync - 1 of point 0, and
the profiled stretches go on past them, so the window's records are
picked by the rounds they carry, never by their place: the newest run
starts at the last record of point 0's round 0.  None where the program
keeps no records (it has no such module), or where the records of the
window are not one a sync."""


def window(r) -> list | None:
    try:
        from faid_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.recent()
    starts = [i for i, x in enumerate(recs) if x["snr_idx"] == 0 and x["round0"] == 0]
    if not starts:
        return None
    end = r.lead["syncs"] * r.lead["rounds_per_sync"]
    got = [x for x in recs[starts[-1]:] if x["snr_idx"] == 0 and x["round0"] < end]
    return got if len(got) == r.lead["syncs"] else None


def span_ns(rec: dict, name: str) -> int:
    """The nanoseconds of span ``name`` in a record, 0 where it did not
    open."""
    return rec["spans"].get(name, (0, 0))[1]
