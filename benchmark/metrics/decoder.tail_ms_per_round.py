"""decoder.tail_ms_per_round: the BF tail's device milliseconds in one
round of the decoder kernel.  Kernel F's profiled device time a round
(kernel B's, where B ran the round), found as ``decoder_roofline`` finds
them, times the tail's share of the three counted phases' SM cycles over
the same profiled syncs.

The cycles are the program's own counters (faid_tpu_torch/csrc/
decoder.cuh's phase clocks): thread 0 of each block reads its SM's clock
at the start, after the prologue (the channel, or the LLR ingest), after
MP and after the tail, and the runner adds a sync's block cycles of the
three phases to its record (``decoder.prologue_cycles``,
``decoder.mp_cycles``, ``decoder.tail_cycles``).  A block's cycles do not
depend on the clock rate, and in group mode the blocks of a word run the
same iterations and rounds.  The kernel's last step (the decisions and
the error count) and the time between blocks are in none of the three,
so the share is of the counted phases and reads the tail a little above
its share of the launch.  None without a profile, and where the profiled
syncs' records lack the counters (a program that keeps none, the CPU's
plain path).

``BENCHMARK.json`` does not list this metric yet, so runs do not report
it: benchmark/tests/test_portbench_program_spans.py requires the four
``program_span`` metrics to be the last ``per_layer`` entries, and new
entries may only be appended.  Listing it takes a change to that test."""

from benchmark.metrics.decoder_roofline import KERNEL_B, KERNEL_F

PHASES = ("decoder.prologue_cycles", "decoder.mp_cycles", "decoder.tail_cycles")


def _profiled(r) -> list | None:
    """The newest run's records of the profiled syncs (``first`` ..
    ``stop`` - 1 of the profile, sync k running rounds k x
    rounds_per_sync ..), one a sync, or None."""
    try:
        from faid_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.recent()
    starts = [i for i, x in enumerate(recs) if x["snr_idx"] == 0 and x["round0"] == 0]
    if not starts:
        return None
    p, rps = r.lead["profile"], r.lead["rounds_per_sync"]
    lo, hi = p["first"] * rps, p["stop"] * rps
    got = [x for x in recs[starts[-1]:] if x["snr_idx"] == 0 and lo <= x["round0"] < hi]
    return got if len(got) == p["stop"] - p["first"] else None


def read(r):
    if not r.profiled:
        return None
    recs = _profiled(r)
    if not recs or any(p not in x["counters"] for x in recs for p in PHASES):
        return None
    cycles = [sum(x["counters"][p] for x in recs) for p in PHASES]
    if sum(cycles) <= 0:
        return None
    sim = r.ops(KERNEL_F.search)[0] > 0
    if sim == (r.ops(KERNEL_B.search)[0] > 0):
        return None
    rounds = r.profile_rounds()
    seconds = r.launch_seconds((KERNEL_F if sim else KERNEL_B).search, rounds)
    if seconds is None:
        return None
    return seconds / (rounds * len(r.ranks)) * 1e3 * cycles[2] / sum(cycles)
