"""Spans and counters of the campaign, kept a sync at a time.

The runner (sim/runner.py) opens one record for each sync, its loop call
of ``rounds_per_sync`` rounds and what follows it (``sync``).  While it
is open, ``span(name)`` adds each span's host nanoseconds and a count
under its name, and ``count(name, n)`` adds to a counter.  A record is
a plain dict of a few hundred bytes:

    snr_idx, round0, rounds   the sync's SNR point, first round, rounds
    start_ns                  its host start (``time.perf_counter_ns``)
    spans                     {name: [count, ns]}
    counters                  {name: total}
    device_gap_ns             the device's idle time before the sync's
                              first launch (see below; None on the CPU
                              and for a run's first sync)

The newest ``KEEP`` records of syncs that ended normally stay in memory,
oldest first (``recent``); a sync ended by an exception leaves none.
``python -m faid_tpu_torch.cli --trace-dir DIR`` writes them to
``DIR/syncs.json``.

On a CUDA device, ``sync`` records a timing event before the sync's
first launch and ``launched`` one after its last, two events a device
reused sync after sync.  A sync's ``device_gap_ns`` is the time from the
end of the previous sync's work to its own first launch, on the device's
clock: the device's idle time at the sync boundary.  It is known where
the previous sync ran the rounds of the same point just before this one
and ended normally.

While a torch profiler records, each span also opens a profiler range
``faid.<name>``, tagged ``sync`` = ``<snr_idx>:<round0>`` where a sync is
open, so the campaign's ranges sit on the profiler's clock, nested under
their parents.  The tag reaches the trace where the profiler records
shapes (``record_shapes=True``), as the CLI's does.  With no sync open
and no profiler recording, ``span`` returns a shared no-op.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

# 4096 syncs cover 110 s of the shortest sync on an H100 (27 ms)
KEEP = 4096
PREFIX = "faid."

_store: collections.deque = collections.deque(maxlen=KEEP)
_open: dict | None = None        # the open sync's record
_clock = None                    # the open sync's device clock
_clocks: dict = {}               # device -> its _Clock


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _range(name: str):
    """The profiler range of span ``name``, tagged with the open sync.
    ``record_function`` drops its ``args`` string from the trace; the
    keyword values of ``_RecordFunctionFast`` reach the trace's args."""
    kw = {} if _open is None else {"sync": f"{_open['snr_idx']}:{_open['round0']}"}
    return torch._C._profiler._RecordFunctionFast(PREFIX + name, [], kw)


class _Span:
    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = _range(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        if _open is not None:
            spans = _open["spans"]
            s = spans.get(self.name)
            if s is None:
                spans[self.name] = [1, ns]
            else:
                s[0] += 1
                s[1] += ns
        return False


class _Clock:
    """The timing events of one CUDA device: the open sync's start and
    the end of the last sync's work, which ``after`` says the sync at
    ``(snr_idx, round)`` follows on from."""
    __slots__ = ("device", "start", "end", "after")

    def __init__(self, device: torch.device):
        self.device = device
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.after = None

    def record(self, event) -> None:
        event.record(torch.cuda.current_stream(self.device))


def span(name: str):
    """A context manager that times its block into the open sync's record
    under ``name`` (and opens the range ``faid.<name>`` while a profiler
    records); a shared no-op where neither holds."""
    if _open is None and not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the open sync's counter ``name``."""
    if _open is not None:
        c = _open["counters"]
        c[name] = c.get(name, 0) + n


def launched() -> None:
    """Marks the end of the open sync's launches on its device's stream,
    and sets the sync's ``device_gap_ns`` where the previous sync's end
    leads to it.  The sync's start is complete by now, as the device was
    idle when it was recorded; no wait."""
    c = _clock
    if c is None:
        return
    rec = _open
    if c.after == (rec["snr_idx"], rec["round0"]) and c.start.query():
        rec["device_gap_ns"] = round(c.end.elapsed_time(c.start) * 1e6)
    c.record(c.end)
    c.after = (rec["snr_idx"], rec["round0"] + rec["rounds"])


@contextlib.contextmanager
def sync(snr_idx: int, round0: int, rounds: int, device=None):
    """Opens the record of one sync, rounds ``round0 ..`` of SNR point
    ``snr_idx``, and yields it; the record is kept where the block ends
    normally.  On a CUDA ``device`` it records the sync's start."""
    global _open, _clock
    rec = {"snr_idx": snr_idx, "round0": round0, "rounds": rounds,
           "start_ns": time.perf_counter_ns(), "spans": {}, "counters": {},
           "device_gap_ns": None}
    if device is not None and device.type == "cuda":
        _clock = _clocks.get(device) or _clocks.setdefault(device, _Clock(device))
        _clock.record(_clock.start)
    _open = rec
    try:
        yield rec
    except BaseException:
        if _clock is not None:
            _clock.after = None
        raise
    finally:
        _open = _clock = None
    _store.append(rec)


def recent() -> list[dict]:
    """The kept records, oldest first."""
    return list(_store)
