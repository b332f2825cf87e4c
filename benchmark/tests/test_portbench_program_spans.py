"""The readers of the program's own spans (``program_span`` metrics): the
window's records picked by their rounds, nothing where the records do
not match the window or the program keeps none, and a rehearsed trace
run that reports them."""

import collections
import sys
from types import SimpleNamespace

import pytest

import faid_tpu_torch.utils
from benchmark import harness
from benchmark.registry import Registry
from faid_tpu_torch.utils import trace

METRICS = ("runner.checkpoint_ms", "runner.temp_txt_ms_per_sync",
           "runner.device_gap_ms_per_sync", "codewords.host_ms_per_round")


def _rec(round0, gap=None, checkpoint=None, codewords=True):
    spans = {"runner.sync": [1, 9_000_000], "runner.temp_txt": [1, 500_000]}
    if checkpoint is not None:
        spans["runner.checkpoint"] = [1, checkpoint]
    if codewords:
        spans["pipeline.message_stream"] = [8, 16_000_000]
        spans["pipeline.encoder"] = [8, 8_000_000]
    return {"snr_idx": 0, "round0": round0, "rounds": 8, "start_ns": 0,
            "spans": spans, "counters": {}, "device_gap_ns": gap}


def _store(codewords=True, cuda=True):
    """An older run, then the window's 3 syncs (rounds 0 .. 23) with a
    profiled stretch after them, which repeats no round of the window."""
    old = [_rec(0, checkpoint=90_000_000), _rec(8, gap=90_000_000)]
    gaps = [None, 1_000_000, 3_000_000] if cuda else [None] * 3
    window = [_rec(8 * k, gap=g, checkpoint=c, codewords=codewords)
              for k, (g, c) in enumerate(zip(gaps, [2_000_000, None, 4_000_000]))]
    stretch = [_rec(24 + 8 * k, gap=50_000_000, checkpoint=70_000_000,
                    codewords=codewords) for k in range(3)]
    return collections.deque(old + window + stretch, maxlen=trace.KEEP)


def _read(monkeypatch, store, syncs=3):
    monkeypatch.setattr(trace, "_store", store)
    reg = Registry()
    r = SimpleNamespace(lead={"syncs": syncs, "rounds_per_sync": 8})
    return {m: reg.reader(m)(r) for m in METRICS}


def test_readers_pick_the_window_by_its_rounds(monkeypatch):
    assert _read(monkeypatch, _store()) == pytest.approx({
        "runner.checkpoint_ms": 3.0, "runner.temp_txt_ms_per_sync": 0.5,
        "runner.device_gap_ms_per_sync": 2.0, "codewords.host_ms_per_round": 3.0})
    got = _read(monkeypatch, _store(codewords=False, cuda=False))
    assert got["runner.checkpoint_ms"] == pytest.approx(3.0)
    assert got["runner.device_gap_ms_per_sync"] is None      # the CPU's
    assert got["codewords.host_ms_per_round"] is None        # the all-zero word


@pytest.mark.parametrize("case", ["a_sync_twice", "a_sync_missing", "no_records",
                                  "no_module"])
def test_readers_read_nothing_that_is_not_the_window(monkeypatch, case):
    store = _store()
    if case == "a_sync_twice":
        store.insert(4, _rec(8, gap=1_000_000))
    elif case == "a_sync_missing":
        del store[3]
    elif case == "no_records":
        store.clear()
    else:
        # a program without the module: the parent of the spans
        monkeypatch.delattr(faid_tpu_torch.utils, "trace")
        monkeypatch.setitem(sys.modules, "faid_tpu_torch.utils.trace", None)
    assert _read(monkeypatch, store) == dict.fromkeys(METRICS)


def test_the_entries_keep_the_contract():
    spec = Registry().spec
    entries = {m["name"]: m for m in spec["per_layer"] if m["name"] in METRICS}
    assert set(entries) == set(METRICS)
    assert {m["source"] for m in entries.values()} == {"program_span"}
    assert entries["codewords.host_ms_per_round"]["workloads"] == [
        "16qam.codewords-7.5dB", "qpsk.codewords-4.0dB"]
    assert list(entries) == [m["name"] for m in spec["per_layer"][-4:]]


def test_a_rehearsed_trace_run_reports_the_spans(monkeypatch):
    """A codewords cell, traced, its window long enough for a checkpoint
    (every 8th sync; a rehearsed sync takes about 0.6 s); the CPU has no
    device gap."""
    monkeypatch.setattr(trace, "_store", collections.deque(maxlen=trace.KEEP))
    opts = harness.Options("qpsk.codewords-4.0dB", 2**31 + 23, 6.0, trace=True,
                           rehearse=True)
    rc, line, _ = harness.lead_main(opts, 0.0)
    assert rc == 0 and line["correct"] and line["syncs"] >= 8
    got = set(line["rehearsal_metrics"])
    assert {"runner.checkpoint_ms", "runner.temp_txt_ms_per_sync",
            "codewords.host_ms_per_round"} <= got
    assert "runner.device_gap_ms_per_sync" not in got
