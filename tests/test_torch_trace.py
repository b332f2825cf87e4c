"""The campaign's spans and counters (faid_tpu_torch/utils/trace.py) on the
CPU, on the toy code: records a sync, nesting, the bounded store, the
profiler's ranges and their sync tags, and the spans of the runner, the
round and the all-reduce."""

from __future__ import annotations

import collections
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from faid_tpu_torch import MonteCarloRunner
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, SimConfig
from faid_tpu_torch.ops import philox
from faid_tpu_torch.parallel import mesh
from faid_tpu_torch.sim import pipeline
from faid_tpu_torch.utils import trace

torch.set_num_threads(1)

RUNNER_SPANS = {"runner.sync", "runner.loop_call", "runner.counter_read",
                "runner.bookkeeping", "runner.progress", "runner.temp_txt"}


@pytest.fixture(autouse=True)
def store(monkeypatch):
    """An empty store of records for each test."""
    monkeypatch.setattr(trace, "_store", collections.deque(maxlen=trace.KEEP))


def toy_runner(tmp_path, syncs: int, **kw) -> MonteCarloRunner:
    """A toy runner of one SNR point that stops after ``syncs`` syncs of one
    round (4 frames, or 32 where ``batch_per_device`` says so), its
    checkpoint and Temp.txt in ``tmp_path``."""
    base = dict(decode_method=DecodeMethod.FAID_DTBF, max_iteration=2,
                mod_type=2, batch_per_device=4, seed=3, fake_encode=True,
                channel_backend="fused", min_frame_errors=0,
                rounds_per_sync=1, snr_start=6.0, snr_pass=1.0, snr_end=6.5)
    base.update(kw)
    base["min_frames"] = base["batch_per_device"] * syncs
    return MonteCarloRunner(SimConfig(**base), code=toy_code(), device="cpu",
                            checkpoint_path=tmp_path / "checkpoint.json",
                            temp_txt_path=tmp_path / "Temp.txt")


def test_spans_nest_and_sum_into_the_open_sync():
    with trace.span("outside"):
        trace.count("outside", 1)
    assert trace.recent() == []
    assert trace.span("a") is trace.span("b")       # the shared no-op
    with trace.sync(2, 16, 8) as rec:
        with trace.span("outer"):
            for _ in range(3):
                with trace.span("inner"):
                    sum(range(1000))
        trace.count("bytes", 5)
        trace.count("bytes", 7)
    with trace.span("after"):
        pass
    assert trace.recent() == [rec]
    assert (rec["snr_idx"], rec["round0"], rec["rounds"]) == (2, 16, 8)
    assert set(rec["spans"]) == {"outer", "inner"}
    (n_out, ns_out), (n_in, ns_in) = rec["spans"]["outer"], rec["spans"]["inner"]
    assert (n_out, n_in) == (1, 3) and ns_out >= ns_in > 0
    assert rec["counters"] == {"bytes": 12} and rec["device_gap_ns"] is None


def test_the_store_keeps_the_newest_records():
    for i in range(trace.KEEP + 3):
        with trace.sync(0, i, 1):
            pass
    got = trace.recent()
    assert len(got) == trace.KEEP
    assert (got[0]["round0"], got[-1]["round0"]) == (3, trace.KEEP + 2)


def test_a_sync_ended_by_an_exception_leaves_no_record(tmp_path):
    with pytest.raises(KeyboardInterrupt):
        with trace.sync(0, 0, 1), trace.span("a"):
            raise KeyboardInterrupt
    assert trace.recent() == []
    # the runner's third sync fails in its loop call
    r = toy_runner(tmp_path, 8)
    loop, calls = r.loop, []

    def failing(*args):
        calls.append(args)
        if len(calls) == 3:
            raise RuntimeError("the device is lost")
        return loop(*args)

    r.loop = failing
    with pytest.raises(RuntimeError, match="device is lost"):
        r.run_point()
    assert [x["round0"] for x in trace.recent()] == [0, 1]


@pytest.mark.parametrize("case", ["zero_word", "codewords_qam", "codewords_float"])
def test_a_runner_point_gives_one_record_a_sync(tmp_path, case):
    """Every runner span in every record, the checkpoint's span and size on
    every 8th sync, and the round's stages of the path that runs."""
    # kernel F's twin takes the round at a batch of whole 32-frame words
    kw = {"zero_word": dict(batch_per_device=32),
          "codewords_qam": dict(fake_encode=False, mod_type=4),
          "codewords_float": dict(fake_encode=False, channel_backend="xla")}[case]
    r = toy_runner(tmp_path, 16, **kw)
    sizes = []

    def progress(snr_db, c):
        path = tmp_path / "checkpoint.json"
        sizes.append(path.stat().st_size if path.exists() else None)

    r.run_point(progress=progress)
    recs = trace.recent()
    assert [(x["snr_idx"], x["round0"], x["rounds"]) for x in recs] == [
        (0, k, 1) for k in range(16)]
    for k, x in enumerate(recs):
        spans = x["spans"]
        assert RUNNER_SPANS <= set(spans) and x["device_gap_ns"] is None
        assert spans["runner.sync"][1] >= spans["runner.loop_call"][1] > 0
        assert spans["pipeline.round"][0] == 1 and spans["pipeline.counters"][0] == 1
        assert ("runner.checkpoint" in spans) == (k % 8 == 7)
        assert ("runner.checkpoint_bytes" in x["counters"]) == (k % 8 == 7)
        codewords = {"pipeline.message_stream", "pipeline.encoder"} <= set(spans)
        assert codewords == (case != "zero_word")
        if case == "zero_word":
            assert "pipeline.fused_sim" in spans and "pipeline.decoder" not in spans
        else:
            assert {"pipeline.channel", "pipeline.mod_stats",
                    "pipeline.decoder"} <= set(spans)
    # sync 9's progress call sees the file that sync 8 wrote
    assert recs[7]["counters"]["runner.checkpoint_bytes"] == sizes[8] > 0


def test_no_profiler_range_opens_without_a_profiler(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    toy_runner(tmp_path, 3, fake_encode=False).run_point()
    assert len(trace.recent()) == 3


def test_profiler_ranges_carry_their_sync(tmp_path):
    r = toy_runner(tmp_path, 2)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        r.run_point()
    ranges = [e for e in prof.events() if e.name.startswith(trace.PREFIX)]
    syncs = [e for e in ranges if e.name == "faid.runner.sync"]
    assert [e.kwinputs for e in syncs] == [{"sync": "0:0"}, {"sync": "0:1"}]
    rounds = [e for e in ranges if e.name == "faid.pipeline.round"]
    assert len(rounds) == 2
    for e in rounds:
        chain = []
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        assert chain[1:3] == ["faid.runner.loop_call", "faid.runner.sync"]
    assert {e.kwinputs["sync"] for e in rounds} == {"0:0", "0:1"}
    # the sums a sync are kept alongside
    assert [x["spans"]["pipeline.round"][0] for x in trace.recent()] == [1, 1]


class FakeEvent:
    """A CUDA timing event on the host's clock: complete once recorded."""

    def __init__(self, enable_timing=False):
        self.ns = None

    def record(self, stream=None):
        self.ns = time.perf_counter_ns()

    def query(self):
        return self.ns is not None

    def elapsed_time(self, other):
        return (other.ns - self.ns) / 1e6


def test_the_device_gap_spans_consecutive_syncs_of_a_point(monkeypatch):
    """The gap is the end of the last sync's launches to this sync's start,
    known where the last sync ran the rounds just before, on the same
    point, and ended normally."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(trace, "_clocks", {})
    dev = torch.device("cuda", 0)

    def one(snr_idx, round0, idle_s=0.0, fail=False):
        with trace.sync(snr_idx, round0, 2, dev):
            trace.launched()
            if fail:
                raise RuntimeError("lost")
        time.sleep(idle_s)

    one(0, 0, 0.01)
    one(0, 2)
    one(0, 6)                                   # rounds 4, 5 not run
    one(1, 8)                                   # another point
    one(1, 10)
    with pytest.raises(RuntimeError):
        one(1, 12, fail=True)
    one(1, 14)                                  # after a failed sync
    with trace.sync(1, 16, 2):                  # no device: no events
        pass
    gaps = [x["device_gap_ns"] for x in trace.recent()]
    assert gaps[0] is None and gaps[1] >= 1e7 and gaps[4] > 0
    assert [g is None for g in gaps] == [True, False, True, True, False,
                                         True, True]


def test_the_all_reduce_is_a_span(monkeypatch):
    monkeypatch.setattr(mesh.dist, "all_reduce", lambda t: None)
    stats = {"a": torch.tensor(3, dtype=torch.int32),
             "h": torch.arange(5, dtype=torch.int32)}
    with trace.sync(0, 0, 1) as rec:
        out = mesh.all_reduce_counters(stats)
    assert all(torch.equal(out[k], v) for k, v in stats.items())
    assert rec["spans"]["mesh.all_reduce"][0] == 1


def test_stage_swaps_still_intercept_the_calls(tmp_path, monkeypatch):
    """A caller that swaps the module attributes the round looks up (as a
    benchmark's stage spans do) still sees every call."""
    calls = collections.Counter()

    def counted(fn, name):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    make_encode = pipeline.make_encode_fn
    monkeypatch.setattr(philox, "message_bits",
                        counted(philox.message_bits, "message_stream"))
    monkeypatch.setattr(pipeline, "make_encode_fn", lambda *a, **k: counted(
        make_encode(*a, **k), "encoder"))
    monkeypatch.setattr(pipeline, "mod_stats", counted(pipeline.mod_stats, "mod_stats"))
    monkeypatch.setattr(mesh, "all_reduce_counters",
                        counted(lambda stats: stats, "all_reduce"))
    toy_runner(tmp_path, 3, fake_encode=False, mod_type=4).run_point()
    assert calls == {"message_stream": 3, "encoder": 3, "mod_stats": 3}
    # a world of two looks the all-reduce up at each call
    r = toy_runner(tmp_path / "world2", 1)
    loop = mesh.build_sharded_sim_loop(r.code, r.cfg, mesh.Mesh(0, 2, r.device), 1)
    loop(3, r.cfg.sigma_at(6.0), 0)
    assert calls["all_reduce"] == 1
