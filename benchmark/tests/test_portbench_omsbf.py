"""The waterfall cell of OMS+BF (``qpsk-omsbf.zero-word-3.6dB``): it is
registered with the per-layer metrics of the path it runs, its rehearsed
traced run is correct, ``decoder_roofline`` counts the static tail's work
where kernel F runs it, the reader ``decoder.tail_ms_per_round`` (which
``BENCHMARK.json`` does not list yet) reads the tail's share of the
decoder's cycles off the profiled syncs' records, and the check's
control (the reference in bfloat16 thresholds) fails the cell's check."""

import collections
from types import SimpleNamespace

import pytest
import torch

from benchmark import control, harness, opmodel
from benchmark.reference.code import load_code
from benchmark.reference.config import Deployment
from benchmark.registry import Registry
from faid_tpu_torch.utils import trace

CELL = "qpsk-omsbf.zero-word-3.6dB"
# the runner, pipeline, kernel F and device layers, which the cell runs
METRICS = {"runner.write_ms_per_sync", "runner.checkpoint_ms",
           "runner.temp_txt_ms_per_sync", "runner.device_gap_ms_per_sync",
           "pipeline.host_ms_per_round", "pipeline.launches_per_round",
           "decoder_roofline", "device.idle_share"}
# what a short rehearsal on the CPU reads: no profile, no device gap, and
# a window too short for a checkpoint (every 8th sync)
REHEARSED = {"runner.write_ms_per_sync", "runner.temp_txt_ms_per_sync",
             "pipeline.host_ms_per_round"}
# kernel F's selective-OMS / static-BF instance, as the profiler names it
F = "void faid::decoder_kernel<(faid::Out)3, (faid::Style)1, (faid::Bf)1, false, 4>(signed char const*)"
B = "void faid::decoder_kernel<(faid::Out)0, (faid::Style)2, (faid::Bf)2, false, 4>(signed char const*)"
PHASES = ("decoder.prologue_cycles", "decoder.mp_cycles", "decoder.tail_cycles")


def _readings(ops, syncs=3):
    """Readings of a traced run whose profile holds ``ops`` over syncs 10
    and 11 (rounds 80 .. 95), after a window of ``syncs`` syncs of 8
    rounds."""
    reg = Registry()
    cell = reg.cell(CELL)
    config = reg.config(cell["config"])
    lead = {"syncs": syncs, "rounds_per_sync": 8,
            "profile": {"first": 10, "stop": 12, "ops": ops}}
    return harness.Readings(cell, config, [lead], torch.device("cpu"), None, 1, False)


def _record(round0, cycles=(100, 300, 600)):
    counters = dict(zip(PHASES, cycles)) if cycles else {}
    return {"snr_idx": 0, "round0": round0, "rounds": 8, "start_ns": 0,
            "spans": {}, "counters": counters, "device_gap_ns": None}


def test_the_cell_is_registered_with_its_layers_metrics():
    reg = Registry()
    cell = reg.cell(CELL)
    config = reg.config(cell["config"])
    s = config["settings"]
    assert (s["decode_method"], s["stop_mode"], s["scale"]) == (3, "group", 13)
    assert config["reduced"] == []
    dcfg = Deployment.from_config(config).decoder()
    assert (dcfg.bf.kind, dcfg.bf.max_iter, dcfg.bf.static_vote_cap) == ("static", 50, 5)
    assert (dcfg.oms_mode, dcfg.floor_err_count, dcfg.floor_iter_thresh) == (1, 100, 4)
    assert (cell["encode"], cell["snr_db"], cell["chips"]) == ("zero_word", 3.6, 1)
    assert METRICS == {m["name"] for m in reg.per_layer(CELL)}


def test_a_rehearsed_trace_run_is_correct(monkeypatch):
    monkeypatch.setattr(trace, "_store", collections.deque(maxlen=trace.KEEP))
    opts = harness.Options(CELL, 2**31 + 31, 0.5, trace=True, rehearse=True)
    rc, line, gaps = harness.lead_main(opts, 0.0)
    assert rc == 0 and line["correct"] and not any(gaps.values())
    assert line["checked"]["counter_gap"] == {"value": 0, "limit": 0}
    assert REHEARSED <= set(line["rehearsal_metrics"])
    # the CPU's plain path counts no cycles
    assert "decoder.tail_ms_per_round" not in line["rehearsal_metrics"]


def test_the_control_fails_the_check():
    for seed in (5, 2**31 + 3, 2**33 + 11):
        assert control.control_gaps(CELL, seed, rehearse=True)["counter_gap"] > 0


def test_the_control_at_the_cells_size(card):
    """On the card: the control at the cell's own size fails the check."""
    got = control.control_gaps(CELL, 2**31 + 7, rehearse=False, device=card)
    assert got["counter_gap"] > 0
    torch.cuda.empty_cache()


def test_the_roofline_counts_the_static_tails_work():
    """Two profiled syncs of F in which every frame ran 6 MP iterations
    and most words 40 static rounds: the frozen op model votes on every
    column each round, over F's time; nothing without a profile."""
    reg = Registry()
    cell = reg.cell(CELL)
    config = reg.config(cell["config"])
    mp_hist, bf_hist = [0] * 7, [0] * 51
    mp_hist[6], bf_hist[40], bf_hist[50] = 32768, 30720, 2048
    counters = {"test_frames": 32768, "mp_hist": mp_hist, "bf_hist": bf_hist}
    lead = {"rounds_per_sync": 8,
            "profile": {"first": 10, "stop": 12, "counters": counters,
                        "ops": {F: [16, 0.0896], "reduce_kernel": [64, 0.001]}}}
    code = load_code("50gpon")
    r = harness.Readings(cell, config, [lead], torch.device("cpu"), code, 1, False)
    tables = opmodel.code_tables(code, Deployment.from_config(config).decoder())
    assert tables.n_vote == code.n_block_cols
    assert tables.vote_edges == int(code.degrees_np.sum())
    ops = (opmodel.decoder_ops_from_histograms(code, tables, mp_hist, bf_hist)
           + 32768 * code.n_info + 16 * opmodel.channel_ops(2048, code.n_var, 7))
    want = 100 * opmodel.bound(16 * 5 * 4 * 2048, ops)[0] / 1e3 / 0.0896
    read = reg.reader("decoder_roofline")
    assert read(r) == pytest.approx(want) and 0 < want < 100
    assert read(SimpleNamespace(profiled=False)) is None


@pytest.mark.parametrize("kernel", [F, B])
def test_the_tail_reader_takes_the_kernels_time_by_the_tails_cycles(monkeypatch, kernel):
    """F (or B) 5 ms a round in the profile; the records of the 2 profiled
    syncs give the tail 600 of every 1000 cycles: 3 ms.  An older run,
    the window and the profiler's warm-up sync are not read."""
    store = [_record(80, (1, 1, 10**9)), _record(0, (1, 1, 10**9))]
    store += [_record(8 * k, (1, 1, 10**9)) for k in range(3)]
    store += [_record(72, (1, 1, 10**9)), _record(80), _record(88)]
    monkeypatch.setattr(trace, "_store", collections.deque(store, maxlen=trace.KEEP))
    r = _readings({kernel: [16, 0.08], "reduce_kernel": [64, 0.001]})
    assert Registry().reader("decoder.tail_ms_per_round")(r) == pytest.approx(3.0)


@pytest.mark.parametrize("case", ["no_profile", "no_counters", "a_record_without",
                                  "a_sync_missing", "no_cycles", "no_decoder",
                                  "no_records"])
def test_the_tail_reader_reads_nothing_without_its_inputs(monkeypatch, case):
    window = [_record(8 * k) for k in range(4)]
    store = window + [_record(80), _record(88)]
    ops = {F: [16, 0.08]}
    if case == "no_counters":
        store = window + [_record(80, None), _record(88, None)]
    elif case == "a_record_without":
        store[-1] = _record(88, None)
    elif case == "a_sync_missing":
        del store[-1]
    elif case == "no_cycles":
        store = window + [_record(80, (0, 0, 0)), _record(88, (0, 0, 0))]
    elif case == "no_decoder":
        ops = {"reduce_kernel": [64, 0.001]}
    elif case == "no_records":
        store = []
    monkeypatch.setattr(trace, "_store", collections.deque(store, maxlen=trace.KEEP))
    read = Registry().reader("decoder.tail_ms_per_round")
    r = SimpleNamespace(profiled=False) if case == "no_profile" else _readings(ops)
    assert read(r) is None
