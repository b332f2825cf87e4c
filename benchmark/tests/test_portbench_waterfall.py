"""The waterfall cell of the hybrid decoder (``qpsk-2b1c.zero-word-3.6dB``):
it is registered with the per-layer metrics of the path it runs, its
rehearsed traced run is correct, and ``decoder_roofline`` counts the
hybrid decoder's work where kernel F runs it."""

import collections
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, opmodel
from benchmark.reference.code import load_code
from benchmark.reference.config import Deployment
from benchmark.registry import Registry
from faid_tpu_torch.utils import trace

CELL = "qpsk-2b1c.zero-word-3.6dB"
# the runner, pipeline, kernel F and device layers, which the cell runs
METRICS = {"runner.write_ms_per_sync", "runner.checkpoint_ms",
           "runner.temp_txt_ms_per_sync", "runner.device_gap_ms_per_sync",
           "pipeline.host_ms_per_round", "pipeline.launches_per_round",
           "decoder_roofline", "device.idle_share"}
# what a short rehearsal on the CPU reads: no profile, no device gap, and
# a window too short for a checkpoint (every 8th sync)
REHEARSED = {"runner.write_ms_per_sync", "runner.temp_txt_ms_per_sync",
             "pipeline.host_ms_per_round"}
# kernel F's FAID EF 1 / 2B1C instance, as the profiler names it
F = "void faid::decoder_kernel<(faid::Out)3, (faid::Style)4, (faid::Bf)3, false, 4>(signed char const*)"


def test_the_cell_is_registered_with_its_layers_metrics():
    reg = Registry()
    cell = reg.cell(CELL)
    config = reg.config(cell["config"])
    assert config["settings"]["decode_method"] == 5
    assert config["settings"]["scale"] == 12.5 and config["reduced"] == []
    assert (cell["encode"], cell["snr_db"], cell["chips"]) == ("zero_word", 3.6, 1)
    assert METRICS <= {m["name"] for m in reg.per_layer(CELL)}


def test_a_rehearsed_trace_run_is_correct(monkeypatch):
    monkeypatch.setattr(trace, "_store", collections.deque(maxlen=trace.KEEP))
    opts = harness.Options(CELL, 2**31 + 29, 0.5, trace=True, rehearse=True)
    rc, line, gaps = harness.lead_main(opts, 0.0)
    assert rc == 0 and line["correct"] and not any(gaps.values())
    assert line["checked"]["counter_gap"] == {"value": 0, "limit": 0}
    assert REHEARSED <= set(line["rehearsal_metrics"])


def test_the_roofline_counts_the_hybrid_decoders_work():
    """Two profiled syncs of F in which every frame ran 6 MP iterations and
    most the whole tail: the frozen op model on the 2B1C decoder (EF 1's
    rows, the tail's demotes) over F's time; nothing without a profile."""
    reg = Registry()
    cell = reg.cell(CELL)
    config = reg.config(cell["config"])
    mp_hist, bf_hist = [0] * 7, [0] * 11
    mp_hist[6], bf_hist[10], bf_hist[4] = 32768, 32000, 768
    counters = {"test_frames": 32768, "mp_hist": mp_hist, "bf_hist": bf_hist}
    lead = {"rounds_per_sync": 8,
            "profile": {"first": 10, "stop": 12, "counters": counters,
                        "ops": {F: [16, 0.1075], "reduce_kernel": [64, 0.001]}}}
    code = load_code("50gpon")
    r = harness.Readings(cell, config, [lead], torch.device("cpu"), code, 1, False)
    tables = opmodel.code_tables(code, Deployment.from_config(config).decoder())
    ops = (opmodel.decoder_ops_from_histograms(code, tables, mp_hist, bf_hist)
           + 32768 * code.n_info + 16 * opmodel.channel_ops(2048, code.n_var, 7))
    want = 100 * opmodel.bound(16 * 5 * 4 * 2048, ops)[0] / 1e3 / 0.1075
    read = reg.reader("decoder_roofline")
    assert read(r) == pytest.approx(want) and 0 < want < 100
    assert read(SimpleNamespace(profiled=False)) is None
