"""The harness: every file found by name, a new cell or metric picked up
from files alone, the operation model's forms, the trace readers and the
metric readers on synthetic data, and one rehearsed run a cell."""

import dataclasses
import json
import re
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, opmodel, tracing
from benchmark.reference.code import load_code
from benchmark.reference.config import BFConfig, Deployment
from benchmark.registry import ROOT, Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_file_found_by_name():
    reg = Registry()
    spec = reg.spec
    for c in spec["configs"]:
        assert reg.config(c["name"])["name"] == c["name"]
        assert (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["chips"] == w["chips"]
        assert reg.end_to_end(w["name"])
        assert reg.per_layer(w["name"])
    for m in spec["per_layer"]:
        assert callable(reg.reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    spec = Registry().spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1] == "benchmark/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in spec["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == len(cells)
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(cells) // 4)
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in spec["per_layer"])
    assert len(json.dumps(spec)) < 64 * 1024


def test_new_cell_and_metric_are_picked_up(tmp_path):
    """A later change adds files and BENCHMARK.json entries; no file of the
    harness changes."""
    base = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((base / "workloads" / "qpsk.zero-word-4.0dB.json").read_text())
    cell.update(traffic="zero-word-3.6dB", snr_db=3.6, why="the waterfall")
    (base / "workloads" / "qpsk.zero-word-3.6dB.json").write_text(json.dumps(cell))
    (base / "metrics" / "runner.syncs.py").write_text(
        "def read(r):\n    return r.lead['syncs']\n")
    spec["workloads"].append({"name": "qpsk.zero-word-3.6dB", "config": cell["config"],
                              "traffic": cell["traffic"], "chips": 1,
                              "why": "the waterfall"})
    spec["per_layer"].append({"name": "runner.syncs", "unit": "syncs",
                              "better": "higher", "source": "host_clock",
                              "layer": "runner (sim/runner.py)",
                              "moves": "info_mbit_s",
                              "workloads": ["qpsk.zero-word-3.6dB"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(tmp_path / "BENCHMARK.json", base)
    assert reg.cell("qpsk.zero-word-3.6dB")["snr_db"] == 3.6
    assert "runner.syncs" in [m["name"] for m in reg.per_layer("qpsk.zero-word-3.6dB")]
    assert "runner.syncs" not in [m["name"] for m in reg.per_layer("qpsk.zero-word-4.0dB")]
    assert reg.reader("runner.syncs")(SimpleNamespace(lead={"syncs": 7})) == 7


def _per_frame(rng, frames, dcfg):
    """Per-frame MP iterations and BF rounds as a decoder gives them: BF
    rounds only where MP ran out."""
    mp = rng.integers(1, dcfg.max_iter + 1, frames)
    bf = np.where(mp == dcfg.max_iter, rng.integers(0, dcfg.bf.max_iter + 1, frames), 0)
    return torch.as_tensor(mp), torch.as_tensor(bf)


@pytest.mark.parametrize("method", [0, 1, 2, 3, 4, 5])
def test_histogram_ops_equal_per_frame_ops(method):
    code = load_code("50gpon")
    dcfg = Deployment(decode_method=method).decoder()
    if method == 2:
        # EF 2's window as well
        dcfg = dataclasses.replace(dcfg, ef_elimination=2, floor_iter_thresh=3)
    tables = opmodel.code_tables(code, dcfg)
    mp, bf = _per_frame(np.random.default_rng(method), 4096, dcfg)
    mp_hist = torch.bincount(mp, minlength=dcfg.max_iter + 1).tolist()
    bf_hist = torch.bincount(bf, minlength=max(dcfg.bf.max_iter, 1) + 1).tolist()
    want = opmodel.decoder_ops(code, tables, mp, bf)
    got = opmodel.decoder_ops_from_histograms(code, tables, mp_hist, bf_hist)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("kind", ["dtbf", "static", "dtbf2b1c"])
def test_code_tables_count_the_ports_tables(kind):
    from faid_tpu_torch.code.qc_matrix import load_code as port_load_code
    from faid_tpu_torch.config import BFConfig as PortBF
    from faid_tpu_torch.config import DecoderConfig as PortDecoderConfig
    from faid_tpu_torch.ops.cuda_decoder import decoder_tables

    code = load_code("50gpon")
    ef = 2 if kind == "dtbf" else 0
    port = decoder_tables(port_load_code("50gpon"), PortDecoderConfig(
        ef_elimination=ef, bf=PortBF(kind=kind, max_iter=10)), "cpu")
    ours = opmodel.code_tables(code, SimpleNamespace(
        method=2, oms_mode=0, ef_elimination=ef, bf=BFConfig(kind=kind, max_iter=10)))
    assert (ours.n_vote, ours.vote_edges, ours.erasing) == (
        port.vote_col.numel(), int(port.vote_ptr[-1]), int((port.ef_ptr >= 0).sum()))


def test_qam_counts_equal_qam_least_ops():
    from benchmark.reference.qam import plan_threshold_ints

    dep = Deployment(mod_type=4, interleave_depth=2)
    params = plan_threshold_ints(dep, dep.sigma_at(7.5))
    rng = np.random.default_rng(3)
    ms = [torch.as_tensor(rng.integers(0, 2, (16, 40))) for _ in range(3)]
    want = sum(opmodel.qam_least_ops(params, m, 4, 4) for m in ms)
    per_row = sum(torch.bincount(m.reshape(-1), minlength=2) for m in ms)
    assert opmodel.qam_least_ops_counts(params, per_row, 3, 4, 4) == want


def _event(name, start, end, device, parent=None, kernels=()):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        cpu_parent=parent,
        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])


F = "void faid::decoder_kernel<(faid::Out)3, (faid::Style)2, (faid::Bf)2, false, 4>(signed char const*)"


def test_kernel_classes():
    assert tracing.kernel_class(F) == "kernel_F"
    assert tracing.kernel_class("void faid::decoder_kernel<0, 2, 2, true, 4>(x)") == "kernel_B"
    assert tracing.kernel_class("void (anonymous namespace)::qam_channel_kernel(Args)") == "kernel_G"
    assert tracing.kernel_class("void (anonymous namespace)::quantile_channel_kernel<true>(x)") == "kernel_A"
    assert tracing.kernel_class("ncclDevKernel_AllReduce_Sum_i64_RING_LL(x)") == "nccl"
    assert tracing.kernel_class("void at::native::reduce_kernel<512, 1>(x)") is None


def test_trace_readers_on_a_synthetic_trace():
    """Two syncs: F 10 us then a torch kernel 2 us, with host phases and a
    message stream span; all times in microseconds."""
    span = lambda n, s, e, p=None: _event(tracing.SPAN + n, s, e, False, p)  # noqa: E731
    loop0, loop1 = span("loop_call", 0, 4), span("loop_call", 30, 34)
    stage = span("message_stream", 1, 2, loop0)
    launch = _event("cudaLaunchKernel", 1.5, 1.8, False, stage,
                    [("elementwise_kernel", 2.0)])
    red = _event("cudaLaunchKernel", 3, 3.2, False, loop0, [("reduce_kernel", 1.0)])
    events = [loop0, span("counter_wait", 4, 20), span("runner_writes", 20, 30),
              loop1, span("counter_wait", 34, 50), stage, launch, red,
              _event(F, 5, 15, True), _event("elementwise_kernel", 15, 17, True),
              _event(F, 35, 45, True), _event("Memcpy DtoH", 46, 47, True)]
    s = tracing.device_summary(events)
    assert s["busy_s"] == pytest.approx(23e-6)
    assert s["ops"][F] == [2, pytest.approx(20e-6)]
    b = tracing.breakdown(events)
    assert dict(map(tuple, b["device_ops"])) == pytest.approx(
        {"kernel_F": 20e-6, "message_stream": 2e-6, "reductions": 1e-6})
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx(
        {"loop_call": 5e-6, "counter_wait": 3e-6 + 1e-6, "runner_writes": 18e-6})


def _readings(config_name="pon50g-qpsk-faid_dtbf", ranks=1):
    reg = Registry()
    cell = next(reg.cell(w["name"]) for w in reg.spec["workloads"]
                if w["config"] == config_name)
    mp_hist, bf_hist = [0] * 7, [0] * 11
    mp_hist[3], mp_hist[6], bf_hist[2] = 16000, 384, 32
    counters = {"test_frames": 16384 * ranks, "mp_hist": mp_hist, "bf_hist": bf_hist}
    lead = {"syncs": 100, "window_s": 2.5, "rounds_per_sync": 8, "batch": 2048,
            "writes_s": [0.001, 0.003], "loop_s": [0.008] * 100,
            "allreduce_host_s": [0.0002, 0.0004],
            "profile": {"window_s": 0.05, "busy_s": 0.04, "first": 10, "stop": 12,
                        "counters": counters,
                        "ops": {F: [16, 0.048], "reduce_kernel": [64, 0.001],
                                "Memcpy DtoH": [22, 0.0001],
                                "ncclDevKernel_AllReduce(x)": [2, 0.0002]}}}
    return harness.Readings(cell, reg.config(config_name), [lead] * ranks,
                            torch.device("cpu"), load_code("50gpon"), 1, False)


def test_metric_readers_on_synthetic_readings():
    reg = Registry()
    r = _readings()
    read = lambda name: reg.reader(name)(r)  # noqa: E731
    assert read("runner.write_ms_per_sync") == pytest.approx(2.0)
    assert read("pipeline.host_ms_per_round") == pytest.approx(1.0)
    assert read("pipeline.launches_per_round") == pytest.approx((16 + 64 + 2) / 16)
    # a profiled sync busy 20 ms, a sync of the window 25 ms
    assert read("device.idle_share") == pytest.approx(20.0)
    assert read("mesh.allreduce_ms_per_sync") is None
    code = r.ref_code
    tables = opmodel.code_tables(code, Deployment().decoder())
    c = r.lead["profile"]["counters"]
    ops = (opmodel.decoder_ops_from_histograms(code, tables, c["mp_hist"], c["bf_hist"])
           + 16384 * code.n_info + 16 * opmodel.channel_ops(2048, code.n_var, 7))
    want = 100 * opmodel.bound(16 * 5 * 4 * 2048, ops)[0] / 1e3 / 0.048
    assert read("decoder_roofline") == pytest.approx(want)
    assert 0 < want < 100
    # a launch the profiler dropped counts at the mean of the rest; a
    # profile that dropped more than a tenth reads nothing
    r.lead["profile"]["ops"][F] = [15, 0.045]
    assert read("decoder_roofline") == pytest.approx(want)
    r.lead["profile"]["ops"][F] = [14, 0.042]
    assert read("decoder_roofline") is None
    r4 = _readings(ranks=4)
    assert reg.reader("mesh.allreduce_ms_per_sync")(r4) == pytest.approx(
        (0.0003 + 0.0002 * 4 / 4 / 2) * 1e3)


def test_window_statistics():
    assert harness.p95(list(range(1, 101))) == pytest.approx(95.05)
    a = harness.sample_syncs(2**33 + 5, 400, 2)
    assert a == harness.sample_syncs(2**33 + 5, 400, 2) and len(set(a)) == 2
    assert harness.sample_syncs(7, 1, 3) == [0]


@pytest.mark.parametrize("cell", ["qpsk.zero-word-4.0dB", "16qam.codewords-7.5dB",
                                  "qpsk.codewords-4.0dB"])
def test_rehearsed_run(cell):
    """The whole flow on the CPU: window, spans, check, line."""
    opts = harness.Options(cell, 2**31 + 11, 0.5, trace=cell.startswith("16qam"),
                           rehearse=True)
    rc, line, gaps = harness.lead_main(opts, 0.0)
    assert rc == 0 and line["correct"] and not any(gaps.values())
    assert list(line)[-1] == "checked" and line["metrics"] == {}
    assert line["checked"]["counter_gap"] == {"value": 0, "limit": 0}
    assert line["attempted"] == line["syncs"] * 8 * harness.REHEARSAL_BATCH
