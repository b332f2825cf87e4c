"""PyTorch port, the throughput benchmark (faid_tpu_torch/bench.py) on
the CPU, on the toy code: its JSON line, its baseline file (written only
under --update-baseline, keyed by the whole workload) and its flags,
which are bench.py's with bench.py's defaults plus --device."""

from __future__ import annotations

import json

import pytest
import torch

from faid_tpu_torch import bench, load_code
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.ops import cuda_sim

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

KEYS = {"metric", "value", "unit", "vs_baseline", "encode",
        "baseline_same_workload", "device"}


def _args(*argv):
    return bench.build_argparser().parse_args(["--batch", "32", *argv])


@pytest.mark.parametrize("encode", ["fake", "random"])
def test_run_and_line_on_the_toy_code(tmp_path, monkeypatch, encode):
    """bench.run times queued build_sim_loop calls; the line carries the
    port's own metric, Mbit/s, and a null vs_baseline where no entry
    exists, and nothing is written unless --update-baseline; then the
    entry it wrote compares like with like."""
    monkeypatch.setattr(bench, "BASELINE_PATH", tmp_path / "untouched.json")
    args = _args("--encode", encode)
    cfg = bench.bench_config(args)
    assert cfg.fake_encode == (encode == "fake")
    m = bench.run(toy_code(), cfg, rounds=2, calls=3, snr=2.0, device="cpu")
    assert m["frames"] == 32 * 2 * 3 == m["stats"]["test_frames"]
    assert m["device_s"] == m["wall_s"] > 0
    assert m["mbit_s"] == pytest.approx(m["frames"] * 64 / m["device_s"] / 1e6)
    assert 0 < m["stats"]["error_frames"] < m["frames"]
    dev = bench.card("cpu")
    assert dev == {"name": "cpu", "power_limit": None}
    base = tmp_path / "baseline.json"
    line = bench.result_line(m, cfg, 2.0, encode, dev, base)
    assert set(line) == KEYS and line["unit"] == "Mbit/s"
    assert line["metric"] == bench.METRIC != (
        "decoded_info_throughput_faid_dtbf_qpsk_4dB")
    assert line["vs_baseline"] is None and line["baseline_same_workload"] is None
    assert line["encode"] == encode and line["value"] == round(m["mbit_s"], 3)
    assert not base.exists() and not (tmp_path / "untouched.json").exists()
    json.dumps(line)

    bench.result_line(m, cfg, 2.0, encode, dev, base, update=True)
    entry, = json.loads(base.read_text())["baselines"].values()
    assert entry == {"value": m["mbit_s"], "device": "cpu", "power_limit": None}
    again = bench.result_line(dict(m, mbit_s=m["mbit_s"] / 2), cfg, 2.0,
                              encode, dev, base)
    assert again["vs_baseline"] == 0.5
    # another workload (here: another SNR) has no baseline
    assert bench.result_line(m, cfg, 3.0, encode, dev, base)[
        "vs_baseline"] is None


def test_flags_are_bench_py_s():
    a = bench.build_argparser().parse_args([])
    assert (a.batch, a.rounds, a.calls, a.snr, a.method, a.backend, a.channel,
            a.stop_mode, a.encode, a.update_baseline, a.device) == (
        2048, 25, 8, 4.0, 2, "auto", "fused", "group", "fake", False, "cuda")
    cfg = bench.bench_config(a)
    assert cfg.mod_type == 2 and cfg.max_iteration == 6
    assert cuda_sim.supports_sim(load_code("50gpon"), cfg)


def test_committed_baselines_name_the_card():
    """Every committed entry names its card and power limit, and its key
    the whole workload."""
    base = json.loads(bench.BASELINE_PATH.read_text())
    assert base["metric"] == bench.METRIC and base["unit"] == "Mbit/s"
    assert {k.split()[0] for k in base["baselines"]} == {"encode=fake",
                                                         "encode=random"}
    for key, e in base["baselines"].items():
        assert [w.split("=")[0] for w in key.split()[:6]] == [
            "encode", "channel", "stop_mode", "method", "batch", "snr"]
        assert key.endswith(f"device={e['device']}") and "H100" in e["device"]
        assert e["power_limit"].endswith("W") and e["value"] > 0


def test_no_gpu_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code not in (0, None)
