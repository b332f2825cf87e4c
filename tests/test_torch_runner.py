"""PyTorch port, the SNR-sweep runner, the CLI and the Profile parser
(faid_tpu_torch/sim/runner.py, cli.py, utils/profile.py) on the CPU:
the semantics of tests/test_observability.py on the toy code, and the
result tables byte for byte against faid_tpu.sim.runner's writers."""

from __future__ import annotations

import dataclasses
import enum
import json
import warnings

import numpy as np
import pytest
import torch

from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import SimConfig as JSimConfig
from faid_tpu.sim import runner as jrunner
from faid_tpu.utils import profile as jprofile
from faid_tpu_torch import MonteCarloRunner, cli
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, SimConfig
from faid_tpu_torch.ops import philox
from faid_tpu_torch.sim import runner
from faid_tpu_torch.utils import profile

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def cfg_at(**kw):
    base = dict(decode_method=DecodeMethod.FAID_DTBF, max_iteration=2,
                mod_type=2, batch_per_device=4, seed=3, fake_encode=True,
                channel_backend="fused", min_frames=8, min_frame_errors=0,
                rounds_per_sync=2)
    base.update(kw)
    return SimConfig(**base)


def make_runner(cfg, **kw):
    return MonteCarloRunner(cfg, code=toy_code(), device="cpu", **kw)


def test_runner_forensics_and_itercount(tmp_path):
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-2.0)
    r = make_runner(cfg, max_rounds_per_snr=4)
    r.run()
    assert r.results[0].err_chunks, "low SNR must produce error chunks"
    c = r.results[0].counters
    assert sum(c["mp_hist"]) == sum(c["bf_hist"]) == c["test_frames"] == 8
    r.write_itercount_txt(tmp_path / "iterCount.txt")
    txt = (tmp_path / "iterCount.txt").read_text()
    assert "mp_iters" in txt and "bf_rounds" in txt

    n = r.collect_error_frames(tmp_path, max_frames=16)
    assert 0 < n <= max(c["error_frames"], 16)
    idx = (tmp_path / "errorindex.txt").read_text().splitlines()
    assert len(idx) == n and " : b" in idx[0]
    # every dumped frame's error count is its number of listed positions
    for line in idx:
        tag, pos = line.split(" : ")
        assert tag.startswith("snr -3.00 dev 0 round ")
        assert int(tag.split("errs ")[1]) == len(pos.split())
    dec = (tmp_path / "errordecode.txt").read_text().splitlines()
    assert all(set(d.split(" : ")[1].split()) == {"1"} for d in dec)


def test_temp_txt_live_progress(tmp_path):
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-2.5)
    r = make_runner(cfg, max_rounds_per_snr=4,
                    temp_txt_path=tmp_path / "Temp.txt")
    r.run()
    row, resume = (tmp_path / "Temp.txt").read_text().splitlines()[:2]
    cols = row.split("\t")
    assert len(cols) >= 7
    assert int(cols[1]) == r.results[-1].counters["test_frames"]
    assert float(cols[4]) > 0          # FER floor: never 0
    assert "resume: seed=" in resume and "checkpoint.json" in resume


def test_errorfloat_is_the_dequantized_llr(tmp_path):
    """errorfloat.txt holds llr / scale, 6 decimals: times the scale it
    rounds back to the dumped LLR of every position."""
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-2.0)
    r = make_runner(cfg, max_rounds_per_snr=4)
    r.run()
    n = r.collect_error_frames(tmp_path, max_frames=8)
    assert n > 0
    flt = (tmp_path / "errorfloat.txt").read_text().splitlines()
    llr = (tmp_path / "errorllr.txt").read_text().splitlines()
    assert len(flt) == len(llr) == n
    for fl, ql in zip(flt, llr):
        fvals = np.array([float(x) for x in fl.split(" : ")[1].split()])
        qvals = np.array([int(x) for x in ql.split(" : ")[1].split()])
        np.testing.assert_array_equal(np.rint(fvals * cfg.scale), qvals)


def test_checkpoint_config_fingerprint(tmp_path, monkeypatch):
    """Resuming under a changed config, world size or random stream
    starts fresh; result-neutral changes keep the checkpoint."""
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-1.0)
    ck = tmp_path / "ck.json"
    r1 = make_runner(cfg, checkpoint_path=ck, max_rounds_per_snr=2)
    r1.run_snr(0, -3.0)
    r1._save_checkpoint()
    saved = json.loads(ck.read_text())
    assert saved["world_size"] == 1 and saved["stream"] == philox.STREAM_TAG

    def resumes(c, ckpt=ck):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            r = make_runner(c, checkpoint_path=ckpt, max_rounds_per_snr=2)
        fresh = r._state["round"] == 0 and r._state["snr_idx"] == 0
        assert fresh == any("fingerprint" in str(x.message) for x in w)
        return not fresh

    assert not resumes(dataclasses.replace(cfg, max_iteration=3))
    assert resumes(cfg)
    assert resumes(dataclasses.replace(cfg, min_frame_errors=999,
                                       backend="plain", rounds_per_sync=3))

    fp = runner.config_fingerprint(cfg)
    assert runner.config_fingerprint(cfg, world_size=1) == fp
    assert runner.config_fingerprint(cfg, world_size=2) != fp
    for other in (runner.config_fingerprint(cfg, world_size=2),
                  jrunner.config_fingerprint(JSimConfig(**_fields(cfg))),
                  None):
        st = dict(saved, config_fingerprint=other)
        ck2 = tmp_path / "ck2.json"
        ck2.write_text(json.dumps(st))
        assert not resumes(cfg, ck2), other
    monkeypatch.setattr(philox, "STREAM_TAG", "another-stream/v0")
    assert runner.config_fingerprint(cfg) != fp
    assert not resumes(cfg)


@pytest.mark.parametrize("backend,quant_bits,moves", [
    ("xla", 4, False), ("fused", 1, False), ("fused", 4, True)])
def test_checkpoint_device_type(tmp_path, backend, quant_bits, moves):
    """A float-chain checkpoint (channel_backend xla, or fused at 1 bit)
    belongs to the device type that drew its noise: stamped with another
    device type it starts fresh.  A quantile-channel checkpoint resumes
    on either device type, its kernels being bit-exact against their
    CPU twins."""
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-1.0,
                 channel_backend=backend, quant_bits=quant_bits)
    ck = tmp_path / "ck.json"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # fused at 1 bit warns
        r1 = make_runner(cfg, checkpoint_path=ck, max_rounds_per_snr=2)
        r1.run_snr(0, -3.0)
        r1._save_checkpoint()
    saved = json.loads(ck.read_text())
    assert saved["config_fingerprint"] == runner.config_fingerprint(
        cfg, device_type="cpu")
    assert (runner.config_fingerprint(cfg, device_type="cuda")
            == saved["config_fingerprint"]) == moves
    ck2 = tmp_path / "ck2.json"
    ck2.write_text(json.dumps(dict(saved, config_fingerprint=runner.config_fingerprint(
        cfg, device_type="cuda"))))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r2 = make_runner(cfg, checkpoint_path=ck2, max_rounds_per_snr=2)
    resumed = r2._state == r1._state and len(r2.results) == len(r1.results)
    assert resumed == moves
    assert any("device type" in str(x.message) for x in w) != moves
    assert r2._state["round"] == (r1._state["round"] if moves else 0)


def test_sweep_economics_budget():
    """max_frames_per_snr and giveup_zero_error_frames bound the work a
    deep-floor (zero-error) point can burn."""
    per_sync = 4 * 2              # batch x rounds_per_sync, one device
    cfg = cfg_at(snr_start=20.0, snr_pass=1.0, snr_end=21.0,
                 min_frame_errors=1, giveup_zero_error_frames=16)
    res = make_runner(cfg, max_rounds_per_snr=1000).run()
    assert res[0].counters["error_frames"] == 0
    assert res[0].counters["test_frames"] == 2 * per_sync

    cfg2 = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-2.0,
                  min_frame_errors=10**9, max_frames_per_snr=16)
    res2 = make_runner(cfg2, max_rounds_per_snr=1000).run()
    assert res2[0].counters["test_frames"] == 2 * per_sync


def test_resume_equals_uninterrupted(tmp_path):
    """A sweep killed mid-point and rerun on its checkpoint gives the
    counters and error chunks of one run straight through."""
    cfg = cfg_at(snr_start=-1.0, snr_pass=1.0, snr_end=1.0, min_frames=128,
                 batch_per_device=32, stop_mode="group")
    whole = make_runner(cfg).run()

    ck = tmp_path / "checkpoint.json"
    syncs = []

    def kill_after_three(snr_db, c):
        syncs.append(snr_db)
        if len(syncs) == 3:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        make_runner(cfg, checkpoint_path=ck).run(progress=kill_after_three)
    state = json.loads(ck.read_text())["state"]
    assert state["snr_idx"] == 1 and state["round"] == 2
    resumed = make_runner(cfg, checkpoint_path=ck).run()
    assert [(r.snr_db, r.counters, r.err_chunks) for r in resumed] == [
        (r.snr_db, r.counters, r.err_chunks) for r in whole]
    assert whole[0].counters["error_frames"] > 0


def _fields(cfg):
    """Port SimConfig -> keyword arguments of faid_tpu's SimConfig."""
    return {f.name: (getattr(cfg, f.name).value
                     if isinstance(getattr(cfg, f.name), enum.Enum)
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("stop_mode,batch,method", [
    ("group", 32, DecodeMethod.FAID_DTBF), ("frame", 4, DecodeMethod.FAID_DTBF),
    ("group", 32, DecodeMethod.OMS), ("group", 32, DecodeMethod.OMS_DTBF)])
def test_tables_byte_equal_to_jax(tmp_path, stop_mode, batch, method):
    """Result.txt, demod.txt, iterCount.txt (both formats) and Temp.txt's
    row written by the port and by faid_tpu from the same results are the
    same bytes: for FAID+DTBF, for OMS (no BF: a 2-bucket bf_hist, all
    zero) and for OMS+DTBF (50 BF rounds)."""
    cfg = cfg_at(snr_start=-1.0, snr_pass=1.5, snr_end=2.0, min_frames=64,
                 batch_per_device=batch, stop_mode=stop_mode,
                 max_iteration=6, decode_method=method)
    r = make_runner(cfg, temp_txt_path=tmp_path / "t_Temp.txt")
    r.run()
    assert len(r.results) == 2
    bf_hist = r.results[0].counters["bf_hist"]
    assert len(bf_hist) == max(cfg.decoder().bf.max_iter, 1) + 1
    assert (sum(bf_hist[1:]) > 0) == (method != DecodeMethod.OMS)
    j = object.__new__(jrunner.MonteCarloRunner)
    j.cfg, j.code = JSimConfig(**_fields(cfg)), jtoy_code()
    j.results = [jrunner.SnrResult(x.snr_db, x.counters, x.seconds,
                                   x.err_chunks) for x in r.results]
    writers = [("Result.txt", "write_result_txt", {}),
               ("demod.txt", "write_demod_txt", {}),
               ("iterCount.txt", "write_itercount_txt", {}),
               ("iterCount_ref.txt", "write_itercount_txt",
                {"ref_format": True})]
    for name, method_name, kw in writers:
        getattr(r, method_name)(tmp_path / f"t_{name}", **kw)
        getattr(j, method_name)(tmp_path / f"j_{name}", **kw)
        got = (tmp_path / f"t_{name}").read_bytes()
        assert got == (tmp_path / f"j_{name}").read_bytes(), name
        # the reference format lists BF rounds used only: none for OMS
        assert got or (name == "iterCount_ref.txt"
                       and method == DecodeMethod.OMS)
    assert r.report_rows() == j.report_rows()
    # Temp.txt: the in-flight row is the reference's; the resume line
    # names each package's own stream
    j.temp_txt_path, j._state = tmp_path / "j_Temp.txt", r._state
    j._write_temp_txt(r.results[-1].snr_db, r.results[-1].counters)
    got, want = ((tmp_path / f"{p}_Temp.txt").read_text().splitlines()[0]
                 for p in "tj")
    assert got == want


def test_helpers_match_jax():
    for kw in (dict(snr_start=3.6, snr_pass=0.1, snr_end=3.8),
               dict(snr_start=3.0, snr_pass=0.1, snr_end=5.0),
               dict(snr_start=-3.0, snr_pass=1.0, snr_end=-2.0),
               dict(snr_start=0.0, snr_pass=0.3, snr_end=1.0)):
        assert runner.snr_points(SimConfig(**kw)) == jrunner.snr_points(
            JSimConfig(**kw))
    hist = [64, 32, 0, 96, 0, 0, 0, 0, 0, 0, 320]
    for cap in (10, 4):
        for exact in (True, False):
            assert runner.itercount_ref_lines(hist, cap, exact) == \
                jrunner.itercount_ref_lines(hist, cap, exact)
    with pytest.raises(ValueError):
        runner.itercount_ref_lines([0, 3], 1, True)
    assert runner.COUNTER_KEYS == jrunner.COUNTER_KEYS
    assert runner.HIST_KEYS == jrunner.HIST_KEYS
    assert runner.MAX_ERR_CHUNKS == jrunner.MAX_ERR_CHUNKS


def test_parse_profile_matches_jax(tmp_path):
    jcfg = JSimConfig(snr_start=2.5, snr_pass=0.25, snr_end=4.0,
                      decode_method=4, max_iteration=8, mod_type=1,
                      interleave_depth=2, factor_1=26, factor_2=32,
                      scale=11.5, file_name="50GPON-CP12", z=256)
    path = tmp_path / "Profile.txt"
    jprofile.write_profile(jcfg, path)
    got, want = profile.parse_profile(path), jprofile.parse_profile(path)
    assert _fields(got) == _fields(want)
    assert got.decode_method == DecodeMethod.OMS_DTBF
    profile.write_profile(got, tmp_path / "Profile2.txt")
    assert (tmp_path / "Profile2.txt").read_bytes() == path.read_bytes()


CLI_ARGS = ["--method", "2", "--fake-encode", "--channel-backend", "fused",
            "--stop-mode", "group", "--batch", "32", "--snr-start", "6",
            "--snr-pass", "1", "--snr-end", "6.5", "--min-frames", "32",
            "--max-rounds", "1", "--quiet"]


def test_cli_full_code_on_cpu(tmp_path):
    """The campaign command at its smallest, on the full 50G-PON code:
    one 6 dB point, one sync of 32-frame rounds; it writes the tables and
    resumes from its checkpoint."""
    out = tmp_path / "out"
    assert cli.main([*CLI_ARGS, "--device", "cpu", "--out", str(out)]) == 0
    for name in ("Result.txt", "demod.txt", "iterCount.txt", "Temp.txt",
                 "checkpoint.json"):
        assert (out / name).exists(), name
    rows = (out / "Result.txt").read_text().splitlines()
    assert len(rows) == 2 and rows[1].split()[:2] == ["6.00", "256"]
    st = json.loads((out / "checkpoint.json").read_text())
    assert st["state"]["snr_idx"] == 1 and st["world_size"] == 1
    # a rerun resumes: no new round runs, the same table comes out
    before = (out / "Result.txt").read_bytes()
    assert cli.main([*CLI_ARGS, "--device", "cpu", "--out", str(out)]) == 0
    assert (out / "Result.txt").read_bytes() == before


def test_cli_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main([*CLI_ARGS, "--device", "cuda", "--out", out])
    assert e.value.code not in (0, None)
    # --multihost outside torchrun's environment names what is missing
    for k in cli._TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="--multihost.*RANK"):
        cli.main([*CLI_ARGS, "--device", "cpu", "--multihost", "--out", out])
    # the default float chain and 16-QAM run (tests/test_torch_qam.py);
    # an interleaver that does not divide the code's length does not
    with pytest.raises(ValueError, match="--interleave"):
        cli.main([*CLI_ARGS, "--interleave", "0", "--device", "cpu",
                  "--out", out])
    with pytest.raises(ValueError, match="interleaver rows"):
        cli.main([*CLI_ARGS, "--mod-type", "4", "--interleave", "5",
                  "--device", "cpu", "--out", out])


def test_cli_trace_dir(tmp_path, monkeypatch):
    """--trace-dir writes a torch.profiler chrome trace of the first SNR
    point, then the sweep goes on (the toy code keeps the trace small)."""
    monkeypatch.setattr(runner, "load_code", lambda name: toy_code())
    out, trace = tmp_path / "out", tmp_path / "trace"
    args = [a if a != "6.5" else "7.5" for a in CLI_ARGS]   # points 6 and 7 dB
    assert cli.main([*args, "--device", "cpu", "--trace-dir", str(trace),
                     "--out", str(out)]) == 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    rows = (out / "Result.txt").read_text().splitlines()[1:]
    assert [r.split()[0] for r in rows] == ["6.00", "7.00"]
