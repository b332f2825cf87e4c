"""PyTorch port, the sharded Monte-Carlo round (faid_tpu_torch/
parallel/mesh.py), the runner in a world of several ranks and the CLI's
--multihost, on the CPU: worlds of 2 and 4 processes over gloo
(tests/_torch_dist.py, which imports no JAX), on the toy code.

The exact check: rank r of W draws frames r*b .. (r+1)*b - 1 of each
round, so W ranks at batch b count what one rank counts at batch W*b,
counter for counter.  Against faid_tpu.parallel.mesh, whose devices draw
other random streams, the check is statistical."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import SimConfig as JSimConfig
from faid_tpu.parallel import mesh as jmesh
from faid_tpu_torch import (MonteCarloRunner, build_debug_step,
                            build_sharded_sim_loop, build_sharded_sim_step,
                            build_sim_loop, build_sim_step, cli, make_mesh)
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.parallel import mesh
from faid_tpu_torch.sim import runner

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

B = 32                      # frames a rank: one 32-frame word
ROUNDS, ROUND0, SEED = 2, 3, 11
CHANNELS = {                # (fields, an SNR of the toy code's waterfall)
    "qpsk": (dict(channel_backend="fused", mod_type=2), 2.0),
    "float": (dict(channel_backend="xla", mod_type=2), 2.0),
    "qam16": (dict(channel_backend="fused", mod_type=4, interleave_depth=2),
              6.0),
}
CASES = [(ch, enc, stop) for ch in CHANNELS for enc in ("fake", "real")
         for stop in ("group", "frame")]
IDS = ["-".join(c) for c in CASES]
WORLD_TIMEOUT_S = 120


def fields(ch, enc, stop, batch, **kw):
    return dict(decode_method=2, max_iteration=6, batch_per_device=batch,
                seed=SEED, fake_encode=enc == "fake", stop_mode=stop,
                **CHANNELS[ch][0], **kw)


def py(stats):
    return {k: v.tolist() for k, v in stats.items()}


def add(a, b):
    return {k: [x + y for x, y in zip(a[k], b[k])] if isinstance(a[k], list)
            else a[k] + b[k] for k in a}


@pytest.mark.parametrize("ch,enc,stop", CASES, ids=IDS)
def test_frame0_slices_a_round(ch, enc, stop):
    """A step at batch 2b is the sum of the steps at b with frame0 0 and
    b, and the replay at frame0 b is the second half's frames."""
    code = toy_code()
    whole, half = (td.sim_config(fields(ch, enc, stop, n)) for n in (2 * B, B))
    sigma = whole.sigma_at(CHANNELS[ch][1])
    want = py(build_sim_step(code, whole, "cpu")(SEED, 5, sigma))
    got = [py(build_sim_step(code, half, "cpu", frame0=f0)(SEED, 5, sigma))
           for f0 in (0, B)]
    assert add(*got) == want
    assert 0 < want["error_frames"] < 2 * B and got[0] != got[1]
    full = build_debug_step(code, whole, "cpu")(SEED, 5, sigma)
    second = build_debug_step(code, half, "cpu", frame0=B)(SEED, 5, sigma)
    for k in ("err_bits", "llr", "cw", "soft"):
        assert torch.equal(second[k], full[k][B:]), k
    assert int(second["err_bits"].sum()) == got[1]["error_bits"]


def loop_specs():
    return [{"name": "-".join(c), "code": "toy", "cfg": fields(*c, B),
             "rounds": ROUNDS, "snr": CHANNELS[c[0]][1], "round0": ROUND0}
            for c in CASES]


RUNNER_FIELDS = fields("qpsk", "real", "group", B, snr_start=1.0,
                       snr_pass=1.0, snr_end=2.5, min_frames=4 * B,
                       rounds_per_sync=2)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One world of 2 ranks: every loop case, then the runner's sweep."""
    out = tmp_path_factory.mktemp("world2")
    spec = {"device": "cpu", "out": str(out), "loops": loop_specs(),
            "runner": {"code": "toy", "cfg": RUNNER_FIELDS, "max_rounds": 8,
                       "collect": True}}
    return out, td.launch(spec, 2, WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("world4")
    spec = {"device": "cpu", "out": str(out), "loops": loop_specs()}
    return out, td.launch(spec, 4, WORLD_TIMEOUT_S)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("ch,enc,stop", CASES, ids=IDS)
def test_sharded_loop_equals_one_rank(request, world, ch, enc, stop):
    """Every rank's counters equal the one-rank loop's at batch W*b."""
    _, results = request.getfixturevalue(f"world{world}")
    cfg = td.sim_config(fields(ch, enc, stop, world * B))
    want = py(build_sim_loop(toy_code(), cfg, ROUNDS, "cpu")(
        SEED, cfg.sigma_at(CHANNELS[ch][1]), ROUND0))
    assert [r["rank"] for r in results] == list(range(world))
    for r in results:
        assert r["size"] == world
        assert r["loops"]["-".join((ch, enc, stop))]["counters"] == want


def _rows(path):
    return td.result_rows(Path(path).read_text())


def _one_rank_runner(out, batch):
    cfg = td.sim_config(dict(RUNNER_FIELDS, batch_per_device=batch))
    out.mkdir(parents=True, exist_ok=True)
    return MonteCarloRunner(cfg, code=toy_code(), device="cpu",
                            checkpoint_path=out / "checkpoint.json",
                            max_rounds_per_snr=8)


def test_runner_world2_equals_world1(world2, tmp_path):
    """The W = 2 sweep's tables equal the W = 1 sweep's at 2b (all but
    Time(s)); rank 0 alone wrote files; its dump replays both ranks'
    slices, dev d frame f being frame d*b + f of the W = 1 dump; the
    rerun resumed from rank 0's checkpoint on both ranks."""
    out, results = world2
    r1 = _one_rank_runner(tmp_path / "w1", 2 * B)
    r1.run()
    r1.write_result_txt(tmp_path / "w1" / "Result.txt")
    r1.write_demod_txt(tmp_path / "w1" / "demod.txt")
    r1.write_itercount_txt(tmp_path / "w1" / "iterCount.txt")
    n1 = r1.collect_error_frames(tmp_path / "w1")
    w2 = out / "rank0"
    assert not (out / "rank1").exists()
    assert _rows(w2 / "Result.txt") == _rows(tmp_path / "w1" / "Result.txt")
    assert len(_rows(w2 / "Result.txt")) == 3
    for name in ("demod.txt", "iterCount.txt"):
        assert (w2 / name).read_bytes() == (tmp_path / "w1" / name).read_bytes()
    lead, other = (r["runner"] for r in results)
    assert lead["dumped"] == n1 > 0 and other["dumped"] == 0
    assert lead["counters"] == other["counters"] == [
        res.counters for res in r1.results]
    for name in ("errorindex.txt", "errordecode.txt", "errorllr.txt",
                 "errorfloat.txt"):
        assert td.dump_as_world1((w2 / name).read_text(), B) == (
            tmp_path / "w1" / name).read_text().splitlines()
    assert {ln.split()[3] for ln in (w2 / "errorindex.txt").read_text()
            .splitlines()} == {"0", "1"}
    for r in (lead, other):
        assert r["resume_calls"] == 0
        assert r["resumed_counters"] == r["counters"]


def test_world2_checkpoint_starts_fresh_at_world1(world2):
    """The fingerprint hashes the world size: a W = 2 checkpoint does not
    resume a W = 1 run of the same batch."""
    out, _ = world2
    st = json.loads((out / "rank0" / "checkpoint.json").read_text())
    assert st["world_size"] == 2 and st["state"]["snr_idx"] == 2
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r = MonteCarloRunner(td.sim_config(RUNNER_FIELDS), code=toy_code(),
                             device="cpu",
                             checkpoint_path=out / "rank0" / "checkpoint.json")
    assert r._state["snr_idx"] == 0 and not r.results
    assert any("fingerprint" in str(x.message) for x in w)


CLI_ARGV = ["--method", "2", "--fake-encode", "--channel-backend", "fused",
            "--stop-mode", "group", "--snr-start", "1", "--snr-pass", "1",
            "--snr-end", "2.5", "--min-frames", str(4 * B), "--max-rounds", "4",
            "--seed", "3", "--collect-errors", "--quiet"]


def test_cli_multihost_under_torchrun(tmp_path, monkeypatch):
    """python -m torch.distributed.run --nproc-per-node 2 -m
    faid_tpu_torch.cli --multihost --device cpu on the toy code: rank 0
    alone writes the files (each rank is given its own --out), and its
    tables equal the one-process CLI's at twice the batch."""
    spec = {"device": "cpu", "out": str(tmp_path / "mh"), "cli": {
        "toy": True, "argv": [*CLI_ARGV, "--batch", str(B), "--multihost",
                              "--device", "cpu"]}}
    results = td.launch(spec, 2, WORLD_TIMEOUT_S, torchrun=True)
    assert [r["cli"]["rc"] for r in results] == [0, 0]
    lead = tmp_path / "mh" / "rank0"
    assert not (tmp_path / "mh" / "rank1").exists()
    names = {p.name for p in lead.iterdir()}
    assert {"Result.txt", "demod.txt", "iterCount.txt", "Temp.txt",
            "checkpoint.json", "errorindex.txt"} <= names
    monkeypatch.setattr(runner, "load_code", lambda name: toy_code())
    one = tmp_path / "one"
    assert cli.main([*CLI_ARGV, "--batch", str(2 * B), "--device", "cpu",
                     "--out", str(one)]) == 0
    assert _rows(lead / "Result.txt") == _rows(one / "Result.txt")
    for name in ("demod.txt", "iterCount.txt"):
        assert (lead / name).read_bytes() == (one / name).read_bytes()


def test_multihost_fails_without_its_world(tmp_path):
    """--multihost exits non-zero within --dist-timeout, and does not
    hang, when the other ranks never come: as rank 0 (the store's host)
    and as rank 1 (no store to reach)."""
    env = dict(os.environ, PYTHONPATH=str(td.REPO), WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "faid_tpu_torch.cli", *CLI_ARGV, "--batch",
         str(B), "--multihost", "--device", "cpu", "--dist-timeout", "2",
         "--out", str(tmp_path / f"r{rank}")],
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank),
                 MASTER_PORT=str(td.free_port())),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    t0 = time.monotonic()
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert time.monotonic() - t0 < 60
    for p, (_, err) in zip(procs, outs):
        assert p.returncode not in (0, None)
        assert "could not join the gloo world" in err, err[-2000:]


def test_make_mesh_without_a_group():
    assert make_mesh("cpu") == mesh.Mesh(0, 1, torch.device("cpu"))
    assert make_mesh().device == torch.device("cuda")


def test_one_all_reduce_per_call(monkeypatch):
    """The sharded loop packs the 9 counters and 2 histograms into one
    int64 tensor and reduces it once per call, whatever the rounds, and so
    does the sharded step; at size 1 the loop makes no collective call and
    is build_sim_loop.  The sums wrap as int32 sums do."""
    calls = []

    def fake_all_reduce(t):
        calls.append(t.clone())
        t.mul_(2)                      # the other rank counted the same

    monkeypatch.setattr(mesh.dist, "all_reduce", fake_all_reduce)
    code = toy_code()
    cfg = td.sim_config(fields("qpsk", "fake", "group", B))
    sigma = cfg.sigma_at(2.0)
    one = build_sharded_sim_loop(code, cfg, mesh.Mesh(0, 1, torch.device("cpu")),
                                 3)(SEED, sigma, 0)
    assert not calls
    assert py(one) == py(build_sim_loop(code, cfg, 3, "cpu")(SEED, sigma, 0))
    got = build_sharded_sim_loop(code, cfg, mesh.Mesh(1, 2, torch.device("cpu")),
                                 3)(SEED, sigma, 0)
    dcfg = cfg.decoder()
    assert len(calls) == 1 and calls[0].dtype == torch.int64
    assert calls[0].numel() == 9 + dcfg.max_iter + 1 + max(dcfg.bf.max_iter, 1) + 1
    mine = build_sim_loop(code, cfg, 3, "cpu", frame0=B)(SEED, sigma, 0)
    for k, v in mine.items():
        assert got[k].dtype == torch.int32 and got[k].shape == v.shape
        assert torch.equal(got[k], v * 2), k
    step = build_sharded_sim_step(code, cfg, mesh.Mesh(1, 2, torch.device("cpu")))
    got = step(SEED, 4, sigma)
    assert len(calls) == 2
    assert py(got) == py({k: v * 2 for k, v in build_sim_step(
        code, cfg, "cpu", frame0=B)(SEED, 4, sigma).items()})
    big = {"a": torch.tensor(2**31 - 5, dtype=torch.int32),
           "h": torch.tensor([1, 2], dtype=torch.int32)}
    out = mesh.all_reduce_counters(big)
    assert out["a"].item() == (big["a"] + big["a"]).item() < 0
    assert out["h"].tolist() == [2, 4]


def test_world_frames_stay_in_the_stream():
    """Frames are uint32 in the stream: the last rank of the largest
    world starts at 2^32 - b; one frame more is refused."""
    code = toy_code()
    cfg = td.sim_config(fields("qpsk", "real", "group", B))
    cpu = torch.device("cpu")
    top = 2**32 // B
    build_sharded_sim_loop(code, cfg, mesh.Mesh(top - 1, top, cpu), 1)
    last = build_sim_step(code, cfg, "cpu", frame0=2**32 - B)(SEED, 0, 1.0)
    assert int(last["test_frames"]) == B and int(last["mod_error_bits"]) > 0
    with pytest.raises(ValueError, match="2\\^32"):
        build_sharded_sim_loop(code, cfg, mesh.Mesh(0, top + 1, cpu), 1)
    with pytest.raises(ValueError, match="uint32"):
        build_sim_step(code, cfg, "cpu", frame0=2**32 - B + 1)
    with pytest.raises(ValueError, match="uint32"):
        build_debug_step(code, cfg, "cpu", frame0=2**32)


def test_statistically_equal_to_jax_mesh():
    """faid_tpu.parallel.mesh on the 8-device CPU mesh (toy code, xla
    backend) against the port's one-rank loop over the same number of
    frames: the same counter keys, dtypes and histogram lengths, equal
    test_frames; every frame in error at -6 dB and none at 12 dB in
    both; and the FER within |z| <= 4 at a waterfall point."""
    jm = jmesh.make_mesh()
    assert jm.size == 8
    rounds, b = 4, 32
    jcfg = JSimConfig(decode_method=2, max_iteration=6, mod_type=2,
                      batch_per_device=b, seed=SEED, fake_encode=True,
                      channel_backend="xla", stop_mode="group")
    jloop = jmesh.build_sharded_sim_loop(jtoy_code(), jcfg, jm, rounds,
                                         backend="xla")
    cfg = td.sim_config(fields("float", "fake", "group", jm.size * b))
    loop = build_sim_loop(toy_code(), cfg, rounds, "cpu")
    key = jax.random.key(SEED)
    for snr in (-6.0, 12.0, 2.0):
        want = {k: np.asarray(v) for k, v in jax.device_get(
            jloop(key, jnp.float32(jcfg.sigma_at(snr)), jnp.int32(0))).items()}
        got = loop(SEED, cfg.sigma_at(snr), 0)
        assert set(got) == set(want)
        for k, v in got.items():
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
            assert tuple(v.shape) == want[k].shape, k
        n = int(got["test_frames"])
        assert n == int(want["test_frames"]) == jm.size * b * rounds
        e1, e2 = int(got["error_frames"]), int(want["error_frames"])
        if snr == -6.0:
            assert e1 == e2 == n
        elif snr == 12.0:
            assert e1 == e2 == 0
        else:
            p = (e1 + e2) / (2 * n)
            z = (e1 - e2) / n / np.sqrt(2 * p * (1 - p) / n)
            assert 0 < p < 1 and abs(z) <= 4, (e1, e2, z)
