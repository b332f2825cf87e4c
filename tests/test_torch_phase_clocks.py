"""The decoder kernel's phase clocks (faid_tpu_torch/csrc/decoder.cuh):
kernels B and F add each block's SM cycles of the prologue, MP and the BF
tail to their device's [3] int64 tensor (utils/kernels.py
``phase_clocks``), and the runner adds each sync's cycles to the sync's
record as the counters ``decoder.prologue_cycles``, ``.mp_cycles`` and
``.tail_cycles``, apart from the statistics it sums and checkpoints.

On the CPU: the plain path counts no cycles and the runner's statistics
gain no key; the runner's differences of a stand-in clock that its loop
advances, what ran before the point left out; no clocks for the CPU.
The cases marked ``cuda`` need an NVIDIA GPU and skip without one: there
F and B count positive prologue and MP cycles, tail cycles only where a
tail ran, never fewer across launches, D and E count none, and a round
launches what it launched before.  This file imports no JAX, so on the card it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_phase_clocks.py
"""

from __future__ import annotations

import collections
import dataclasses

import pytest
import torch

from faid_tpu_torch import MonteCarloRunner, load_code, sigma_for
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, SimConfig
from faid_tpu_torch.ops import cuda_channel as cc
from faid_tpu_torch.ops import cuda_decoder as cd
from faid_tpu_torch.ops import cuda_sim as cs
from faid_tpu_torch.sim import pipeline
from faid_tpu_torch.sim import runner as runner_mod
from faid_tpu_torch.utils import kernels, trace

SEED = 2026201
BATCH = 2048
KEYS = set(runner_mod.COUNTER_KEYS) | set(runner_mod.HIST_KEYS)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def store(monkeypatch):
    """An empty store of records for each test."""
    monkeypatch.setattr(trace, "_store", collections.deque(maxlen=trace.KEEP))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase clocks run in the decoder kernels")
    return torch.device("cuda", torch.cuda.current_device())


def _cfg(method=DecodeMethod.OMS_BF, **kw) -> SimConfig:
    base = dict(decode_method=method, max_iteration=6, mod_type=2, quant_bits=4,
                scale=13.0, batch_per_device=32, fake_encode=True,
                channel_backend="fused", stop_mode="group", seed=SEED,
                min_frame_errors=0, rounds_per_sync=1, snr_start=3.0,
                snr_pass=1.0, snr_end=3.5)
    base.update(kw)
    return SimConfig(**base)


def _runner(tmp_path, cfg, syncs, code, device) -> MonteCarloRunner:
    cfg = dataclasses.replace(
        cfg, min_frames=cfg.batch_per_device * cfg.rounds_per_sync * syncs)
    return MonteCarloRunner(cfg, code=code, device=device,
                            checkpoint_path=tmp_path / "checkpoint.json",
                            temp_txt_path=tmp_path / "Temp.txt")


def _cycles(rec) -> list:
    return [rec["counters"].get(name) for name in runner_mod.PHASE_COUNTERS]


# ---- the CPU -----------------------------------------------------------------

def test_the_counters_name_the_kernels_phases():
    assert kernels.PHASES == ("prologue", "mp", "tail")
    assert runner_mod.PHASE_COUNTERS == ("decoder.prologue_cycles", "decoder.mp_cycles",
                                         "decoder.tail_cycles")


@pytest.mark.parametrize("device", ["cpu", "cpu_device", "cpu_tensor", "meta"])
def test_no_clocks_but_a_cuda_devices(device):
    """The CPU's plain twins count no cycles: no clocks; a device with
    neither kernels nor twins is refused, as the wrappers refuse it."""
    if device == "meta":
        with pytest.raises(ValueError, match="meta"):
            kernels.phase_clocks(torch.device("meta"))
        return
    arg = {"cpu": "cpu", "cpu_device": torch.device("cpu"),
           "cpu_tensor": torch.zeros(1)}[device]
    assert kernels.phase_clocks(arg) is None


@pytest.mark.parametrize("case", ["fused_sim", "stats_decoder"])
def test_the_plain_path_counts_no_cycles(tmp_path, case):
    """Kernel F's twin (the zero word) and kernel B's (16-QAM codewords):
    no record carries a decoder counter, and the runner's statistics keep
    their keys."""
    kw = {} if case == "fused_sim" else dict(fake_encode=False, mod_type=4, snr_start=8.0,
                                             snr_end=8.5)
    r = _runner(tmp_path, _cfg(**kw), 3, toy_code(), "cpu")
    seen = []
    r.run_point(progress=lambda snr, c: seen.append(set(c)))
    recs = trace.recent()
    assert len(recs) == 3
    assert not any(k.startswith("decoder.") for x in recs for k in x["counters"])
    assert seen == [KEYS] * 3 and set(r.results[-1].counters) == KEYS
    assert "cycles" not in (tmp_path / "checkpoint.json").read_text()


def test_the_runner_counts_each_syncs_cycles(tmp_path, monkeypatch):
    """A stand-in for a device's clocks, which held (5, 5, 5) when the
    runner was built, gained (7, 7, 7) before its point (a warm-up's
    launches) and which the loop advances by (1, 10, 100) x the sync's
    number: each record holds its own sync's cycles, and the statistics
    keep their keys."""
    clocks = torch.full((3,), 5, dtype=torch.int64)
    build = runner_mod.build_sharded_sim_loop

    def clocked(*args, **kwargs):
        inner, calls = build(*args, **kwargs), []

        def loop(seed, sigma, round0):
            calls.append(round0)
            clocks.add_(torch.tensor([1, 10, 100]) * len(calls))
            return inner(seed, sigma, round0)

        return loop

    monkeypatch.setattr(runner_mod, "build_sharded_sim_loop", clocked)
    monkeypatch.setattr(kernels, "phase_clocks", lambda device: clocks)
    r = _runner(tmp_path, _cfg(), 4, toy_code(), "cpu")
    clocks.add_(7)
    seen = []
    r.run_point(progress=lambda snr, c: seen.append(set(c)))
    assert [_cycles(x) for x in trace.recent()] == [
        [k, 10 * k, 100 * k] for k in range(1, 5)]
    assert seen == [KEYS] * 4 and set(r.results[-1].counters) == KEYS


# ---- the card ----------------------------------------------------------------

def _round(code, method, snr, device, stop_mode="group"):
    """The configuration, its tables, the thresholds on the device and
    kernel A's LLRs of round 1 at ``snr``."""
    cfg = _cfg(method, batch_per_device=BATCH, stop_mode=stop_mode)
    params = cc.threshold_ints(cfg, sigma_for(cfg, snr)).to(device)
    llr = cc.quantile_channel(params, seed=SEED, rnd=1, batch=BATCH, n_var=code.n_var,
                              n_info=code.n_info, mod_type=2, quant_bits=4)[0]
    return cd.decoder_tables(code, cfg.decoder(), device), params, llr


def _launch(kernel, tables, params, llr):
    """One launch of F or B: (mp_iters, bf_rounds, what it added to the
    device's clocks)."""
    clocks = kernels.phase_clocks(params.device)
    start = clocks.tolist()
    if kernel == "F":
        out = cs.fused_sim(params, tables, seed=SEED, rnd=1, batch=BATCH, mod_type=2,
                           quant_bits=4)
        iters, rounds = out["mp_iters"], out["bf_rounds"]
    else:
        _, iters, rounds = cd.stats_decode(llr, tables)
    return iters, rounds, [b - a for a, b in zip(start, clocks.tolist())]


@pytest.mark.cuda
@pytest.mark.parametrize("stop_mode", ["group", "frame"])
@pytest.mark.parametrize("kernel", ["F", "B"])
def test_tails_count_where_they_ran(cuda, kernel, stop_mode):
    """OMS+BF on 50G-PON: at 3.6 dB words run the static tail, and the
    tail's cycles are positive; at 6 dB MP decodes every frame before
    its last iteration, and the tail counts 0.  Prologue and MP count
    positive cycles in both."""
    code = load_code("50gpon")
    for snr, tails in ((3.6, True), (6.0, False)):
        tables, params, llr = _round(code, DecodeMethod.OMS_BF, snr, cuda, stop_mode)
        iters, rounds, (pro, mp, tail) = _launch(kernel, tables, params, llr)
        assert pro > 0 and mp > 0, (snr, pro, mp)
        if tails:
            assert int((rounds > 0).sum()) > 0 and tail > 0
        else:
            assert int(iters.max()) < tables.dcfg.max_iter and tail == 0


@pytest.mark.cuda
def test_the_clocks_only_grow_and_d_and_e_count_none(cuda):
    """Three launches of F and B: each adds positive cycles to every phase
    of the device's one tensor; kernels D (OMS+BF) and E (OMS) leave it as
    it was."""
    code = load_code("50gpon")
    tables, params, llr = _round(code, DecodeMethod.OMS_BF, 3.6, cuda)
    clocks = kernels.phase_clocks(cuda)
    assert clocks is kernels.phase_clocks(torch.device("cuda"))
    last = clocks.tolist()
    for _ in range(3):
        cs.fused_sim(params, tables, seed=SEED, rnd=1, batch=BATCH, mod_type=2,
                     quant_bits=4)
        cd.stats_decode(llr, tables)
        now = clocks.tolist()
        assert all(b > a for a, b in zip(last, now)), (last, now)
        last = now
    oms = cd.decoder_tables(code, _cfg(DecodeMethod.OMS).decoder(), cuda)
    cd.full_decode(llr, tables)
    cd.mp_decode(llr, oms)
    assert clocks.tolist() == last


@pytest.mark.cuda
@pytest.mark.parametrize("method,mod_type,launched", [
    (DecodeMethod.OMS_BF, 2, {"F": 1}),
    (DecodeMethod.FAID_DTBF, 4, {"M": 1, "G": 1, "B": 1})])
def test_a_round_launches_what_it_did(cuda, method, mod_type, launched):
    """A round of the pipeline launches its own kernels once each and no
    other (no kernel resets the clocks), and its decoder adds to the
    device's clocks."""
    code = load_code("50gpon")
    cfg = _cfg(method, batch_per_device=BATCH, mod_type=mod_type,
               fake_encode=mod_type == 2, interleave_depth=1 if mod_type == 2 else 2)
    step = pipeline.build_sim_step(code, cfg, cuda)
    sigma = sigma_for(cfg, 3.6 if mod_type == 2 else 7.5)
    clocks = kernels.phase_clocks(cuda)
    step(SEED, 1, sigma)
    before, last = kernels.launches.copy(), clocks.tolist()
    out = step(SEED, 2, sigma)
    torch.cuda.synchronize(cuda)
    got = kernels.launches.copy()
    got.subtract(before)
    assert +got == collections.Counter(launched)
    assert int(out["test_frames"]) == BATCH
    assert all(b > a for a, b in zip(last[:2], clocks.tolist()[:2]))


@pytest.mark.cuda
def test_the_runner_records_the_devices_cycles(tmp_path, cuda):
    """The runner on the card (the toy code, kernel F): every record holds
    the three counters, prologue and MP positive, and together they are
    what the device's clocks gained."""
    code = toy_code()
    r = _runner(tmp_path, _cfg(DecodeMethod.OMS_BF, batch_per_device=64), 4, code, cuda)
    clocks = kernels.phase_clocks(cuda)
    start = clocks.tolist()
    r.run_point()
    recs = trace.recent()
    assert len(recs) == 4
    cycles = [_cycles(x) for x in recs]
    assert all(c[0] > 0 and c[1] > 0 and c[2] >= 0 for c in cycles)
    assert [sum(c[i] for c in cycles) for i in range(3)] == [
        b - a for a, b in zip(start, clocks.tolist())]
    assert set(r.results[-1].counters) == KEYS
