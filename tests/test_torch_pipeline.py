"""PyTorch port, Monte-Carlo round (faid_tpu_torch/sim/pipeline.py): the
port's step with the channel's words injected from numpy against the
JAX composition staircase -> reduce_mod_stats ->
build_stats_decoder(xla) -> the counter formulas of build_sim_step."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code.qc_matrix import load_code as jload_code
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import SimConfig as JSimConfig
from faid_tpu.decoders.core import build_stats_decoder as jbuild_stats
from faid_tpu.ops import pallas_channel as pc
from faid_tpu.sim.pipeline import _histogram as jhistogram
from faid_tpu_torch import build_sim_loop, build_sim_step, sigma_for
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, SimConfig
from faid_tpu_torch.convert import code_from_arrays
from faid_tpu_torch.ops import cuda_channel, cuda_decoder, philox
from faid_tpu_torch.sim import pipeline

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


SCALARS = ("test_frames", "error_bits", "error_frames", "lt3_frames",
           "mod_error_bits", "mod_error_symbols", "mod_error_frames",
           "mp_iters", "bf_rounds")


def _cfg(cls, batch, stop_mode="group", **kw):
    base = dict(decode_method=2, max_iteration=6, mod_type=2,
                batch_per_device=batch, fake_encode=True,
                channel_backend="fused", stop_mode=stop_mode, seed=7)
    base.update(kw)
    return cls(**base)


def _py(stats):
    return {k: v.tolist() for k, v in stats.items()}


def _jax_round(jcode, jcfg, ix, params, jstats):
    """The JAX composition of one round on the words ``ix``."""
    n_info = jcode.n_info
    llr, err = pc.staircase(jnp.asarray(ix), jnp.zeros(ix.shape, jnp.int32),
                            jnp.asarray(params), jcfg.quant_bits)
    mb, ms = pc.reduce_mod_stats(err, n_info, jcfg.mod_type)
    out = {k: np.asarray(v) for k, v in jstats(llr).items()}
    mb, ms = np.asarray(mb), np.asarray(ms)
    err_bits = out["err_bits"]
    frame_err = err_bits > 0
    dcfg = jcfg.decoder()
    counters = {
        "test_frames": ix.shape[0],
        "error_bits": int(err_bits.sum()),
        "error_frames": int(frame_err.sum()),
        "lt3_frames": int((frame_err & (err_bits < 3)).sum()),
        "mod_error_bits": int(mb.sum()),
        "mod_error_symbols": int(ms.sum()),
        "mod_error_frames": int((mb > 0).sum()),
        "mp_iters": int(out["mp_iters"].sum()),
        "bf_rounds": int(out["bf_rounds"].sum()),
        "mp_hist": np.asarray(jhistogram(jnp.asarray(out["mp_iters"]),
                                         dcfg.max_iter + 1)).tolist(),
        "bf_hist": np.asarray(jhistogram(jnp.asarray(out["bf_rounds"]),
                                         dcfg.bf.max_iter + 1)).tolist(),
    }
    return counters, out


def _inject(monkeypatch, words):
    """Make the port's channel draw ``words[rnd]`` instead of Philox."""
    def fake(seed, rnd, frame0, batch, n_bits, device):
        assert frame0 == 0 and words[rnd].shape == (batch, n_bits)
        return torch.from_numpy(words[rnd]).to(device)

    monkeypatch.setattr(philox, "channel_words", fake)


def _words(rng, batch, n):
    return rng.integers(-2**31, 2**31, (batch, n), dtype=np.int64).astype(
        np.int32)


def _compare(monkeypatch, rng, jcode, batch, snr, stop_mode):
    code = code_from_arrays(jcode.name, jcode.z, jcode.n_var, jcode.n_chk,
                            jcode.block_cols_np, jcode.shifts_np,
                            jcode.degrees_np, puncture_tail=jcode.puncture_tail)
    cfg = _cfg(SimConfig, batch, stop_mode)
    jcfg = _cfg(JSimConfig, batch, stop_mode)
    sigma = sigma_for(cfg, snr)
    words = {3: _words(rng, batch, code.n_var)}
    _inject(monkeypatch, words)
    got = _py(build_sim_step(code, cfg, "cpu")(0, 3, sigma))
    # Both sides use the port's thresholds: the threshold sets of the two
    # packages agree only within float32 error (test_torch_channel.py).
    params = cuda_channel.threshold_ints(cfg, sigma).numpy()
    jstats = jbuild_stats(jcode, jcfg.decoder(), backend="xla")
    # Op by op rather than jitted: the full-code jit compile takes ~6
    # CPU-minutes, eager execution ~1.3 for the same integer results.
    with jax.disable_jit():
        want, per_frame = _jax_round(jcode, jcfg, words[3], params, jstats)
    assert got == want
    assert got["bf_rounds"] > 0 and got["mod_error_bits"] > 0
    return code, cfg, words, per_frame


@pytest.mark.parametrize("stop_mode", ["group", "frame"])
def test_step_matches_jax_composition_toy(monkeypatch, rng, stop_mode):
    _compare(monkeypatch, rng, jtoy_code(), 64, 2.0, stop_mode)


def test_step_matches_jax_composition_full_code(monkeypatch, rng):
    """Full 50G-PON code, one 32-frame word at 3.6 dB; also holds the
    port's per-frame stats decoder outputs against
    build_stats_decoder(xla) on the same LLRs."""
    code, cfg, words, want = _compare(monkeypatch, rng, jload_code("50gpon"),
                                      32, 3.6, "group")
    params = cuda_channel.threshold_ints(cfg, sigma_for(cfg, 3.6))
    llr, _, _ = cuda_channel.quantile_channel(
        params, seed=0, rnd=3, batch=32, n_var=code.n_var,
        n_info=code.n_info, mod_type=2, quant_bits=4)
    got = cuda_decoder.stats_decode(
        llr, cuda_decoder.decoder_tables(code, cfg.decoder(), "cpu"))
    for k, g in zip(("err_bits", "mp_iters", "bf_rounds"), got):
        np.testing.assert_array_equal(g.numpy(), want[k], err_msg=k)
    assert (got[0] > 0).any()


def test_loop_equals_sum_of_steps():
    code = toy_code()
    cfg = _cfg(SimConfig, 64)
    sigma = sigma_for(cfg, 2.5)
    step = build_sim_step(code, cfg, "cpu")
    steps = [_py(step(11, r, sigma)) for r in (5, 6, 7)]
    loop = _py(build_sim_loop(code, cfg, 3, "cpu")(11, sigma, 5))
    for k in SCALARS:
        assert loop[k] == sum(s[k] for s in steps), k
    for k in ("mp_hist", "bf_hist"):
        assert loop[k] == np.sum([s[k] for s in steps], axis=0).tolist(), k
    assert loop["test_frames"] == 3 * 64
    assert loop != _py(build_sim_loop(code, cfg, 3, "cpu")(12, sigma, 5))


def test_high_snr_zero_errors():
    code = toy_code()
    cfg = _cfg(SimConfig, 32)
    out = _py(build_sim_step(code, cfg, "cpu")(0, 0, sigma_for(cfg, 8.0)))
    assert out["test_frames"] == 32
    assert out["error_frames"] == 0 and out["error_bits"] == 0


def test_low_snr_errors():
    code = toy_code()
    cfg = _cfg(SimConfig, 32)
    out = _py(build_sim_step(code, cfg, "cpu")(0, 0, sigma_for(cfg, -8.0)))
    assert out["error_frames"] == 32
    assert out["mod_error_bits"] > 0
    assert sum(out["mp_hist"]) == sum(out["bf_hist"]) == 32


def test_cpu_never_launches_kernels():
    cuda_channel.quantile_channel.launches = 0
    cuda_decoder.stats_decode.launches = 0
    code = toy_code()
    cfg = _cfg(SimConfig, 32)
    build_sim_loop(code, cfg, 2, "cpu")(0, sigma_for(cfg, 3.0), 0)
    assert cuda_channel.quantile_channel.launches == 0
    assert cuda_decoder.stats_decode.launches == 0


def test_unported_pipeline_configs_raise():
    code = toy_code()
    # the float chain, 16-QAM and the 1-bit quantizer are ported; values
    # outside the JAX package's configurations raise
    for kw in (dict(channel_backend="xla"), dict(mod_type=4),
               dict(channel_backend="xla", quant_bits=1)):
        build_sim_step(code, _cfg(SimConfig, 32, **kw), "cpu")
    for kw in (dict(channel_backend="float"), dict(mod_type=3),
               dict(quant_bits=0)):
        with pytest.raises(ValueError):
            build_sim_step(code, _cfg(SimConfig, 32, **kw), "cpu")
    # real codewords and frame stop mode are ported, on the CPU and on a
    # CUDA device; the plain backend is refused on a CUDA device before
    # any table reaches it
    build_sim_step(code, _cfg(SimConfig, 32, fake_encode=False), "cpu")
    pipeline.check_ported(_cfg(SimConfig, 32, stop_mode="frame",
                               fake_encode=False,
                               decode_method=DecodeMethod.OMS), "cuda")
    with pytest.raises(ValueError, match="--backend auto"):
        build_sim_step(code, _cfg(SimConfig, 32, backend="plain",
                                  decode_method=DecodeMethod.NMS), "cuda")
    with pytest.raises(ValueError):
        build_sim_loop(code, _cfg(SimConfig, 32), 0, "cpu")
    step = build_sim_step(code, _cfg(SimConfig, 33), "cpu")
    with pytest.raises(ValueError):       # group words are 32 frames
        step(0, 0, 1.0)
    assert math.isclose(sigma_for(_cfg(SimConfig, 32), 3.6),
                        JSimConfig(mod_type=2).sigma_at(3.6))
