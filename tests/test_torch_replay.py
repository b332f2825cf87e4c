"""PyTorch port, the forensic replay path: kernel C's plain twin
(ops/cuda_channel.py ``quantile_channel_map``) against JAX's
``pallas_channel.staircase``, kernel D's plain twin (ops/cuda_decoder.py
``full_decode``) against ``make_full_decoder(interpret=True)``, and
``build_debug_step`` against ``build_sim_step``, bit for bit on the
CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import DecodeMethod as JMethod
from faid_tpu.config import DecoderConfig as JDecoderConfig
from faid_tpu.decoders.core import ingest_llrs as jingest
from faid_tpu.ops import pallas_channel as pc
from faid_tpu.ops import pallas_decoder as pk
from faid_tpu_torch import build_debug_step, build_sim_loop, build_sim_step
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, DecoderConfig, SimConfig
from faid_tpu_torch.convert import code_from_arrays
from faid_tpu_torch.decoders.core import build_decoder
from faid_tpu_torch.ops import cuda_channel as cc
from faid_tpu_torch.ops import cuda_decoder as cd
from faid_tpu_torch.ops import philox
from faid_tpu_torch.sim import pipeline
from faid_tpu_torch.utils import kernels

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("mod_type", [1, 2])
@pytest.mark.parametrize("quant_bits", [3, 4, 6])
def test_map_channel_equals_jax_staircase(rng, mod_type, quant_bits):
    """Kernel C's twin on the port's Philox words against JAX's staircase
    on the same words, codeword mask and thresholds; its LLRs are kernel
    A's twin's, and its info-bit map sums to A's counts."""
    batch, n, n_info = 8, 1024, 840
    cfg = SimConfig(mod_type=mod_type, quant_bits=quant_bits)
    params = cc.threshold_ints(cfg, cfg.sigma_at(1.0))
    cw = torch.from_numpy(rng.integers(0, 2, (batch, n)).astype(np.int8))
    kw = dict(seed=91, rnd=philox.stream_round(2, 5), batch=batch, n_var=n,
              quant_bits=quant_bits, frame0=3, cw=cw)
    llr, err = cc.quantile_channel_map(params, **kw)
    assert llr.dtype == err.dtype == torch.int8
    assert llr.shape == err.shape == (batch, n)
    ix = philox.channel_words(91, kw["rnd"], 3, batch, n, "cpu").numpy()
    mask = -(cw.numpy() != 0).astype(np.int32)
    want_llr, want_err = pc.staircase(jnp.asarray(ix), jnp.asarray(mask),
                                      jnp.asarray(params.numpy()), quant_bits)
    np.testing.assert_array_equal(llr.numpy(), np.asarray(want_llr))
    np.testing.assert_array_equal(err.numpy(), np.asarray(want_err))

    a_llr, a_bits, _ = cc.quantile_channel(params, n_info=n_info,
                                           mod_type=mod_type, **kw)
    np.testing.assert_array_equal(llr.numpy(), a_llr.numpy())
    np.testing.assert_array_equal(
        err[:, :n_info].sum(dim=1, dtype=torch.int32).numpy(), a_bits.numpy())
    assert int(a_bits.sum()) > 0
    assert kernels.launches["C"] == 0   # CPU tensors never launch


def _cfgs(stop_mode):
    return (JDecoderConfig.for_method(JMethod.FAID_DTBF, stop_mode=stop_mode),
            DecoderConfig.for_method(DecodeMethod.FAID_DTBF,
                                     stop_mode=stop_mode))


@pytest.mark.parametrize("stop_mode", ["group", "frame"])
@pytest.mark.parametrize("llr_range", [7, 127])
def test_full_decoder_toy_vs_pallas_interpret(rng, stop_mode, llr_range):
    """Kernel D's twin on CPU against make_full_decoder(interpret=True):
    toy code, batch 64, two 32-frame words with different exits, DTBF
    engaged.  JAX's [C, B, Z] hard bits are transposed to [B, n_var]."""
    jcode = jtoy_code()
    code = code_from_arrays(jcode.name, jcode.z, jcode.n_var, jcode.n_chk,
                            jcode.block_cols_np, jcode.shifts_np,
                            jcode.degrees_np)
    jdcfg, dcfg = _cfgs(stop_mode)
    llr = rng.integers(-llr_range, llr_range + 1,
                       (64, code.n_var)).astype(np.int8)
    llr[:32] = np.minimum(llr[:32], -1)
    full = pk.make_full_decoder(jcode, jdcfg, interpret=True)
    cbz = jnp.transpose(jingest(jnp.asarray(llr), jcode), (1, 0, 2))
    w_hard, w_iters, w_bf = (np.asarray(x) for x in jax.jit(full)(cbz))
    w_hard = np.transpose(w_hard, (1, 0, 2)).reshape(64, code.n_var)

    hard, iters, bf = cd.full_decode(
        torch.from_numpy(llr), cd.decoder_tables(code, dcfg, "cpu"))
    assert hard.dtype == torch.int8 and hard.shape == (64, code.n_var)
    np.testing.assert_array_equal(hard.numpy(), w_hard)
    np.testing.assert_array_equal(iters.numpy(), w_iters)
    np.testing.assert_array_equal(bf.numpy(), w_bf)
    assert int(bf.sum()) > 0 and int(hard[:32].sum()) == 0
    assert kernels.launches["D"] == 0


def test_build_decoder_backends_agree(rng):
    code = toy_code()
    dcfg = DecoderConfig.for_method(DecodeMethod.FAID_DTBF, stop_mode="group")
    llr = torch.from_numpy(rng.integers(-7, 8, (32, code.n_var)).astype(np.int8))
    auto = build_decoder(code, dcfg)(llr)
    plain = build_decoder(code, dcfg, backend="plain")(llr)
    assert auto["hard"].dtype == torch.bool
    for k in ("hard", "mp_iters", "bf_rounds"):
        assert torch.equal(auto[k], plain[k]), k
    with pytest.raises(ValueError):
        build_decoder(code, dcfg, backend="xla")


def _sim_cfg(**kw):
    base = dict(decode_method=2, max_iteration=6, mod_type=2,
                batch_per_device=64, fake_encode=True,
                channel_backend="fused", stop_mode="group", seed=5)
    base.update(kw)
    return SimConfig(**base)


@pytest.mark.parametrize("seed,snr_idx,rnd", [(5, 0, 0), (17, 3, 2**32 - 1)])
def test_debug_step_matches_sim_step(seed, snr_idx, rnd):
    """The replay reproduces the hot path's error counts for the same
    (seed, snr_idx, rnd), and its LLRs are kernel A's twin's."""
    code = toy_code()
    cfg = _sim_cfg()
    sigma = cfg.sigma_at(1.5)
    sr = philox.stream_round(snr_idx, rnd)
    a = build_sim_step(code, cfg, "cpu")(seed, sr, sigma)
    b = build_debug_step(code, cfg, "cpu")(seed, sr, sigma)
    assert int(a["error_bits"]) == int(b["err_bits"].sum()) > 0
    assert int(a["error_frames"]) == int((b["err_bits"] > 0).sum())
    llr, _, _ = cc.quantile_channel(
        cc.threshold_ints(cfg, sigma), seed=seed, rnd=sr, batch=64,
        n_var=code.n_var, n_info=code.n_info, mod_type=2, quant_bits=4)
    assert torch.equal(b["llr"], llr)
    assert b["hard"].dtype == torch.bool and not b["cw"].any()
    assert torch.equal(b["soft"], llr.to(torch.float32) / 13.0)
    np.testing.assert_array_equal(
        b["err_bits"].numpy(), b["hard"][:, :code.n_info].sum(1).numpy())


@pytest.mark.parametrize("method", [0, 1, 3, 4, 5])
def test_debug_step_matches_sim_step_methods(method):
    """The replay of the other methods (kernel E's path for NMS and OMS,
    kernel D's for the rest) gives the sweep step's error counts."""
    code = toy_code()
    cfg = _sim_cfg(decode_method=method, factor_1=26 if method == 0 else 1,
                   factor_2=32 if method == 0 else 6)
    sigma = cfg.sigma_at(1.5)
    sr = philox.stream_round(1, 3)
    a = build_sim_step(code, cfg, "cpu")(9, sr, sigma)
    b = build_debug_step(code, cfg, "cpu")(9, sr, sigma)
    assert int(a["error_bits"]) == int(b["err_bits"].sum()) > 0
    assert int(a["error_frames"]) == int((b["err_bits"] > 0).sum())
    assert (int(a["bf_rounds"]) > 0) == (method in (3, 4, 5))


def test_stream_round():
    assert philox.stream_round(0, 0) == 0
    assert philox.stream_round(3, 7) == 3 * 2**32 + 7
    assert philox.stream_round(2**32 - 1, 2**32 - 1) == 2**64 - 1
    for bad in ((-1, 0), (0, -1), (2**32, 0), (0, 2**32)):
        with pytest.raises(ValueError):
            philox.stream_round(*bad)
    # neighbouring SNR points draw different words for the same round
    a = philox.channel_words(1, philox.stream_round(0, 4), 0, 2, 64, "cpu")
    b = philox.channel_words(1, philox.stream_round(1, 4), 0, 2, 64, "cpu")
    assert (a != b).float().mean() > 0.99


def test_replay_rejects_unported_configs():
    code = toy_code()
    # the float chain, 16-QAM and the 1-bit quantizer are ported; values
    # outside the JAX package's configurations raise
    for kw in (dict(channel_backend="xla"), dict(mod_type=4),
               dict(channel_backend="xla", quant_bits=1)):
        build_debug_step(code, _sim_cfg(**kw), "cpu")
    for kw in (dict(channel_backend="float"), dict(mod_type=3),
               dict(quant_bits=0)):
        with pytest.raises(ValueError):
            build_debug_step(code, _sim_cfg(**kw), "cpu")
    build_debug_step(code, _sim_cfg(fake_encode=False), "cpu")   # ported
    with pytest.raises(ValueError):
        build_debug_step(code, _sim_cfg(backend="xla"), "cpu")


@pytest.mark.parametrize("build", ["sweep", "replay"])
def test_cuda_rounds_refuse_the_plain_path(build):
    """On a CUDA device a round runs the kernels only: the plain backend
    is refused, naming the flag, before any table reaches the device (so
    no card is needed here); frame stop mode runs there."""
    code = toy_code()

    def make(cfg):
        if build == "sweep":
            return build_sim_loop(code, cfg, 1, "cuda")
        return build_debug_step(code, cfg, "cuda")

    with pytest.raises(ValueError, match="--backend auto"):
        make(_sim_cfg(backend="plain"))
    with pytest.raises(ValueError, match="--backend auto"):
        make(_sim_cfg(backend="plain", stop_mode="frame"))
    pipeline.check_ported(_sim_cfg(stop_mode="frame"), "cuda")
    # both run on the CPU, where the plain path is the kernels' twin
    for kw in (dict(stop_mode="frame"), dict(backend="plain")):
        pipeline.check_ported(_sim_cfg(**kw), "cpu")
    pipeline.check_ported(_sim_cfg(), torch.device("cuda", 0))
