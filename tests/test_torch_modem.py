"""PyTorch port, the float channel chain (faid_tpu_torch/ops/fixed_point.py
``quantize_llr``, ops/modem.py, ops/channel.py, the noise stream of
ops/philox.py) against faid_tpu's quantizer, modem and AWGN on the CPU.

The JAX side runs op by op (``jax.disable_jit()``): each float operation
is then one rounding, as in the port's eager ops, so the two must agree
bit for bit.  A fused elementwise loop could contract a multiply and an
add into one rounding."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.config import SimConfig as JSimConfig
from faid_tpu.ops import channel as jchannel
from faid_tpu.ops import fixed_point as jfp
from faid_tpu.ops import modem as jmodem
from faid_tpu_torch.config import SimConfig
from faid_tpu_torch.ops import channel, modem, philox
from faid_tpu_torch.ops.fixed_point import quantize_llr

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """float32 values as their bit patterns, so -0.0 != 0.0 and a NaN is
    compared like any other value."""
    return np.asarray(x, np.float32).view(np.int32)


def _near(values, ulps: int = 3) -> np.ndarray:
    """float32 values and their ``ulps`` neighbours on either side."""
    v = np.asarray(values, np.float32)
    out = [v]
    lo, hi = v.copy(), v.copy()
    for _ in range(ulps):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return np.concatenate(out)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("scale", [13.0, 4.0])
def test_quantize_llr_matches_jax(rng, bits, scale):
    """Boundary-dense floats: every step k/scale and half-step (k+1/2)/scale
    with its neighbours (at scale 4 the half-integers are exact, so 6-bit
    rounds true ties to even), the int8 pack limits, and random values."""
    ks = np.arange(-40, 41, dtype=np.float64)
    x = np.concatenate([_near(ks / scale), _near((ks + 0.5) / scale),
                        _near([128 / scale, -129 / scale, 0.0]),
                        rng.normal(0, 2, 4000).astype(np.float32)])
    want = np.asarray(jfp.quantize_llr(jnp.asarray(x), scale, bits))
    got = quantize_llr(torch.from_numpy(x), scale, bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_interleave_matches_jax(rng, depth):
    x = rng.integers(0, 2, (5, 96)).astype(np.int8)
    want = np.asarray(jmodem.interleave(jnp.asarray(x), depth))
    got = modem.interleave(torch.from_numpy(x), depth)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(modem.deinterleave(got, depth).numpy(), x)
    np.testing.assert_array_equal(
        modem.deinterleave(torch.from_numpy(want.copy()), depth).numpy(),
        np.asarray(jmodem.deinterleave(jnp.asarray(want), depth)))


@pytest.mark.parametrize("mod_type", [2, 4, 6, 8])
def test_modulate_qam_matches_jax(rng, mod_type):
    bits = rng.integers(0, 2, (3, 48 * mod_type)).astype(np.int8)
    want = np.asarray(jmodem.modulate_qam(jnp.asarray(bits), mod_type))
    got = modem.modulate_qam(torch.from_numpy(bits), mod_type)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(
        modem.modulate_bpsk(torch.from_numpy(bits)).numpy(),
        np.asarray(jmodem.modulate_bpsk(jnp.asarray(bits))))


def _fold_dense(rng, mod_type) -> np.ndarray:
    """Received (I, Q) values dense around every fold boundary of the
    demap: +-c_1, +-(c_1 +- c_2), ... and their neighbours, the table's
    amplitudes, and random values."""
    folds = [0.0] + list(jmodem._FOLD[mod_type])
    points = {0.0}
    for c in folds:
        points = {s * (abs(p) + c) for p in points for s in (1, -1)} | \
                 {s * abs(abs(p) - c) for p in points for s in (1, -1)}
    table = np.abs(jmodem._TABLES[mod_type]).astype(np.float64)
    dense = np.concatenate([_near(sorted(points), 4), _near(table, 2),
                            _near(-table, 2),
                            rng.normal(0, 1.2, 3000).astype(np.float32)])
    pad = (-dense.size) % 2
    return np.concatenate([dense, np.zeros(pad, np.float32)]).reshape(1, -1, 2)


@pytest.mark.parametrize("mod_type", [2, 4, 6, 8])
def test_demodulate_qam_matches_jax(rng, mod_type):
    """The max-log demap with the compensated fold (TwoSum) on
    boundary-dense samples, bit for bit; also the fold alone."""
    sym = _fold_dense(rng, mod_type)
    with jax.disable_jit():
        want = np.asarray(jmodem.demodulate_qam(jnp.asarray(sym), mod_type))
    got = modem.demodulate_qam(torch.from_numpy(sym), mod_type)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    x = np.abs(sym.reshape(-1))
    for c in jmodem._FOLD[mod_type]:
        with jax.disable_jit():
            w = np.asarray(jmodem._fold_sub(jnp.asarray(x), c))
        g = modem._fold_sub(torch.from_numpy(x), c).numpy()
        np.testing.assert_array_equal(_bits(g), _bits(w))
        # and it is float32(float64(x) - c), the reference's narrowing
        np.testing.assert_array_equal(
            _bits(g), _bits((x.astype(np.float64) - c).astype(np.float32)))


def _jax_chain(cw, key, sigma, jcfg):
    """The JAX package's float chain (the else branch of build_sim_step),
    op by op; returns (llr, soft, mod_err map) and the noise it drew."""
    mod = jcfg.mod_type
    with jax.disable_jit():
        sig = jnp.float32(sigma)
        tx = jmodem.interleave(jnp.asarray(cw), jcfg.interleave_depth)
        if mod == 1:
            sym = jmodem.modulate_bpsk(tx)
            noise = jax.random.normal(key, sym.shape, dtype=jnp.float32)
            soft = jmodem.demodulate_bpsk(jchannel.awgn_real(key, sym, sig))
        else:
            sym = jmodem.modulate_qam(tx, mod)
            noise = jax.random.normal(key, sym.shape, dtype=jnp.float32)
            soft = jmodem.demodulate_qam(
                jchannel.awgn_complex(key, sym, sig / jnp.sqrt(2.0)), mod)
        soft = jmodem.deinterleave(soft, jcfg.interleave_depth)
        llr = jfp.quantize_llr(soft, jcfg.scale, jcfg.quant_bits)
        err = jnp.logical_xor(soft > 0, jnp.asarray(cw) != 0)
    return ((np.asarray(llr), np.asarray(soft), np.asarray(err).astype(np.int8)),
            np.asarray(noise))


@pytest.mark.parametrize("mod_type,depth,quant_bits,snr", [
    (1, 1, 1, 2.0), (1, 3, 4, 2.0), (2, 1, 4, 3.0), (2, 2, 6, 3.0),
    (4, 2, 4, 8.0), (4, 3, 3, 8.0), (6, 2, 6, 12.0), (6, 3, 5, 12.0),
    (8, 1, 4, 16.0), (8, 2, 2, 16.0)])
def test_float_chain_matches_jax(rng, mod_type, depth, quant_bits, snr):
    """One noise array, drawn by jax.random.normal, through the JAX
    package's modem, awgn_* and quantizer and through the port's pure
    float_channel: the same LLRs, float LLRs and ModCalErr map, bit for
    bit, with a random codeword."""
    n = 96
    cfg = SimConfig(mod_type=mod_type, interleave_depth=depth,
                    quant_bits=quant_bits)
    jcfg = JSimConfig(mod_type=mod_type, interleave_depth=depth,
                      quant_bits=quant_bits)
    sigma = cfg.sigma_at(snr)
    cw = rng.integers(0, 2, (6, n)).astype(np.int8)
    want, noise = _jax_chain(cw, jax.random.key(mod_type * 10 + depth),
                             sigma, jcfg)
    assert noise.reshape(6, -1).shape[1] == channel.noise_samples(n, mod_type)
    got = channel.float_channel(torch.from_numpy(cw),
                                torch.from_numpy(noise.reshape(6, -1)),
                                sigma, cfg)
    assert [g.dtype for g in got] == [torch.int8, torch.float32, torch.int8]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert 0 < want[2].mean() < 0.5      # the noise reached the decisions


def test_noise_stream_law():
    """About 1e6 samples of the float chain's noise: mean, variance and a
    Kolmogorov-Smirnov test against N(0, 1); the tails stay within the
    float32 erfinv's range."""
    from scipy import stats

    z = philox.normal_noise(5, philox.stream_round(2, 9), 0, 64, 16384,
                            "cpu").numpy().astype(np.float64).reshape(-1)
    m = z.size
    assert abs(z.mean()) < 5 / math.sqrt(m)
    assert abs(z.var() - 1) < 5 * math.sqrt(2 / m)
    assert stats.kstest(z, "norm").pvalue > 1e-4
    assert np.isfinite(z).all() and np.abs(z).max() < 6.0


def test_noise_stream_contract(monkeypatch):
    """The noise words are Philox words of counter (2^30 | p // 4, frame,
    round): disjoint from the channel's (p // 4) and the message's
    (2^31 | j // 128) domains, keyed by the global frame, and a pure
    function of (seed, round, frame)."""
    seen = {}
    real = philox._words

    def spy(seed, rnd, frame0, batch, c0):
        seen.setdefault(spy.name, set()).update(c0.tolist())
        return real(seed, rnd, frame0, batch, c0)

    monkeypatch.setattr(philox, "_words", spy)
    n = 17664
    for spy.name, draw in (("channel", philox.channel_words),
                           ("message", philox.message_bits),
                           ("noise", philox.normal_noise)):
        draw(3, 7, 0, 1, n, "cpu")
    assert not seen["noise"] & seen["channel"]
    assert not seen["noise"] & seen["message"]
    assert min(seen["noise"]) == 2**30 and max(seen["channel"]) < 2**30
    # the same words as the contract's counters give
    w = real(3, 7, 4, 2, philox._NOISE_DOMAIN | torch.arange(6))
    z = philox.normal_from_words(w.reshape(2, 24))
    np.testing.assert_array_equal(
        philox.normal_noise(3, 7, 4, 2, 24, "cpu").numpy(), z.numpy())
    # frames offset by frame0 are the same frames
    a = philox.normal_noise(3, 7, 0, 6, 24, "cpu")
    b = philox.normal_noise(3, 7, 4, 2, 24, "cpu")
    np.testing.assert_array_equal(a[4:].numpy(), b.numpy())
    assert (a[0] != a[1]).all()


def test_normal_from_words_maps_bits_as_jax():
    """The uniform-to-normal map of jax.random.normal (its ``_uniform`` on
    the word's top 23 bits, then sqrt(2) erfinv), on chosen words: the
    extremes, the middle and random words; within an ulp or two, since
    erfinv is each library's own."""
    words = np.array([0, 1, 511, 512, 2**31 - 1, 2**31, 2**31 + 512,
                      2**32 - 513, 2**32 - 1] + list(
                          np.random.default_rng(4).integers(0, 2**32, 500)),
                     np.uint64)
    bits = jnp.asarray(words.astype(np.uint32))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    with jax.disable_jit():
        f = jax.lax.bitcast_convert_type((bits >> 9) | jnp.uint32(0x3F800000),
                                         jnp.float32) - 1.0
        u = jnp.maximum(lo, f * (jnp.float32(1.0) - lo) + lo)
        want = np.asarray(jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(u))
    got = philox.normal_from_words(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-7, atol=0)
