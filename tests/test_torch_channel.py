"""PyTorch port, quantile channel (faid_tpu_torch/ops/cuda_channel.py)
against faid_tpu/ops/pallas_channel.py, on the CPU (the plain twin of
kernel A)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.config import SimConfig as JSimConfig
from faid_tpu.ops import pallas_channel as pc
from faid_tpu_torch.config import SimConfig
from faid_tpu_torch.ops import cuda_channel as cc
from faid_tpu_torch.ops import philox
from faid_tpu_torch.utils import kernels

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _jax_params(mod_type, quant_bits, sigma):
    cfg = JSimConfig(mod_type=mod_type, quant_bits=quant_bits)
    return np.array(jax.jit(lambda s: pc._threshold_ints(cfg, s))(
        jnp.float32(sigma)))


@pytest.mark.parametrize("quant_bits", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("bit", [0, 1])
def test_staircase_bit_exact(rng, quant_bits, bit):
    """Same int32 words, same thresholds -> the same LLRs and error bits."""
    params = _jax_params(2, quant_bits, 0.45)
    ix = rng.integers(-2**31, 2**31, (16, 512), dtype=np.int64).astype(np.int32)
    # Put some words right on the thresholds: the compares are strict.
    ix[0, :params.size] = params
    ix[1, :params.size] = params + 1
    mask = np.full(ix.shape, -bit, np.int32)
    want_llr, want_err = pc.staircase(jnp.asarray(ix), jnp.asarray(mask),
                                      jnp.asarray(params), quant_bits)
    got_llr, got_err = cc.staircase(torch.from_numpy(ix),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(params), quant_bits)
    assert got_llr.dtype == got_err.dtype == torch.int8
    np.testing.assert_array_equal(got_llr.numpy(), np.asarray(want_llr))
    np.testing.assert_array_equal(got_err.numpy(), np.asarray(want_err))


@pytest.mark.parametrize("mod_type", [1, 2])
@pytest.mark.parametrize("quant_bits", [4, 6])
@pytest.mark.parametrize("snr", [1.0, 3.6, 8.0])
def test_thresholds_within_float32_error(mod_type, quant_bits, snr):
    """Both packages compute the thresholds in float32, but torch's and
    XLA's ndtr (and XLA's fusion of the argument arithmetic) differ in
    the last bits.  The grid count p * 2^32 is a float32, whose ulp is
    256 for the largest counts (~2^31), so compare the small-side counts
    within max(256, 1e-5 * count): 1e-5 bounds the relative tail error
    of a float32 argument rounding (~6e-8) amplified by t^2 for t <= 12.
    Measured on a grid of 460 thresholds (mod 1/2, 2-6 bits, -2..9 dB):
    never more than 256 grid units, a relative 1.2e-7 of the step
    probability, below the float32 error the law already carries."""
    sigma = SimConfig(mod_type=mod_type).sigma_at(snr)
    want = _jax_params(mod_type, quant_bits, sigma).astype(np.int64)
    got = cc.threshold_ints(SimConfig(mod_type=mod_type,
                                      quant_bits=quant_bits), sigma)
    assert got.dtype == torch.int32 and got.shape == want.shape
    got = got.numpy().astype(np.int64)
    # distance to the rail = the small-side count of grid points
    small_g = np.minimum(2**31 - got, got + 2**31 + 1)
    small_w = np.minimum(2**31 - want, want + 2**31 + 1)
    bound = np.maximum(256, 1e-5 * np.maximum(small_g, small_w))
    assert (np.abs(small_g - small_w) <= bound).all(), got - want


@pytest.mark.parametrize("mod_type,n_info", [(1, 300), (2, 300), (2, 301)])
def test_mod_stats_match_reduce(rng, mod_type, n_info):
    err = (rng.random((24, 320)) < 0.2).astype(np.int8)
    want_b, want_s = pc.reduce_mod_stats(jnp.asarray(err), n_info, mod_type)
    got_b, got_s = cc.mod_stats(torch.from_numpy(err), n_info, mod_type)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("mod_type,with_cw", [(2, False), (2, True),
                                              (1, False)])
def test_channel_equals_jax_composition(rng, mod_type, with_cw):
    """The port's channel (CPU path = kernel A's plain twin) equals JAX's
    staircase + reduce_mod_stats on the port's Philox words."""
    batch, n, n_info = 8, 1024, 840
    cfg = SimConfig(mod_type=mod_type)
    params = cc.threshold_ints(cfg, cfg.sigma_at(1.5))
    cw = (torch.from_numpy(rng.integers(0, 2, (batch, n)).astype(np.int8))
          if with_cw else None)
    llr, bits, syms = cc.quantile_channel(
        params, seed=77, rnd=3, batch=batch, n_var=n, n_info=n_info,
        mod_type=mod_type, quant_bits=4, frame0=5, cw=cw)
    ix = philox.channel_words(77, 3, 5, batch, n, "cpu").numpy()
    mask = (np.zeros_like(ix) if cw is None
            else -(cw.numpy() != 0).astype(np.int32))
    want_llr, want_err = pc.staircase(jnp.asarray(ix), jnp.asarray(mask),
                                      jnp.asarray(params.numpy()), 4)
    want_b, want_s = pc.reduce_mod_stats(want_err, n_info, mod_type)
    np.testing.assert_array_equal(llr.numpy(), np.asarray(want_llr))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(syms.numpy(), np.asarray(want_s))
    assert int(bits.sum()) > 0
    assert kernels.launches["A"] == 0   # CPU tensors never launch


def _phi_c(t):
    """Upper tail of the standard normal, float64."""
    return 0.5 * math.erfc(t / math.sqrt(2.0))


def test_channel_law_chi_square():
    """The port's channel on its own Philox words follows the float64-erf
    law of the float chain it replaces: QPSK, 4-bit truncating quantizer
    at scale 13, sent 0-bit (amplitude -a), so y = 13 * (-a + srail * z)
    and q = clip(trunc(y), -7, 7)."""
    cfg = SimConfig(mod_type=2, quant_bits=4)
    sigma = cfg.sigma_at(3.0)
    batch, n = 64, 17664
    llr, bits, _ = cc.quantile_channel(
        cc.threshold_ints(cfg, sigma), seed=2024, rnd=0, batch=batch,
        n_var=n, n_info=n, mod_type=2, quant_bits=4)
    llr = llr.numpy().reshape(-1)
    m = llr.size
    a, srail, scale = 0.707107, sigma / math.sqrt(2.0), 13.0
    # P(q >= k) = P(y >= k),  P(q <= -k) = P(y <= -k)  for k = 1..7
    ge = [1.0] + [_phi_c((k / scale + a) / srail) for k in range(1, 8)] + [0.0]
    le = [1.0] + [1.0 - _phi_c((a - k / scale) / srail)
                  for k in range(1, 8)] + [0.0]
    probs = {v: ge[v] - ge[v + 1] for v in range(1, 8)}
    probs.update({-v: le[v] - le[v + 1] for v in range(1, 8)})
    probs[0] = 1.0 - sum(probs.values())
    counts = np.bincount(llr.astype(np.int64) + 7, minlength=15)
    expect = np.array([probs[v] for v in range(-7, 8)]) * m
    assert expect.min() > 50          # every bin is well populated
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    # chi-square with 14 degrees of freedom: P(chi2 > 54.6) = 1e-6
    assert chi2 < 54.6, (chi2, counts, expect.round())
    # the pre-decoder error rate P(soft > 0), a binomial 6-sigma check
    p_err = _phi_c(a / srail)
    emp = int(bits.sum()) / m
    assert abs(emp - p_err) < 6 * math.sqrt(p_err * (1 - p_err) / m)


def test_channel_rejects_unported_and_bad_args():
    cfg = SimConfig(mod_type=2)
    params = cc.threshold_ints(cfg, 0.5)
    kw = dict(seed=0, rnd=0, batch=2, n_var=16, n_info=12, quant_bits=4)
    with pytest.raises(NotImplementedError):
        cc.quantile_channel(params, mod_type=4, **kw)
    with pytest.raises(ValueError):
        cc.quantile_channel(params[:-1], mod_type=2, **kw)
    with pytest.raises(ValueError):
        cc.quantile_channel(params.to("meta"), mod_type=2, **kw)
