"""The float channel chain, ``channel_backend="xla"`` (``faid_tpu.ops.channel``
and the float branch of ``faid_tpu.sim.pipeline``).

interleave -> modulate -> AWGN -> soft demap -> deinterleave -> quantize,
in plain PyTorch, one eager op per step.  The noise is an explicit input
(``philox.normal_noise`` in a round), so the chain is a pure function of
(codeword, noise, sigma, configuration) and the tests can feed the JAX
package and the port one noise array.

The reference's two Gaussian generators (MKL for BPSK, Box-Muller for
QAM) are not reproduced: N(0, sigma^2) i.i.d. noise of the same sigma is
the statistical contract, as in the JAX package.
"""

from __future__ import annotations

import torch

from . import modem
from .fixed_point import quantize_llr


def noise_samples(n_var: int, mod_type: int) -> int:
    """Noise samples per frame: one per bit for BPSK, one per I/Q rail
    (two per symbol) otherwise."""
    return n_var if mod_type == 1 else 2 * (n_var // mod_type)


def awgn_real(signal: torch.Tensor, noise: torch.Tensor,
              sigma: torch.Tensor) -> torch.Tensor:
    """y = x + sigma * noise; signal [batch, n] (the BPSK path).  ``sigma``
    is a float32 tensor on the signal's device."""
    return signal + sigma * noise


def awgn_complex(sym: torch.Tensor, noise: torch.Tensor,
                 sigma: torch.Tensor) -> torch.Tensor:
    """Complex AWGN, independent noise per I and Q rail with per-rail
    sigma ``sigma / sqrt(2)`` (reference CSimulate.cpp:126), taken in
    float32 on the device: a division by a host scalar would run as a
    multiply by its reciprocal.  sym, noise [batch, nsym, 2]."""
    rail = sigma / torch.sqrt(modem._f32(2.0, sym.device))
    return sym + rail * noise


def float_channel(cw: torch.Tensor, noise: torch.Tensor, sigma, cfg):
    """The float chain on codewords ``cw`` [batch, n] int8 (decoder order)
    with ``noise`` [batch, noise_samples(n, mod)] float32 N(0, 1).

    Returns (llr [batch, n] int8, soft [batch, n] float32, mod_err [batch,
    n] int8), all in decoder order: the quantized and the float LLRs, and
    the pre-decoder hard decision ``soft > 0`` against the sent bit.
    ``sigma`` is a float or a 0-dim float32 tensor on the device."""
    if not isinstance(sigma, torch.Tensor):
        sigma = modem._f32(sigma, cw.device)
    tx = modem.interleave(cw, cfg.interleave_depth)
    if cfg.mod_type == 1:
        soft = modem.demodulate_bpsk(
            awgn_real(modem.modulate_bpsk(tx), noise, sigma))
    else:
        sym = modem.modulate_qam(tx, cfg.mod_type)
        soft = modem.demodulate_qam(
            awgn_complex(sym, noise.reshape(sym.shape), sigma), cfg.mod_type)
    soft = modem.deinterleave(soft, cfg.interleave_depth)
    llr = quantize_llr(soft, cfg.scale, cfg.quant_bits)
    mod_err = ((soft > 0) ^ (cw != 0)).to(torch.int8)
    return llr, soft, mod_err
