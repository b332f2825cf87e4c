"""The quantile channel of a round, plain: each codeword bit (BPSK/QPSK)
or I/Q rail (16/64/256-QAM) draws one Philox word and reads its
quantized LLRs and its pre-decoder hard decision off a staircase of
thresholds on the uniform int32 grid; a sent 1 mirrors the grid.

A frozen copy of faid_tpu_torch/ops/cuda_channel.py's plain twins
(``threshold_ints``, ``staircase``, ``quantile_channel_map_plain``,
``quantile_channel_qam_plain``, ``mod_stats``) at commit
f97303742a3ef9c90c8903c33bcd676948a22a11.  The thresholds take the float
type of their probabilities (float32, as the configuration states).
"""

from __future__ import annotations

import torch

from . import philox
from .qam import (_QUANT_LIMITS, deinterleave, grid, interleave, ndtr,
                  staircase_qam, step_offsets)

_AMPLITUDE = {1: 1.0, 2: 0.707107}   # BPSK; QPSK rail


def threshold_ints(cfg, sigma: float,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int32[2L+1] CPU tensor [A_1..A_L, B_1..B_L, H] for a sent 0-bit.

    Each probability is taken on its small side with ``ndtr``, rounded
    half-to-even onto the 2^-32 grid, and turned into a threshold with
    exact integer arithmetic.  A step whose probability rounds to 0
    saturates to an unreachable threshold.  ``dtype``: the float type the
    probabilities are taken in."""
    f32 = dict(dtype=dtype)
    a = torch.tensor(_AMPLITUDE[cfg.mod_type], **f32)
    srail = torch.tensor(sigma, **f32)
    if cfg.mod_type != 1:   # QPSK splits the noise power over I and Q
        srail = srail / torch.sqrt(torch.tensor(2.0, **f32))
    inv_scale = torch.tensor(1.0 / cfg.scale, **f32)
    k = torch.as_tensor(step_offsets(cfg.quant_bits), **f32)
    imax, imin = 2**31 - 1, -(2**31)

    t_a = (k * inv_scale + a) / srail
    A = imax - grid(ndtr(-t_a))
    t_b = (a - k * inv_scale) / srail
    B = torch.where(t_b > 0, imax - grid(ndtr(-t_b), 1.0) + 1,
                    imin + grid(ndtr(t_b)))
    H = imax - grid(ndtr(-a / srail))
    return torch.cat([A, B, H[None]]).to(torch.int32)


def staircase(ix: torch.Tensor, mask: torch.Tensor, params: torch.Tensor,
              quant_bits: int):
    """int32 words -> (int8 LLR, int8 pre-decoder error indicator).

    ``mask`` is 0 for a sent 0-bit and -1 for a 1-bit (mirrors the grid)."""
    lo, hi = _QUANT_LIMITS[quant_bits]
    L = max(hi, -lo)
    ixe = ix ^ mask
    q = torch.zeros(ix.shape, dtype=torch.int32, device=ix.device)
    for i in range(L):
        q += (ixe > params[i]).to(torch.int32)
        q -= (ixe < params[L + i]).to(torch.int32)
    q = (q ^ mask) - mask                      # restore the bit's sign
    if -lo != hi:                              # asymmetric final clip
        q = torch.clamp(q, lo, hi)
    return q.to(torch.int8), (ixe > params[2 * L]).to(torch.int8)


def mod_stats(err: torch.Tensor, n_info: int, mod_type: int):
    """ModCalErr map [batch, n] -> per-frame (info-bit errors, info-symbol
    errors), each [batch] int32; a symbol is ``mod_type`` consecutive info
    bits (``pallas_channel.reduce_mod_stats``)."""
    e = err[:, :n_info] != 0
    bits = e.sum(dim=1, dtype=torch.int32)
    pad = (-n_info) % mod_type
    if pad:
        e = torch.cat([e, e.new_zeros((e.shape[0], pad))], dim=1)
    syms = e.reshape(e.shape[0], -1, mod_type).any(dim=2)
    return bits, syms.sum(dim=1, dtype=torch.int32)


def binary_channel(params, *, seed: int, rnd: int, batch: int, n_var: int,
                   quant_bits: int, frame0: int = 0, cw=None):
    """BPSK/QPSK: (llr [batch, n_var] int8, mod_err [batch, n_var] int8)
    of frames ``frame0 ..`` of stream round ``rnd``; ``cw`` None is the
    all-zero word."""
    ix = philox.channel_words(seed, rnd, frame0, batch, n_var, params.device)
    mask = (torch.zeros_like(ix) if cw is None
            else -(cw != 0).to(torch.int32))
    return staircase(ix, mask, params, quant_bits)


def qam_channel(params, *, seed: int, rnd: int, batch: int, n_var: int,
                mod_type: int, depth: int, quant_bits: int, scale: float,
                frame0: int = 0, cw=None):
    """16/64/256-QAM on ``params``' device (``plan_threshold_ints``): the
    stream's rail words, ``staircase_qam`` in the rail layout, the levels
    stacked and deinterleaved -> (llr, mod_err) as ``binary_channel``."""
    h, nsym = mod_type // 2, n_var // mod_type
    ix = philox.channel_words(seed, rnd, frame0, batch, 2 * nsym,
                              params.device).reshape(batch, nsym, 2)
    cw32 = (torch.zeros((batch, n_var), dtype=torch.int32, device=params.device)
            if cw is None else interleave(cw, depth).to(torch.int32))
    grp = cw32.reshape(batch, nsym, h, 2)
    qs, hards = staircase_qam(ix, grp[:, :, 0], [grp[:, :, i] for i in range(1, h)],
                              params, mod_type=mod_type, quant_bits=quant_bits,
                              scale=scale)
    errs = [hards[0]] + [hards[i] ^ grp[:, :, i] for i in range(1, h)]
    llr, err = (deinterleave(torch.stack(x, dim=2).reshape(batch, n_var)
                             .to(torch.int8), depth) for x in (qs, errs))
    return llr, err
