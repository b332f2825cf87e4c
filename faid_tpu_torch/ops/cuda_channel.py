"""Fused quantile channel (``faid_tpu.ops.pallas_channel``).

For one bit per LLR the whole front end (modulate, AWGN, demap,
quantize) is a monotone staircase of one standard-normal draw, so the
channel draws ONE uniform word per bit and compares it against the
quantile thresholds of each quantizer step:

  q >= k      <=>  ix >  A_k
  q <= -k     <=>  ix <  B_k
  soft > 0    <=>  ix >  H      (pre-decoder hard decision)

with ix the word as int32 (u = (ix + 2^31) / 2^32).  A sent 1-bit
mirrors the grid (``ix ^ -1``) and negates the output.  The output law
is the float chain's marginal up to the 2^-32 grid and the float32
normal CDF of the thresholds.

The words come from the Philox stream of ops/philox.py.  Three
variants:

  quantile_channel      BPSK/QPSK LLRs + per-frame ModCalErr counts:
                        kernel A, the Monte-Carlo sweep's channel
  quantile_channel_map  BPSK/QPSK LLRs + the ModCalErr map [B, n]:
                        kernel C, the forensic replay's channel
  quantile_channel_qam  16/64/256-QAM LLRs + the ModCalErr map [B, n]:
                        kernel G (csrc/qam_channel.cu), the sweep's and
                        the replay's channel; one word per I/Q rail, every
                        level of the rail a staircase of it (the plan of
                        ops/qam_plan.py: the joint law of the folded
                        demap's LLRs), looked up in the per-row cell
                        table of its thresholds (``cell_table``)

On a CUDA tensor each launches its kernel (A and C:
csrc/quantile_channel.cu); on a CPU tensor it takes its plain twin
(``*_plain``), which gives the same outputs bit for bit.  Replay contract: for the same (seed, rnd, frame0)
kernel C's LLRs equal kernel A's bit for bit, because both run the same
device code (csrc/staircase.cuh) on the same stream words, and both
twins run ``staircase`` on ``philox.channel_words``.  The punctured tail
is left to the decoder's ingest, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import modem, philox
from .fixed_point import _QUANT_LIMITS
from .qam_plan import (CELL_ENTRY_WORDS, _plan, cell_table, grid, ndtr,
                       plan_threshold_ints, staircase_qam, step_offsets)

_AMPLITUDE = {1: 1.0, 2: 0.707107}   # BPSK; QPSK rail


def threshold_ints(cfg, sigma: float) -> torch.Tensor:
    """int32[2L+1] CPU tensor [A_1..A_L, B_1..B_L, H] for a sent 0-bit.

    The port of ``pallas_channel._threshold_ints``, in float32 as there:
    each probability is taken on its small side with ``ndtr``, rounded
    half-to-even onto the 2^-32 grid, and turned into a threshold with
    exact integer arithmetic.  A step whose probability rounds to 0
    saturates to an unreachable threshold."""
    f32 = dict(dtype=torch.float32)
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


class QamTables(NamedTuple):
    """Kernel G's inputs at one sigma, made together by ``qam_tables``:
    the thresholds ``params`` (``plan_threshold_ints``, what the plain
    twin walks), their ``cell_table`` (what the kernel searches), both on
    one device, and the configuration the table was made for."""

    params: torch.Tensor
    cells: torch.Tensor
    mod_type: int
    quant_bits: int
    scale: float


def qam_tables(params: torch.Tensor, mod_type: int, quant_bits: int,
               scale: float) -> QamTables:
    """``params`` with its cell table, on ``params``' device."""
    cells = cell_table(params, mod_type, quant_bits, scale).to(params.device)
    return QamTables(params, cells, mod_type, quant_bits, float(scale))


class ThresholdCache:
    """The quantile channel's thresholds on ``device``, made once per sigma
    (a copy from pageable host memory each round would hold the host to
    the device): ``threshold_ints`` for BPSK/QPSK; for 16/64/256-QAM a
    ``QamTables``, the plan's ``plan_threshold_ints`` with the cell table
    made from them, handed out together so that a table never meets
    another sigma's thresholds."""

    def __init__(self, cfg, device):
        self.cfg, self.device, self.cache = cfg, torch.device(device), {}

    def _make(self, sigma: float):
        cfg = self.cfg
        if cfg.mod_type in (1, 2):
            return threshold_ints(cfg, sigma).to(self.device)
        t = qam_tables(plan_threshold_ints(cfg, sigma), cfg.mod_type,
                       cfg.quant_bits, cfg.scale)
        return t._replace(params=t.params.to(self.device),
                          cells=t.cells.to(self.device))

    def __call__(self, sigma: float):
        if sigma not in self.cache:
            self.cache[sigma] = self._make(sigma)
        return self.cache[sigma]


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


def _check_args(params, batch, n_var, quant_bits, cw):
    if quant_bits not in _QUANT_LIMITS:
        raise NotImplementedError(
            f"quantile channel: a {quant_bits}-bit quantizer (2-6 bits; 1 bit "
            "runs on the float chain)")
    lo, hi = _QUANT_LIMITS[quant_bits]
    if (params.dtype != torch.int32 or params.dim() != 1
            or params.numel() != 2 * max(hi, -lo) + 1
            or not params.is_contiguous()):
        raise ValueError("params must be a contiguous int32 [2L+1] tensor")
    _check_cw(cw, batch, n_var, params.device)


def _check_cw(cw, batch, n_var, device):
    if cw is not None and (cw.dtype != torch.int8 or cw.shape != (batch, n_var)
                           or cw.device != device or not cw.is_contiguous()):
        raise ValueError("cw must be a contiguous int8 [batch, n_var] tensor "
                         "on the params' device")


def _check_stats_args(n_var, n_info, mod_type):
    if mod_type not in (1, 2):
        raise NotImplementedError(
            f"quantile channel: mod_type {mod_type} (BPSK/QPSK; 16/64/256-QAM "
            "is quantile_channel_qam)")
    if not 0 < n_info <= n_var:
        raise ValueError(f"n_info={n_info} outside (0, n_var={n_var}]")


def _kernel_device(params):
    """The device whose kernel to launch; None for the plain twin."""
    if params.device.type == "cpu":
        return None
    if params.device.type != "cuda":
        raise ValueError(f"no quantile channel for device {params.device}")
    return params.device


def quantile_channel_map_plain(params, *, seed: int, rnd: int, batch: int,
                               n_var: int, quant_bits: int, frame0: int = 0,
                               cw=None):
    """Plain PyTorch twin of kernel C on ``params``' device."""
    _check_args(params, batch, n_var, quant_bits, cw)
    ix = philox.channel_words(seed, rnd, frame0, batch, n_var, params.device)
    mask = (torch.zeros_like(ix) if cw is None
            else -(cw != 0).to(torch.int32))
    return staircase(ix, mask, params, quant_bits)


def quantile_channel_map(params, *, seed: int, rnd: int, batch: int,
                         n_var: int, quant_bits: int, frame0: int = 0,
                         cw=None):
    """Frames ``frame0 ..`` of round ``rnd`` through the quantile channel,
    with the ModCalErr map: the replay's channel.

    Arguments as for ``quantile_channel``.  Returns (llr [batch, n_var]
    int8, mod_err [batch, n_var] int8), ``mod_err`` 1 where the
    pre-decoder hard decision differs from the sent bit.  ``llr`` equals
    ``quantile_channel``'s bit for bit for the same (seed, rnd, frame0).
    A CPU ``params`` takes the plain twin; a CUDA one launches kernel C."""
    dev = _kernel_device(params)
    if dev is None:
        return quantile_channel_map_plain(
            params, seed=seed, rnd=rnd, batch=batch, n_var=n_var,
            quant_bits=quant_bits, frame0=frame0, cw=cw)
    _check_args(params, batch, n_var, quant_bits, cw)
    philox.check_stream_args(seed, rnd, frame0, batch)
    from ..utils import kernels

    lib = kernels.library()
    lo, hi = _QUANT_LIMITS[quant_bits]
    llr = torch.empty((batch, n_var), dtype=torch.int8, device=dev)
    err = torch.empty((batch, n_var), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.faid_quantile_channel_map(
            None if cw is None else cw.data_ptr(), llr.data_ptr(),
            err.data_ptr(), params.data_ptr(), batch, n_var, max(hi, -lo),
            lo, hi, seed, rnd, frame0, stream)
    quantile_channel_map.launches += 1
    kernels.check(status)
    return llr, err


quantile_channel_map.launches = 0


def quantile_channel_plain(params, *, seed: int, rnd: int, batch: int,
                           n_var: int, n_info: int, mod_type: int,
                           quant_bits: int, frame0: int = 0, cw=None):
    """Plain PyTorch twin of kernel A on ``params``' device."""
    _check_stats_args(n_var, n_info, mod_type)
    llr, err = quantile_channel_map_plain(
        params, seed=seed, rnd=rnd, batch=batch, n_var=n_var,
        quant_bits=quant_bits, frame0=frame0, cw=cw)
    bits, syms = mod_stats(err, n_info, mod_type)
    return llr, bits, syms


def quantile_channel(params, *, seed: int, rnd: int, batch: int, n_var: int,
                     n_info: int, mod_type: int, quant_bits: int,
                     frame0: int = 0, cw=None):
    """Frames ``frame0 ..`` of round ``rnd`` through the quantile channel.

    ``params`` is ``threshold_ints`` on the device to run on; ``cw`` the
    [batch, n_var] int8 codeword, or None for the all-zero word.  Returns
    (llr [batch, n_var] int8, mod_error_bits [batch] int32,
    mod_error_symbols [batch] int32).  A CPU ``params`` takes the plain
    twin; a CUDA one launches kernel A."""
    dev = _kernel_device(params)
    if dev is None:
        return quantile_channel_plain(
            params, seed=seed, rnd=rnd, batch=batch, n_var=n_var,
            n_info=n_info, mod_type=mod_type, quant_bits=quant_bits,
            frame0=frame0, cw=cw)
    _check_stats_args(n_var, n_info, mod_type)
    _check_args(params, batch, n_var, quant_bits, cw)
    philox.check_stream_args(seed, rnd, frame0, batch)
    from ..utils import kernels

    lib = kernels.library()
    lo, hi = _QUANT_LIMITS[quant_bits]
    llr = torch.empty((batch, n_var), dtype=torch.int8, device=dev)
    bits = torch.empty(batch, dtype=torch.int32, device=dev)
    syms = torch.empty(batch, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.faid_quantile_channel(
            None if cw is None else cw.data_ptr(), llr.data_ptr(),
            bits.data_ptr(), syms.data_ptr(), params.data_ptr(), batch,
            n_var, n_info, mod_type, max(hi, -lo), lo, hi, seed, rnd, frame0,
            stream)
    quantile_channel.launches += 1
    kernels.check(status)
    return llr, bits, syms


quantile_channel.launches = 0


def _check_qam_args(params, batch, n_var, mod_type, depth, quant_bits, scale, cw):
    if mod_type not in (4, 6, 8):
        raise ValueError(f"QAM channel: mod_type {mod_type} is not 16/64/256-QAM")
    if quant_bits not in _QUANT_LIMITS:
        raise ValueError(f"QAM channel: {quant_bits}-bit quantizer (2-6 bits; "
                         "1-bit runs on the float chain)")
    if depth < 1 or n_var % mod_type or n_var % depth:
        raise ValueError(f"n_var={n_var} needs whole symbols of {mod_type} bits "
                         f"and whole interleaver rows of depth {depth}")
    nparam = len(_plan(mod_type, quant_bits, float(scale))[1])
    if (params.dtype != torch.int32
            or params.shape != (2 ** (mod_type // 2 - 1), nparam)
            or not params.is_contiguous()):
        raise ValueError("params must be the contiguous int32 [nmag, nparam] "
                         "plan_threshold_ints of this configuration")
    _check_cw(cw, batch, n_var, params.device)


def _check_qam_tables(tables, mod_type, quant_bits, scale):
    """``QamTables`` made for this configuration; the C entry owns the
    table's layout limits (its width, its shared memory)."""
    cells = tables.cells
    if ((tables.mod_type, tables.quant_bits, tables.scale)
            != (mod_type, quant_bits, float(scale))):
        raise ValueError(f"QAM tables made for mod {tables.mod_type}, "
                         f"{tables.quant_bits}-bit, scale {tables.scale}")
    if (cells.dtype != torch.int32 or cells.dim() != 3
            or cells.shape[0] != tables.params.shape[0]
            or cells.shape[2] != CELL_ENTRY_WORDS
            or not cells.is_contiguous() or cells.device != tables.params.device):
        raise ValueError("cells must be the contiguous int32 [nmag, 2^s, 6] "
                         "cell_table of params, on their device")


def quantile_channel_qam_plain(params, *, seed: int, rnd: int, batch: int,
                               n_var: int, mod_type: int, depth: int,
                               quant_bits: int, scale: float, frame0: int = 0,
                               cw=None):
    """Plain PyTorch twin of kernel G on ``params``' device: the stream's
    rail words, ``staircase_qam`` in the rail layout, the levels stacked
    and deinterleaved."""
    _check_qam_args(params, batch, n_var, mod_type, depth, quant_bits, scale, cw)
    h, nsym = mod_type // 2, n_var // mod_type
    ix = philox.channel_words(seed, rnd, frame0, batch, 2 * nsym,
                              params.device).reshape(batch, nsym, 2)
    cw32 = (torch.zeros((batch, n_var), dtype=torch.int32, device=params.device)
            if cw is None else modem.interleave(cw, depth).to(torch.int32))
    grp = cw32.reshape(batch, nsym, h, 2)
    qs, hards = staircase_qam(ix, grp[:, :, 0], [grp[:, :, i] for i in range(1, h)],
                              params, mod_type=mod_type, quant_bits=quant_bits,
                              scale=scale)
    errs = [hards[0]] + [hards[i] ^ grp[:, :, i] for i in range(1, h)]
    llr, err = (modem.deinterleave(torch.stack(x, dim=2).reshape(batch, n_var)
                                   .to(torch.int8), depth) for x in (qs, errs))
    return llr, err


def quantile_channel_qam(tables: QamTables, *, seed: int, rnd: int,
                         batch: int, n_var: int, mod_type: int, depth: int,
                         quant_bits: int, scale: float, frame0: int = 0,
                         cw=None):
    """Frames ``frame0 ..`` of round ``rnd`` through the 16/64/256-QAM
    quantile channel: one stream word per I/Q rail of the interleaved
    codeword, every level's LLR a staircase of it (the joint law).

    ``tables`` is the ``QamTables`` of the sigma, on the device to run on
    (``ThresholdCache`` makes them once per sigma; ``qam_tables`` for a
    one-off call), ``cw`` the [batch, n_var] int8 codeword (decoder order)
    or None for the all-zero word, ``depth`` the interleaver's.  Returns
    (llr, mod_err), each [batch, n_var] int8 in decoder order.  On the CPU
    the plain twin walks ``tables.params``; on a CUDA device kernel G
    (csrc/qam_channel.cu) searches each rail's word in ``tables.cells``,
    and raises where the table does not fit its shared memory."""
    params, cells = tables.params, tables.cells
    _check_qam_args(params, batch, n_var, mod_type, depth, quant_bits, scale, cw)
    _check_qam_tables(tables, mod_type, quant_bits, scale)
    dev = _kernel_device(params)
    if dev is None:
        return quantile_channel_qam_plain(
            params, seed=seed, rnd=rnd, batch=batch, n_var=n_var,
            mod_type=mod_type, depth=depth, quant_bits=quant_bits, scale=scale,
            frame0=frame0, cw=cw)
    philox.check_stream_args(seed, rnd, frame0, batch)
    from ..utils import kernels

    lib = kernels.library()
    lo, hi = _QUANT_LIMITS[quant_bits]
    if -lo == hi:               # the symmetric widths take no clip
        lo, hi = -2**31, 2**31 - 1
    llr = torch.empty((batch, n_var), dtype=torch.int8, device=dev)
    err = torch.empty((batch, n_var), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.faid_qam_channel(
            None if cw is None else cw.data_ptr(), llr.data_ptr(),
            err.data_ptr(), cells.data_ptr(), cells.shape[0], cells.shape[1],
            batch, n_var, mod_type, depth, lo, hi, seed, rnd, frame0, stream)
    quantile_channel_qam.launches += 1
    kernels.check(status)
    return llr, err


quantile_channel_qam.launches = 0
