"""One Monte-Carlo round in one kernel, and its replay twin
(``faid_tpu.ops.pallas_decoder`` ``build_fused_sim``, ``build_fused_sim_emit``):

  fused_sim       channel draw -> staircase -> LLR ingest -> MP (+ BF)
                  -> per-frame info-bit errors against the codeword and
                  ModCalErr counts: kernel F (csrc/fused_sim.cu), five
                  [batch] int32 counters; the Monte-Carlo round on a CUDA
                  device wherever ``supports_sim`` holds
  fused_sim_emit  the same draw and staircase, emitting the LLRs and the
                  ModCalErr map [batch, n_var] int8: the replay's channel

Kernel F is the fourth output of the decoder template (csrc/decoder.cuh)
with kernel A's draw and staircase (csrc/staircase.cuh) as its
prologue, on kernel A's stream (ops/philox.py).  So for the same (seed,
rnd, frame0, cw) its counters equal kernel A's then kernel B's, frame by
frame, and its plain twin (``fused_sim_plain``) is exactly that
composition of A's and B's plain twins.

The JAX emit kernel differs from ``pallas_channel._kernel`` only in how
it seeds the TPU's hardware PRNG per batch tile.  Under the port's one
Philox contract it computes kernel C's function, so ``fused_sim_emit``
launches kernel C (ops/cuda_channel.py ``quantile_channel_map``): there
is no second copy of that device code.  ``emit`` then a decoder of the
same frames gives F's error counts, which is what makes the replay of a
fused round exact.

Each wrapper launches its kernel on a CUDA tensor and takes its plain
twin on a CPU one; utils/kernels.py ``launches`` counts the launches.
"""

from __future__ import annotations

import torch

from ..code.qc_matrix import QCCode
from ..utils import kernels
from . import cuda_channel as cc
from . import cuda_decoder as cd
from . import philox
from .fixed_point import _QUANT_LIMITS

COUNTERS = ("err_bits", "mp_iters", "bf_rounds", "mod_error_bits",
            "mod_error_symbols")


def supports_sim(code: QCCode, cfg) -> bool:
    """The gate of the one-kernel round, ``pallas_decoder.supports_sim``:
    BPSK/QPSK, a 2-6-bit quantizer, an even Z for QPSK (the symbol pairs
    (even, odd) bits), info bits that tile into block columns, and a
    batch of whole 32-frame words, on top of the decoder configurations
    the decoder kernels' template covers (``pallas_decoder.supports``)."""
    return (cd.supports(cfg.decoder()) and code.n_info % code.z == 0
            and cfg.mod_type in (1, 2)
            and (cfg.mod_type != 2 or code.z % 2 == 0)
            and cfg.quant_bits in (2, 3, 4, 5, 6)
            and cfg.batch_per_device % 32 == 0)


def fused_sim_plain(params: torch.Tensor, code: QCCode, dcfg, *, seed: int,
                    rnd: int, batch: int, mod_type: int, quant_bits: int,
                    frame0: int = 0, cw: torch.Tensor | None = None) -> dict:
    """Plain PyTorch twin of kernel F on ``params``' device: kernel A's
    twin, then kernel B's against ``cw``."""
    llr, mod_bits, mod_syms = cc.quantile_channel_plain(
        params, seed=seed, rnd=rnd, batch=batch, n_var=code.n_var,
        n_info=code.n_info, mod_type=mod_type, quant_bits=quant_bits,
        frame0=frame0, cw=cw)
    err, iters, rounds = cd.stats_decode_plain(llr, code, dcfg, cw)
    return dict(zip(COUNTERS, (err, iters, rounds, mod_bits, mod_syms)))


def fused_sim(params: torch.Tensor, tables: cd.DecoderTables, *, seed: int,
              rnd: int, batch: int, mod_type: int, quant_bits: int,
              frame0: int = 0, cw: torch.Tensor | None = None) -> dict:
    """Frames ``frame0 ..`` of stream round ``rnd`` through the quantile
    channel (``params``: ``threshold_ints`` on the device) and the decoder
    of ``tables``, counted against ``cw`` ([batch, n_var] int8, or None
    for the all-zero word).  Returns the dict of ``COUNTERS``, each
    [batch] int32 (bf_rounds 0 without a BF tail).  A CPU ``params`` takes
    the plain twin; a CUDA one launches kernel F, which adds its blocks'
    cycles to the device's ``kernels.phase_clocks``."""
    code, dcfg = tables.code, tables.dcfg
    dev = kernels.kernel_device(params, tables.device)
    if dev is None:
        return fused_sim_plain(params, code, dcfg, seed=seed, rnd=rnd,
                               batch=batch, mod_type=mod_type,
                               quant_bits=quant_bits, frame0=frame0, cw=cw)
    cc._check_stats_args(code.n_var, code.n_info, mod_type)
    cc._check_args(params, batch, code.n_var, quant_bits, cw)
    philox.check_stream_args(seed, rnd, frame0, batch)
    style, bf = cd.kernel_ids(dcfg)
    if (style, bf) not in cd.SIM_PAIRS:
        raise NotImplementedError(
            f"kernel F is built for DecoderConfig.for_method's (style, BF kind) "
            f"pairs; {dcfg} is not one")
    cd.check_launch(batch, tables)
    out = {k: torch.empty(batch, dtype=torch.int32, device=dev)
           for k in COUNTERS}
    lo, hi = _QUANT_LIMITS[quant_bits]
    kernels.launch("faid_fused_sim", dev, style, bf, cd.frame_mode(dcfg),
                   tables.plan.msg_bits, kernels.ptr(cw),
                   *(out[k].data_ptr() for k in COUNTERS), params.data_ptr(),
                   kernels.phase_clocks(dev).data_ptr(), mod_type, max(hi, -lo), lo,
                   hi, seed, rnd, frame0, tables.args, batch)
    return out


def fused_sim_emit(params: torch.Tensor, *, seed: int, rnd: int, batch: int,
                   n_var: int, quant_bits: int, frame0: int = 0,
                   cw: torch.Tensor | None = None):
    """Kernel F's channel for the same frames: (llr [batch, n_var] int8
    before the ingest, mod_err [batch, n_var] int8).  A CUDA ``params``
    launches kernel C (the same function under the one stream); a CPU one
    takes C's plain twin."""
    return cc.quantile_channel_map(params, seed=seed, rnd=rnd, batch=batch,
                                   n_var=n_var, quant_bits=quant_bits,
                                   frame0=frame0, cw=cw)


def _check_cw(cfg, cw):
    if (cw is None) != bool(cfg.fake_encode):
        raise ValueError("cw is None exactly when cfg.fake_encode is set")


def build_fused_sim(code: QCCode, cfg, device="cuda", frame0: int = 0):
    """Returns sim(cw [batch, n_var] int8 | None, seed, rnd, sigma) ->
    dict(err_bits, mp_iters, bf_rounds, mod_error_bits,
    mod_error_symbols), each [batch] int32 on ``device``: frames ``frame0
    ..`` of stream round ``rnd`` of stream ``seed`` through kernel F (its
    twin on the CPU).  ``cw`` is None exactly when ``cfg.fake_encode`` is
    set."""
    if not supports_sim(code, cfg):
        raise ValueError("config not supported by the fused sim kernel")
    tables = cd.decoder_tables(code, cfg.decoder(), device)
    thresholds = cc.ThresholdCache(cfg, tables.device)

    def sim(cw, seed: int, rnd: int, sigma: float) -> dict:
        _check_cw(cfg, cw)
        return fused_sim(thresholds(sigma), tables, seed=seed, rnd=rnd,
                         batch=cfg.batch_per_device, mod_type=cfg.mod_type,
                         quant_bits=cfg.quant_bits, frame0=frame0, cw=cw)

    return sim


def build_fused_sim_emit(code: QCCode, cfg, device="cuda", frame0: int = 0):
    """Returns emit(cw | None, seed, rnd, sigma) -> (llr, mod_err), each
    [batch, n_var] int8: the channel of ``build_fused_sim``'s round, the
    LLRs before the decoder's ingest."""
    if not supports_sim(code, cfg):
        raise ValueError("config not supported by the fused sim kernel")
    thresholds = cc.ThresholdCache(cfg, device)

    def emit(cw, seed: int, rnd: int, sigma: float):
        _check_cw(cfg, cw)
        return fused_sim_emit(thresholds(sigma), seed=seed, rnd=rnd,
                              batch=cfg.batch_per_device, n_var=code.n_var,
                              quant_bits=cfg.quant_bits, frame0=frame0,
                              cw=cw)

    return emit
