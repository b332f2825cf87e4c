"""One Monte-Carlo round: messages -> encode -> channel -> decode ->
counters, and its forensic replay (``faid_tpu.sim.pipeline``).

The port runs both channels of the JAX package: the float chain
(``channel_backend="xla"``, the default: modulate, AWGN, demap,
quantize, ops/channel.py) and the quantile channel ("fused"), for
BPSK/QPSK/16/64/256-QAM, any interleaver depth, the all-zero codeword
(``fake_encode``) or real ones, any of the six decoders, in either stop
mode.  On a CUDA device:

  build_sim_step / build_sim_loop   kernel F, the whole round in one
                                    kernel (ops/cuda_sim.py), for the
                                    quantile channel wherever
                                    ``supports_sim`` holds (BPSK/QPSK;
                                    the JAX package's
                                    ``_resolve_fused_sim``); else the
                                    channel, then kernel B (stats
                                    decoder): kernel A (BPSK/QPSK
                                    quantile channel with its ModCalErr
                                    counts), kernel G (16/64/256-QAM
                                    quantile channel) or the float chain,
                                    the last two with their ModCalErr
                                    maps reduced by ``mod_stats``.  Every
                                    counter stays on the device
  build_debug_step                  the same frames' LLRs (kernel C,
                                    through ``fused_sim_emit`` where F
                                    ran the round; kernel G; the float
                                    chain), then kernel D (hard
                                    decisions, a BF tail) or kernel E
                                    (MP only, NMS and OMS): the same
                                    round's frames, exactly

With real codewords the round's message bits come from the message
stream (``philox.message_bits``) and go through the encoder
(code/encoder.py); the replay regenerates them.  ``rnd`` is the stream's
64-bit round (ops/philox.py); the SNR sweep passes
``philox.stream_round(snr_idx, round)`` to both, so a replay redraws the
sweep's frames bit for bit (the float chain's on the device type that
ran the sweep: its erfinv is the device's).

Every ``build_*`` function here takes ``frame0``, the round's first
global frame: its rounds draw frames ``frame0 .. frame0 + batch - 1``.
Rank r of a sharded run (parallel/mesh.py) passes ``r * batch``, so W
ranks at batch b draw the frames of one rank at batch W * b.

Counters per round (the reference's CalculateErrors and ModCalErr):
  error_bits       decoded info-bit errors
  error_frames     frames with >= 1 info-bit error
  lt3_frames       error frames with < 3 bit errors
  mod_error_bits/symbols/frames   hard-decision errors before decoding
  mp_iters, bf_rounds             summed per-frame iteration counts
  mp_hist[max_iter+1], bf_hist[bf_max+1]   their histograms
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from ..code.encoder import make_encode_fn
from ..code.qc_matrix import QCCode
from ..config import SimConfig
from ..decoders.core import build_decoder, build_stats_decoder, check_backend
from ..ops import philox
from ..ops.channel import float_channel, noise_samples
from ..ops.cuda_channel import (ThresholdCache, mod_stats, quantile_channel,
                                quantile_channel_map, quantile_channel_qam)
from ..ops.cuda_sim import build_fused_sim, build_fused_sim_emit, supports_sim
from ..ops.fixed_point import _QUANT_LIMITS


def _histogram(x: torch.Tensor, length: int) -> torch.Tensor:
    """bincount(clip(x, 0, length-1), length) as int32, via a compare
    matrix."""
    edges = torch.arange(length, dtype=x.dtype, device=x.device)
    return (torch.clamp(x, 0, length - 1)[:, None] == edges[None, :]).sum(
        dim=0, dtype=torch.int32)


def check_ported(cfg: SimConfig, device) -> None:
    """Raise, naming the CLI flag to change, for a round the port cannot
    run on ``device``: ValueError for a configuration outside the JAX
    package's too, and for the plain backend on a CUDA device, where a
    round runs the kernels only."""
    check_backend(cfg.backend)
    if torch.device(device).type == "cuda" and cfg.backend != "auto":
        raise ValueError(
            f"backend={cfg.backend!r} runs the plain PyTorch path, which "
            "the port runs on the CPU only: pass --backend auto, or "
            "--device cpu")
    if cfg.channel_backend not in ("xla", "fused"):
        raise ValueError(
            f"channel_backend={cfg.channel_backend!r}: pass --channel-backend "
            "xla (the float chain) or fused (the quantile channel)")
    if cfg.mod_type not in (1, 2, 4, 6, 8):
        raise ValueError(f"mod_type {cfg.mod_type}: pass --mod-type 1, 2, 4, 6 "
                         "or 8")
    if cfg.quant_bits != 1 and cfg.quant_bits not in _QUANT_LIMITS:
        raise ValueError(f"a {cfg.quant_bits}-bit quantizer: pass --quant-bits "
                         "1..6")
    if cfg.interleave_depth < 1:
        raise ValueError(f"interleave depth {cfg.interleave_depth}: pass "
                         "--interleave 1 or more")


def _check_shape(code: QCCode, cfg: SimConfig) -> None:
    if code.n_var % cfg.mod_type or code.n_var % cfg.interleave_depth:
        raise ValueError(
            f"n_var={code.n_var} is not a whole number of {cfg.mod_type}-bit "
            f"symbols and of interleaver rows of depth {cfg.interleave_depth}")


def quantile_draws(cfg: SimConfig) -> bool:
    """True where the quantile channel draws the round: channel_backend
    "fused" with a 2-6-bit quantizer; else the float chain does."""
    return cfg.channel_backend == "fused" and cfg.quant_bits in _QUANT_LIMITS


def _quantile(cfg: SimConfig) -> bool:
    """``quantile_draws``, with the JAX package's warning where "fused"
    with a 1-bit quantizer takes the float chain
    (``_resolve_fused_channel``); a builder asks once per round it
    builds."""
    if cfg.channel_backend != "fused":
        return False
    if quantile_draws(cfg):
        return True
    warnings.warn(
        f"channel_backend='fused' is not supported for this config "
        f"(mod_type={cfg.mod_type}, quant_bits={cfg.quant_bits}); falling "
        f"back to the float chain.", stacklevel=4)
    return False


def _fuses(code: QCCode, cfg: SimConfig) -> bool:
    """True where kernel F takes the whole round: the quantile channel, the
    auto backend and ``supports_sim`` (``_resolve_fused_sim``)."""
    return (cfg.backend == "auto" and cfg.channel_backend == "fused"
            and supports_sim(code, cfg))


def _codewords(code: QCCode, cfg: SimConfig, device, frame0: int):
    """None for the all-zero word (``fake_encode``); else codewords(seed,
    rnd) -> [batch, n_var] int8: the message bits of frames ``frame0 ..``
    of the round from the stream, encoded, on ``device``."""
    if cfg.fake_encode:
        return None
    encode = make_encode_fn(code, device)

    def codewords(seed: int, rnd: int) -> torch.Tensor:
        return encode(philox.message_bits(seed, rnd, frame0,
                                          cfg.batch_per_device, code.n_info,
                                          device))

    return codewords


def _map_channel(code: QCCode, cfg: SimConfig, device, quantile: bool,
                 frame0: int) -> Callable:
    """-> channel(cw, seed, rnd, sigma) -> (llr, mod_err, soft): the LLRs
    and the ModCalErr map [batch, n_var] int8 of frames ``frame0 ..`` of
    the round's channel (``quantile``: ``_quantile(cfg)``), and its float
    LLRs [batch, n_var] float32 where the channel has them (the float
    chain), else None.  ``cw`` None is the all-zero word.

      quantile, BPSK/QPSK   kernel C (ops/cuda_channel.py)
      quantile, 16-256-QAM  kernel G (ops/cuda_channel.py)
      float chain           ops/channel.py on the stream's noise
                            (ops/philox.py ``normal_noise``)"""
    batch, n_var, mod = cfg.batch_per_device, code.n_var, cfg.mod_type
    if quantile:
        thresholds = ThresholdCache(cfg, device)

        def quantile(cw, seed: int, rnd: int, sigma: float):
            if mod in (1, 2):
                llr, err = quantile_channel_map(
                    thresholds(sigma), seed=seed, rnd=rnd, batch=batch,
                    n_var=n_var, quant_bits=cfg.quant_bits, frame0=frame0,
                    cw=cw)
            else:
                llr, err = quantile_channel_qam(
                    thresholds(sigma), seed=seed, rnd=rnd, batch=batch,
                    n_var=n_var, mod_type=mod, depth=cfg.interleave_depth,
                    quant_bits=cfg.quant_bits, scale=cfg.scale,
                    frame0=frame0, cw=cw)
            return llr, err, None

        return quantile
    zero = torch.zeros((batch, n_var), dtype=torch.int8, device=device)
    samples = noise_samples(n_var, mod)

    def float_chain(cw, seed: int, rnd: int, sigma: float):
        noise = philox.normal_noise(seed, rnd, frame0, batch, samples, device)
        llr, soft, err = float_channel(zero if cw is None else cw, noise,
                                       sigma, cfg)
        return llr, err, soft

    return float_chain


def _check_frames(cfg: SimConfig, frame0: int) -> None:
    """The round's frames must be global frame indices of the stream."""
    philox.check_stream_args(0, 0, frame0, cfg.batch_per_device)


def _build_round(code: QCCode, cfg: SimConfig, device, fuse: bool,
                 frame0: int):
    """-> round(seed, rnd, sigma) -> counters on ``device`` for frames
    ``frame0 ..`` of each round."""
    check_ported(cfg, device)
    _check_shape(code, cfg)
    _check_frames(cfg, frame0)
    dcfg = cfg.decoder()
    batch = cfg.batch_per_device
    codewords = _codewords(code, cfg, device, frame0)
    bf_cap = max(dcfg.bf.max_iter, 1)
    if fuse and _fuses(code, cfg):
        sim = build_fused_sim(code, cfg, device, frame0)
    else:
        decoder = build_stats_decoder(code, dcfg, device)
        quantile = _quantile(cfg)
        if cfg.mod_type in (1, 2) and quantile:
            thresholds = ThresholdCache(cfg, device)

            def channel(cw, seed: int, rnd: int, sigma: float):
                return quantile_channel(
                    thresholds(sigma), seed=seed, rnd=rnd, batch=batch,
                    n_var=code.n_var, n_info=code.n_info,
                    mod_type=cfg.mod_type, quant_bits=cfg.quant_bits,
                    frame0=frame0, cw=cw)
        else:
            map_channel = _map_channel(code, cfg, device, quantile, frame0)

            def channel(cw, seed: int, rnd: int, sigma: float):
                llr, err, _ = map_channel(cw, seed, rnd, sigma)
                return (llr, *mod_stats(err, code.n_info, cfg.mod_type))

        def sim(cw, seed: int, rnd: int, sigma: float) -> dict:
            llr, mod_bits, mod_syms = channel(cw, seed, rnd, sigma)
            return dict(decoder(llr, cw), mod_error_bits=mod_bits,
                        mod_error_symbols=mod_syms)

    def run_round(seed: int, rnd: int, sigma: float) -> dict:
        cw = None if codewords is None else codewords(seed, rnd)
        out = sim(cw, seed, rnd, sigma)
        err = out["err_bits"]
        mod_bits = out["mod_error_bits"]
        frame_err = err > 0
        return {
            # a fill kernel, not a host-to-device copy that would sync
            # the host with the device every round
            "test_frames": torch.full((), batch, dtype=torch.int32,
                                      device=err.device),
            "error_bits": err.sum(dtype=torch.int32),
            "error_frames": frame_err.sum(dtype=torch.int32),
            "lt3_frames": (frame_err & (err < 3)).sum(dtype=torch.int32),
            "mod_error_bits": mod_bits.sum(dtype=torch.int32),
            "mod_error_symbols": out["mod_error_symbols"].sum(dtype=torch.int32),
            "mod_error_frames": (mod_bits > 0).sum(dtype=torch.int32),
            "mp_iters": out["mp_iters"].sum(dtype=torch.int32),
            "bf_rounds": out["bf_rounds"].sum(dtype=torch.int32),
            "mp_hist": _histogram(out["mp_iters"], dcfg.max_iter + 1),
            "bf_hist": _histogram(out["bf_rounds"], bf_cap + 1),
        }

    return run_round


def build_sim_step(code: QCCode, cfg: SimConfig, device="cuda",
                   fuse: bool = True, frame0: int = 0) -> Callable:
    """Returns step(seed, rnd, sigma) -> dict of int32 counters on
    ``device`` for frames ``frame0 .. frame0 + batch - 1`` of stream round
    ``rnd`` of stream ``seed``.  ``fuse=False`` composes kernels A and B
    even where kernel F covers the round (the same counters; for
    comparing the two)."""
    return _build_round(code, cfg, device, fuse, frame0)


def build_sim_loop(code: QCCode, cfg: SimConfig, rounds: int,
                   device="cuda", fuse: bool = True,
                   frame0: int = 0) -> Callable:
    """Returns loop(seed, sigma, round0) -> counters summed ON the device
    over stream rounds ``round0 .. round0 + rounds - 1``; identical to
    summing ``build_sim_step``'s counters for those rounds."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    run_round = _build_round(code, cfg, device, fuse, frame0)

    def loop(seed: int, sigma: float, round0: int) -> dict:
        acc = None
        for i in range(rounds):
            stats = run_round(seed, round0 + i, sigma)
            acc = stats if acc is None else {k: acc[k] + v
                                             for k, v in stats.items()}
        return acc

    return loop


def build_debug_step(code: QCCode, cfg: SimConfig, device="cuda",
                     frame0: int = 0) -> Callable:
    """Forensic replay step: the datapath of ``build_sim_step``, returning
    per-frame arrays instead of counters.  Every message bit and channel
    word is a pure function of (seed, rnd, frame), so any Monte-Carlo
    round can be replayed exactly to dump its failing frames.

    Returns debug(seed, rnd, sigma) -> dict(err_bits [batch] int32,
    hard [batch, n_var] bool, cw [batch, n_var] int8, llr [batch, n_var]
    int8, soft [batch, n_var] float32) on ``device``.  On the float chain
    ``soft`` is the float LLR (the reference's errorfloat.txt); no float
    LLR exists in the quantile channel, so there it is the dequantized
    ``llr / scale``, as the JAX package's fused-channel replay gives it.
    For the same (seed, rnd, sigma, frame0), ``err_bits`` sums to
    ``build_sim_step``'s error_bits and counts its error_frames."""
    check_ported(cfg, device)
    _check_shape(code, cfg)
    _check_frames(cfg, frame0)
    decoder = build_decoder(code, cfg.decoder())
    codewords = _codewords(code, cfg, device, frame0)
    if _fuses(code, cfg):
        # the fused round's own replay twin (the same channel, kernel C)
        emit = build_fused_sim_emit(code, cfg, device, frame0)

        def channel(cw, seed: int, rnd: int, sigma: float):
            return (*emit(cw, seed, rnd, sigma), None)
    else:
        channel = _map_channel(code, cfg, device, _quantile(cfg), frame0)
    # A 0-dim tensor on the device, not a Python float: CUDA divides by a
    # host scalar as a multiply by its float32 reciprocal, which is not
    # always the quotient the JAX package's division gives.
    scale = torch.tensor(cfg.scale, dtype=torch.float32, device=device)

    def debug(seed: int, rnd: int, sigma: float) -> dict:
        cw = None if codewords is None else codewords(seed, rnd)
        llr, _, soft = channel(cw, seed, rnd, sigma)
        if soft is None:
            soft = llr.to(torch.float32) / scale
        out = decoder(llr)
        if cw is None:
            cw = torch.zeros_like(llr)      # every decoded 1 is an error
        err = out["hard"][:, :code.n_info] ^ (cw[:, :code.n_info] != 0)
        return {"err_bits": err.sum(dim=1, dtype=torch.int32),
                "hard": out["hard"], "cw": cw, "llr": llr, "soft": soft}

    return debug


def sigma_for(cfg: SimConfig, snr_db: float) -> float:
    """Noise sigma from Eb/N0."""
    return cfg.sigma_at(snr_db)
