"""One Monte-Carlo round: channel -> decode -> counters
(``faid_tpu.sim.pipeline``).

This slice runs the all-zero codeword (``fake_encode``) through the
fused quantile channel (``channel_backend="fused"``, BPSK/QPSK) and the
stats decoder (FAID + DTBF).  On a CUDA device the round is two kernel
launches, kernel A then kernel B, and every counter stays on the device.

Counters per round (the reference's CalculateErrors and ModCalErr):
  error_bits       decoded info-bit errors
  error_frames     frames with >= 1 info-bit error
  lt3_frames       error frames with < 3 bit errors
  mod_error_bits/symbols/frames   hard-decision errors before decoding
  mp_iters, bf_rounds             summed per-frame iteration counts
  mp_hist[max_iter+1], bf_hist[bf_max+1]   their histograms
"""

from __future__ import annotations

from typing import Callable

import torch

from ..code.qc_matrix import QCCode
from ..config import SimConfig
from ..decoders.core import build_stats_decoder
from ..ops.cuda_channel import quantile_channel, threshold_ints


def _histogram(x: torch.Tensor, length: int) -> torch.Tensor:
    """bincount(clip(x, 0, length-1), length) as int32, via a compare
    matrix."""
    edges = torch.arange(length, dtype=x.dtype, device=x.device)
    return (torch.clamp(x, 0, length - 1)[:, None] == edges[None, :]).sum(
        dim=0, dtype=torch.int32)


def _build_round(code: QCCode, cfg: SimConfig, device):
    """-> round(params, seed, rnd) -> counters, with ``params`` the
    channel thresholds on ``device``."""
    if not cfg.fake_encode or cfg.channel_backend != "fused":
        raise NotImplementedError(
            "only fake_encode=True with channel_backend='fused' is ported")
    dcfg = cfg.decoder()
    batch = cfg.batch_per_device
    decoder = build_stats_decoder(code, dcfg, device)
    bf_cap = max(dcfg.bf.max_iter, 1)

    def run_round(params: torch.Tensor, seed: int, rnd: int) -> dict:
        llr, mod_bits, mod_syms = quantile_channel(
            params, seed=seed, rnd=rnd, batch=batch, n_var=code.n_var,
            n_info=code.n_info, mod_type=cfg.mod_type,
            quant_bits=cfg.quant_bits)
        out = decoder(llr)
        err = out["err_bits"]
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
            "mod_error_symbols": mod_syms.sum(dtype=torch.int32),
            "mod_error_frames": (mod_bits > 0).sum(dtype=torch.int32),
            "mp_iters": out["mp_iters"].sum(dtype=torch.int32),
            "bf_rounds": out["bf_rounds"].sum(dtype=torch.int32),
            "mp_hist": _histogram(out["mp_iters"], dcfg.max_iter + 1),
            "bf_hist": _histogram(out["bf_rounds"], bf_cap + 1),
        }

    return run_round


def build_sim_step(code: QCCode, cfg: SimConfig, device) -> Callable:
    """Returns step(seed, rnd, sigma) -> dict of int32 counters on
    ``device`` for Monte-Carlo round ``rnd`` of stream ``seed``."""
    run_round = _build_round(code, cfg, device)

    def step(seed: int, rnd: int, sigma: float) -> dict:
        return run_round(threshold_ints(cfg, sigma).to(device), seed, rnd)

    return step


def build_sim_loop(code: QCCode, cfg: SimConfig, rounds: int,
                   device) -> Callable:
    """Returns loop(seed, sigma, round0) -> counters summed ON the device
    over rounds ``round0 .. round0 + rounds - 1``; identical to summing
    ``build_sim_step``'s counters for those rounds."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    run_round = _build_round(code, cfg, device)

    def loop(seed: int, sigma: float, round0: int) -> dict:
        params = threshold_ints(cfg, sigma).to(device)
        acc = None
        for i in range(rounds):
            stats = run_round(params, seed, round0 + i)
            acc = stats if acc is None else {k: acc[k] + v
                                             for k, v in stats.items()}
        return acc

    return loop


def sigma_for(cfg: SimConfig, snr_db: float) -> float:
    """Noise sigma from Eb/N0."""
    return cfg.sigma_at(snr_db)
