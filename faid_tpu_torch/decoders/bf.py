"""Bit-flipping post-processors: static BF, DTBF and 2B1C-DTBF
(``faid_tpu.decoders.bf``).

Operate on hard decisions in the block layout [batch, C, Z] bool.  Static
BF flips, per round, every VN whose vote reaches min(max vote, cap).
DTBF, per round:
  1. syndrome + flip votes from the current hard bits; stop if clean;
  2. threshold update:   Th -= delta           where not flipped last round
                         Th = gamma+alpha      where flipped and l0 < L0
                         Th = gamma+alpha-d    where flipped, l0>=L0, l1<L1
                         Th = gamma+alpha-2d   otherwise (if flipped)
                         Th = max(Th, 1)
  3. flip weight-gamma VNs with  votes + alpha*(hard != hard_ch) >= Th;
  4. 2B1C variant: a second bit marks reliable VNs (|post-MP LLR| >=
     reliability_threshold); below a threshold of gamma a flip demotes a
     reliable bit instead of flipping it.
Frames that are clean (per frame, or per 32-frame word in group mode)
keep their state.
"""

from __future__ import annotations

import torch

from ..code.qc_matrix import QCCode
from ..config import BFConfig
from ..ops import syndrome as syn

GROUP = 32  # the reference's SIMD word = 32 frames


def group_any(active: torch.Tensor) -> torch.Tensor:
    """[batch] bool -> [batch] bool: OR over each consecutive 32-frame
    word.  Group semantics are defined on whole words, so a batch that
    is not a multiple of 32 is rejected."""
    b = active.shape[0]
    if b % GROUP:
        raise ValueError(
            f"stop_mode='group' is defined on {GROUP}-frame words; batch "
            f"must be a multiple of {GROUP}, got {b}")
    return active.reshape(b // GROUP, GROUP).any(dim=1).repeat_interleave(GROUP)


def _dtbf_threshold(Th, l0, l1, t, cfg: BFConfig):
    gamma, alpha, delta = cfg.gamma, cfg.alpha, cfg.delta
    Th = torch.where(t, Th, Th - delta)
    max_th = t & (l0 < cfg.l0)
    Th = torch.where(max_th, gamma + alpha, Th)
    l0 = l0 + max_th.to(torch.int32)
    submax = t & ~max_th & (l1 < cfg.l1)
    Th = torch.where(submax, gamma + alpha - delta, Th)
    l1 = l1 + submax.to(torch.int32)
    ssubmax = t & ~max_th & ~submax
    Th = torch.where(ssubmax, gamma + alpha - 2 * delta, Th)
    Th = torch.clamp(Th, min=1)
    return Th, l0, l1


def run_static_bf(hard: torch.Tensor, code: QCCode, cfg: BFConfig,
                  group: bool = False):
    """Static-threshold BF: flip every VN whose vote reaches
    min(max(max vote of the frame, 1), cap).  Returns (hard,
    rounds_used[batch] int32)."""
    rounds = torch.zeros(hard.shape[0], dtype=torch.int32, device=hard.device)
    for _ in range(cfg.max_iter):
        unsat = syn.unsat_checks(hard, code)
        count = syn.error_count(unsat)
        if not bool((count > 0).any()):
            break
        dirty = group_any(count > 0) if group else count > 0
        votes = syn.flip_votes(unsat, code)
        max_vote = torch.clamp(votes.amax(dim=(1, 2)), min=1)
        thresh = torch.clamp(max_vote, max=cfg.static_vote_cap)
        hard = hard ^ ((votes >= thresh[:, None, None]) & dirty[:, None, None])
        rounds = rounds + dirty.to(torch.int32)
    return hard, rounds


def run_dtbf(hard: torch.Tensor, code: QCCode, cfg: BFConfig,
             group: bool = False, two_bit: bool = False,
             llr: torch.Tensor | None = None):
    """Returns (hard, rounds_used[batch] int32).  ``two_bit`` runs the
    2B1C machine, seeded from ``llr``, the post-MP LLRs [batch, C, Z]."""
    hard_ch = hard          # DTBF anchors on the post-MP hard decision
    if two_bit:
        thr = cfg.reliability_threshold
        hard2 = (llr >= thr) | (llr <= -thr)
    eligible = torch.as_tensor(code.vn_weight_blocks_np == cfg.gamma,
                               device=hard.device)[None]
    batch = hard.shape[0]
    i32 = dict(dtype=torch.int32, device=hard.device)
    Th = torch.full((batch,), cfg.gamma, **i32)
    l0 = torch.zeros(batch, **i32)
    l1 = torch.zeros(batch, **i32)
    t = torch.ones(batch, dtype=torch.bool, device=hard.device)
    rounds = torch.zeros(batch, **i32)
    for _ in range(cfg.max_iter):
        unsat = syn.unsat_checks(hard, code)
        count = syn.error_count(unsat)
        if not bool((count > 0).any()):
            break
        dirty = group_any(count > 0) if group else count > 0
        votes = syn.flip_votes(unsat, code)
        Th2, l0n, l1n = _dtbf_threshold(Th, l0, l1, t, cfg)
        score = votes + cfg.alpha * (hard ^ hard_ch).to(torch.int32)
        flip = eligible & (score >= Th2[:, None, None]) & dirty[:, None, None]
        if two_bit:
            big = (Th2 >= cfg.gamma)[:, None, None]
            xor3 = big & flip
            hard, hard2 = hard ^ xor3, hard2 ^ xor3
            small = ~big & flip
            hard = hard ^ (small & ~hard2)
            hard2 = hard2 ^ (small & hard2)
        else:
            hard = hard ^ flip
        # Frozen (clean) frames keep their state; they never flip.
        Th = torch.where(dirty, Th2, Th)
        l0 = torch.where(dirty, l0n, l0)
        l1 = torch.where(dirty, l1n, l1)
        t = torch.where(dirty, flip.any(dim=(1, 2)), t)
        rounds = rounds + dirty.to(torch.int32)
    return hard, rounds
