"""The plain decoder: LLR ingest -> layered MP iterations (NMS, OMS or
FAID row updates) -> the BF post-processor (static BF, DTBF, 2B1C), in
either stop mode, and the info-bit error count against the sent word.

A frozen copy of faid_tpu_torch's plain decoder at commit
f97303742a3ef9c90c8903c33bcd676948a22a11: ops/fixed_point.py's
saturation constants, decoders/luts.py, ops/syndrome.py,
ops/cn_update.py, decoders/bf.py and decoders/core.py's plain path,
in one module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .code import QCCode
from .config import BFConfig, DecodeMethod, DecoderConfig, FaidLutFamily


def _lut_tensors(lut, lut_ef, device):
    """FAID magnitude rows and error-floor rows -> int32 tensors."""
    return tuple(torch.as_tensor(np.asarray(x).astype(np.int32), device=device)
                 .contiguous() for x in (lut, lut_ef))


INT8_MIN, INT8_MAX = -128, 127

# Saturation limits of the 6-bit variables and 4-bit messages.
SAT_POS_VAR, SAT_NEG_VAR = 31, -31
SAT_POS_MSG = 7


def sat8(x: torch.Tensor) -> torch.Tensor:
    """Saturate a widened integer tensor to the int8 range (stays wide)."""
    return torch.clamp(x, INT8_MIN, INT8_MAX)


_FAID3 = np.array([
    [0, 1, 1, 2, 3, 3, 3, 3],
    [0, 1, 1, 2, 3, 3, 3, 3],
    [0, 1, 1, 2, 4, 4, 4, 4],
    [0, 1, 1, 3, 3, 4, 4, 4],
    [0, 1, 1, 3, 3, 3, 6, 6],
    [0, 1, 1, 3, 3, 3, 7, 7],
], dtype=np.int8)


_FAID32 = np.array([
    [0, 1, 1, 2, 3, 3, 3, 3],
    [0, 1, 1, 2, 3, 3, 3, 3],
    [0, 1, 1, 2, 4, 4, 4, 4],
    [1, 1, 1, 1, 4, 4, 4, 4],
    [1, 1, 1, 1, 5, 5, 5, 5],
    [1, 1, 1, 1, 6, 6, 6, 6],
], dtype=np.int8)

_FAID2 = np.array([
    [0, 0, 2, 2, 2, 2, 2, 2],
    [0, 0, 2, 2, 2, 2, 2, 2],
    [1, 1, 1, 3, 3, 3, 3, 3],
    [1, 1, 1, 4, 4, 4, 4, 4],
    [1, 1, 1, 5, 5, 5, 5, 5],
    [1, 1, 1, 6, 6, 6, 6, 6],
], dtype=np.int8)

_FAID_2B1C = np.array([
    [0, 0, 1, 2, 3, 3, 3, 3],
    [0, 1, 1, 2, 3, 3, 3, 3],
    [0, 1, 1, 2, 3, 3, 3, 3],
    [0, 1, 1, 3, 3, 4, 4, 4],
    [0, 1, 1, 3, 3, 3, 6, 6],
    [0, 1, 1, 3, 3, 3, 7, 7],
], dtype=np.int8)

# Error-floor table, identical for every iteration and family.
EF_ROW = np.array([2, 3, 3, 4, 5, 6, 6, 7], dtype=np.int8)

_FAMILIES = {
    FaidLutFamily.FAID3: _FAID3,
    FaidLutFamily.FAID32: _FAID32,
    FaidLutFamily.FAID2: _FAID2,
    FaidLutFamily.FAID_2B1C: _FAID_2B1C,
}


def table_for(family: FaidLutFamily, max_iter: int) -> np.ndarray:
    """[max_iter, 8] int8; iterations beyond 6 reuse the last row."""
    base = _FAMILIES[family]
    if max_iter <= base.shape[0]:
        return base[:max_iter]
    extra = np.repeat(base[-1:], max_iter - base.shape[0], axis=0)
    return np.concatenate([base, extra], axis=0)


def ef_table(max_iter: int) -> np.ndarray:
    return np.repeat(EF_ROW[None, :], max_iter, axis=0)


def hard_decision(en: torch.Tensor) -> torch.Tensor:
    """bit = (LLR > 0), the reference's convention."""
    return en > 0


def unsat_checks(hard: torch.Tensor, code: QCCode) -> torch.Tensor:
    """[batch, n_block_rows, Z] bool, True where the check is unsatisfied."""
    rows = []
    for r in range(code.n_block_rows):
        acc = None
        for e in range(code.degrees[r]):
            c, s = code.block_cols[r][e], code.shifts[r][e]
            contrib = torch.roll(hard[:, c, :], -s, dims=-1)
            acc = contrib if acc is None else acc ^ contrib
        rows.append(acc)
    return torch.stack(rows, dim=1)


def error_count(unsat: torch.Tensor) -> torch.Tensor:
    """[batch] int32, unsatisfied checks per frame."""
    return unsat.sum(dim=(1, 2), dtype=torch.int32)


def flip_votes(unsat: torch.Tensor, code: QCCode) -> torch.Tensor:
    """[batch, n_block_cols, Z] int32, unsatisfied checks adjacent to
    each VN."""
    batch = unsat.shape[0]
    votes = torch.zeros((batch, code.n_block_cols, code.z), dtype=torch.int32,
                        device=unsat.device)
    for r in range(code.n_block_rows):
        u = unsat[:, r, :].to(torch.int32)
        for e in range(code.degrees[r]):
            c, s = code.block_cols[r][e], code.shifts[r][e]
            votes[:, c, :] += torch.roll(u, s, dims=-1)
    return votes


STYLES = ("nms", "oms", "faid")


@dataclasses.dataclass(frozen=True)
class RowCtx:
    """Per-iteration, per-block-row context of the selective-OMS and EF
    styles (``faid_tpu.ops.cn_update.RowCtx``)."""

    it: int = 0                  # iteration index (0-based)
    in_floor: bool = False       # remaining iterations <= floor_iter_thresh
    l_checksum: torch.Tensor | None = None     # [batch, Z] bool: check unsatisfied
    l_m_error_sum: torch.Tensor | None = None  # [batch] bool: count < floor_err_count
    # EF 2: the flip votes of the iteration-top syndrome, [batch, C, Z]
    # int32, and the VNs erased so far this iteration, [batch, C, Z]
    # bool, which the row update marks in place (JAX returns a new array)
    votes: torch.Tensor | None = None
    era: torch.Tensor | None = None


def _floor_gate(ctx: RowCtx):
    """[batch, Z] bool: the checks in the error-floor window (unsatisfied
    at the iteration top, in a frame with few unsatisfied checks, in the
    last iterations), or None when no check can be (no syndrome sweep)."""
    if ctx.l_checksum is None or not ctx.in_floor:
        return None
    return ctx.l_checksum & ctx.l_m_error_sum[:, None]


def _min2_scan(mags):
    """The reference's min1/min2 recurrence, both starting at 31."""
    min1 = torch.full_like(mags[0], SAT_POS_VAR)
    min2 = min1
    for m in mags:
        min2 = torch.minimum(min2, torch.maximum(min1, m))
        min1 = torch.minimum(m, min1)
    return min1, min2


def _selective_offset(m, eff, f1: int, f2: int):
    """Selective-OMS offset: checks in the floor window raise their
    minimum toward the factor thresholds, all others take the -1/-2
    offset; both steps are sequential."""
    up = m + (m < f2).to(torch.int32)
    up = up + (up <= f1).to(torch.int32)
    down = m - (m > f1).to(torch.int32)
    down = down - (down >= f2).to(torch.int32)
    return down if eff is None else torch.where(eff, up, down)


def make_block_row_update(code: QCCode, r: int, *, style: str,
                          oms_offset: int, lut: torch.Tensor | None,
                          lut_ef: torch.Tensor | None = None,
                          factor_1: int = 1, factor_2: int = 6,
                          oms_mode: int = 0, sign_backtrack: bool = True,
                          ef_elimination: int = 0):
    """Build the update of block-row ``r``.

    Returns f(en, msgs_r, ctx) -> (en_new, msgs_r_new), where ``en`` is
    [batch, C, Z] int32, ``msgs_r`` is [batch, deg_r, Z] (any integer
    type; the new messages are int8, wrapped as the reference stores
    them), ``ctx`` a ``RowCtx``, and ``lut`` / ``lut_ef`` the [max_iter,
    8] int32 tables on the tensors' device (FAID only)."""
    if style not in STYLES:
        raise ValueError(f"style must be one of {STYLES}, got {style!r}")
    if style == "faid" and ef_elimination not in (0, 1, 2):
        raise ValueError(f"ef_elimination must be 0, 1 or 2, got {ef_elimination}")
    if style == "oms" and oms_mode not in (0, 1):
        raise ValueError(f"oms_mode must be 0 or 1, got {oms_mode}")
    faid = style == "faid"
    use_ef = faid and ef_elimination >= 1
    selective = style == "oms" and oms_mode == 1
    deg = code.degrees[r]
    cols = code.block_cols[r][:deg]
    shifts = code.shifts[r][:deg]
    odd = bool(deg & 1)
    # EF 2 erases on the edges into columns of weight 3
    erasing = ([e for e, c in enumerate(cols)
                if int(code.vn_weight_blocks_np[c, 0]) == 3]
               if faid and ef_elimination == 2 else [])

    def update(en, msgs_r, ctx: RowCtx):
        vns = [torch.roll(en[:, c, :], -s, dims=-1)
               for c, s in zip(cols, shifts)]
        m32 = msgs_r.to(torch.int32)
        vcs = [torch.clamp(sat8(vns[e] - m32[:, e, :]), min=SAT_NEG_VAR)
               for e in range(deg)]
        if faid:
            vcs = [torch.clamp(v, max=SAT_POS_VAR) for v in vcs]
        if erasing and ctx.votes is not None and ctx.in_floor:
            # EF 2: in a frame with few unsatisfied checks, the first edge
            # this iteration into a VN with >= 3 flip votes contributes 0
            # and marks the VN erased
            for e in erasing:
                c, s = cols[e], shifts[e]
                m = ((torch.roll(ctx.votes[:, c, :], -s, dims=-1) >= 3)
                     & ctx.l_m_error_sum[:, None]
                     & ~torch.roll(ctx.era[:, c, :], -s, dims=-1))
                vcs[e] = torch.where(m, 0, vcs[e])
                ctx.era[:, c, :] |= torch.roll(m, s, dims=-1)
        if faid and sign_backtrack:
            # A zero contribution borrows the sign of En.
            negs = [torch.where(vcs[e] == 0, vns[e], vcs[e]) < 0
                    for e in range(deg)]
        else:
            negs = [v < 0 for v in vcs]
        parity = negs[0]
        for e in range(1, deg):
            parity = parity ^ negs[e]

        eff = _floor_gate(ctx) if (use_ef or selective) else None
        if faid:
            row = lut[ctx.it]
            idx = [torch.clamp(v.abs(), max=7).long() for v in vcs]
            mags = [row[i] for i in idx]
            if eff is not None:
                # the per-check swap to the error-floor row
                row_ef = lut_ef[ctx.it]
                mags = [torch.where(eff, row_ef[i], m)
                        for i, m in zip(idx, mags)]
        elif style == "oms":
            mags = [torch.clamp(v.abs(), max=SAT_POS_MSG) for v in vcs]
        else:
            mags = [v.abs() for v in vcs]
        min1, min2 = _min2_scan(mags)

        if style == "nms":
            # int16 multiply, arithmetic >> 5, pack-saturate, clamp to 7
            cste_1 = torch.clamp(sat8((min2 * factor_2) >> 5),
                                 max=SAT_POS_MSG)
            cste_2 = torch.clamp(sat8((min1 * factor_1) >> 5),
                                 max=SAT_POS_MSG)
        elif selective:
            cste_1 = torch.clamp(_selective_offset(min2, eff, factor_1,
                                                   factor_2), max=SAT_POS_MSG)
            cste_2 = torch.clamp(_selective_offset(min1, eff, factor_1,
                                                   factor_2), max=SAT_POS_MSG)
        else:
            cste_1 = torch.clamp(min2 - oms_offset, max=SAT_POS_MSG)
            cste_2 = torch.clamp(min1 - oms_offset, max=SAT_POS_MSG)

        en_out = en.clone()
        new_msgs = []
        for e, (c, s) in enumerate(zip(cols, shifts)):
            # FAID compares the mapped magnitude with min1, NMS and OMS
            # the raw |contribution|
            cmp = mags[e] if faid else vcs[e].abs()
            vres = torch.where(cmp == min1, cste_1, cste_2)
            neg = parity ^ negs[e] ^ odd
            new_msg = torch.where(neg, -vres, vres)
            en_new = torch.clamp(sat8(vcs[e] + new_msg),
                                 SAT_NEG_VAR, SAT_POS_VAR)
            new_msgs.append(new_msg)
            en_out[:, c, :] = torch.roll(en_new, s, dims=-1)
        return en_out, torch.stack(new_msgs, dim=1).to(torch.int8)

    return update


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
        unsat = unsat_checks(hard, code)
        count = error_count(unsat)
        if not bool((count > 0).any()):
            break
        dirty = group_any(count > 0) if group else count > 0
        votes = flip_votes(unsat, code)
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
        unsat = unsat_checks(hard, code)
        count = error_count(unsat)
        if not bool((count > 0).any()):
            break
        dirty = group_any(count > 0) if group else count > 0
        votes = flip_votes(unsat, code)
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


def _style_for(method: DecodeMethod) -> str:
    if method == DecodeMethod.NMS:
        return "nms"
    if method in (DecodeMethod.OMS, DecodeMethod.OMS_BF, DecodeMethod.OMS_DTBF):
        return "oms"
    return "faid"


def ingest_llrs(llr: torch.Tensor, code: QCCode) -> torch.Tensor:
    """[batch, n_var] int8 -> block layout [batch, C, Z] int32 with the
    punctured tail zeroed."""
    en = llr.to(torch.int32)
    if code.puncture_tail:
        en[:, llr.shape[1] - code.puncture_tail:] = 0
    return en.reshape(llr.shape[0], code.n_block_cols, code.z)


def _row_updates(code: QCCode, dcfg: DecoderConfig, device) -> list:
    """The block-row updates of ``dcfg``'s style, tables on ``device``."""
    style = _style_for(dcfg.method)
    lut = lut_ef = None
    if style == "faid":
        lut, lut_ef = _lut_tensors(
            table_for(dcfg.lut_family, dcfg.max_iter),
            ef_table(dcfg.max_iter), device)
    return [make_block_row_update(
                code, r, style=style, oms_offset=dcfg.oms_offset, lut=lut,
                lut_ef=lut_ef, factor_1=dcfg.factor_1,
                factor_2=dcfg.factor_2, oms_mode=dcfg.oms_mode,
                sign_backtrack=dcfg.sign_backtrack,
                ef_elimination=dcfg.ef_elimination)
            for r in range(code.n_block_rows)]


def _run_bf(en: torch.Tensor, code: QCCode, dcfg: DecoderConfig,
            group: bool):
    """The BF post-processor of ``dcfg`` on the post-MP ``en`` [batch,
    C, Z]: (hard [batch, C, Z] bool, bf_rounds [batch] int32)."""
    hard = hard_decision(en)
    kind = dcfg.bf.kind
    if kind == "static":
        return run_static_bf(hard, code, dcfg.bf, group=group)
    if kind in ("dtbf", "dtbf2b1c"):
        return run_dtbf(hard, code, dcfg.bf, group=group,
                               two_bit=kind == "dtbf2b1c", llr=en)
    return hard, torch.zeros(en.shape[0], dtype=torch.int32, device=en.device)


def build_plain_mp(code: QCCode, dcfg: DecoderConfig):
    """The plain layered MP iterations: mp(llr [batch, n_var] int8) ->
    (en [batch, C, Z] int32, the post-MP LLRs; mp_iters [batch] int32)."""
    entry_offsets = np.concatenate([[0], np.cumsum(code.degrees_np)])
    n_entries = int(entry_offsets[-1])
    group = dcfg.stop_mode == "group"
    needs_votes = (_style_for(dcfg.method) == "faid"
                   and dcfg.ef_elimination == 2)

    def mp(llr: torch.Tensor):
        batch = llr.shape[0]
        device = llr.device
        rows = _row_updates(code, dcfg, device)
        en = ingest_llrs(llr, code)
        msgs = torch.zeros((batch, n_entries, code.z), dtype=torch.int8,
                           device=device)
        mp_iters = torch.zeros(batch, dtype=torch.int32, device=device)
        for it in range(dcfg.max_iter):
            unsat = l_m_err = votes = era = None
            if dcfg.stop_early:
                # the syndrome at the iteration top: the stop test, and
                # the floor window's per-check map and per-frame gate
                unsat = unsat_checks(hard_decision(en), code)
                count = error_count(unsat)
                active = count > 0
                if not bool(active.any()):
                    break
                l_m_err = count < dcfg.floor_err_count
                if needs_votes:
                    # EF 2's votes; its erase marks reset every iteration
                    votes = flip_votes(unsat, code)
                    era = torch.zeros_like(en, dtype=torch.bool)
            in_floor = dcfg.max_iter - 1 - it <= dcfg.floor_iter_thresh
            en_new, msgs_new = en, msgs.clone()
            for r in range(code.n_block_rows):
                lo, hi = int(entry_offsets[r]), int(entry_offsets[r + 1])
                ctx = RowCtx(
                    it=it, in_floor=in_floor, l_m_error_sum=l_m_err,
                    l_checksum=None if unsat is None else unsat[:, r, :],
                    votes=votes, era=era)
                en_new, msgs_new[:, lo:hi, :] = rows[r](
                    en_new, msgs_new[:, lo:hi, :], ctx)
            if not dcfg.stop_early:
                # no early stop (NMS): every frame runs every iteration
                en, msgs = en_new, msgs_new
                mp_iters += 1
                continue
            # Frames clean at the iteration top keep their state; in
            # group mode a clean frame keeps updating while any frame of
            # its 32-frame word is dirty, and the iteration counts for
            # the whole word.
            counted = group_any(active) if group else active
            a3 = counted[:, None, None]
            en = torch.where(a3, en_new, en)
            msgs = torch.where(a3, msgs_new, msgs)
            mp_iters += counted.to(torch.int32)
        return en, mp_iters

    return mp


def _build_plain_decoder(code: QCCode, dcfg: DecoderConfig):
    mp = build_plain_mp(code, dcfg)
    group = dcfg.stop_mode == "group"

    def decode(llr: torch.Tensor) -> dict:
        en, mp_iters = mp(llr)
        hard, bf_rounds = _run_bf(en, code, dcfg, group)
        return {"hard": hard.reshape(llr.shape[0], code.n_var),
                "mp_iters": mp_iters, "bf_rounds": bf_rounds}

    return decode


def stats_decode(llr: torch.Tensor, code: QCCode, dcfg: DecoderConfig,
                 ref: torch.Tensor | None = None):
    """(err_bits, mp_iters, bf_rounds), each [batch] int32: the decode of
    ``llr`` [batch, n_var] int8, its info bits counted against ``ref``
    (the codeword; None: the all-zero word)."""
    out = _build_plain_decoder(code, dcfg)(llr)
    hard = out["hard"][:, :code.n_info]
    if ref is not None:
        hard = hard ^ (ref[:, :code.n_info] != 0)
    return hard.sum(dim=1, dtype=torch.int32), out["mp_iters"], out["bf_rounds"]
