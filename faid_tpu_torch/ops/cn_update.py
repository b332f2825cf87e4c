"""Layered check-node update in the QC block layout
(``faid_tpu.ops.cn_update.make_block_row_update``).

One call updates a whole block-row (Z independent checks) for every
frame.  Every block is a shifted identity, so the Z checks of a
block-row touch disjoint VNs and the dense update equals the
reference's sequential walk within the row; rows run in order (the
layered schedule).

Sign convention: LLR > 0 is bit 1, so the message sign is
``parity_all XOR own_neg XOR (degree odd)``.

Styles: ``nms`` (raw magnitudes, ``(min * factor) >> 5``), ``oms``
(magnitudes clipped to 7; offset mode 0 or the selective offsets of mode
1) and ``faid`` (per-iteration LUT magnitudes, sign backtrack, EF 0, the
EF 1 per-check swap to the error-floor row, or EF 2: that swap and the
one-shot erasure of flip-voted weight-3 VNs).
"""

from __future__ import annotations

import dataclasses

import torch

from ..code.qc_matrix import QCCode
from . import fixed_point as fp

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
    min1 = torch.full_like(mags[0], fp.SAT_POS_VAR)
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
        vcs = [torch.clamp(fp.sat8(vns[e] - m32[:, e, :]), min=fp.SAT_NEG_VAR)
               for e in range(deg)]
        if faid:
            vcs = [torch.clamp(v, max=fp.SAT_POS_VAR) for v in vcs]
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
            mags = [torch.clamp(v.abs(), max=fp.SAT_POS_MSG) for v in vcs]
        else:
            mags = [v.abs() for v in vcs]
        min1, min2 = _min2_scan(mags)

        if style == "nms":
            # int16 multiply, arithmetic >> 5, pack-saturate, clamp to 7
            cste_1 = torch.clamp(fp.sat8((min2 * factor_2) >> 5),
                                 max=fp.SAT_POS_MSG)
            cste_2 = torch.clamp(fp.sat8((min1 * factor_1) >> 5),
                                 max=fp.SAT_POS_MSG)
        elif selective:
            cste_1 = torch.clamp(_selective_offset(min2, eff, factor_1,
                                                   factor_2), max=fp.SAT_POS_MSG)
            cste_2 = torch.clamp(_selective_offset(min1, eff, factor_1,
                                                   factor_2), max=fp.SAT_POS_MSG)
        else:
            cste_1 = torch.clamp(min2 - oms_offset, max=fp.SAT_POS_MSG)
            cste_2 = torch.clamp(min1 - oms_offset, max=fp.SAT_POS_MSG)

        en_out = en.clone()
        new_msgs = []
        for e, (c, s) in enumerate(zip(cols, shifts)):
            # FAID compares the mapped magnitude with min1, NMS and OMS
            # the raw |contribution|
            cmp = mags[e] if faid else vcs[e].abs()
            vres = torch.where(cmp == min1, cste_1, cste_2)
            neg = parity ^ negs[e] ^ odd
            new_msg = torch.where(neg, -vres, vres)
            en_new = torch.clamp(fp.sat8(vcs[e] + new_msg),
                                 fp.SAT_NEG_VAR, fp.SAT_POS_VAR)
            new_msgs.append(new_msg)
            en_out[:, c, :] = torch.roll(en_new, s, dims=-1)
        return en_out, torch.stack(new_msgs, dim=1).to(torch.int8)

    return update
