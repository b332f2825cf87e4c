"""Layered check-node update in the QC block layout
(``faid_tpu.ops.cn_update.make_block_row_update``).

One call updates a whole block-row (Z independent checks) for every
frame.  Every block is a shifted identity, so the Z checks of a
block-row touch disjoint VNs and the dense update equals the
reference's sequential walk within the row; rows run in order (the
layered schedule).

Sign convention: LLR > 0 is bit 1, so the message sign is
``parity_all XOR own_neg XOR (degree odd)``.

This slice ports the FAID style with EF 0 (FAID3/FAID32/FAID2 tables,
sign backtrack on or off); the NMS and OMS styles and EF 1/2 raise.
"""

from __future__ import annotations

import torch

from ..code.qc_matrix import QCCode
from . import fixed_point as fp


def _min2_scan(mags):
    """The reference's min1/min2 recurrence, both starting at 31."""
    min1 = torch.full_like(mags[0], fp.SAT_POS_VAR)
    min2 = min1
    for m in mags:
        min2 = torch.minimum(min2, torch.maximum(min1, m))
        min1 = torch.minimum(m, min1)
    return min1, min2


def make_block_row_update(code: QCCode, r: int, *, style: str,
                          oms_offset: int, lut: torch.Tensor,
                          sign_backtrack: bool = True,
                          ef_elimination: int = 0):
    """Build the update of block-row ``r``.

    Returns f(en, msgs_r, it) -> (en_new, msgs_r_new), where ``en`` is
    [batch, C, Z] int32, ``msgs_r`` is [batch, deg_r, Z] int32 and
    ``lut`` is the [max_iter, 8] int32 table on the tensors' device."""
    if style != "faid" or ef_elimination != 0:
        raise NotImplementedError(
            f"style={style!r} ef_elimination={ef_elimination} is not "
            f"ported yet (only FAID with EF 0)")
    deg = code.degrees[r]
    cols = code.block_cols[r][:deg]
    shifts = code.shifts[r][:deg]
    odd = bool(deg & 1)

    def update(en, msgs_r, it: int):
        vns = [torch.roll(en[:, c, :], -s, dims=-1)
               for c, s in zip(cols, shifts)]
        vcs = [torch.clamp(fp.sat8(vns[e] - msgs_r[:, e, :]),
                           fp.SAT_NEG_VAR, fp.SAT_POS_VAR)
               for e in range(deg)]
        if sign_backtrack:
            # A zero contribution borrows the sign of En.
            negs = [torch.where(vcs[e] == 0, vns[e], vcs[e]) < 0
                    for e in range(deg)]
        else:
            negs = [v < 0 for v in vcs]
        parity = negs[0]
        for e in range(1, deg):
            parity = parity ^ negs[e]

        row = lut[it]
        mags = [row[torch.clamp(v.abs(), max=7).long()] for v in vcs]
        min1, min2 = _min2_scan(mags)
        cste_1 = torch.clamp(min2 - oms_offset, max=fp.SAT_POS_MSG)
        cste_2 = torch.clamp(min1 - oms_offset, max=fp.SAT_POS_MSG)

        en_out = en.clone()
        new_msgs = []
        for e, (c, s) in enumerate(zip(cols, shifts)):
            vres = torch.where(mags[e] == min1, cste_1, cste_2)
            neg = parity ^ negs[e] ^ odd
            new_msg = torch.where(neg, -vres, vres)
            en_new = torch.clamp(fp.sat8(vcs[e] + new_msg),
                                 fp.SAT_NEG_VAR, fp.SAT_POS_VAR)
            new_msgs.append(new_msg)
            en_out[:, c, :] = torch.roll(en_new, s, dims=-1)
        return en_out, torch.stack(new_msgs, dim=1)

    return update
