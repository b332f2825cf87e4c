"""Syndrome and flip-vote sweeps in the QC block layout
(``faid_tpu.ops.syndrome``).

``hard`` is [batch, n_block_cols, Z] bool; each block entry of H
contributes one roll along Z (``torch.roll`` has ``jnp.roll``'s
semantics), so there is no gather or scatter.
"""

from __future__ import annotations

import torch

from ..code.qc_matrix import QCCode


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
