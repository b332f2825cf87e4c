"""Numpy arrays -> the port's code object and device tables.

The JAX package describes a code and its decoder tables as numpy arrays
(``QCCode.block_cols_np`` / ``shifts_np`` / ``degrees_np``,
``luts.table_for``).  These two functions turn such arrays into the
port's objects, so ``load_code`` and the decoders build from them, and
tests drive both packages from one source."""

from __future__ import annotations

import numpy as np
import torch

from .code.qc_matrix import QCCode


def code_from_arrays(name: str, z: int, n_var: int, n_chk: int, block_cols,
                     shifts, degrees, puncture_tail: int = 0) -> QCCode:
    """``block_cols`` / ``shifts``: [n_block_rows, >= degree] integer
    arrays (rows may be padded past their degree), ``degrees``: [n_block_rows]."""
    degrees = tuple(int(d) for d in np.asarray(degrees).reshape(-1))
    rows = [np.asarray(r).reshape(-1) for r in block_cols]
    shf = [np.asarray(s).reshape(-1) for s in shifts]
    if not len(rows) == len(shf) == len(degrees) == n_chk // z:
        raise ValueError("one row of block_cols/shifts/degrees per block row")
    return QCCode(
        name=name, z=int(z), n_var=int(n_var), n_chk=int(n_chk),
        block_cols=tuple(tuple(int(x) for x in r) for r in rows),
        shifts=tuple(tuple(int(x) for x in s) for s in shf),
        degrees=degrees, puncture_tail=int(puncture_tail))


def tables_from_arrays(lut, lut_ef, device):
    """FAID magnitude rows ([max_iter, 8]) and error-floor rows -> a pair
    of contiguous int32 tensors on ``device``."""
    def t(x):
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != 8:
            raise ValueError(f"LUT rows must be [max_iter, 8], got {x.shape}")
        return torch.as_tensor(x.astype(np.int32), device=device).contiguous()

    return t(lut), t(lut_ef)
