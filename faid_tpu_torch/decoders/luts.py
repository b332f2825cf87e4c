"""FAID V2C lookup tables as data, ``[iteration][|v2c|]``.

The same rows as ``faid_tpu.decoders.luts``: one row per iteration (all
published weight buckets are identical), magnitudes 0..7 where index 7
doubles as the overflow bucket for |v2c| >= 8."""

from __future__ import annotations

import numpy as np

from ..config import FaidLutFamily

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
