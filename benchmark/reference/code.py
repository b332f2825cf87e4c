"""The QC-LDPC code in block form, read from the code's data file.

A frozen copy of faid_tpu_torch/code/qc_matrix.py and ``convert.py``'s
``code_from_arrays`` at commit f97303742a3ef9c90c8903c33bcd676948a22a11.
``block_cols[r][e]`` / ``shifts[r][e]`` describe entry ``e`` of block row
``r`` as a Z x Z cyclically shifted identity: check ``i`` of block row
``r`` connects to variable node ``block_cols[r][e] * Z + (shifts[r][e] +
i) % Z``.  The data is ``faid_tpu/code/data/<name>.npz``, read by path:
the same file the program loads, and no import of either package.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parents[2] / "faid_tpu" / "code" / "data"
# the 50G-PON code's punctured tail: the last 384 VNs' LLRs are zeroed
PUNCTURE_TAIL = {"50gpon": 384}


@dataclasses.dataclass(frozen=True)
class QCCode:
    name: str
    z: int
    n_var: int
    n_chk: int
    block_cols: tuple
    shifts: tuple
    degrees: tuple
    puncture_tail: int = 0

    @property
    def n_info(self) -> int:
        return self.n_var - self.n_chk

    @property
    def n_block_cols(self) -> int:
        return self.n_var // self.z

    @property
    def n_block_rows(self) -> int:
        return self.n_chk // self.z

    @functools.cached_property
    def degrees_np(self) -> np.ndarray:
        return np.asarray(self.degrees, dtype=np.int32)

    @functools.cached_property
    def vn_weight_np(self) -> np.ndarray:
        """Column weight per VN, [n_var] int32."""
        w = np.zeros(self.n_var, dtype=np.int32)
        for r in range(self.n_block_rows):
            for c in self.block_cols[r][:self.degrees[r]]:
                w[c * self.z:(c + 1) * self.z] += 1
        return w

    @functools.cached_property
    def vn_weight_blocks_np(self) -> np.ndarray:
        """[n_block_cols, z] column weights in block layout."""
        return self.vn_weight_np.reshape(self.n_block_cols, self.z)

    def h_dense(self) -> np.ndarray:
        """Dense H as uint8 [n_chk, n_var]."""
        h = np.zeros((self.n_chk, self.n_var), dtype=np.uint8)
        for r in range(self.n_block_rows):
            for c, s in zip(self.block_cols[r][:self.degrees[r]],
                            self.shifts[r][:self.degrees[r]]):
                i = np.arange(self.z)
                h[r * self.z + i, c * self.z + (s + i) % self.z] = 1
        return h


def code_from_arrays(name: str, z: int, n_var: int, n_chk: int, block_cols,
                     shifts, degrees, puncture_tail: int = 0) -> QCCode:
    """``block_cols`` / ``shifts``: [n_block_rows, >= degree] integer
    arrays (rows may be padded past their degree), ``degrees``:
    [n_block_rows]."""
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


def load_code(name: str) -> QCCode:
    """The code of ``DATA_DIR / <name>.npz``."""
    with np.load(DATA_DIR / f"{name}.npz") as d:
        return code_from_arrays(
            name, d["z"], d["n_var"], d["n_chk"], d["block_cols"],
            d["shifts"], d["degrees"], PUNCTURE_TAIL.get(name, 0))
