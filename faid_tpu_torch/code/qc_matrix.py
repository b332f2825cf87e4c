"""QC-LDPC code object in the block form of ``faid_tpu.code.qc_matrix``.

``block_cols[r][e]`` / ``shifts[r][e]`` describe entry ``e`` of block-row
``r`` as a Z x Z cyclically shifted identity: check ``i`` of block-row
``r`` connects to variable node ``block_cols[r][e]*Z + (shifts[r][e] + i)
% Z``.  Numpy only; the code data is the JAX package's committed
``faid_tpu/code/data/*.npz``, read in place by path (importing
``faid_tpu`` would pull in JAX).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parents[2] / "faid_tpu" / "code" / "data"


@dataclasses.dataclass(frozen=True)
class QCCode:
    """Static description of a QC-LDPC code; hashable."""

    name: str
    z: int                      # circulant size (256)
    n_var: int                  # codeword length N (17664)
    n_chk: int                  # number of checks M (3072)
    block_cols: tuple           # tuple[tuple[int]] per block-row
    shifts: tuple               # same shape as block_cols
    degrees: tuple              # check degree per block-row
    vn_weight_key: str = "50gpon"
    # Channel LLRs of the last `puncture_tail` VNs are zeroed before
    # decoding (384 for 50G-PON, making the effective rate 14592/17280).
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

    @property
    def max_deg(self) -> int:
        return max(self.degrees)

    @functools.cached_property
    def block_cols_np(self) -> np.ndarray:
        return np.asarray(self.block_cols, dtype=np.int32)

    @functools.cached_property
    def shifts_np(self) -> np.ndarray:
        return np.asarray(self.shifts, dtype=np.int32)

    @functools.cached_property
    def degrees_np(self) -> np.ndarray:
        return np.asarray(self.degrees, dtype=np.int32)

    @functools.cached_property
    def vn_weight_np(self) -> np.ndarray:
        """Column weight per VN, [n_var] int32."""
        w = np.zeros(self.n_var, dtype=np.int32)
        for r in range(self.n_block_rows):
            for e in range(self.degrees[r]):
                c = self.block_cols[r][e]
                w[c * self.z:(c + 1) * self.z] += 1
        return w

    @functools.cached_property
    def vn_weight_blocks_np(self) -> np.ndarray:
        """[n_block_cols, z] column weights in block layout."""
        return self.vn_weight_np.reshape(self.n_block_cols, self.z)

    @functools.cached_property
    def edge_list_np(self) -> np.ndarray:
        """Flat row-major check->VN edge list."""
        out = []
        for r in range(self.n_block_rows):
            cols = self.block_cols_np[r, :self.degrees[r]]
            shf = self.shifts_np[r, :self.degrees[r]]
            for i in range(self.z):
                out.append(cols * self.z + (shf + i) % self.z)
        return np.concatenate(out).astype(np.int32)

    def h_dense(self) -> np.ndarray:
        """Dense H as uint8 [n_chk, n_var]."""
        h = np.zeros((self.n_chk, self.n_var), dtype=np.uint8)
        rows = np.repeat(np.arange(self.n_chk),
                         [self.degrees[r] for r in np.arange(self.n_chk) // self.z])
        h[rows, self.edge_list_np] = 1
        return h


def load_code(name: str = "50gpon") -> QCCode:
    from ..convert import code_from_arrays

    with np.load(DATA_DIR / f"{name}.npz") as d:
        return code_from_arrays(
            name, d["z"], d["n_var"], d["n_chk"], d["block_cols"], d["shifts"],
            d["degrees"], puncture_tail=384 if name == "50gpon" else 0)
