"""Small synthetic QC-LDPC codes for tests and the on-card smoke run.

The same generator as ``faid_tpu.code.toy``: QC shifted-identity blocks,
mixed column weights including weight-3 VNs (so the DTBF flip rule has
eligible targets), deterministic, searching seeds until every column is
used and the parity part H_p is invertible over GF(2)."""

from __future__ import annotations

import functools

import numpy as np

from .qc_matrix import QCCode


def _gf2_invertible(a: np.ndarray) -> bool:
    """True if the square 0/1 matrix ``a`` is invertible over GF(2)."""
    m = a.astype(bool).copy()
    n = m.shape[0]
    for col in range(n):
        piv = np.nonzero(m[col:, col])[0]
        if piv.size == 0:
            return False
        p = col + int(piv[0])
        if p != col:
            m[[col, p]] = m[[p, col]]
        rows = np.nonzero(m[:, col])[0]
        rows = rows[rows != col]
        m[rows] ^= m[col]
    return True


@functools.lru_cache(maxsize=4)
def toy_code(z: int = 8, n_block_cols: int = 12, n_block_rows: int = 4,
             row_degree: int = 6, seed: int = 0) -> QCCode:
    rng_seed = seed
    for _ in range(64):
        rng = np.random.default_rng(rng_seed)
        block_cols, shifts = [], []
        n_par = n_block_rows
        par = n_block_cols - n_par + np.arange(n_par)
        for r in range(n_block_rows):
            # Lower block-bidiagonal parity part keeps H_p triangular.
            par_cols = [par[r]] if r == 0 else [par[r - 1], par[r]]
            info = rng.choice(n_block_cols - n_par,
                              size=row_degree - len(par_cols), replace=False)
            cols = np.sort(np.concatenate([info, par_cols]))
            block_cols.append(tuple(int(c) for c in cols))
            shifts.append(tuple(int(s) for s in
                                rng.integers(0, z, size=len(cols))))
        code = QCCode(
            name=f"toy_z{z}_c{n_block_cols}_r{n_block_rows}_s{rng_seed}",
            z=z, n_var=n_block_cols * z, n_chk=n_block_rows * z,
            block_cols=tuple(block_cols), shifts=tuple(shifts),
            degrees=tuple(len(c) for c in block_cols))
        if (code.vn_weight_np.min() == 0
                or not _gf2_invertible(code.h_dense()[:, code.n_info:])):
            rng_seed += 1
            continue
        return code
    raise RuntimeError("no invertible toy code found")
