"""GF(2) systematic encoding: c = [u | (P u) mod 2] with P = H_p^-1 H_i.

A frozen copy of faid_tpu_torch/code/encoder.py at commit
f97303742a3ef9c90c8903c33bcd676948a22a11, with its own product: the
program takes ``torch._int_mm`` (an int8 library kernel); this one takes a
float32 matrix product with TF32 off, exact since every partial sum is
an integer below 2^24.  P is read from ``<name>_encoder.npz`` beside the
code's data file or, where there is none (toy codes), solved by
elimination over GF(2).
"""

from __future__ import annotations

import numpy as np
import torch

from .code import DATA_DIR, QCCode


def _pack_bits(a: np.ndarray) -> np.ndarray:
    """[rows, cols] uint8 {0,1} -> [rows, ceil(cols/64)] uint64 bit-pack."""
    rows, cols = a.shape
    pad = (-cols) % 64
    if pad:
        a = np.pad(a, ((0, 0), (0, pad)))
    bits = a.reshape(rows, -1, 64).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(64, dtype=np.uint64))[None, None, :]
    return (bits * weights).sum(axis=2, dtype=np.uint64)


def _unpack_bits(p: np.ndarray, cols: int) -> np.ndarray:
    rows = p.shape[0]
    bits = (p[:, :, None] >> np.arange(64, dtype=np.uint64)[None, None, :]) & np.uint64(1)
    return bits.reshape(rows, -1)[:, :cols].astype(np.uint8)


def solve_parity_projection(h: np.ndarray, n_info: int) -> np.ndarray:
    """P with parity = (P @ u) % 2, by elimination on [H_p | H_i] to
    reduced row echelon form.  Raises if H_p is singular over GF(2)."""
    n_chk = h.shape[0]
    aug = _pack_bits(np.concatenate([h[:, n_info:], h[:, :n_info]], axis=1))
    for col in range(n_chk):
        word, bit = divmod(col, 64)
        col_bits = (aug[:, word] & (np.uint64(1) << np.uint64(bit))) != 0
        pivots = np.nonzero(col_bits[col:])[0]
        if pivots.size == 0:
            raise ValueError(f"H_p singular at column {col}")
        piv = col + int(pivots[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
            col_bits[[col, piv]] = col_bits[[piv, col]]
        col_bits[col] = False
        rows = np.nonzero(col_bits)[0]
        if rows.size:
            aug[rows] ^= aug[col]
    # the left block is now the identity; the right block's rows are P
    return _unpack_bits(aug, n_chk + n_info)[:, n_chk:]


def encoder_matrix(code: QCCode) -> np.ndarray:
    """[n_chk, n_info] uint8 parity projection matrix."""
    path = DATA_DIR / f"{code.name}_encoder.npz"
    if path.exists():
        with np.load(path) as d:
            return np.ascontiguousarray(d["p"], dtype=np.uint8)
    return solve_parity_projection(code.h_dense(), code.n_info)


def make_encode_fn(code: QCCode, device):
    """encode(u [batch, n_info] int8 0/1) -> c [batch, n_var] int8."""
    if code.n_info >= 2**24:
        raise ValueError("float32 sums are exact below 2^24 terms only")
    p_t = torch.from_numpy(encoder_matrix(code).T.astype(np.float32)).to(device)

    def encode(u: torch.Tensor) -> torch.Tensor:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            acc = u.to(torch.float32) @ p_t
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        parity = (acc.to(torch.int64) & 1).to(torch.int8)
        return torch.cat([u.to(torch.int8), parity], dim=1)

    return encode
