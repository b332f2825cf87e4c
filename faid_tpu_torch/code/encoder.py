"""GF(2) systematic encoder for QC-LDPC codes (``faid_tpu.code.encoder``).

With the codeword split c = [u | p] (info, parity), H c^T = 0 gives
``p = (H_p^{-1} H_i) u`` over GF(2).  The dense projection matrix
``P = H_p^{-1} H_i`` (n_chk x n_info) is read from the JAX package's
committed ``faid_tpu/code/data/<name>_encoder.npz`` in place (45 MB as
int8 for 50G-PON) or, where there is none (toy codes), solved here with
bit-packed Gaussian elimination, a numpy copy of
``solve_parity_projection``.  Encoding is then one int8 matrix product
with int32 sums, taken mod 2.

The product is a plain PyTorch call (``torch._int_mm``), as the JAX
package leaves it to XLA; it is not one of the port's kernels.  Its row
sums reach n_info (14592 for 50G-PON), beyond the exact range of fp16
and bf16 outputs, so the sums stay int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .qc_matrix import DATA_DIR, QCCode


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


@functools.lru_cache(maxsize=4)
def encoder_matrix(code: QCCode) -> np.ndarray:
    """[n_chk, n_info] uint8 parity projection matrix: the committed
    ``<name>_encoder.npz`` when there is one, else solved (never
    written)."""
    path = DATA_DIR / f"{code.name}_encoder.npz"
    if not code.name.startswith("toy_") and path.exists():
        with np.load(path) as d:
            p = d["p"]
    else:
        p = solve_parity_projection(code.h_dense(), code.n_info)
    p = np.ascontiguousarray(p, dtype=np.uint8)
    p.setflags(write=False)
    return p


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


def make_encode_fn(code: QCCode, device="cuda"):
    """Returns encode(u [batch, n_info] int8 0/1 on ``device``) -> c
    [batch, n_var] int8 = [u | (u @ P^T) & 1].

    ``torch._int_mm`` takes int8 x int8 -> int32 with more than 16 rows
    and both other dimensions multiples of 8 (the CUDA constraint), so a
    smaller batch or a toy code's dimensions are zero-padded; zero rows
    and columns add nothing to the sums."""
    p = encoder_matrix(code)
    n_chk, n_info = p.shape
    k8, n8 = _ceil8(n_info), _ceil8(n_chk)
    # P^T [k8, n8] as the transpose of a row-major P, the operand layout
    # cuBLASLt's int8 product takes
    p_pad = torch.zeros((n8, k8), dtype=torch.int8)
    p_pad[:n_chk, :n_info] = torch.from_numpy(p.astype(np.int8))
    p_t = p_pad.to(device).t()

    def encode(u: torch.Tensor) -> torch.Tensor:
        if (u.dtype != torch.int8 or u.dim() != 2 or u.shape[1] != n_info
                or u.device != p_t.device):
            raise ValueError(f"u must be int8 [batch, {n_info}] on "
                             f"{p_t.device}")
        batch = u.shape[0]
        a = u
        if batch <= 16 or k8 != n_info:
            a = u.new_zeros((max(batch, 17), k8))
            a[:batch, :n_info] = u
        acc = torch._int_mm(a.contiguous(), p_t)[:batch, :n_chk]
        return torch.cat([u, (acc & 1).to(torch.int8)], dim=1)

    return encode


def syndrome_weight(code: QCCode, c: torch.Tensor) -> torch.Tensor:
    """[batch] int32: the unsatisfied checks of each frame of ``c``
    [batch, n_var] (0/1), on ``c``'s device (``syndrome_weight_np``)."""
    from ..ops import syndrome

    hard = (c != 0).reshape(c.shape[0], code.n_block_cols, code.z)
    return syndrome.error_count(syndrome.unsat_checks(hard, code))
