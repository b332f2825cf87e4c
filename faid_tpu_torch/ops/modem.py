"""Modulation, demodulation and the channel interleaver, batched over
frames (``faid_tpu.ops.modem``).

Gray-mapped BPSK/QPSK/16/64/256-QAM amplitude tables, the bit -> symbol
packing (even bit positions feed I, odd feed Q, the first bit of a rail
is the MSB of its table index), the max-log "folding" soft demap, and
the per-frame depth-D block interleaver.  Frames are the rows of a
[batch, n] tensor.

Every float operation here is one eager PyTorch op, so nothing can be
contracted into a fused multiply-add or reassociated: the compensated
fold (``_fold_sub``) depends on that, and it is what keeps the demap
bit-exact with the JAX package and the reference.  Do not compile this
path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Gray-map amplitude tables, reference CModulate.cpp:4-7.
TABLE_QPSK = np.array([-0.707107, 0.707107], np.float32)
TABLE_16QAM = np.array([-0.316228, -0.948683, 0.316228, 0.948683], np.float32)
TABLE_64QAM = np.array(
    [-0.462910, -0.154303, -0.771517, -1.08012,
     0.462910, 0.154303, 0.771517, 1.08012], np.float32)
TABLE_256QAM = np.array(
    [-0.383482, -0.536875, -0.230089, -0.076696,
     -0.843661, -0.690268, -0.997054, -1.150447,
     0.383482, 0.536875, 0.230089, 0.076696,
     0.843661, 0.690268, 0.997054, 1.150447], np.float32)

_TABLES = {2: TABLE_QPSK, 4: TABLE_16QAM, 6: TABLE_64QAM, 8: TABLE_256QAM}

# Max-log demap folding constants, reference CModulate.cpp:290-353.
# Python floats (doubles): the reference subtracts the double literal
# from a float and narrows the result to float (see _fold_sub).
_FOLD = {
    2: [],
    4: [0.6324555],
    6: [0.6172134, 0.3086067],
    8: [0.613568, 0.306784, 0.153392],
}


def _f32(value, device) -> torch.Tensor:
    """A 0-dim float32 constant on ``device``, made by a fill kernel: no
    host-to-device copy, which would wait for the device."""
    return torch.full((), value, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _table(mod_type: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_TABLES[mod_type]).to(device)


def _fold_sub(x: torch.Tensor, const: float) -> torch.Tensor:
    """float32(float64(x) - const), computed in float32.

    The constant splits into float32 hi + lo parts and the subtraction
    is compensated (TwoSum), which gives the double-narrowed result
    exactly; a plain float32 subtract of the rounded constant differs in
    the last ulp about half of the time."""
    c_hi = np.float32(const)
    c_lo = np.float32(const - float(c_hi))
    b = _f32(float(-c_hi), x.device)
    s = x + b
    bb = s - x
    err = (x - (s - bb)) + (b - bb)
    return s + (err - _f32(float(c_lo), x.device))


def interleave(bits: torch.Tensor, depth: int) -> torch.Tensor:
    """Per-frame block interleaver: out[j*D + i] = in[(L/D)*i + j] for j in
    [0, L/D), i in [0, D) (reference CModulate.cpp:138-149).  bits: [batch, L]."""
    if depth == 1:
        return bits
    b, length = bits.shape
    return bits.reshape(b, depth, length // depth).transpose(1, 2).reshape(b, length)


def deinterleave(llr: torch.Tensor, depth: int) -> torch.Tensor:
    """Inverse of ``interleave`` (reference CModulate.cpp:161-171)."""
    if depth == 1:
        return llr
    b, length = llr.shape
    return llr.reshape(b, length // depth, depth).transpose(1, 2).reshape(b, length)


def modulate_bpsk(bits: torch.Tensor) -> torch.Tensor:
    """bit -> 2b - 1 amplitude (reference CModulate.cpp:363-370)."""
    return (2 * bits.to(torch.int32) - 1).to(torch.float32)


def modulate_qam(bits: torch.Tensor, mod_type: int) -> torch.Tensor:
    """bits [batch, L] -> symbols as (I, Q) floats [batch, L/mod_type, 2].

    Even bit positions feed I, odd feed Q; within a rail the first bit is
    the MSB of the table index (reference CModulate.cpp:244-262).  A table
    gather: the amplitudes are the table's float32 entries, as the JAX
    package's select tree gives them."""
    half = mod_type // 2
    b, length = bits.shape
    grp = bits.reshape(b, length // mod_type, half, 2).to(torch.int64)
    weights = 2 ** torch.arange(half - 1, -1, -1, device=bits.device)
    idx = (grp != 0).to(torch.int64).mul(weights[:, None]).sum(dim=2)
    return _table(mod_type, bits.device)[idx]


def demodulate_qam(sym: torch.Tensor, mod_type: int) -> torch.Tensor:
    """Max-log soft demap: level 0 is (I, Q), each further level folds
    |prev| - const (reference CModulate.cpp:270-362).
    sym [batch, nsym, 2] -> LLRs [batch, nsym * mod_type], per symbol in
    the order [I0, Q0, I1, Q1, ...]."""
    outs = [sym]
    prev = sym
    for const in _FOLD[mod_type]:
        prev = _fold_sub(torch.abs(prev), const)
        outs.append(prev)
    b, nsym = sym.shape[0], sym.shape[1]
    return torch.stack(outs, dim=2).reshape(b, nsym * mod_type)


def demodulate_bpsk(sym: torch.Tensor) -> torch.Tensor:
    return sym
