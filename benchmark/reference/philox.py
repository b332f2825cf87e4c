"""Philox4x32-10 and the port's stream contract: the quantile
channel's words and the message bits of a round.

A frozen copy of faid_tpu_torch/ops/philox.py at commit
f97303742a3ef9c90c8903c33bcd676948a22a11, without the float chain's
noise stream.  The contract (its docstring there) in short:

  key      = (seed mod 2^32, seed >> 32)
  channel  counter (bit // 4, frame, round mod 2^32, round >> 32),
           word(bit) = w[bit mod 4], as int32
  messages counter (2^31 | (j // 128), frame, round lo, round hi),
           bit j = (w[(j // 32) mod 4] >> (j mod 32)) & 1
  round    = (snr_idx << 32) | rnd          (``stream_round``)

``frame`` is the global frame index of the round: rank r of a world
draws frames r * batch ..
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57        # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments
ROUNDS = 10
_MASK = 0xFFFFFFFF
_MESSAGE_DOMAIN = 1 << 31                # counter word 0's top bit


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for a constant m < 2^32 and an int64
    tensor x in [0, 2^32)."""
    p_lo = x * (m & 0xFFFF)                       # < 2^48
    p_hi = x * (m >> 16)                          # < 2^48
    low_sum = p_lo + ((p_hi & 0xFFFF) << 16)      # < 2^49
    return (p_hi >> 16) + (low_sum >> 32), low_sum & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors (values in [0, 2^32)) broadcast
    together; returns the four output words as int64 tensors."""
    for i in range(ROUNDS):
        if i:
            k0 = (k0 + W0) & _MASK
            k1 = (k1 + W1) & _MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _as_int32(w: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def check_stream_args(seed: int, rnd: int, frame0: int, batch: int) -> None:
    """Seed and round are uint64, global frame indices uint32."""
    if not (0 <= seed < 2**64 and 0 <= rnd < 2**64 and 0 <= frame0
            and frame0 + batch <= 2**32):
        raise ValueError("seed and round are uint64, frames uint32")


def stream_round(snr_idx: int, rnd: int) -> int:
    """The stream's 64-bit round for Monte-Carlo round ``rnd`` of SNR
    point ``snr_idx``."""
    if not (0 <= snr_idx < 2**32 and 0 <= rnd < 2**32):
        raise ValueError(f"snr_idx {snr_idx} and round {rnd} must each lie "
                         f"in [0, 2^32)")
    return (snr_idx << 32) | rnd


def _words(seed: int, rnd: int, frame0: int, batch: int, c0: torch.Tensor):
    """[batch, len(c0), 4] int64: the Philox words of counters (c0, frame,
    round) for frames ``frame0 .. frame0 + batch - 1``."""
    check_stream_args(seed, rnd, frame0, batch)
    i64 = dict(dtype=torch.int64, device=c0.device)
    c1 = torch.arange(frame0, frame0 + batch, **i64)[:, None]
    c0, c1 = torch.broadcast_tensors(c0[None, :], c1)
    c2 = torch.full((1, 1), rnd & _MASK, **i64)
    c3 = torch.full((1, 1), rnd >> 32, **i64)
    return torch.stack(philox4x32(c0, c1, c2, c3, seed & _MASK, seed >> 32),
                       dim=-1)


def channel_words(seed: int, rnd: int, frame0: int, batch: int, n_bits: int,
                  device) -> torch.Tensor:
    """[batch, n_bits] int32: the stream's words for frames
    ``frame0 .. frame0 + batch - 1`` of round ``rnd``."""
    groups = -(-n_bits // 4)
    w = _words(seed, rnd, frame0, batch,
               torch.arange(groups, dtype=torch.int64, device=device))
    return _as_int32(w.reshape(batch, groups * 4)[:, :n_bits])


def message_bits(seed: int, rnd: int, frame0: int, batch: int, n_bits: int,
                 device) -> torch.Tensor:
    """[batch, n_bits] int8 0/1: the message bits of frames ``frame0 ..
    frame0 + batch - 1`` of round ``rnd``, 128 bits per Philox call."""
    calls = -(-n_bits // 128)
    if calls > _MESSAGE_DOMAIN:
        raise ValueError(f"{n_bits} message bits exceed the stream's domain")
    w = _as_int32(_words(seed, rnd, frame0, batch, _MESSAGE_DOMAIN | torch.arange(
        calls, dtype=torch.int64, device=device)))
    # bit j of word k is bit j % 8 of the word's little-endian byte j // 8,
    # so the call's 16 bytes, bit by bit, are its 128 bits in order
    octets = w.view(torch.uint8)                 # [batch, calls, 16]
    shifts = torch.arange(8, dtype=torch.uint8, device=device)
    bits = (octets[..., None] >> shifts) & 1     # [batch, calls, 16, 8]
    return bits.reshape(batch, calls * 128)[:, :n_bits].to(torch.int8)
