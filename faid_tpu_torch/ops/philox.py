"""Philox4x32-10 counter-based generator: the random streams of a round,
the quantile channels' words, the message bits and the float chain's
noise.

Replaces the TPU kernels' hardware PRNG (``pltpu.prng_random_bits``) and
the portable threefry draws of ``faid_tpu.ops.pallas_channel``.  Neither
can be reproduced here, so the port defines its own stream and owns both
implementations of it: this plain-torch one, and the CUDA one in
``csrc/philox.cuh``, which must give the same words bit for bit.  The
device half covers the channel's domain (kernels A, C, F, G) and the
message domain (``csrc/message_stream.cu``, which ``message_bits``
launches on a CUDA device); the float chain's noise is plain torch on
every device.

Stream contract
---------------
One uint32 word per codeword bit.  The word for (seed, round, frame,
bit) is a pure function of those four:

  key     = (seed mod 2^32, seed >> 32)                 64-bit seed
  counter = (bit // 4, frame, round mod 2^32, round >> 32)
  (w0, w1, w2, w3) = Philox4x32-10(counter, key)
  word(bit) = w[bit mod 4]

``frame`` is the GLOBAL frame index within the round (a multi-device
run offsets it by the device's first frame, ``frame0 = rank * batch``;
0 on one GPU), ``round`` the stream's 64-bit round.  The SNR sweep gives
Monte-Carlo round ``rnd`` of SNR point ``snr_idx`` the stream round

  round   = (snr_idx << 32) | rnd          ``stream_round``, both < 2^32

the counterpart of the JAX runner's fold_in(fold_in(key(seed),
snr_idx), rnd).  Nothing depends on the batch size, the block size or
the launch geometry, so any frame of any round can be replayed exactly.
The channel uses the word bit-cast to int32 (``ix``).

The message bits of a round with real codewords (``message_bits``,
the counterpart of the JAX pipeline's ``_random_message_bits``) come
from the same generator in a disjoint counter domain, the top bit of
counter word 0 set (the channel's ``bit // 4`` stays below 2^31):

  counter = (2^31 | (j // 128), frame, round mod 2^32, round >> 32)
  bit j   = (w[(j // 32) mod 4] >> (j mod 32)) & 1

so a replay regenerates any round's messages, and the channel's words
are the same with or without them.  ``message_bits_plain`` is the
contract's plain twin; on a CUDA device ``message_bits`` writes the same
bits with one kernel launch.

The QAM quantile channel (kernel G, ops/cuda_channel.py
``quantile_channel_qam``) draws one word per I/Q rail, in the channel's
domain: rail ``r = 2*s + c`` of symbol ``s`` (c = 0 for I, 1 for Q), the
symbols counted on the interleaved bit order, takes word ``r`` of the
frame exactly as bit ``r`` would (counter ``(r // 4, frame, round)``,
word ``r mod 4``).

The float chain's noise (``normal_noise``, channel_backend "xla") takes
one word per noise sample in a third domain, bit 30 of counter word 0
set (the channel's ``bit // 4`` stays below 2^29, the message domain has
bit 31 set):

  counter  = (2^30 | (p // 4), frame, round mod 2^32, round >> 32)
  word(p)  = w[p mod 4]

for sample ``p`` of the frame's noise, counted in the order of the
channel's input: bit p of the interleaved word for BPSK, rail p = 2*s + c
for QPSK and QAM.  A word becomes N(0, 1) the way ``jax.random.normal``
turns its bits into a normal: u = 1.f - 1 from the word's top 23 bits, in
[0, 1); v = max(2u + nextafter(-1, 0), nextafter(-1, 0)), in (-1, 1);
z = float32(sqrt 2) * erfinv(v), all in float32.  erfinv is the
device's: a replay is exact on the device type that ran the round.

``STREAM_TAG`` names this contract (every stream); checkpoints record it
(sim/runner.py).

Philox4x32-10 is Random123's (Salmon et al., SC'11): ten rounds of
``(c0, c1, c2, c3) -> (hi(M1*c2) ^ c1 ^ k0, lo(M1*c2), hi(M0*c0) ^ c3 ^ k1,
lo(M0*c0))`` with the key bumped by the Weyl constants between rounds.

The plain version computes in int64: each 32x32-bit product is split at
16 bits so no intermediate leaves the exact int64 range.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels

M0, M1 = 0xD2511F53, 0xCD9E8D57        # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments
ROUNDS = 10
_MASK = 0xFFFFFFFF
STREAM_TAG = "philox4x32-10/v3"
_MESSAGE_DOMAIN = 1 << 31                # counter word 0's top bit
_NOISE_DOMAIN = 1 << 30                  # counter word 0's bit 30


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


def message_bits_plain(seed: int, rnd: int, frame0: int, batch: int,
                       n_bits: int, device) -> torch.Tensor:
    """Plain PyTorch twin of the message stream's kernel, on ``device``:
    the contract's message domain as int64 tensor ops."""
    calls = _message_calls(n_bits)
    w = _as_int32(_words(seed, rnd, frame0, batch, _MESSAGE_DOMAIN | torch.arange(
        calls, dtype=torch.int64, device=device)))
    # bit j of word k is bit j % 8 of the word's little-endian byte j // 8,
    # so the call's 16 bytes, bit by bit, are its 128 bits in order
    octets = w.view(torch.uint8)                 # [batch, calls, 16]
    shifts = torch.arange(8, dtype=torch.uint8, device=device)
    bits = (octets[..., None] >> shifts) & 1     # [batch, calls, 16, 8]
    return bits.reshape(batch, calls * 128)[:, :n_bits].to(torch.int8)


def _message_calls(n_bits: int) -> int:
    """The Philox calls of a frame's ``n_bits`` message bits, 128 a call."""
    calls = -(-n_bits // 128)
    if calls > _MESSAGE_DOMAIN:
        raise ValueError(f"{n_bits} message bits exceed the stream's domain")
    return calls


def message_bits(seed: int, rnd: int, frame0: int, batch: int, n_bits: int,
                 device) -> torch.Tensor:
    """[batch, n_bits] int8 0/1: the message bits of frames ``frame0 ..
    frame0 + batch - 1`` of round ``rnd``, 128 bits per Philox call.

    On a CUDA device one launch of csrc/message_stream.cu writes them on
    the current stream, with every scalar a kernel argument (no copy to
    the device, no wait for it); on the CPU the plain twin
    ``message_bits_plain`` computes the same bits."""
    dev = kernels.kernel_device(device)
    if dev is None:
        return message_bits_plain(seed, rnd, frame0, batch, n_bits, device)
    check_stream_args(seed, rnd, frame0, batch)
    _message_calls(n_bits)
    out = torch.empty((batch, n_bits), dtype=torch.int8, device=dev)
    if out.numel():
        kernels.launch("faid_message_bits", dev, out.data_ptr(), batch, n_bits,
                       seed, rnd, frame0)
    return out


def normal_from_words(w: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> float32 N(0, 1) samples, as
    ``jax.random.normal`` maps its bits (see the stream contract)."""
    def f32(value):      # a fill kernel, not a copy that waits for the device
        return torch.full((), value, dtype=torch.float32, device=w.device)

    mant = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = mant - f32(1.0)
    lo = f32(float(np.nextafter(np.float32(-1), np.float32(0))))
    v = torch.maximum(u * f32(2.0) + lo, lo)
    return f32(float(np.float32(np.sqrt(2)))) * torch.erfinv(v)


def normal_noise(seed: int, rnd: int, frame0: int, batch: int, n_samples: int,
                 device) -> torch.Tensor:
    """[batch, n_samples] float32 N(0, 1): the float chain's noise of frames
    ``frame0 .. frame0 + batch - 1`` of round ``rnd``."""
    groups = -(-n_samples // 4)
    if groups > _NOISE_DOMAIN // 2:
        raise ValueError(f"{n_samples} noise samples exceed the stream's domain")
    w = _words(seed, rnd, frame0, batch, _NOISE_DOMAIN | torch.arange(
        groups, dtype=torch.int64, device=device))
    return normal_from_words(w.reshape(batch, groups * 4)[:, :n_samples])
