"""Fixed-point constants, saturation of the reference's int8 SIMD, and the
channel LLR quantizers.

Torch int8 arithmetic wraps, so every sum is taken on int32 tensors and
clipped, which reproduces the saturating semantics exactly:

  adds_epi8(a, b) == clip(a + b, -128, 127)
  subs_epi8(a, b) == clip(a - b, -128, 127)
"""

from __future__ import annotations

import torch

INT8_MIN, INT8_MAX = -128, 127

# Saturation limits of the 6-bit variables and 4-bit messages.
SAT_POS_VAR, SAT_NEG_VAR = 31, -31
SAT_POS_MSG = 7

# Per-width quantizer output limits (2..6 bits).
_QUANT_LIMITS = {
    6: (-31, 31),
    5: (-16, 15),
    4: (-7, 7),
    3: (-4, 3),
    2: (-2, 1),
}


def sat8(x: torch.Tensor) -> torch.Tensor:
    """Saturate a widened integer tensor to the int8 range (stays wide)."""
    return torch.clamp(x, INT8_MIN, INT8_MAX)


def quantize_llr(x: torch.Tensor, scale: float, bits: int) -> torch.Tensor:
    """float LLR -> int8 fixed point (``faid_tpu.ops.fixed_point.quantize_llr``,
    the reference's float2LimitChar_{bits}bit).

    ``x * scale`` is one float32 multiply by the scale as a float32 tensor
    on ``x``'s device (a fill, not a copy that would wait for the device).  6-bit rounds half to even; 5..2-bit truncate toward
    zero; both then take the int16 -> int8 pack saturation and the width's
    limits.  1-bit slices the sign to +-31.  The 6-bit quantizer rounds
    every element, as the JAX package does; the reference's scalar tail
    loop truncates the last ``n % 16`` of a frame, which no 50G-PON
    shape reaches (17664 is a multiple of 16)."""
    y = x * torch.full((), scale, dtype=torch.float32, device=x.device)
    if bits == 1:
        return torch.where(torch.trunc(y) > 0, 31, -31).to(torch.int8)
    lo, hi = _QUANT_LIMITS[bits]
    q = torch.round(y) if bits == 6 else torch.trunc(y)
    q = torch.clamp(q, INT8_MIN, INT8_MAX)       # packs_epi16 saturation
    return torch.clamp(q, lo, hi).to(torch.int8)
