"""Fixed-point constants and saturation of the reference's int8 SIMD.

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
