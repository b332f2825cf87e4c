"""The 16/64/256-QAM quantile channel's plan: the rail's levels as
staircases of one uniform draw, their thresholds, and the per-frame
block interleaver.

A frozen copy of faid_tpu_torch/ops/qam_plan.py (``_plan``,
``plan_threshold_ints``, ``_eval_level``, ``staircase_qam``, ``ndtr``,
``grid``) and of ops/modem.py's tables, folding constants and
interleaver, at commit f97303742a3ef9c90c8903c33bcd676948a22a11.  It
evaluates each level's intervals one by one, the plain path; the
program's kernel searches a cell table made from the same thresholds.

``plan_threshold_ints`` and ``ndtr`` take the float type of the
probabilities (float32, as the configuration states; the control of
``benchmark/control.py`` passes bfloat16).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_QUANT_LIMITS = {6: (-31, 31), 5: (-16, 15), 4: (-7, 7), 3: (-4, 3), 2: (-2, 1)}
_INF = float("inf")

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

# Max-log demap folding constants, reference CModulate.cpp:290-353.
# Python floats (doubles): the reference subtracts the double literal
# from a float and narrows the result to float (see _fold_sub).
_FOLD = {
    2: [],
    4: [0.6324555],
    6: [0.6172134, 0.3086067],
    8: [0.613568, 0.306784, 0.153392],
}


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


# QAM rail magnitudes indexed by the Gray magnitude index m (the rail's
# bits after the sign bit, the first sent the MSB of m): the tables are
# sign-symmetric halves, table[2^(h-1) + m] == -table[m].
_MAGNITUDES = {
    2: np.abs(TABLE_QPSK[1:]).astype(np.float64),
    4: np.abs(TABLE_16QAM[2:]).astype(np.float64),
    6: np.abs(TABLE_64QAM[4:]).astype(np.float64),
    8: np.abs(TABLE_256QAM[8:]).astype(np.float64),
}

# the int32 grid: u = (ix + 2^31) / 2^32
_IMAX, _IMIN = 2**31 - 1, -(2**31)
_XMAX = float(2**31 - 256)                 # float32-representable clamp


def step_offsets(quant_bits: int) -> np.ndarray:
    """float64[L] quantizer step positions: {q >= k} <=> {y > off[k-1]};
    integers for the truncating 2-5-bit quantizers, half-integers for the
    round-half-even 6-bit one."""
    lo, hi = _QUANT_LIMITS[quant_bits]
    ks = np.arange(1, max(hi, -lo) + 1, dtype=np.float64)
    return ks - 0.5 if quant_bits == 6 else ks


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF in ``x``'s float type (float32 as the
    configuration states), as ``jax.scipy.special.ndtr`` takes it: 0.5 (1
    + erf(x / sqrt 2)) for |x| < 1, erfc in both tails.
    ``torch.special.ndtr`` takes 1 + erf everywhere, which in float32
    loses the tail: 4% off at -5, 0 at -5.65 where the CDF is 8.3e-9, so
    a quantizer step that rare would never be drawn."""
    f32 = dict(dtype=x.dtype)
    half_sqrt_2 = torch.tensor(np.float32(0.5) * np.sqrt(np.float32(2.0)), **f32)
    w = x * half_sqrt_2
    z = w.abs()
    one, two, half = (torch.tensor(v, **f32) for v in (1.0, 2.0, 0.5))
    return half * torch.where(z < half_sqrt_2, one + torch.erf(w),
                              torch.where(w > 0, two - torch.special.erfc(z),
                                          torch.special.erfc(z)))


def grid(p: torch.Tensor, least: float = 0.0) -> torch.Tensor:
    """round(p * 2^32) onto the uniform grid, float32 as in the JAX
    package, clamped to [least, 2^31 - 256]; int64.  A probability of a
    narrower float type is widened to float32 first."""
    two32 = torch.tensor(4294967296.0, dtype=torch.float32)
    p = p.to(torch.float32)
    return torch.clamp(torch.round(p * two32), least, _XMAX).to(torch.int64)


def _isect(a, b):
    """Intersection of two disjoint-interval lists (each sorted)."""
    out = []
    for lo1, hi1 in a:
        for lo2, hi2 in b:
            lo, hi = max(lo1, lo2), min(hi1, hi2)
            if lo < hi:
                out.append((lo, hi))
    return out


def _expand_ge(level, t, folds):
    """y-intervals of {L_level >= t}."""
    if level == 0:
        return [(t, _INF)]
    u = folds[level - 1] + t
    if u <= 0:
        return [(-_INF, _INF)]          # |L_{level-1}| >= u always holds
    return (_expand_ge(level - 1, u, folds)
            + _expand_le(level - 1, -u, folds))


def _expand_le(level, t, folds):
    """y-intervals of {L_level <= t}."""
    if level == 0:
        return [(-_INF, t)]
    u = folds[level - 1] + t
    if u < 0:
        return []                       # |L_{level-1}| <= u impossible
    return _isect(_expand_ge(level - 1, -u, folds),
                  _expand_le(level - 1, u, folds))


@functools.lru_cache(maxsize=None)
def _plan(mod_type: int, quant_bits: int, scale: float):
    """(levels, defs): ``defs`` the deduplicated endpoints [('gt'|'lt', x)]
    ('gt' needs T with {ix > T} <=> {y > x}, 'lt' with {ix < T} <=> {y <
    x}); ``levels[l]`` a dict of interval lists per event, each interval
    (lo endpoint index | None, hi endpoint index | None), and ``base``,
    the count of always-true >= steps:
      pos[k-1]: {L_l >= k/scale},  neg[k-1]: {L_l <= -k/scale},
      hard:     {L_l > 0}."""
    folds = tuple(_FOLD[mod_type])
    defs: list[tuple[str, float]] = []
    index: dict[tuple[str, float], int] = {}

    def ref(kind, x):
        key = (kind, float(x))
        if key not in index:
            index[key] = len(defs)
            defs.append(key)
        return index[key]

    def compile_event(intervals):
        out, base = [], 0
        for lo_x, hi_x in intervals:
            if lo_x == -_INF and hi_x == _INF:
                base += 1
                continue
            out.append((None if lo_x == -_INF else ref("gt", lo_x),
                        None if hi_x == _INF else ref("lt", hi_x)))
        return tuple(out), base

    levels = []
    for lev in range(mod_type // 2):
        pos, neg, base = [], [], 0
        for off in step_offsets(quant_bits):
            iv, b = compile_event(_expand_ge(lev, off / scale, folds))
            pos.append(iv)
            base += b
            iv, b = compile_event(_expand_le(lev, -off / scale, folds))
            assert b == 0   # a <= event never covers the whole line
            neg.append(iv)
        hard, hb = compile_event(_expand_ge(lev, 0.0, folds))
        assert hb == 0      # the folds are positive: {L_l > 0} is proper
        levels.append({"pos": tuple(pos), "neg": tuple(neg),
                       "hard": hard, "base": base})
    return tuple(levels), tuple(defs)


def plan_threshold_ints(cfg, sigma: float,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int32 [nmag, nparam] CPU tensor: the plan's thresholds, one row per
    Gray magnitude index, for a sent '0' sign bit (amplitude -a_m).

    The port of ``_plan_threshold_ints``, in float32 with ``ndtr``: each
    probability on its small side, rounded half to even onto the 2^-32
    grid, turned into a threshold with exact integer arithmetic; a step
    whose probability rounds to 0 gets an unreachable threshold.
    ``dtype``: the float type the probabilities are taken in."""
    _, defs = _plan(cfg.mod_type, cfg.quant_bits, float(cfg.scale))
    f32 = dict(dtype=dtype)
    srail = torch.tensor(sigma, **f32) / torch.sqrt(torch.tensor(2.0, **f32))
    s = torch.as_tensor(-_MAGNITUDES[cfg.mod_type], **f32)[:, None]
    xs = torch.as_tensor([x for _, x in defs], **f32)[None, :]
    t = (xs - s) / srail
    t_gt = torch.where(t > 0, _IMAX - grid(ndtr(-t)),
                       _IMIN + grid(ndtr(t), 1.0) - 1)
    t_lt = torch.where(t < 0, _IMIN + grid(ndtr(t)),
                       _IMAX - grid(ndtr(-t), 1.0) + 1)
    is_gt = torch.tensor([k == "gt" for k, _ in defs])[None, :]
    return torch.where(is_gt, t_gt, t_lt).to(torch.int32)


def _eval_level(ixe, level_plan, P):
    """One level's staircase on the mirrored draw ``ixe``; ``P(j)`` the
    threshold of endpoint j for each element's magnitude row.  Returns (q
    int32 before the asymmetric clip and the level-0 sign restore, hard
    int32)."""
    def ind(iv):
        lo, hi = iv
        if lo is None:
            return (ixe < P(hi)).to(torch.int32)
        if hi is None:
            return (ixe > P(lo)).to(torch.int32)
        return ((ixe > P(lo)) & (ixe < P(hi))).to(torch.int32)

    def event(intervals):
        out = torch.zeros(ixe.shape, dtype=torch.int32, device=ixe.device)
        for iv in intervals:
            out += ind(iv)
        return out

    q = torch.full(ixe.shape, level_plan["base"], dtype=torch.int32,
                   device=ixe.device)
    for iv_list in level_plan["pos"]:
        q += event(iv_list)
    for iv_list in level_plan["neg"]:
        q -= event(iv_list)
    return q, event(level_plan["hard"])


def magnitude_index(mag_bits) -> torch.Tensor | int:
    """The Gray magnitude index m of a rail from its magnitude bits
    (levels 1..h-1 in send order, the first the MSB)."""
    m = 0
    for b in mag_bits:
        m = 2 * m + (b != 0).to(torch.int64)
    return m


def staircase_qam(ix_rail, sign_bit, mag_bits, params, *, mod_type,
                  quant_bits, scale):
    """One int32 draw per rail -> every level's quantized LLR and hard
    decision (the rail layout of ``staircase_qam``).

    ix_rail   int32 [...], the rail's draw;
    sign_bit  the rail's sent sign bit (level 0), shaped like ix_rail;
    mag_bits  the rail's magnitude bits, levels 1..h-1 in send order;
    params    int32 [nmag, nparam], ``plan_threshold_ints``.

    Returns (qs, hards), lists over level of int32 tensors: the signed
    quantized LLRs (asymmetric clip applied) and {L_l > 0} on the mirrored
    draw.  hards[0] is the level-0 pre-decoder error indicator; for l >= 1
    the caller XORs hards[l] with the sent bit."""
    levels, _ = _plan(mod_type, quant_bits, float(scale))
    lo, hi = _QUANT_LIMITS[quant_bits]
    mask0 = -(sign_bit != 0).to(torch.int32)
    ixe = ix_rail ^ mask0
    # endpoint j's threshold per element, gathered where it is used: the
    # whole [..., nparam] row per element would not fit at full size
    cols = params.t().contiguous()
    m = magnitude_index(mag_bits)
    P = (lambda j: cols[j][m]) if mag_bits else (lambda j: cols[j][0])
    qs, hards = [], []
    for lev, lplan in enumerate(levels):
        q, h = _eval_level(ixe, lplan, P)
        if lev == 0:
            q = (q ^ mask0) - mask0        # sign restore (odd staircase)
        if -lo != hi:
            q = torch.clamp(q, lo, hi)
        qs.append(q)
        hards.append(h)
    return qs, hards
