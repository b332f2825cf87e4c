"""The staircase plan of the 16/64/256-QAM quantile channel
(``faid_tpu.ops.pallas_channel``: ``_plan``, ``_plan_threshold_ints``,
``_eval_level``, ``staircase_qam``).

The folded max-log demap makes the mod/2 LLRs of one I/Q rail functions
of ONE noise draw.  Level l's soft value is

  L_0 = y = s + sigma_rail * z,   L_l = |L_{l-1}| - c_l

(reference CModulate.cpp:270-362), so each event {L_l >= t} is a union
of disjoint y-intervals whose endpoints depend on the fold constants and
k / scale only (the plan), and sigma enters through turning each
endpoint into a threshold on the uniform int32 grid, one row per Gray
magnitude index m of the sent amplitude.  A rail draws one word, mirrors
it by its sign bit (|y| is mirror-invariant, so only level 0 needs the
sign restore) and evaluates every level's quantized LLR on it: the exact
joint law of the rail's LLRs, not only their marginals.

This module is pure PyTorch and numpy: the plan, its thresholds, the
rail-layout evaluation (the plain twin's core, ops/cuda_channel.py), the
flat plan table of the interval walk, and the per-row cell table that
kernel G (csrc/qam_channel.cu) searches, with its plain lookup.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modem
from .fixed_point import _QUANT_LIMITS

_INF = float("inf")

# QAM rail magnitudes indexed by the Gray magnitude index m (the rail's
# bits after the sign bit, the first sent the MSB of m): the tables are
# sign-symmetric halves, table[2^(h-1) + m] == -table[m].
_MAGNITUDES = {
    2: np.abs(modem.TABLE_QPSK[1:]).astype(np.float64),
    4: np.abs(modem.TABLE_16QAM[2:]).astype(np.float64),
    6: np.abs(modem.TABLE_64QAM[4:]).astype(np.float64),
    8: np.abs(modem.TABLE_256QAM[8:]).astype(np.float64),
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
    """The standard normal CDF in float32, as ``jax.scipy.special.ndtr``
    takes it: 0.5 (1 + erf(x / sqrt 2)) for |x| < 1, erfc in both tails.
    ``torch.special.ndtr`` takes 1 + erf everywhere, which in float32
    loses the tail: 4% off at -5, 0 at -5.65 where the CDF is 8.3e-9, so
    a quantizer step that rare would never be drawn."""
    f32 = dict(dtype=torch.float32)
    half_sqrt_2 = torch.tensor(np.float32(0.5) * np.sqrt(np.float32(2.0)), **f32)
    w = x * half_sqrt_2
    z = w.abs()
    one, two, half = (torch.tensor(v, **f32) for v in (1.0, 2.0, 0.5))
    return half * torch.where(z < half_sqrt_2, one + torch.erf(w),
                              torch.where(w > 0, two - torch.special.erfc(z),
                                          torch.special.erfc(z)))


def grid(p: torch.Tensor, least: float = 0.0) -> torch.Tensor:
    """round(p * 2^32) onto the uniform grid, float32 as in the JAX
    package, clamped to [least, 2^31 - 256]; int64."""
    two32 = torch.tensor(4294967296.0, dtype=torch.float32)
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
    folds = tuple(modem._FOLD[mod_type])
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


def plan_threshold_ints(cfg, sigma: float) -> torch.Tensor:
    """int32 [nmag, nparam] CPU tensor: the plan's thresholds, one row per
    Gray magnitude index, for a sent '0' sign bit (amplitude -a_m).

    The port of ``_plan_threshold_ints``, in float32 with ``ndtr``: each
    probability on its small side, rounded half to even onto the 2^-32
    grid, turned into a threshold with exact integer arithmetic; a step
    whose probability rounds to 0 gets an unreachable threshold."""
    _, defs = _plan(cfg.mod_type, cfg.quant_bits, float(cfg.scale))
    f32 = dict(dtype=torch.float32)
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


# The kernel's plan table, int32: [3h + 1 segment starts, h bases, the
# entries].  Level l's intervals lie in three segments, starts[3l ..
# 3l + 3]: those of its pos events (each adds 1 to q), of its neg events
# (each subtracts 1) and of its hard decision.  An entry packs one
# interval as (lo + 1) | (hi + 1) << 16, lo and hi its endpoint indices,
# -1 for an infinite end.
_FIELD = 1 << 16


@functools.lru_cache(maxsize=None)
def plan_table(mod_type: int, quant_bits: int, scale: float) -> torch.Tensor:
    """The plan of (mod_type, quant_bits, scale) as kernel G's flat int32
    table (layout above), on the CPU."""
    levels, defs = _plan(mod_type, quant_bits, float(scale))
    if len(defs) + 1 >= _FIELD:
        raise ValueError(f"{len(defs)} plan endpoints exceed the table's field")
    starts, bases, entries = [0], [], []
    for lplan in levels:
        for segment in (sum(lplan["pos"], ()), sum(lplan["neg"], ()),
                        lplan["hard"]):
            entries += [(-1 if lo is None else lo) + 1
                        | ((-1 if hi is None else hi) + 1) << 16
                        for lo, hi in segment]
            starts.append(len(entries))
        bases.append(lplan["base"])
    return torch.tensor(starts + bases + entries, dtype=torch.int32)


# Kernel G's cell table, int32 [nmag, 2^s, 6]: entry i of row m is
#   (U[i], 0, cell 2i word 0, cell 2i word 1, cell 2i + 1 word 0, word 1)
# with U row m's sorted distinct thresholds and INT_MAX after them (a
# sentinel cell boundary: it splits no step, since every level is a
# function of the compares {ixe > T}, {ixe < T}), padded with INT_MAX to
# 2^s entries, 2^s - 1 >= the longest row's |U|.  A mirrored word ixe of
# row m lies in cell
#   c = 2 * #{u in U : u < ixe} + [ixe in U]
# (even c the open interval below U[c / 2], odd c the point U[c // 2]),
# and every level's LLR and map bit are constant on a cell.  A cell packs
#   word 0, byte l: level l's int8 LLR; level 0's before its sign restore
#                   and the clip (the kernel applies both, in that order),
#   word 1, byte l: level l's ModCalErr bit: hard_0, and hard_l ^ bit_l(m)
#                   for l >= 1 (the row fixes the magnitude bits).
# Open cells with no word in them (u, u + 1) and the unused entries past
# the sentinel hold zeros; no word lands there.
CELL_ENTRY_WORDS = 6


def cell_rows(params: torch.Tensor) -> list[torch.Tensor]:
    """Each row's sorted distinct thresholds, INT_MAX appended, int64."""
    tail = torch.tensor([_IMAX], dtype=torch.int64)
    return [torch.unique(torch.cat([row.to(torch.int64), tail]))
            for row in params.cpu()]


def cell_width(nparam: int) -> int:
    """The table's entries a row, 2^s, for the worst case of ``nparam``
    thresholds, every one distinct (with the sentinel, nparam + 1)."""
    return 1 << (nparam + 1).bit_length()


def _byte(x: torch.Tensor) -> torch.Tensor:
    """The low byte of int32/int64 values, as an unsigned int64."""
    return x.to(torch.int64) & 0xFF


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def _level0(b0: torch.Tensor, mask0: torch.Tensor, quant_bits: int):
    """Kernel G's level-0 tail: the stored pre-restore byte ``b0`` (int32,
    sign-extended), the sign restore by ``mask0`` (0 or -1), then the
    asymmetric clip; the symmetric widths take none."""
    q = (b0 ^ mask0) - mask0
    lo, hi = _QUANT_LIMITS[quant_bits]
    return torch.clamp(q, lo, hi) if -lo != hi else q


def cell_table(params: torch.Tensor, mod_type: int, quant_bits: int,
               scale: float) -> torch.Tensor:
    """Kernel G's cell table (layout above) for the thresholds ``params``
    (int32 [nmag, nparam], any values), int32 [nmag, 2^s, 6] on the CPU.

    Each non-empty cell is evaluated once through ``staircase_qam`` at one
    of its words, for both sign bits; level 0 is stored in the form that
    the kernel's restore and clip turn into both results."""
    params = params.cpu()
    nmag = params.shape[0]
    h = mod_type // 2
    rows = cell_rows(params)
    width = 1 << max(len(u) for u in rows).bit_length()
    imin = torch.tensor([_IMIN], dtype=torch.int64)
    u_pad = torch.full((nmag, width), _IMAX, dtype=torch.int64)
    word = torch.full((nmag, 2 * width), _IMIN, dtype=torch.int64)
    live = torch.zeros((nmag, 2 * width), dtype=torch.bool)
    for m, u in enumerate(rows):
        k = len(u)
        u_pad[m, :k] = u
        below = torch.cat([imin, u[:-1] + 1])  # the least word of each open cell
        word[m, 0:2 * k:2], word[m, 1:2 * k:2] = below, u
        live[m, 0:2 * k:2], live[m, 1:2 * k:2] = below < u, True
    m_idx = torch.arange(nmag)[:, None].expand(nmag, 2 * width)
    mag = [(m_idx >> (h - 1 - l)) & 1 for l in range(1, h)]
    ix = word.to(torch.int32)
    zero = torch.zeros_like(ix)
    kw = dict(mod_type=mod_type, quant_bits=quant_bits, scale=scale)
    q_pos, hard = staircase_qam(ix, zero, mag, params, **kw)
    q_neg, hard_neg = staircase_qam(~ix, zero + 1, mag, params, **kw)
    # level 0's pre-restore value: the plus-sign LLR, or, where the
    # asymmetric clip cut both signs (q >= hi + 1), hi + 1
    lo, hi = _QUANT_LIMITS[quant_bits]
    b0 = q_pos[0]
    if -lo != hi:
        b0 = torch.where((q_pos[0] == hi) & (q_neg[0] == lo), hi + 1, b0)
    b0 = _sext8(b0)                               # the byte the table holds
    if not (torch.equal(_byte(_level0(b0, zero, quant_bits)), _byte(q_pos[0]))
            and torch.equal(_byte(_level0(b0, zero - 1, quant_bits)), _byte(q_neg[0]))
            and all(torch.equal(a, b) for a, b in zip(hard, hard_neg))
            and all(torch.equal(a, b) for a, b in zip(q_pos[1:], q_neg[1:]))):
        raise AssertionError("a cell's levels depend on more than its mirrored word")
    w0 = _byte(b0)
    w1 = hard[0].to(torch.int64)
    for l in range(1, h):
        w0 = w0 | _byte(q_pos[l]) << (8 * l)
        w1 = w1 | (hard[l].to(torch.int64) ^ mag[l - 1]) << (8 * l)
    cells = torch.stack([_to_int32(w0), _to_int32(w1)], dim=-1) \
        * live[..., None]
    table = torch.zeros((nmag, width, CELL_ENTRY_WORDS), dtype=torch.int32)
    table[:, :, 0] = u_pad.to(torch.int32)
    table[:, :, 2:] = cells.reshape(nmag, width, 4)
    return table


def _sext8(x: torch.Tensor) -> torch.Tensor:
    """The low byte of ``x`` as a signed value, int32."""
    b = _byte(x)
    return (b - ((b & 0x80) << 1)).to(torch.int32)


def staircase_qam_cells(ix_rail, sign_bit, mag_bits, cells, *, mod_type,
                        quant_bits):
    """``staircase_qam`` through the cell table, as kernel G computes it:
    the mirror, the row m, #{u in U : u < ixe} (``torch.searchsorted``),
    the equality test against U itself, one read of cell
    2 #{u < ixe} + [ixe in U], then level 0's sign restore and clip.

    Arguments as for ``staircase_qam``, with ``cells`` (``cell_table``) in
    place of the thresholds.  Returns (qs, hards) as it does, each LLR
    the int8 the channel writes, sign-extended to int32: equal to
    ``staircase_qam``'s modulo 2^8."""
    mask0 = -(sign_bit != 0).to(torch.int32)
    ixe = (ix_rail ^ mask0).to(torch.int64)
    m = torch.as_tensor(magnitude_index(mag_bits), dtype=torch.int64,
                        device=ixe.device).expand(ixe.shape)
    cells = cells.to(ixe.device)
    u = cells[:, :, 0].to(torch.int64)
    # #{u in U_m : u < ixe} in every row, then each element's own row
    below = torch.stack([torch.searchsorted(row, ixe) for row in u])
    pos = below.gather(0, m[None]).squeeze(0)
    entry = cells.reshape(-1, CELL_ENTRY_WORDS)[m * u.shape[1] + pos]
    eq = (entry[..., 0].to(torch.int64) == ixe).to(torch.int64)
    w0, w1 = (entry.gather(-1, (2 + 2 * eq + j)[..., None]).squeeze(-1)
              .to(torch.int64) for j in (0, 1))
    qs = [_sext8(_level0(_sext8(w0), mask0, quant_bits))]
    hards = [_sext8(w1)]
    for l in range(1, mod_type // 2):
        qs.append(_sext8(w0 >> (8 * l)))
        hards.append(_sext8(w1 >> (8 * l)) ^ (mag_bits[l - 1] != 0).to(torch.int32))
    return qs, hards
