"""The yardstick of the roofline metrics: the H100 SXM's published peaks
and the operation model of the round's functions.

A frozen copy of faid_tpu_torch/scripts/roofline.py's constants,
``bound``, ``channel_ops``, ``style_key``, ``decoder_ops``,
``qam_least_ops`` and ``cuda_ms`` at commit
f97303742a3ef9c90c8903c33bcd676948a22a11, so that a later change to the
program cannot move it.  What differs: ``decoder_ops`` and
``qam_least_ops`` read the code's tables (``code_tables``) and the
quantizer's limits from here, not from the program's objects, and
``decoder_ops_from_histograms`` counts the same work from the runner's
iteration histograms, which is all a window reports.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_QUANT_LIMITS = {6: (-31, 31), 5: (-16, 15), 4: (-7, 7), 3: (-4, 3), 2: (-2, 1)}

# The H100 SXM's peaks (NVIDIA's data sheet, at the 700 W limit): HBM
# bytes per second, and int32 operations per second: 64 INT32 lanes per
# SM (Hopper white paper) x 132 SMs x the 1.98 GHz boost clock that the
# published 67 TFLOP/s float32 rate (128 lanes, 2 per FMA) implies.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9
# the peak int8 tensor-core rate of the H100 SXM at 700 W, dense (NVIDIA's
# data sheet): the encoder's product
PEAK_INT8_OPS_PER_S = 1979e12

# Operation model of the functions' arithmetic, in int32 operations; it
# counts what the function needs, not what a kernel spends on addressing:
#   Philox4x32-10, per call: 10 rounds of 2 mul-hi, 2 mul-lo, 4 xor = 80,
#     shared by the 4 bits the call feeds; its 9 x 2 key-schedule adds
#     depend on the seed alone, so they count once per launch;
#   staircase, per bit: the mask xor, 2L compares and 2L adds, the sign
#     restore (xor, sub), the clip (min, max), the error compare = 4L + 6;
#   row update, per edge and MP iteration (ops/cn_update.py), FAID: pass
#     1 subtract, the clip to +-31 (max, min), sign with backtrack
#     (select, compare), parity xor, magnitude (abs, min, table) and the
#     min1/min2 update (max, min, min) = 1 + 2 + 2 + 1 + 3 + 3 = 12 (en is
#     within +-31 and a message within +-7, so the int8 saturation of
#     en - msg never binds and is not counted); pass 2 compare with min1
#     and select, 2 sign xors, negate, add, clip (max, min) = 8;
#     NMS: pass 1 subtract, the lower clip (max), sign compare, parity
#     xor, abs, min1/min2 (3) = 8; pass 2 as FAID's plus the abs of the
#     raw compare = 9; selective and simple-offset OMS: NMS's plus the
#     clip of |v| to 7 in pass 1 = 9 + 9;
#   row update, per check and MP iteration: the two message magnitudes,
#     FAID and simple-offset OMS (subtract, min) x 2 = 4; EF 1 and EF 2
#     add the floor gate (2 ands) and the swap of the LUT row (select) =
#     7; NMS (multiply, shift, min) x 2 = 6 (the int8 saturation cannot
#     bind); selective OMS the gate (2 ands) and, per minimum, the raised
#     and the lowered offsets (2 compares, 2 adds each), the select and
#     the clip to 7 = 2 + 2 x 10;
#   EF 2's erasure, per edge that starts a weight-3 column and MP
#     iteration in the floor window: the VN's 3 votes (2 adds), the
#     compare, the frame gate (and) and the select = 5;
#   syndrome sweep: one xor per edge, and one hard decision (en > 0) per
#     VN where en changed since the last sweep (every MP sweep, and once
#     as a BF tail starts; its sweeps read the hard bits); the
#     map-keeping styles (EF 1, EF 2, selective OMS) add each frame's
#     count, one add per check; NMS runs no sweep;
#   DTBF flip, per weight-gamma bit and round: gamma vote adds, the
#     disagreement xor, multiply-add, compare, flip xor = gamma + 4; 2B1C
#     adds the reliability test and the demote select (+2), and seeds the
#     reliability bits once (2 compares, an or: +3 per VN);
#   static BF, per round: the votes of every column (one add per edge),
#     and per VN the frame's max, the compare and the flip xor (+3);
#   kernel B's error count: one add per info bit;
#   the message stream, per bit: a 128th of a Philox call and its
#     unpacking (shift, and);
#   the float chain's noise draw, per sample: a quarter of one Philox call
#     and the mantissa's shift and or; its float work (the uniform's affine
#     map, erfinv, the scale) is not counted, so its bound is a lower one.
PHILOX_OPS = 10 * 8
PHILOX_KEY_OPS = 9 * 2
ROW_OPS = {   # style -> (per edge, per check) of one row update
    "faid": (12 + 8, 4), "faid_ef1": (12 + 8, 7), "faid_ef2": (12 + 8, 7),
    "nms": (8 + 9, 6), "oms_selective": (9 + 9, 2 + 2 * 10),
    "oms_offset": (9 + 9, 4)}
EF2_OPS_PER_ERASING_EDGE = 5
KEEPS_MAP = ("faid_ef1", "faid_ef2", "oms_selective")
SYNDROME_OPS_PER_EDGE = 1
HARD_OPS_PER_VN = 1
MESSAGE_OPS_PER_BIT = PHILOX_OPS / 128 + 2
NOISE_INT_OPS = PHILOX_OPS / 4 + 2
# the 4-bit quantizer's L: 2L + 1 thresholds
QUANT_L = 7


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_INT32_OPS_PER_S):
    """(least ms, what bounds it) for work that moves ``n_bytes`` and does
    ``n_ops`` operations at ``peak_ops`` a second (int32 by default)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def channel_ops(batch: int, n_var: int, quant_bits_l: int) -> float:
    return (batch * n_var * (PHILOX_OPS / 4 + 4 * quant_bits_l + 6)
            + PHILOX_KEY_OPS)


def style_key(dcfg) -> str:
    if dcfg.method == 0:
        return "nms"
    if dcfg.method in (1, 3, 4):
        return "oms_selective" if dcfg.oms_mode == 1 else "oms_offset"
    return ("faid", "faid_ef1", "faid_ef2")[dcfg.ef_elimination]


@dataclasses.dataclass(frozen=True)
class CodeTables:
    """What ``decoder_ops`` reads of the decoder's tables, counted from the
    code: the block columns the BF tail votes on (``vote_col``), their
    adjacency entries (``vote_ptr[-1]``) and EF 2's erasing entries
    (``ef_ptr >= 0``)."""

    dcfg: object
    n_vote: int
    vote_edges: int
    erasing: int


def code_tables(code, dcfg) -> CodeTables:
    """The counts of ``CodeTables`` for ``dcfg`` on ``code``, as the
    program's ``decoder_tables`` lays them out: the tail votes on the
    columns of weight gamma (DTBF, 2B1C) or on every column (static BF);
    EF 2 erases at the first entry of each column of weight 3."""
    weight = np.zeros(code.n_block_cols, dtype=np.int64)
    for r in range(code.n_block_rows):
        for c in code.block_cols[r][:code.degrees[r]]:
            weight[c] += 1
    vote = (np.ones_like(weight, dtype=bool) if dcfg.bf.kind == "static"
            else weight == dcfg.bf.gamma)
    erasing = int((weight == 3).sum()) if style_key(dcfg) == "faid_ef2" else 0
    return CodeTables(dcfg, int(vote.sum()), int(weight[vote].sum()), erasing)


def decoder_ops(code, tables: CodeTables, mp_iters: torch.Tensor,
                bf_rounds: torch.Tensor) -> float:
    """The decoder's arithmetic for this run's per-frame iteration counts:
    each MP iteration's syndrome sweep and row updates, the sweep that
    finds a word clean, and, where MP ran out, the hard decisions that
    open the BF tail and each of its sweeps and flip rounds (a sweep that
    finds the word clean ends the tail before its round cap)."""
    dcfg, bfc = tables.dcfg, tables.dcfg.bf
    edges = int(code.degrees_np.sum()) * code.z
    style = style_key(dcfg)
    per_edge, per_check = ROW_OPS[style]
    mp = mp_iters.to(torch.float64)
    bf = bf_rounds.to(torch.float64)
    zero = torch.zeros_like(mp)
    sweeps = (mp + (mp_iters < dcfg.max_iter).to(torch.float64)
              if dcfg.stop_early else zero)
    tail = tail_sweeps = zero
    if bfc.kind != "none":
        tail = (mp_iters == dcfg.max_iter).to(torch.float64)
        tail_sweeps = tail * (bf + (bf_rounds < bfc.max_iter).to(torch.float64))
    vote_bits = tables.n_vote * code.z
    if bfc.kind == "static":
        per_round = tables.vote_edges * code.z + 3 * vote_bits
    else:
        per_round = vote_bits * (bfc.gamma + 4 + 2 * (bfc.kind == "dtbf2b1c"))
    keeps_map = style in KEEPS_MAP
    if style == "faid_ef2" and dcfg.stop_early:
        # the iterations in the floor window: index >= max_iter - 1 - thresh
        first = max(0, dcfg.max_iter - 1 - dcfg.floor_iter_thresh)
        window = torch.clamp(mp - first, min=0)
        erasing = tables.erasing * code.z
        ops_ef2 = window * erasing * EF2_OPS_PER_ERASING_EDGE
    else:
        ops_ef2 = zero
    ops = (mp * (edges * per_edge + code.n_chk * per_check) + ops_ef2
           + sweeps * (edges * SYNDROME_OPS_PER_EDGE
                       + code.n_var * HARD_OPS_PER_VN + code.n_chk * keeps_map)
           + tail * code.n_var * (HARD_OPS_PER_VN + 3 * (bfc.kind == "dtbf2b1c"))
           + tail_sweeps * edges * SYNDROME_OPS_PER_EDGE
           + bf * per_round)
    return float(ops.sum())


def decoder_ops_from_histograms(code, tables: CodeTables, mp_hist,
                                bf_hist) -> float:
    """``decoder_ops`` of frames whose per-frame counts are given only as
    histograms: ``mp_hist[i]`` frames ran i MP iterations, ``bf_hist[j]``
    frames j BF rounds.  Every term of ``decoder_ops`` is a sum over frames
    of a function of one count, but for the tail's sweeps, which pairs
    the two counts: a frame runs BF rounds only where MP ran out (in
    group mode its whole word did), so the frames with a BF round are
    among those with ``max_iter`` iterations, and those with the cap of
    rounds are that cap's bucket."""
    dcfg, bfc = tables.dcfg, tables.dcfg.bf
    edges = int(code.degrees_np.sum()) * code.z
    style = style_key(dcfg)
    per_edge, per_check = ROW_OPS[style]
    mp_hist = [int(x) for x in mp_hist]
    bf_hist = [int(x) for x in bf_hist]
    frames = sum(mp_hist)
    mp = sum(i * n for i, n in enumerate(mp_hist))
    bf = sum(j * n for j, n in enumerate(bf_hist))
    ran_out = mp_hist[dcfg.max_iter]
    sweeps = mp + frames - ran_out if dcfg.stop_early else 0
    tail = tail_sweeps = 0
    if bfc.kind != "none":
        tail = ran_out
        at_cap = bf_hist[bfc.max_iter] if bfc.max_iter < len(bf_hist) else 0
        tail_sweeps = bf + ran_out - at_cap
    vote_bits = tables.n_vote * code.z
    if bfc.kind == "static":
        per_round = tables.vote_edges * code.z + 3 * vote_bits
    else:
        per_round = vote_bits * (bfc.gamma + 4 + 2 * (bfc.kind == "dtbf2b1c"))
    keeps_map = style in KEEPS_MAP
    ops_ef2 = 0
    if style == "faid_ef2" and dcfg.stop_early:
        first = max(0, dcfg.max_iter - 1 - dcfg.floor_iter_thresh)
        window = sum(max(i - first, 0) * n for i, n in enumerate(mp_hist))
        ops_ef2 = window * tables.erasing * code.z * EF2_OPS_PER_ERASING_EDGE
    return float(mp * (edges * per_edge + code.n_chk * per_check) + ops_ef2
                 + sweeps * (edges * SYNDROME_OPS_PER_EDGE
                             + code.n_var * HARD_OPS_PER_VN + code.n_chk * keeps_map)
                 + tail * code.n_var * (HARD_OPS_PER_VN + 3 * (bfc.kind == "dtbf2b1c"))
                 + tail_sweeps * edges * SYNDROME_OPS_PER_EDGE
                 + bf * per_round)


def qam_least_ops(params, m, mod_type: int, quant_bits: int) -> float:
    """The least int32 work of kernel G's function on these inputs: per
    rail (``m`` [batch, rails], each rail's row) a quarter of one Philox
    call, the mirror xor, the magnitude index (a shift-add per magnitude
    bit), a binary search of the word among the 2 |U_m| + 1 cells that
    row m's distinct thresholds U_m cut the words into (a compare and a
    select a step), one read of the rail's packed cell (every level's LLR
    and map bit; the map's magnitude xor is folded into the table), level
    0's sign restore (xor, sub) and, for the asymmetric widths only, its
    clip (min, max); and the key schedule once."""
    lo, hi = _QUANT_LIMITS[quant_bits]
    steps = torch.tensor([math.ceil(math.log2(2 * len(torch.unique(row)) + 1))
                          for row in params.cpu()])
    per_row = torch.bincount(m.reshape(-1).cpu(), minlength=len(steps))
    per_rail = PHILOX_OPS / 4 + 1 + (mod_type // 2 - 1) + 1 + 2 + (2 if -lo != hi else 0)
    return m.numel() * per_rail + 2 * int((steps * per_row).sum()) + PHILOX_KEY_OPS


def qam_least_ops_counts(params, per_row, launches: int, mod_type: int,
                         quant_bits: int) -> float:
    """``qam_least_ops`` summed over ``launches`` launches whose rails lie
    ``per_row[m]`` times in row m, all launches together."""
    lo, hi = _QUANT_LIMITS[quant_bits]
    steps = torch.tensor([math.ceil(math.log2(2 * len(torch.unique(row)) + 1))
                          for row in params.cpu()])
    per_row = torch.as_tensor(per_row).cpu()
    per_rail = PHILOX_OPS / 4 + 1 + (mod_type // 2 - 1) + 1 + 2 + (2 if -lo != hi else 0)
    return (int(per_row.sum()) * per_rail + 2 * int((steps * per_row).sum())
            + launches * PHILOX_KEY_OPS)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps
