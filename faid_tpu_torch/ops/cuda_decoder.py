"""The decoder kernels (``faid_tpu.ops.pallas_decoder``):

  stats_decode  per-frame info-bit error count against a reference word,
                mp_iters, bf_rounds: kernel B (``make_stats_decoder``),
                the Monte-Carlo round's decoder where kernel F
                (ops/cuda_sim.py) does not take the whole round, every
                method
  full_decode   hard decisions [B, n_var], mp_iters, bf_rounds: kernel D
                (``make_full_decoder``), build_decoder's kernel path and
                the forensic replay's decoder for the methods with a BF
                tail (FAID+DTBF, OMS+BF, OMS+DTBF, FAID-2B1C)
  mp_decode     the final LLRs en [B, n_var], mp_iters: kernel E
                (``make_mp_decoder``), the same for the methods without
                one (NMS, OMS)

The three kernels, and kernel F, are one template (csrc/decoder.cuh)
over the output, the check-node style, the BF kind, the stop mode and
the message width.  B is instantiated for every (style, BF kind) pair
(``KERNEL_PAIRS``: the six styles, NMS, selective OMS, simple-offset
OMS, FAID with EF 0, 1 or 2, times the four BF kinds), D for the pairs
with a BF tail, E for those without, so that they run every
configuration of ``pallas_decoder.supports`` (``supports``); kernel F
for the pairs ``DecoderConfig.for_method`` produces (``SIM_PAIRS``), the
only ones a ``SimConfig`` reaches.  Each comes in both stop modes and
both widths.  A block holds a few frames' whole decoder state
in shared memory, the frames side by side in the lanes of each word (a
quad of threads updates a check for all of them at once), and in group
mode a thread-block cluster holds one 32-frame word; ``launch_plan``
picks the width (4-bit messages where ``msg_bound`` proves |message| <=
7, else 8-bit), the frames a block and the shared-memory bytes, and
``DecoderTables.plan`` carries it.
Each wrapper launches its kernel on a CUDA tensor and takes its plain
twin (``*_plain``) on a CPU tensor.  The twins are the composition of
the plain modules (decoders/core.py ``build_decoder(backend="plain")``:
syndrome, row updates, BF), plus the error count for B; each agrees with
its kernel bit for bit.  B and F also add their blocks' SM cycles of the
prologue, MP and the BF tail to the device's ``kernels.phase_clocks``.

The kernels run codes of row degree <= ``MAX_DEG`` whose block fits
in shared memory, with check-node constants that fit a byte lane
(``constants_in_lanes``); other configurations raise before any launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..code.qc_matrix import QCCode
from ..config import DecoderConfig
from ..convert import tables_from_arrays
from ..decoders import luts
from ..decoders.bf import GROUP   # frames per stop word == per cluster
from ..utils import kernels

MAX_DEG = 24     # csrc/decoder.cuh kMaxDeg
THREADS = 1024   # csrc/decoder.cuh kThreads: the BF tail takes a bit a thread
SMEM_LIMIT = 232_448   # shared memory one Hopper block can use, bytes
# what a block's static shared arrays may take beside the plan's dynamic
# bytes (ptxas reports at most 512 bytes; chip_smoke.py checks it)
STATIC_SMEM = 1024

# csrc/decoder.cuh's Style and Bf ids
NMS, OMS_SELECTIVE, FAID, FAID_EF1, OMS_OFFSET, FAID_EF2 = range(6)
BF_IDS = {"none": 0, "static": 1, "dtbf": 2, "dtbf2b1c": 3}
# kernel B's (style, BF kind) pairs: every style with every BF kind (D
# takes those with a tail, E those without)
KERNEL_PAIRS = frozenset((s, b) for s in range(6) for b in range(4))
# kernel F's: those of DecoderConfig.for_method
SIM_PAIRS = frozenset({(NMS, 0), (OMS_SELECTIVE, 0), (FAID, 2),
                       (OMS_SELECTIVE, 1), (OMS_SELECTIVE, 2), (FAID_EF1, 3)})


def supports(dcfg: DecoderConfig) -> bool:
    """Whether the decoder kernels run ``dcfg``
    (``pallas_decoder.supports``): either stop mode, OMS offset mode 0 or
    1, FAID EF 0, 1 or 2, any BF kind."""
    return (dcfg.stop_mode in ("frame", "group") and dcfg.oms_mode in (0, 1)
            and dcfg.ef_elimination in (0, 1, 2) and dcfg.bf.kind in BF_IDS)


def _style_id(dcfg: DecoderConfig) -> int:
    style = _style_name(dcfg)
    if style == "nms":
        return NMS
    if style == "oms":
        return OMS_SELECTIVE if dcfg.oms_mode == 1 else OMS_OFFSET
    return (FAID, FAID_EF1, FAID_EF2)[dcfg.ef_elimination]


def kernel_ids(dcfg: DecoderConfig) -> tuple[int, int]:
    """(style id, BF kind id) of ``dcfg``'s kernel instance; raises
    NotImplementedError for a configuration outside ``supports``."""
    if not supports(dcfg):
        raise NotImplementedError(f"no decoder kernel for {dcfg}")
    return _style_id(dcfg), BF_IDS[dcfg.bf.kind]


def _style_name(dcfg: DecoderConfig) -> str:
    m = int(dcfg.method)
    return "nms" if m == 0 else ("oms" if m in (1, 3, 4) else "faid")


def msg_bound(dcfg: DecoderConfig) -> int | None:
    """A bound M on |stored message| for ``dcfg``, or None when no bound
    <= 48 can be proven (a copy of ``pallas_decoder._msg_bound``).  Every
    check-node constant is clamped to <= 7; its lower side is what can
    push a message past 7: never for NMS with factors >= 0 or selective
    OMS (offsets move a minimum by at most 2), and for FAID and simple
    OMS the least LUT magnitude (0 for OMS) minus the offset."""
    style = _style_name(dcfg)
    if style == "nms":
        return 7 if (dcfg.factor_1 >= 0 and dcfg.factor_2 >= 0) else None
    if style == "oms" and dcfg.oms_mode == 1:
        return 7
    off = dcfg.oms_offset
    if style == "oms":
        lo = min(7, -off)
    else:
        lut = luts.table_for(dcfg.lut_family, dcfg.max_iter)
        lmin = int(lut.min())
        if dcfg.ef_elimination >= 1:
            lmin = min(lmin, int(luts.ef_table(dcfg.max_iter).min()))
        lo = min(7, min(lmin, 31) - off)
    m = max(7, abs(lo))
    return m if m <= 48 else None


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the decoder kernels lay a configuration out on the card
    (csrc/decoder.cuh): ``frames`` frames a block, whose en, messages and
    check map sit in ``smem_bytes`` of dynamic shared memory, the frames
    in lanes; in group mode ``cluster`` blocks make one 32-frame word
    (frame mode launches the blocks unclustered).  A message is
    ``msg_bits`` wide, the block's frames' messages of an edge 16 bits
    together: row r's start at word ``msg_off[r]`` of the block's
    ``msg_words``, ``(msg_off[r + 1] - msg_off[r]) / z`` words for each
    zz."""

    msg_bits: int
    frames: int
    cluster: int
    msg_off: tuple
    msg_words: int
    smem_bytes: int

    @property
    def fits(self) -> bool:
        return self.smem_bytes + STATIC_SMEM <= SMEM_LIMIT


def _row_words(deg: int) -> int:
    """Words of one (row, zz)'s ``deg`` messages for the block's frames,
    16 bits an edge (4 frames x 4 bits, or 2 x 8): 4 x an odd number, so
    that a warp's 8 checks x 4 lanes (lane q the words q, q + 4, ...) hit
    32 banks.  csrc/decoder.cuh ``row_update`` computes the same from the
    degree."""
    return 4 * (-(-deg // 8) | 1)


def vote_columns(code: QCCode, dcfg: DecoderConfig) -> list:
    """The block columns the BF tail votes on and flips: every column for
    static BF, those of weight gamma for DTBF and 2B1C."""
    weights = code.vn_weight_blocks_np[:, 0]
    if dcfg.bf.kind == "static":
        return list(range(code.n_block_cols))
    return [c for c in range(code.n_block_cols) if weights[c] == dcfg.bf.gamma]


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def tail_bytes(code: QCCode, dcfg: DecoderConfig, frames: int) -> int:
    """csrc/decoder.cuh ``tail_bytes``: the BF tail's state in the message
    region of a block of ``frames`` frames: a byte per VN (the hard bits),
    the check map the flips toggle, a byte per check, and the vote tables
    (column bases, adjacency pointers, at most ``n_entries`` adjacency
    entries, a word each)."""
    return (_round16(frames * code.n_var) + _round16(frames * code.n_block_rows * code.z)
            + 4 * (2 * len(vote_columns(code, dcfg)) + 1 + int(code.degrees_np.sum())))


def launch_plan(code: QCCode, dcfg: DecoderConfig) -> LaunchPlan:
    """The kernels' layout of ``dcfg`` on ``code``: 4-bit messages and 4
    frames a block (clusters of 8) where ``msg_bound`` is at most 7, else
    8-bit messages and 2 frames a block (clusters of 16).  After MP the
    message region holds the BF tail's state (``tail_bytes``)."""
    bound = msg_bound(dcfg)
    bits = 4 if bound is not None and bound <= 7 else 8
    frames = 4 if bits == 4 else 2
    off = np.concatenate([[0], np.cumsum([_row_words(int(d)) * code.z
                                          for d in code.degrees_np])])
    words = int(off[-1])
    has_bf = dcfg.bf.kind != "none"
    tail = tail_bytes(code, dcfg, frames) if has_bf else 0
    words = max(words, -(-tail // 4))
    # the check map: the BF tail's, and the floor window's and EF 2's votes'
    # (decoder.cuh kKeepsMap)
    keeps_map = has_bf or _style_id(dcfg) in (OMS_SELECTIVE, FAID_EF1, FAID_EF2)
    smem = (_round16(frames * code.n_var) + words * 4
            + (frames * code.n_block_rows * code.z if keeps_map else 0))
    return LaunchPlan(msg_bits=bits, frames=frames, cluster=GROUP // frames,
                      msg_off=tuple(int(x) for x in off), msg_words=words,
                      smem_bytes=smem)


@dataclasses.dataclass(frozen=True)
class DecoderTables:
    """The code and decoder tables the decoder kernels read, on one
    device."""

    code: QCCode
    dcfg: DecoderConfig
    device: torch.device
    row_ptr: torch.Tensor     # [n_rows + 1] first entry of each block row
    ent_col: torch.Tensor     # [n_entries] block column of each entry
    ent_shift: torch.Tensor   # [n_entries] circulant shift of each entry
    vote_col: torch.Tensor    # [n_vote] block columns the BF tail flips
    vote_ptr: torch.Tensor    # [n_vote + 1] first adjacency entry of each
    vote_row: torch.Tensor    # their block rows
    vote_shift: torch.Tensor  # and shifts
    lut: torch.Tensor         # [max_iter, 8] FAID magnitudes
    lut_ef: torch.Tensor      # [max_iter, 8] FAID error-floor magnitudes
    plan: LaunchPlan
    msg_off: torch.Tensor     # [n_rows + 1] plan.msg_off
    ef_ptr: torch.Tensor      # [n_entries] EF 2: the entry's erasing column's
                              #   first adjacency entry, -1 where it erases nothing
    ef_row: torch.Tensor      # [3 * erasing columns] their block rows
    ef_shift: torch.Tensor    # and shifts
    # CUDA tables: the kernels' csrc/decoder.cuh CodeArgs, built once
    # (``decoder_args``); None on the CPU
    args: kernels.DecoderArgs | None = dataclasses.field(default=None,
                                                         compare=False, repr=False)


def erasing_entries(code: QCCode) -> dict:
    """EF 2's erasure as a static rule: {entry: its column's adjacency
    [(row, shift)] * 3} for each entry that starts a column of weight 3.

    JAX erases at the first edge into an eligible VN each iteration (its
    ``era`` marks); eligibility (votes >= 3 from the iteration-top map, a
    frame with few unsatisfied checks, the floor window) holds for the
    whole iteration, and rows run in order.  So where no block column
    appears twice in a block row, every VN of a weight-3 column is first
    reached from the column's lowest block row, and erasing there is
    JAX's rule with no per-VN marks.  Raises NotImplementedError for a
    code where a column repeats in a row."""
    adj = {c: [] for c in range(code.n_block_cols)}
    first = {}
    ge = 0
    for r in range(code.n_block_rows):
        cols = code.block_cols[r][:code.degrees[r]]
        if len(set(cols)) != len(cols):
            raise NotImplementedError(
                f"block row {r} of {code.name} holds a column twice")
        for c, s in zip(cols, code.shifts[r][:code.degrees[r]]):
            first.setdefault(c, ge)
            adj[c].append((r, s))
            ge += 1
    return {first[c]: adj[c] for c in adj if len(adj[c]) == 3}


def decoder_tables(code: QCCode, dcfg: DecoderConfig, device) -> DecoderTables:
    """The tables of ``dcfg``'s decode on ``device``.  The BF tail votes
    on the columns of weight gamma (DTBF, 2B1C) or on every column
    (static BF); FAID's EF 2 on the columns of weight 3
    (``erasing_entries``), with tables of its own."""
    kernel_ids(dcfg)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # tensors created on "cuda" report the indexed current device
        device = torch.device("cuda", torch.cuda.current_device())
    deg = code.degrees_np
    cols = np.concatenate([code.block_cols_np[r, :deg[r]]
                           for r in range(code.n_block_rows)])
    shifts = np.concatenate([code.shifts_np[r, :deg[r]]
                             for r in range(code.n_block_rows)])
    adj = {c: [] for c in range(code.n_block_cols)}
    for r in range(code.n_block_rows):
        for c, s in zip(code.block_cols[r][:deg[r]], code.shifts[r][:deg[r]]):
            adj[c].append((r, s))
    vote = vote_columns(code, dcfg)
    vote_rs = np.array([rs for c in vote for rs in adj[c]],
                       dtype=np.int32).reshape(-1, 2)
    lut, lut_ef = tables_from_arrays(
        luts.table_for(dcfg.lut_family, dcfg.max_iter),
        luts.ef_table(dcfg.max_iter), device)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                               device=device)

    n_entries = int(deg.sum())
    ef_ptr = np.full(n_entries, -1)
    ef_adj = []
    if _style_id(dcfg) == FAID_EF2:
        for ge, rs in sorted(erasing_entries(code).items()):
            ef_ptr[ge] = len(ef_adj)
            ef_adj += rs
    ef_adj = np.array(ef_adj, dtype=np.int32).reshape(-1, 2)
    plan = launch_plan(code, dcfg)
    tables = DecoderTables(
        code=code, dcfg=dcfg, device=device,
        row_ptr=t(np.concatenate([[0], np.cumsum(deg)])),
        ent_col=t(cols), ent_shift=t(shifts), vote_col=t(vote),
        vote_ptr=t(np.concatenate([[0], np.cumsum([len(adj[c])
                                                    for c in vote])])),
        vote_row=t(vote_rs[:, 0]), vote_shift=t(vote_rs[:, 1]), lut=lut,
        lut_ef=lut_ef, plan=plan, msg_off=t(plan.msg_off), ef_ptr=t(ef_ptr),
        ef_row=t(ef_adj[:, 0]), ef_shift=t(ef_adj[:, 1]))
    if device.type == "cuda":
        tables = dataclasses.replace(tables, args=decoder_args(tables))
    return tables


def decoder_args(tables: DecoderTables) -> kernels.DecoderArgs:
    """The kernels' code tables and parameters (csrc/decoder.cuh
    ``CodeArgs``): the addresses of ``tables``' tensors, which the tables
    keep alive, and the decoder's parameters."""
    code, dcfg, bf = tables.code, tables.dcfg, tables.dcfg.bf
    ptrs = {k: getattr(tables, k).data_ptr() for k in (
        "row_ptr", "ent_col", "ent_shift", "vote_col", "vote_ptr", "vote_row",
        "vote_shift", "lut", "lut_ef")}
    return kernels.DecoderArgs(
        **ptrs, n_var=code.n_var, n_info=code.n_info, z=code.z,
        n_rows=code.n_block_rows, n_entries=int(tables.ent_col.numel()),
        punct_start=code.n_var - code.puncture_tail, max_iter=dcfg.max_iter,
        stop_early=int(dcfg.stop_early), factor_1=dcfg.factor_1,
        factor_2=dcfg.factor_2, offset=dcfg.oms_offset,
        sign_backtrack=int(dcfg.sign_backtrack),
        floor_err_count=dcfg.floor_err_count,
        floor_iter_thresh=dcfg.floor_iter_thresh,
        n_vote=int(tables.vote_col.numel()), gamma=bf.gamma,
        bf_max_iter=bf.max_iter, delta=bf.delta, l0_max=bf.l0, l1_max=bf.l1,
        alpha=bf.alpha, vote_cap=bf.static_vote_cap,
        reliability=bf.reliability_threshold, msg_off=tables.msg_off.data_ptr(),
        msg_words=tables.plan.msg_words, ef_ptr=tables.ef_ptr.data_ptr(),
        ef_row=tables.ef_row.data_ptr(), ef_shift=tables.ef_shift.data_ptr())


def stats_decode_plain(llr: torch.Tensor, code: QCCode, dcfg: DecoderConfig,
                       ref: torch.Tensor | None = None):
    """Plain PyTorch twin of kernel B on ``llr``'s device:
    (err_bits, mp_iters, bf_rounds), each [batch] int32."""
    from ..decoders.core import build_decoder

    out = build_decoder(code, dcfg, backend="plain")(llr)
    hard = out["hard"][:, :code.n_info]
    if ref is not None:
        hard = hard ^ (ref[:, :code.n_info] != 0)
    return hard.sum(dim=1, dtype=torch.int32), out["mp_iters"], out["bf_rounds"]


def full_decode_plain(llr: torch.Tensor, code: QCCode, dcfg: DecoderConfig):
    """Plain PyTorch twin of kernel D on ``llr``'s device: (hard [batch,
    n_var] int8 0/1, mp_iters [batch] int32, bf_rounds [batch] int32)."""
    from ..decoders.core import build_decoder

    out = build_decoder(code, dcfg, backend="plain")(llr)
    return out["hard"].to(torch.int8), out["mp_iters"], out["bf_rounds"]


def mp_decode_plain(llr: torch.Tensor, code: QCCode, dcfg: DecoderConfig):
    """Plain PyTorch twin of kernel E on ``llr``'s device: (en [batch,
    n_var] int8, mp_iters [batch] int32)."""
    from ..decoders.core import build_plain_mp

    en, mp_iters = build_plain_mp(code, dcfg)(llr)
    return en.reshape(llr.shape[0], code.n_var).to(torch.int8), mp_iters


def _check_llr(llr: torch.Tensor, tables: DecoderTables) -> None:
    code = tables.code
    if (llr.dtype != torch.int8 or llr.shape != (llr.shape[0], code.n_var)
            or not llr.is_contiguous()):
        raise ValueError("llr must be a contiguous int8 [batch, n_var] tensor")
    check_launch(llr.shape[0], tables)


def check_launch(batch: int, tables: DecoderTables) -> None:
    """Check the batch and the code against the template's bounds."""
    code = tables.code
    if batch % GROUP or batch == 0:
        raise ValueError(f"batch must be a positive multiple of {GROUP}")
    if code.max_deg > MAX_DEG or code.n_var % code.z:
        raise NotImplementedError(
            f"kernel bounds: row degree <= {MAX_DEG}, n_var % z == 0")
    if code.z > THREADS or code.n_block_rows * code.z > 1 << 16:
        raise NotImplementedError(
            f"kernel bounds: z <= {THREADS} (the BF tail walks a bit a thread) and "
            f"n_rows * z <= 65536 (its tables' 16-bit map offsets); z is {code.z}")
    if not tables.plan.fits:
        raise NotImplementedError(
            f"{tables.plan.frames} frames' decoder state ({tables.plan.smem_bytes} "
            f"bytes) exceed a block's shared memory")
    if not constants_in_lanes(tables.dcfg):
        raise NotImplementedError(
            "kernel bounds: the check-node constants and their negations must "
            "fit int8 (an offset in [-127, 127]; NMS factors with "
            "(31 * factor) >> 5 >= -127)")


def constants_in_lanes(dcfg: DecoderConfig) -> bool:
    """Whether every check-node constant c of ``dcfg``, and -c, fits the
    kernels' byte lanes (csrc/decoder.cuh ``constants``): c is at most 7,
    and at least -offset for FAID and simple-offset OMS (a magnitude is
    >= 0), (31 * factor) >> 5 for NMS (a minimum is at most 31), -2 for
    selective OMS."""
    style = _style_id(dcfg)
    if style == NMS:
        return all((31 * f) >> 5 >= -127 for f in (dcfg.factor_1, dcfg.factor_2))
    if style == OMS_SELECTIVE:
        return True
    return -127 <= dcfg.oms_offset <= 127


def frame_mode(dcfg: DecoderConfig) -> int:
    """The kernels' stop-mode flag: 1 for frame stop mode, 0 for group."""
    return int(dcfg.stop_mode == "frame")


def reference_word(ref, batch: int, n_info: int, device):
    """``ref`` [batch, >= n_info] (int8 or bool, contiguous) as the int8
    tensor the kernels read a row of, or None for the all-zero word."""
    if ref is None:
        return None
    if ref.dtype == torch.bool:
        ref = ref.view(torch.int8)
    if (ref.dtype != torch.int8 or ref.dim() != 2 or ref.shape[0] != batch
            or ref.shape[1] < n_info or ref.device != device
            or not ref.is_contiguous()):
        raise ValueError(f"the reference word must be a contiguous int8 or "
                         f"bool [batch, >= {n_info}] tensor on {device}")
    return ref


def stats_decode(llr: torch.Tensor, tables: DecoderTables,
                 ref: torch.Tensor | None = None):
    """Decode ``llr`` [batch, n_var] int8 and count each frame's info-bit
    errors against ``ref`` [batch, >= n_info] (the codeword, or its info
    bits; None: the all-zero word): (err_bits, mp_iters, bf_rounds), each
    [batch] int32.  A CPU tensor takes the plain twin; a CUDA tensor
    launches kernel B, which adds its blocks' cycles to the device's
    ``kernels.phase_clocks``."""
    ref = reference_word(ref, llr.shape[0], tables.code.n_info, llr.device)
    dev = kernels.kernel_device(llr, tables.device)
    if dev is None:
        return stats_decode_plain(llr, tables.code, tables.dcfg, ref)
    style, bf = kernel_ids(tables.dcfg)
    _check_llr(llr, tables)
    batch = llr.shape[0]
    err, iters, rounds = (torch.empty(batch, dtype=torch.int32, device=dev)
                          for _ in range(3))
    kernels.launch("faid_stats_decoder", dev, style, bf, frame_mode(tables.dcfg),
                   tables.plan.msg_bits, llr.data_ptr(), err.data_ptr(),
                   iters.data_ptr(), rounds.data_ptr(), kernels.ptr(ref),
                   0 if ref is None else ref.shape[1],
                   kernels.phase_clocks(dev).data_ptr(), tables.args, batch)
    return err, iters, rounds


def full_decode(llr: torch.Tensor, tables: DecoderTables):
    """Decode ``llr`` [batch, n_var] int8 with a BF tail: (hard [batch,
    n_var] int8 0/1, mp_iters [batch] int32, bf_rounds [batch] int32),
    ``hard`` the final decisions (after the BF tail).  A CPU tensor takes
    the plain twin; a CUDA tensor launches kernel D."""
    dev = kernels.kernel_device(llr, tables.device)
    if dev is None:
        return full_decode_plain(llr, tables.code, tables.dcfg)
    style, bf = kernel_ids(tables.dcfg)
    if bf == BF_IDS["none"]:
        raise ValueError("kernel D runs a BF tail; mp_decode (kernel E) "
                         "decodes a configuration without one")
    _check_llr(llr, tables)
    batch = llr.shape[0]
    hard = torch.empty_like(llr)
    iters, rounds = (torch.empty(batch, dtype=torch.int32, device=dev)
                     for _ in range(2))
    kernels.launch("faid_full_decoder", dev, style, bf, frame_mode(tables.dcfg),
                   tables.plan.msg_bits, llr.data_ptr(), hard.data_ptr(),
                   iters.data_ptr(), rounds.data_ptr(), tables.args, batch)
    return hard, iters, rounds


def mp_decode(llr: torch.Tensor, tables: DecoderTables):
    """MP-decode ``llr`` [batch, n_var] int8 with no BF tail: (en [batch,
    n_var] int8, the final LLRs; mp_iters [batch] int32).  A CPU tensor
    takes the plain twin; a CUDA tensor launches kernel E."""
    dev = kernels.kernel_device(llr, tables.device)
    if dev is None:
        return mp_decode_plain(llr, tables.code, tables.dcfg)
    style, bf = kernel_ids(tables.dcfg)
    if bf != BF_IDS["none"]:
        raise ValueError("kernel E runs no BF tail; full_decode (kernel D) "
                         "decodes a configuration with one")
    _check_llr(llr, tables)
    en = torch.empty_like(llr)
    iters = torch.empty(llr.shape[0], dtype=torch.int32, device=dev)
    kernels.launch("faid_mp_decoder", dev, style, frame_mode(tables.dcfg),
                   tables.plan.msg_bits, llr.data_ptr(), en.data_ptr(),
                   iters.data_ptr(), tables.args, llr.shape[0])
    return en, iters


def launch_info(kernel: str, tables: DecoderTables, batch: int = GROUP) -> dict:
    """What the entry point of kernel ``kernel`` ("B", "D", "E" or "F")
    would launch for ``tables`` on their CUDA device, without launching:
    ``active`` clusters a device holds at once (group mode,
    cudaOccupancyMaxActiveClusters) or blocks an SM holds (frame mode),
    its dynamic shared bytes, frames a block and blocks a cluster."""
    style, bf = kernel_ids(tables.dcfg)
    fm, bits = frame_mode(tables.dcfg), tables.plan.msg_bits
    calls = {   # each entry's arguments before the tables, with no buffers
        "B": ("faid_stats_decoder", (style, bf, fm, bits, *[None] * 5, 0, None)),
        "D": ("faid_full_decoder", (style, bf, fm, bits, *[None] * 4)),
        "E": ("faid_mp_decoder", (style, fm, bits, *[None] * 3)),
        # F: QPSK and no thresholds
        "F": ("faid_fused_sim", (style, bf, fm, bits, *[None] * 8, 2, *[0] * 6))}
    if kernel not in calls:
        raise ValueError(f"no decoder kernel {kernel!r}")
    entry, head = calls[kernel]
    info = (ctypes.c_int * 4)()
    kernels.launch(entry, tables.device, *head, tables.args, batch,
                   info=ctypes.addressof(info))
    return dict(zip(("active", "smem_bytes", "frames", "cluster"), info))
