"""The decoder kernels: MP + DTBF for FAID with EF 0
(``faid_tpu.ops.pallas_decoder``).

  stats_decode  per-frame info-bit error count, mp_iters, bf_rounds:
                kernel B (``make_stats_decoder``), the Monte-Carlo sweep's
                decoder
  full_decode   hard decisions [B, n_var], mp_iters, bf_rounds: kernel D
                (``make_full_decoder``), build_decoder's kernel path and
                the forensic replay's decoder

Both kernels are one template in csrc/stats_decoder.cu.  Each wrapper
launches its kernel on a CUDA tensor and takes its plain twin
(``*_plain``) on a CPU tensor.  The twins are the composition of the
plain modules (decoders/core.py ``build_decoder(backend="plain")``:
syndrome, row updates, DTBF), plus the error count for B; each agrees
with its kernel bit for bit.

The kernels cover FAID with EF 0 + DTBF in group stop mode and codes of
row degree <= ``MAX_DEG``; kernel B also only the all-zero reference
word.  Other configurations raise before any launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..code.qc_matrix import QCCode
from ..config import DecoderConfig
from ..convert import tables_from_arrays
from ..decoders import luts
from ..decoders.bf import GROUP   # frames per stop word == per thread block

MAX_DEG = 24     # csrc/stats_decoder.cu kMaxDeg
SMEM_LIMIT = 232_448   # shared memory one Hopper block can use, bytes


@dataclasses.dataclass(frozen=True)
class DecoderTables:
    """The code and decoder tables kernel B reads, on one device."""

    code: QCCode
    dcfg: DecoderConfig
    device: torch.device
    row_ptr: torch.Tensor     # [n_rows + 1] first entry of each block row
    ent_col: torch.Tensor     # [n_entries] block column of each entry
    ent_shift: torch.Tensor   # [n_entries] circulant shift of each entry
    elig_col: torch.Tensor    # [n_elig] block columns of weight gamma
    elig_row: torch.Tensor    # [n_elig * gamma] their block rows
    elig_shift: torch.Tensor  # [n_elig * gamma] and shifts
    lut: torch.Tensor         # [max_iter, 8] FAID magnitudes


def decoder_tables(code: QCCode, dcfg: DecoderConfig, device) -> DecoderTables:
    from ..decoders.core import check_ported

    check_ported(dcfg)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # tensors created on "cuda" report the indexed current device
        device = torch.device("cuda", torch.cuda.current_device())
    deg = code.degrees_np
    cols = np.concatenate([code.block_cols_np[r, :deg[r]]
                           for r in range(code.n_block_rows)])
    shifts = np.concatenate([code.shifts_np[r, :deg[r]]
                             for r in range(code.n_block_rows)])
    adj = {}
    for r in range(code.n_block_rows):
        for c, s in zip(code.block_cols[r][:deg[r]], code.shifts[r][:deg[r]]):
            adj.setdefault(c, []).append((r, s))
    elig = [c for c in sorted(adj) if len(adj[c]) == dcfg.bf.gamma]
    elig_rs = np.array([rs for c in elig for rs in adj[c]],
                       dtype=np.int32).reshape(-1, 2)
    lut, _ = tables_from_arrays(luts.table_for(dcfg.lut_family, dcfg.max_iter),
                                luts.ef_table(dcfg.max_iter), device)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                               device=device)

    return DecoderTables(
        code=code, dcfg=dcfg, device=device,
        row_ptr=t(np.concatenate([[0], np.cumsum(deg)])),
        ent_col=t(cols), ent_shift=t(shifts), elig_col=t(elig),
        elig_row=t(elig_rs[:, 0]), elig_shift=t(elig_rs[:, 1]), lut=lut)


def stats_decode_plain(llr: torch.Tensor, code: QCCode, dcfg: DecoderConfig):
    """Plain PyTorch twin of kernel B on ``llr``'s device:
    (err_bits, mp_iters, bf_rounds), each [batch] int32."""
    from ..decoders.core import build_decoder

    out = build_decoder(code, dcfg, backend="plain")(llr)
    err = out["hard"][:, :code.n_info].sum(dim=1, dtype=torch.int32)
    return err, out["mp_iters"], out["bf_rounds"]


def full_decode_plain(llr: torch.Tensor, code: QCCode, dcfg: DecoderConfig):
    """Plain PyTorch twin of kernel D on ``llr``'s device: (hard [batch,
    n_var] int8 0/1, mp_iters [batch] int32, bf_rounds [batch] int32)."""
    from ..decoders.core import build_decoder

    out = build_decoder(code, dcfg, backend="plain")(llr)
    return out["hard"].to(torch.int8), out["mp_iters"], out["bf_rounds"]


def _kernel_scratch(llr: torch.Tensor, tables: DecoderTables):
    """Check what kernels B and D take; returns their scratch (en, msgs)."""
    code, dcfg = tables.code, tables.dcfg
    batch = llr.shape[0]
    if (llr.dtype != torch.int8 or llr.shape != (batch, code.n_var)
            or not llr.is_contiguous()):
        raise ValueError("llr must be a contiguous int8 [batch, n_var] tensor")
    if dcfg.stop_mode != "group":
        raise NotImplementedError("the decoder kernels run group stop mode "
                                  "only")
    if batch % GROUP or batch == 0:
        raise ValueError(f"batch must be a positive multiple of {GROUP}")
    if code.max_deg > MAX_DEG or code.n_var % code.z:
        raise NotImplementedError(
            f"kernel bounds: row degree <= {MAX_DEG}, n_var % z == 0")
    if GROUP * code.n_block_rows * code.z > SMEM_LIMIT:
        raise NotImplementedError("the word's check map exceeds shared memory")
    msgs = torch.empty((batch, int(tables.ent_col.numel()), code.z),
                       dtype=torch.int8, device=llr.device)
    return torch.empty_like(llr), msgs


def _code_args(tables: DecoderTables, batch: int) -> tuple:
    """The code tables and parameters both kernels take after their
    buffers (csrc/stats_decoder.cu ``FAID_CODE_PARAMS``)."""
    code, dcfg, bf = tables.code, tables.dcfg, tables.dcfg.bf
    stream = torch.cuda.current_stream(tables.device).cuda_stream
    return (tables.row_ptr.data_ptr(), tables.ent_col.data_ptr(),
            tables.ent_shift.data_ptr(), tables.elig_col.data_ptr(),
            tables.elig_row.data_ptr(), tables.elig_shift.data_ptr(),
            tables.lut.data_ptr(),
            batch, code.n_var, code.n_info, code.z, code.n_block_rows,
            int(tables.ent_col.numel()), code.n_var - code.puncture_tail,
            dcfg.max_iter, int(tables.elig_col.numel()), bf.gamma,
            bf.max_iter, bf.delta, bf.l0, bf.l1, bf.alpha, dcfg.oms_offset,
            int(dcfg.sign_backtrack), stream)


def _on_kernel_device(llr: torch.Tensor, tables: DecoderTables) -> bool:
    """True for a CUDA ``llr`` (launch the kernel), False for a CPU one
    (take the plain twin)."""
    if llr.device != tables.device:
        raise ValueError(f"llr on {llr.device}, tables on {tables.device}")
    if llr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decoder kernel for device {llr.device}")
    return llr.device.type == "cuda"


def stats_decode(llr: torch.Tensor, tables: DecoderTables):
    """Decode ``llr`` [batch, n_var] int8 against the all-zero word:
    (err_bits, mp_iters, bf_rounds), each [batch] int32.  A CPU tensor
    takes the plain twin; a CUDA tensor launches kernel B."""
    if not _on_kernel_device(llr, tables):
        return stats_decode_plain(llr, tables.code, tables.dcfg)
    en, msgs = _kernel_scratch(llr, tables)
    from ..utils import kernels

    lib = kernels.library()
    batch = llr.shape[0]
    hard = torch.empty_like(llr)
    err, iters, rounds = (torch.empty(batch, dtype=torch.int32,
                                      device=llr.device) for _ in range(3))
    with torch.cuda.device(llr.device):
        status = lib.faid_stats_decoder(
            llr.data_ptr(), en.data_ptr(), msgs.data_ptr(), hard.data_ptr(),
            err.data_ptr(), iters.data_ptr(), rounds.data_ptr(),
            *_code_args(tables, batch))
    stats_decode.launches += 1
    kernels.check(status)
    return err, iters, rounds


stats_decode.launches = 0


def full_decode(llr: torch.Tensor, tables: DecoderTables):
    """Decode ``llr`` [batch, n_var] int8: (hard [batch, n_var] int8 0/1,
    mp_iters [batch] int32, bf_rounds [batch] int32), ``hard`` the
    final decisions (after the DTBF tail).  A CPU tensor takes the plain
    twin; a CUDA tensor launches kernel D."""
    if not _on_kernel_device(llr, tables):
        return full_decode_plain(llr, tables.code, tables.dcfg)
    en, msgs = _kernel_scratch(llr, tables)
    from ..utils import kernels

    lib = kernels.library()
    batch = llr.shape[0]
    hard = torch.empty_like(llr)
    iters, rounds = (torch.empty(batch, dtype=torch.int32, device=llr.device)
                     for _ in range(2))
    with torch.cuda.device(llr.device):
        status = lib.faid_full_decoder(
            llr.data_ptr(), en.data_ptr(), msgs.data_ptr(), hard.data_ptr(),
            iters.data_ptr(), rounds.data_ptr(), *_code_args(tables, batch))
    full_decode.launches += 1
    kernels.check(status)
    return hard, iters, rounds


full_decode.launches = 0
