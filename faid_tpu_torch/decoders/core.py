"""Decoder assembly: LLR ingest -> layered MP iterations -> DTBF
(``faid_tpu.decoders.core``).

``build_decoder`` returns hard decisions and iteration counts.  Its
``backend`` is the JAX function's: ``"plain"`` runs the plain PyTorch
path (the counterpart of the JAX package's xla backend) wherever its
input tensor lies; ``"auto"`` launches the full decoder kernel, kernel D
(ops/cuda_decoder.py ``full_decode``), on a CUDA tensor and runs the
plain path on a CPU tensor; the plain twins of kernels B and D call it
with ``"plain"``.  ``build_stats_decoder`` is the Monte-Carlo hot path:
on a CUDA tensor it launches the stats decoder kernel, kernel B; on a
CPU tensor it takes that kernel's plain twin, the plain ``build_decoder``
plus the info-bit error count.

Ported so far: FAID with EF 0 and the DTBF post-processor (method 2,
any FAID3/FAID32/FAID2 table), both stop modes on the plain path, group
stop mode in the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..code.qc_matrix import QCCode
from ..config import DecodeMethod, DecoderConfig
from ..convert import tables_from_arrays
from ..ops import cn_update, syndrome as syn
from . import bf as bf_mod
from . import luts


def _style_for(method: DecodeMethod) -> str:
    if method == DecodeMethod.NMS:
        return "nms"
    if method in (DecodeMethod.OMS, DecodeMethod.OMS_BF, DecodeMethod.OMS_DTBF):
        return "oms"
    return "faid"


BACKENDS = ("auto", "plain")


def check_ported(dcfg: DecoderConfig) -> None:
    """Raise NotImplementedError for a configuration outside this slice."""
    if (_style_for(dcfg.method) != "faid" or dcfg.ef_elimination != 0
            or dcfg.bf.kind != "dtbf" or not dcfg.stop_early
            or dcfg.stop_mode not in ("frame", "group")):
        raise NotImplementedError(
            f"only FAID / EF 0 / DTBF (method 2) is ported so far, got {dcfg}")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def ingest_llrs(llr: torch.Tensor, code: QCCode) -> torch.Tensor:
    """[batch, n_var] int8 -> block layout [batch, C, Z] int32 with the
    punctured tail zeroed."""
    en = llr.to(torch.int32)
    if code.puncture_tail:
        en[:, llr.shape[1] - code.puncture_tail:] = 0
    return en.reshape(llr.shape[0], code.n_block_cols, code.z)


def build_decoder(code: QCCode, dcfg: DecoderConfig, backend: str = "auto"):
    """Returns decode(llr [batch, n_var] int8) -> dict(hard [batch, n_var]
    bool, mp_iters [batch] int32, bf_rounds [batch] int32), computed on
    ``llr``'s device: by kernel D for a CUDA ``llr`` under ``"auto"``,
    else with plain tensor operations."""
    check_ported(dcfg)
    check_backend(backend)
    plain = _build_plain_decoder(code, dcfg)
    if backend == "plain":
        return plain
    from ..ops import cuda_decoder

    tables = {}     # per device, built at the first call there

    def decode(llr: torch.Tensor) -> dict:
        if llr.device.type == "cpu":
            return plain(llr)
        if llr.device not in tables:
            tables[llr.device] = cuda_decoder.decoder_tables(code, dcfg,
                                                             llr.device)
        hard, mp_iters, bf_rounds = cuda_decoder.full_decode(
            llr, tables[llr.device])
        return {"hard": hard.view(torch.bool), "mp_iters": mp_iters,
                "bf_rounds": bf_rounds}

    return decode


def _build_plain_decoder(code: QCCode, dcfg: DecoderConfig):
    entry_offsets = np.concatenate([[0], np.cumsum(code.degrees_np)])
    n_entries = int(entry_offsets[-1])
    group = dcfg.stop_mode == "group"

    def decode(llr: torch.Tensor) -> dict:
        batch = llr.shape[0]
        device = llr.device
        lut, _ = tables_from_arrays(
            luts.table_for(dcfg.lut_family, dcfg.max_iter),
            luts.ef_table(dcfg.max_iter), device)
        rows = [cn_update.make_block_row_update(
                    code, r, style="faid", oms_offset=dcfg.oms_offset,
                    lut=lut, sign_backtrack=dcfg.sign_backtrack)
                for r in range(code.n_block_rows)]
        en = ingest_llrs(llr, code)
        msgs = torch.zeros((batch, n_entries, code.z), dtype=torch.int32,
                           device=device)
        mp_iters = torch.zeros(batch, dtype=torch.int32, device=device)
        for it in range(dcfg.max_iter):
            active = syn.error_count(
                syn.unsat_checks(syn.hard_decision(en), code)) > 0
            if not bool(active.any()):
                break
            en_new, msgs_new = en, msgs.clone()
            for r in range(code.n_block_rows):
                lo, hi = int(entry_offsets[r]), int(entry_offsets[r + 1])
                en_new, msgs_new[:, lo:hi, :] = rows[r](
                    en_new, msgs_new[:, lo:hi, :], it)
            # Frames clean at the iteration top keep their state; in
            # group mode a clean frame keeps updating while any frame of
            # its 32-frame word is dirty, and the iteration counts for
            # the whole word.
            counted = bf_mod.group_any(active) if group else active
            a3 = counted[:, None, None]
            en = torch.where(a3, en_new, en)
            msgs = torch.where(a3, msgs_new, msgs)
            mp_iters += counted.to(torch.int32)

        hard, bf_rounds = bf_mod.run_dtbf(syn.hard_decision(en), code,
                                          dcfg.bf, group=group)
        return {"hard": hard.reshape(batch, code.n_var),
                "mp_iters": mp_iters, "bf_rounds": bf_rounds}

    return decode


def build_stats_decoder(code: QCCode, dcfg: DecoderConfig, device):
    """Counter-producing decoder for the Monte-Carlo hot path, for the
    all-zero codeword.

    Returns decode_stats(llr [batch, n_var] int8 on ``device``) ->
    dict(err_bits, mp_iters, bf_rounds), each [batch] int32.  A CUDA
    ``llr`` goes through the stats decoder kernel, a CPU one through its
    plain twin (ops/cuda_decoder.py)."""
    from ..ops import cuda_decoder

    tables = cuda_decoder.decoder_tables(code, dcfg, device)

    def decode_stats(llr: torch.Tensor) -> dict:
        err, iters, rounds = cuda_decoder.stats_decode(llr, tables)
        return {"err_bits": err, "mp_iters": iters, "bf_rounds": rounds}

    return decode_stats
