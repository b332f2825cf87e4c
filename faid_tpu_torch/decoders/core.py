"""Decoder assembly: LLR ingest -> layered MP iterations -> BF
post-processor (``faid_tpu.decoders.core``).

One function covers the six reference decode methods; they differ in
data (config and tables), not in code paths:

  NMS        style nms,  no early stop
  OMS        style oms,  selective offsets
  FAID+DTBF  style faid, EF 0, DTBF(10)
  OMS+BF     style oms,  selective offsets, static BF(50)
  OMS+DTBF   style oms,  selective offsets, DTBF(50)
  FAID-2B1C  style faid, EF 1, 2B1C-DTBF(10)

``build_decoder`` returns hard decisions and iteration counts.  Its
``backend`` is the JAX function's: ``"plain"`` runs the plain PyTorch
path (the counterpart of the JAX package's xla backend) wherever its
input tensor lies; ``"auto"`` runs the plain path on a CPU tensor and
launches a kernel on a CUDA tensor: the full decoder, kernel D
(ops/cuda_decoder.py ``full_decode``), for a method with a BF tail, the
MP-only decoder, kernel E (``mp_decode``), for one without.  The plain
twins of the kernels call it with ``"plain"``.  ``build_stats_decoder``
is the Monte-Carlo round's decoder where kernel F does not take the
whole round: on a CUDA tensor it launches the stats decoder kernel,
kernel B; on a CPU tensor it takes that kernel's plain twin, the plain
``build_decoder`` plus the info-bit error count against the reference
word.

The plain path and the kernels run every configuration of
``pallas_decoder.supports`` (ops/cuda_decoder.py ``supports``), in both
stop modes.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..code.qc_matrix import QCCode
from ..config import DecodeMethod, DecoderConfig
from ..convert import tables_from_arrays
from ..ops import cn_update, cuda_decoder, fixed_point as fp, syndrome as syn
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
    """Raise NotImplementedError for a configuration that ``faid_tpu``'s
    kernels do not support either (``pallas_decoder.supports``)."""
    if not cuda_decoder.supports(dcfg):
        raise NotImplementedError(f"no decoder for {dcfg}")


def warn_nms_factors(dcfg: DecoderConfig) -> None:
    """Warn when NMS's normalization floors every message to zero."""
    if (_style_for(dcfg.method) == "nms"
            and (fp.SAT_POS_MSG * dcfg.factor_1) >> 5 == 0):
        # The shared Profile default 1/6 floors the NMS normalization
        # (min*factor)>>5 to zero for every possible 4-bit min, pinning
        # FER at 1.0.  NMS wants its own factors, e.g. 26/32.
        warnings.warn(
            f"NMS normalization (min*{dcfg.factor_1})>>5 is zero for all "
            f"4-bit message magnitudes - every V2C message becomes 0 and "
            f"FER pins at 1.0. Use NMS-appropriate factors (e.g. 26/32).",
            stacklevel=3)


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
    ``llr``'s device: by kernel D (BF tail) or kernel E (none) for a CUDA
    ``llr`` under ``"auto"``, else with plain tensor operations."""
    check_ported(dcfg)
    check_backend(backend)
    warn_nms_factors(dcfg)
    plain = _build_plain_decoder(code, dcfg)
    if backend == "plain":
        return plain
    tables = {}     # per device, built at the first call there

    def decode(llr: torch.Tensor) -> dict:
        if llr.device.type == "cpu":
            return plain(llr)
        if llr.device not in tables:
            tables[llr.device] = cuda_decoder.decoder_tables(code, dcfg,
                                                             llr.device)
        if dcfg.bf.kind == "none":
            en, mp_iters = cuda_decoder.mp_decode(llr, tables[llr.device])
            return {"hard": en > 0, "mp_iters": mp_iters,
                    "bf_rounds": torch.zeros_like(mp_iters)}
        hard, mp_iters, bf_rounds = cuda_decoder.full_decode(
            llr, tables[llr.device])
        return {"hard": hard.view(torch.bool), "mp_iters": mp_iters,
                "bf_rounds": bf_rounds}

    return decode


def _row_updates(code: QCCode, dcfg: DecoderConfig, device) -> list:
    """The block-row updates of ``dcfg``'s style, tables on ``device``."""
    style = _style_for(dcfg.method)
    lut = lut_ef = None
    if style == "faid":
        lut, lut_ef = tables_from_arrays(
            luts.table_for(dcfg.lut_family, dcfg.max_iter),
            luts.ef_table(dcfg.max_iter), device)
    return [cn_update.make_block_row_update(
                code, r, style=style, oms_offset=dcfg.oms_offset, lut=lut,
                lut_ef=lut_ef, factor_1=dcfg.factor_1,
                factor_2=dcfg.factor_2, oms_mode=dcfg.oms_mode,
                sign_backtrack=dcfg.sign_backtrack,
                ef_elimination=dcfg.ef_elimination)
            for r in range(code.n_block_rows)]


def _run_bf(en: torch.Tensor, code: QCCode, dcfg: DecoderConfig,
            group: bool):
    """The BF post-processor of ``dcfg`` on the post-MP ``en`` [batch,
    C, Z]: (hard [batch, C, Z] bool, bf_rounds [batch] int32)."""
    hard = syn.hard_decision(en)
    kind = dcfg.bf.kind
    if kind == "static":
        return bf_mod.run_static_bf(hard, code, dcfg.bf, group=group)
    if kind in ("dtbf", "dtbf2b1c"):
        return bf_mod.run_dtbf(hard, code, dcfg.bf, group=group,
                               two_bit=kind == "dtbf2b1c", llr=en)
    return hard, torch.zeros(en.shape[0], dtype=torch.int32, device=en.device)


def build_plain_mp(code: QCCode, dcfg: DecoderConfig):
    """The plain layered MP iterations: mp(llr [batch, n_var] int8) ->
    (en [batch, C, Z] int32, the post-MP LLRs; mp_iters [batch] int32)."""
    entry_offsets = np.concatenate([[0], np.cumsum(code.degrees_np)])
    n_entries = int(entry_offsets[-1])
    group = dcfg.stop_mode == "group"
    needs_votes = (_style_for(dcfg.method) == "faid"
                   and dcfg.ef_elimination == 2)

    def mp(llr: torch.Tensor):
        batch = llr.shape[0]
        device = llr.device
        rows = _row_updates(code, dcfg, device)
        en = ingest_llrs(llr, code)
        msgs = torch.zeros((batch, n_entries, code.z), dtype=torch.int8,
                           device=device)
        mp_iters = torch.zeros(batch, dtype=torch.int32, device=device)
        for it in range(dcfg.max_iter):
            unsat = l_m_err = votes = era = None
            if dcfg.stop_early:
                # the syndrome at the iteration top: the stop test, and
                # the floor window's per-check map and per-frame gate
                unsat = syn.unsat_checks(syn.hard_decision(en), code)
                count = syn.error_count(unsat)
                active = count > 0
                if not bool(active.any()):
                    break
                l_m_err = count < dcfg.floor_err_count
                if needs_votes:
                    # EF 2's votes; its erase marks reset every iteration
                    votes = syn.flip_votes(unsat, code)
                    era = torch.zeros_like(en, dtype=torch.bool)
            in_floor = dcfg.max_iter - 1 - it <= dcfg.floor_iter_thresh
            en_new, msgs_new = en, msgs.clone()
            for r in range(code.n_block_rows):
                lo, hi = int(entry_offsets[r]), int(entry_offsets[r + 1])
                ctx = cn_update.RowCtx(
                    it=it, in_floor=in_floor, l_m_error_sum=l_m_err,
                    l_checksum=None if unsat is None else unsat[:, r, :],
                    votes=votes, era=era)
                en_new, msgs_new[:, lo:hi, :] = rows[r](
                    en_new, msgs_new[:, lo:hi, :], ctx)
            if not dcfg.stop_early:
                # no early stop (NMS): every frame runs every iteration
                en, msgs = en_new, msgs_new
                mp_iters += 1
                continue
            # Frames clean at the iteration top keep their state; in
            # group mode a clean frame keeps updating while any frame of
            # its 32-frame word is dirty, and the iteration counts for
            # the whole word.
            counted = bf_mod.group_any(active) if group else active
            a3 = counted[:, None, None]
            en = torch.where(a3, en_new, en)
            msgs = torch.where(a3, msgs_new, msgs)
            mp_iters += counted.to(torch.int32)
        return en, mp_iters

    return mp


def _build_plain_decoder(code: QCCode, dcfg: DecoderConfig):
    mp = build_plain_mp(code, dcfg)
    group = dcfg.stop_mode == "group"

    def decode(llr: torch.Tensor) -> dict:
        en, mp_iters = mp(llr)
        hard, bf_rounds = _run_bf(en, code, dcfg, group)
        return {"hard": hard.reshape(llr.shape[0], code.n_var),
                "mp_iters": mp_iters, "bf_rounds": bf_rounds}

    return decode


def build_stats_decoder(code: QCCode, dcfg: DecoderConfig, device):
    """Counter-producing decoder for the Monte-Carlo round.

    Returns decode_stats(llr [batch, n_var] int8 on ``device``, ref_bits
    [batch, >= n_info] int8 or bool | None) -> dict(err_bits, mp_iters,
    bf_rounds), each [batch] int32, the errors counted against
    ``ref_bits`` (the codeword, or its info bits; None: the all-zero
    word).  A CUDA ``llr`` goes through the stats decoder kernel, a CPU
    one through its plain twin (ops/cuda_decoder.py)."""
    warn_nms_factors(dcfg)
    tables = cuda_decoder.decoder_tables(code, dcfg, device)

    def decode_stats(llr: torch.Tensor, ref_bits=None) -> dict:
        err, iters, rounds = cuda_decoder.stats_decode(llr, tables, ref_bits)
        return {"err_bits": err, "mp_iters": iters, "bf_rounds": rounds}

    return decode_stats
