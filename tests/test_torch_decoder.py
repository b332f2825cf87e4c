"""PyTorch port, decoder (faid_tpu_torch/decoders, ops/syndrome.py,
ops/cn_update.py, ops/cuda_decoder.py's plain twin) bit for bit against
faid_tpu: the stats kernel in interpret mode on the toy code, and the
xla backend on the full code."""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code.qc_matrix import load_code as jload_code
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import DecodeMethod as JMethod
from faid_tpu.config import DecoderConfig as JDecoderConfig
from faid_tpu.config import FaidLutFamily as JFamily
from faid_tpu.decoders import bf as jbf
from faid_tpu.decoders import luts as jluts
from faid_tpu.decoders.core import build_decoder as jbuild_decoder
from faid_tpu.decoders.core import build_stats_decoder as jbuild_stats
from faid_tpu.ops import cn_update as jcn
from faid_tpu.ops import syndrome as jsyn
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, DecoderConfig, FaidLutFamily
from faid_tpu_torch.convert import code_from_arrays
from faid_tpu_torch.decoders import bf
from faid_tpu_torch.decoders.core import build_decoder, build_stats_decoder
from faid_tpu_torch.ops import cn_update, cuda_decoder, syndrome

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _port_code(jcode):
    return code_from_arrays(jcode.name, jcode.z, jcode.n_var, jcode.n_chk,
                            jcode.block_cols_np, jcode.shifts_np,
                            jcode.degrees_np, puncture_tail=jcode.puncture_tail)


def _cfgs(stop_mode, max_iter=6):
    return (JDecoderConfig.for_method(JMethod.FAID_DTBF, max_iter=max_iter,
                                      stop_mode=stop_mode),
            DecoderConfig.for_method(DecodeMethod.FAID_DTBF, max_iter=max_iter,
                                     stop_mode=stop_mode))


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def test_unsat_checks_and_flip_votes(rng):
    jcode = jtoy_code()
    code = _port_code(jcode)
    hard = rng.integers(0, 2, (16, code.n_block_cols, code.z)).astype(bool)
    want_u = np.asarray(jsyn.unsat_checks(jnp.asarray(hard), jcode))
    got_u = syndrome.unsat_checks(torch.from_numpy(hard), code)
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    np.testing.assert_array_equal(
        syndrome.error_count(got_u).numpy(),
        np.asarray(jsyn.error_count(jnp.asarray(want_u))))
    np.testing.assert_array_equal(
        syndrome.flip_votes(got_u, code).numpy(),
        np.asarray(jsyn.flip_votes(jnp.asarray(want_u), jcode)))


@pytest.mark.parametrize("family", ["faid3", "faid2"])
@pytest.mark.parametrize("sign_backtrack", [True, False])
def test_block_row_update(rng, family, sign_backtrack):
    jcode = jtoy_code()
    code = _port_code(jcode)
    lut = jluts.table_for(JFamily(family), 6)
    en = rng.integers(-31, 32, (8, code.n_block_cols, code.z)).astype(np.int8)
    en[0] = 0                      # zero contributions: sign backtrack
    for r in range(code.n_block_rows):
        deg = code.degrees[r]
        msgs = rng.integers(-7, 8, (8, deg, code.z)).astype(np.int8)
        it = r % 6
        jup = jcn.make_block_row_update(
            jcode, r, style="faid", factor_1=1, factor_2=6, oms_mode=0,
            oms_offset=0, lut=jnp.asarray(lut), sign_backtrack=sign_backtrack)
        want_en, want_m, _ = jup(jnp.asarray(en), jnp.asarray(msgs),
                                 jcn.RowCtx(it=it))
        tup = cn_update.make_block_row_update(
            code, r, style="faid", oms_offset=0,
            lut=torch.from_numpy(lut.astype(np.int32)),
            sign_backtrack=sign_backtrack)
        got_en, got_m = tup(torch.from_numpy(en).to(torch.int32),
                            torch.from_numpy(msgs).to(torch.int32),
                            cn_update.RowCtx(it=it))
        np.testing.assert_array_equal(got_en.numpy(), np.asarray(want_en))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # FAID's EF 2 outside the floor window is EF 0's update (the swap and
    # the erasure wait for it; tests/test_torch_ef2.py holds them)
    tup = cn_update.make_block_row_update(
        code, 0, style="faid", oms_offset=0,
        lut=torch.from_numpy(lut.astype(np.int32)),
        lut_ef=torch.from_numpy(lut.astype(np.int32)),
        sign_backtrack=sign_backtrack, ef_elimination=2)
    en0 = torch.from_numpy(en).to(torch.int32)
    msgs0 = torch.from_numpy(
        rng.integers(-7, 8, (8, code.degrees[0], code.z)).astype(np.int8))
    unsat = torch.ones((8, code.n_block_rows, code.z), dtype=torch.bool)
    got = tup(en0, msgs0, cn_update.RowCtx(
        it=1, in_floor=False, l_checksum=unsat[:, 0, :],
        l_m_error_sum=torch.ones(8, dtype=torch.bool),
        votes=syndrome.flip_votes(unsat, code),
        era=torch.zeros_like(en0, dtype=torch.bool)))
    want = cn_update.make_block_row_update(
        code, 0, style="faid", oms_offset=0,
        lut=torch.from_numpy(lut.astype(np.int32)),
        sign_backtrack=sign_backtrack)(en0, msgs0, cn_update.RowCtx(it=1))
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    with pytest.raises(ValueError):
        cn_update.make_block_row_update(code, 0, style="faid", oms_offset=0,
                                        lut=None, ef_elimination=3)


@pytest.mark.parametrize("group", [False, True])
def test_run_dtbf(rng, group):
    jcode = jtoy_code()
    code = _port_code(jcode)
    jdcfg, dcfg = _cfgs("group" if group else "frame")
    hard = rng.random((64, code.n_block_cols, code.z)) < 0.08
    hard[:32] = False
    hard[:32, 0, :2] = True            # one word with few errors
    want_h, want_r = jax.jit(lambda h: jbf.run_dtbf(
        h, jcode, jdcfg.bf, group=group))(jnp.asarray(hard))
    got_h, got_r = bf.run_dtbf(torch.from_numpy(hard), code, dcfg.bf,
                               group=group)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert got_r.sum() > 0
    with pytest.raises(ValueError):
        bf.group_any(torch.zeros(33, dtype=torch.bool))


@pytest.mark.parametrize("stop_mode", ["group", "frame"])
@pytest.mark.parametrize("llr_range", [7, 127])
def test_stats_decoder_toy_vs_pallas_interpret(rng, stop_mode, llr_range):
    """The port's stats decoder on CPU (kernel B's plain twin) against
    make_stats_decoder(interpret=True): toy code, batch 64, two 32-frame
    words with different exits, DTBF engaged."""
    jcode = jtoy_code()
    code = _port_code(jcode)
    jdcfg, dcfg = _cfgs(stop_mode)
    llr = rng.integers(-llr_range, llr_range + 1,
                       (64, code.n_var)).astype(np.int8)
    llr[:32] = np.minimum(llr[:32], -1)
    want = _np(jax.jit(jbuild_stats(jcode, jdcfg, backend="pallas",
                                    interpret=True))(jnp.asarray(llr)))
    got = build_stats_decoder(code, dcfg, "cpu")(torch.from_numpy(llr))
    for k in ("err_bits", "mp_iters", "bf_rounds"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["bf_rounds"].sum() > 0 and got["err_bits"][:32].sum() == 0
    assert cuda_decoder.stats_decode.launches == 0


def noisy_llrs(rng, batch, n, snr_db):
    """QPSK all-zero word through AWGN and the 4-bit truncating quantizer
    at scale 13, in float64 numpy."""
    sigma = 1.0 / math.sqrt(0.8444444 * 2 * 10.0 ** (0.1 * snr_db))
    soft = -0.707107 + sigma / math.sqrt(2.0) * rng.normal(size=(batch, n))
    return np.clip(np.trunc(13.0 * soft), -7, 7).astype(np.int8)


def test_full_code_vs_xla(rng):
    """Full 50G-PON code, batch 32 (one word) near 3.6 dB: the plain
    decoder's hard bits and counters against build_decoder(xla), and the
    stats decoder's error count against those hard bits.  (The stats
    decoder against build_stats_decoder(xla) on the full code is in
    tests/test_torch_pipeline.py, which runs that graph anyway: one
    full-code JAX decode per file keeps each file near a minute.)"""
    jcode = jload_code("50gpon")
    code = _port_code(jcode)
    jdcfg, dcfg = _cfgs("group")
    llr = noisy_llrs(rng, 32, code.n_var, 3.5)
    # Op by op rather than jitted: the full-code jit compile takes ~6
    # CPU-minutes, eager execution ~1.3 for the same integer results.
    with jax.disable_jit():
        want = _np(jbuild_decoder(jcode, jdcfg, backend="xla")(
            jnp.asarray(llr)))
    got = build_decoder(code, dcfg)(torch.from_numpy(llr))
    np.testing.assert_array_equal(got["hard"].numpy(), want["hard"])
    for k in ("mp_iters", "bf_rounds"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["bf_rounds"].sum() > 0

    got_s = build_stats_decoder(code, dcfg, "cpu")(torch.from_numpy(llr))
    np.testing.assert_array_equal(
        got_s["err_bits"].numpy(),
        want["hard"][:, :code.n_info].sum(axis=1).astype(np.int32))
    assert (got_s["err_bits"] > 0).any()


def test_unported_configs_raise():
    """Every configuration of pallas_decoder.supports builds and decodes
    on the CPU and has a kernel instance: FAID's EF 2, simple-offset OMS,
    every for_method configuration; one outside it (OMS offset mode 2)
    raises, in build_decoder, build_stats_decoder and before any launch
    (so no card is needed here)."""
    code = toy_code()
    llr = torch.from_numpy(np.random.default_rng(4).integers(
        -7, 8, (32, code.n_var)).astype(np.int8))
    ef2 = dataclasses.replace(
        DecoderConfig.for_method(DecodeMethod.FAID_2B1C), ef_elimination=2)
    oms0 = dataclasses.replace(
        DecoderConfig.for_method(DecodeMethod.OMS_DTBF), oms_mode=0)
    for dcfg, pair in ((ef2, (cuda_decoder.FAID_EF2, 3)),
                       (oms0, (cuda_decoder.OMS_OFFSET, 2))):
        out = build_decoder(code, dcfg)(llr)
        stats = build_stats_decoder(code, dcfg, "cpu")(llr)
        np.testing.assert_array_equal(
            stats["err_bits"].numpy(), out["hard"][:, :code.n_info].sum(dim=1).numpy())
        assert int(out["bf_rounds"].sum()) > 0
        assert cuda_decoder.kernel_ids(dcfg) == pair
    for method in DecodeMethod:
        build_decoder(code, DecoderConfig.for_method(method, factor_1=26,
                                                     factor_2=32))
    bad = dataclasses.replace(DecoderConfig.for_method(DecodeMethod.OMS),
                              oms_mode=2)
    with pytest.raises(NotImplementedError, match="no decoder"):
        build_decoder(code, bad)
    with pytest.raises(NotImplementedError, match="no decoder"):
        build_stats_decoder(code, bad, "cpu")
    with pytest.raises(NotImplementedError, match="no decoder"):
        cuda_decoder.kernel_ids(bad)
    ok = DecoderConfig.for_method(DecodeMethod.FAID_DTBF,
                                  lut_family=FaidLutFamily.FAID32)
    build_decoder(code, ok)
    dec = build_stats_decoder(code, ok, "cpu")
    with pytest.raises(ValueError):
        dec(torch.zeros((32, code.n_var), dtype=torch.int8, device="meta"))
