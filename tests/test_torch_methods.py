"""PyTorch port, the decode methods other than FAID+DTBF (NMS, OMS,
OMS+BF, OMS+DTBF, FAID-2B1C) bit for bit against faid_tpu on the toy
code: the plain row update of each style, static BF and 2B1C, and the
decoders: kernel B's, D's and E's plain twins against the Pallas kernels
in interpret mode (group stop mode), the plain path against the xla
backend (frame stop mode)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import DecodeMethod as JMethod
from faid_tpu.config import DecoderConfig as JDecoderConfig
from faid_tpu.config import FaidLutFamily as JFamily
from faid_tpu.decoders import bf as jbf
from faid_tpu.decoders import luts as jluts
from faid_tpu.decoders.core import build_decoder as jbuild_decoder
from faid_tpu.decoders.core import build_stats_decoder as jbuild_stats
from faid_tpu.decoders.core import ingest_llrs as jingest
from faid_tpu.ops import cn_update as jcn
from faid_tpu.ops import pallas_decoder as pk
from faid_tpu_torch.config import DecodeMethod, DecoderConfig, FaidLutFamily
from faid_tpu_torch.convert import code_from_arrays
from faid_tpu_torch.decoders import bf
from faid_tpu_torch.decoders.core import build_decoder, build_stats_decoder
from faid_tpu_torch.ops import cn_update, syndrome
from faid_tpu_torch.ops import cuda_decoder as cd

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _port_code(jcode):
    return code_from_arrays(jcode.name, jcode.z, jcode.n_var, jcode.n_chk,
                            jcode.block_cols_np, jcode.shifts_np,
                            jcode.degrees_np, puncture_tail=jcode.puncture_tail)


# (style, factor_1, factor_2, oms_mode, oms_offset, ef_elimination)
ROW_STYLES = {
    "nms_26_32": ("nms", 26, 32, 0, 0, 0),
    "nms_1_6": ("nms", 1, 6, 0, 0, 0),
    "oms_offset": ("oms", 1, 6, 0, 1, 0),
    "oms_selective": ("oms", 1, 6, 1, 1, 0),
    "faid_ef1": ("faid", 1, 6, 0, 0, 1),
}


@pytest.mark.parametrize("name", list(ROW_STYLES))
def test_row_update_styles(rng, name):
    """Every block row of the toy code, in and out of the floor window,
    with check and frame masks that take both values."""
    style, f1, f2, oms_mode, off, ef = ROW_STYLES[name]
    jcode = jtoy_code()
    code = _port_code(jcode)
    lut = jluts.table_for(JFamily.FAID_2B1C, 6)
    lut_ef = jluts.ef_table(6)
    batch = 8
    for in_floor in (False, True):
        en = rng.integers(-31, 32, (batch, code.n_block_cols, code.z)).astype(np.int8)
        en[0] = 0                  # zero contributions
        for r in range(code.n_block_rows):
            deg = code.degrees[r]
            msgs = rng.integers(-7, 8, (batch, deg, code.z)).astype(np.int8)
            chk = rng.random((batch, code.z)) < 0.5
            lme = np.arange(batch) % 2 == 0
            it = (r + 2 * in_floor) % 6
            jup = jcn.make_block_row_update(
                jcode, r, style=style, factor_1=f1, factor_2=f2,
                oms_mode=oms_mode, oms_offset=off, lut=jnp.asarray(lut),
                lut_ef=jnp.asarray(lut_ef), ef_elimination=ef)
            want_en, want_m, _ = jup(jnp.asarray(en), jnp.asarray(msgs), jcn.RowCtx(
                it=it, in_floor=jnp.bool_(in_floor),
                l_checksum=jnp.asarray(chk), l_m_error_sum=jnp.asarray(lme)))
            tup = cn_update.make_block_row_update(
                code, r, style=style, oms_offset=off,
                lut=torch.from_numpy(lut.astype(np.int32)),
                lut_ef=torch.from_numpy(lut_ef.astype(np.int32)),
                factor_1=f1, factor_2=f2, oms_mode=oms_mode, ef_elimination=ef)
            got_en, got_m = tup(
                torch.from_numpy(en).to(torch.int32), torch.from_numpy(msgs),
                cn_update.RowCtx(it=it, in_floor=in_floor,
                                 l_checksum=torch.from_numpy(chk),
                                 l_m_error_sum=torch.from_numpy(lme)))
            np.testing.assert_array_equal(got_en.numpy(), np.asarray(want_en))
            np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
            assert got_m.dtype == torch.int8


@pytest.mark.parametrize("kind", ["static", "dtbf2b1c"])
@pytest.mark.parametrize("group", [False, True])
def test_static_bf_and_2b1c(rng, kind, group):
    jcode = jtoy_code()
    code = _port_code(jcode)
    method = JMethod.OMS_BF if kind == "static" else JMethod.FAID_2B1C
    jcfg = JDecoderConfig.for_method(method).bf
    cfg = DecoderConfig.for_method(DecodeMethod(int(method))).bf
    llr = rng.integers(-31, 32, (64, code.n_block_cols, code.z)).astype(np.int8)
    llr[:32] = np.minimum(llr[:32], -1)
    llr[:32, 0, :2] = 20               # one word with few errors
    llr[32:] = np.where(rng.random(llr[32:].shape) < 0.9,
                        -np.abs(llr[32:]) - 1, llr[32:])
    hard = llr > 0
    if kind == "static":
        want = jax.jit(lambda h: jbf.run_static_bf(
            h, jcode, jcfg, group=group))(jnp.asarray(hard))
        got = bf.run_static_bf(torch.from_numpy(hard), code, cfg, group=group)
    else:
        want = jax.jit(lambda h, l: jbf.run_dtbf(
            h, jcode, jcfg, two_bit=True, llr=l, group=group))(
                jnp.asarray(hard), jnp.asarray(llr))
        got = bf.run_dtbf(torch.from_numpy(hard), code, cfg, group=group,
                          two_bit=True, llr=torch.from_numpy(llr).to(torch.int32))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].sum() > 0


def _method_cfgs(name, stop_mode):
    """(JAX config, port config) of DecoderConfig.for_method, NMS at its
    own factors 26/32, and OMS+BF with floor_err_count lowered so that
    the frame gate takes both values on the toy code's 32 checks."""
    method = {"nms": 0, "oms": 1, "oms_bf": 3, "oms_dtbf": 4, "faid_2b1c": 5,
              "oms_bf_floor8": 3}[name]
    kw = dict(factor_1=26, factor_2=32) if name == "nms" else {}
    j = JDecoderConfig.for_method(JMethod(method), stop_mode=stop_mode, **kw)
    t = DecoderConfig.for_method(DecodeMethod(method), stop_mode=stop_mode, **kw)
    if name == "oms_bf_floor8":
        j = dataclasses.replace(j, floor_err_count=8)
        t = dataclasses.replace(t, floor_err_count=8)
    return j, t


METHODS = ["nms", "oms", "oms_bf", "oms_dtbf", "faid_2b1c", "oms_bf_floor8"]


def _llrs(batch=64):
    """Two 32-frame words that exit differently: one with a weak error in
    a few frames, on a column of weight 4 (MP clears it in 1-2
    iterations), one noisy (MP fails, the BF tail runs)."""
    llr = np.random.default_rng(1).integers(
        -7, 8, (batch, jtoy_code().n_var)).astype(np.int8)
    llr[:32] = np.minimum(llr[:32], -1)
    llr[:32:5, 5 * 8 + 1] = 2
    return llr


@pytest.mark.parametrize("name", METHODS)
def test_kernel_twins_vs_pallas_interpret(name):
    """Group stop mode, batch 64: kernel B's twin against
    make_stats_decoder(interpret=True), and kernel D's (BF tail) or E's
    (none) against make_full_decoder / make_mp_decoder, through
    build_decoder(backend="plain") and the wrappers' CPU path."""
    jcode = jtoy_code()
    code = _port_code(jcode)
    jdcfg, dcfg = _method_cfgs(name, "group")
    llr = _llrs()
    tllr = torch.from_numpy(llr)
    want = jax.jit(jbuild_stats(jcode, jdcfg, backend="pallas",
                                interpret=True))(jnp.asarray(llr))
    got = build_stats_decoder(code, dcfg, "cpu")(tllr)
    for k in ("err_bits", "mp_iters", "bf_rounds"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["mp_iters"][:32].max()) != int(got["mp_iters"][32:].max()) \
        or name == "nms"
    if name == "oms_bf_floor8":
        # the frame gate count < floor_err_count takes both values
        counts = syndrome.error_count(syndrome.unsat_checks(
            tllr.reshape(64, code.n_block_cols, code.z) > 0, code))
        assert bool((counts < 8).any()) and bool((counts >= 8).any())
    if dcfg.bf.kind != "none":
        assert int(got["bf_rounds"].sum()) > 0

    tables = cd.decoder_tables(code, dcfg, "cpu")
    cbz = jnp.transpose(jingest(jnp.asarray(llr), jcode), (1, 0, 2))
    dec = build_decoder(code, dcfg, backend="plain")(tllr)
    if dcfg.bf.kind == "none":
        w_en, w_iters = jax.jit(pk.make_mp_decoder(jcode, jdcfg, interpret=True))(cbz)
        w_en = np.transpose(np.asarray(w_en), (1, 0, 2)).reshape(64, code.n_var)
        en, iters = cd.mp_decode(tllr, tables)
        assert en.dtype == torch.int8
        np.testing.assert_array_equal(en.numpy(), w_en)
        w_hard, w_bf = w_en > 0, np.zeros(64, np.int32)
    else:
        w_hard, w_iters, w_bf = jax.jit(pk.make_full_decoder(
            jcode, jdcfg, interpret=True))(cbz)
        w_hard = np.transpose(np.asarray(w_hard), (1, 0, 2)).reshape(64, code.n_var)
        hard, iters, rounds = cd.full_decode(tllr, tables)
        np.testing.assert_array_equal(hard.numpy(), w_hard)
        np.testing.assert_array_equal(rounds.numpy(), np.asarray(w_bf))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(w_iters).reshape(64))
    np.testing.assert_array_equal(dec["hard"].numpy(), w_hard.astype(bool))
    np.testing.assert_array_equal(dec["mp_iters"].numpy(), iters.numpy())
    np.testing.assert_array_equal(dec["bf_rounds"].numpy(), np.asarray(w_bf))
    assert cd.stats_decode.launches == cd.full_decode.launches == \
        cd.mp_decode.launches == 0


@pytest.mark.parametrize("name", METHODS)
def test_plain_frame_mode_vs_xla(name):
    jcode = jtoy_code()
    code = _port_code(jcode)
    jdcfg, dcfg = _method_cfgs(name, "frame")
    llr = _llrs()
    want = jax.jit(jbuild_decoder(jcode, jdcfg, backend="xla"))(jnp.asarray(llr))
    got = build_decoder(code, dcfg, backend="plain")(torch.from_numpy(llr))
    for k in ("hard", "mp_iters", "bf_rounds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_nms_factor_warning():
    code = _port_code(jtoy_code())
    with pytest.warns(UserWarning, match="26/32"):
        build_decoder(code, DecoderConfig.for_method(DecodeMethod.NMS))
    with pytest.warns(UserWarning, match="26/32"):
        build_stats_decoder(code, DecoderConfig.for_method(DecodeMethod.NMS),
                            "cpu")


def test_kernel_pairs_are_for_methods():
    """Kernel F is built for exactly DecoderConfig.for_method's (style, BF
    kind) pairs; kernels B, D and E for every style with every BF kind, so
    OMS offset mode 0 takes its own style; a configuration outside
    pallas_decoder.supports is refused before a launch."""
    pairs = {cd.kernel_ids(DecoderConfig.for_method(m, lut_family=fam))
             for m in DecodeMethod for fam in FaidLutFamily}
    assert pairs == cd.SIM_PAIRS < cd.KERNEL_PAIRS
    assert len(cd.KERNEL_PAIRS) == 24
    off = dataclasses.replace(DecoderConfig.for_method(DecodeMethod.OMS),
                              oms_mode=0)
    assert cd.kernel_ids(off) == (cd.OMS_OFFSET, 0)
    with pytest.raises(NotImplementedError, match="no decoder"):
        cd.kernel_ids(dataclasses.replace(off, oms_mode=2))
