"""PyTorch port, every decoder configuration the JAX kernels run
(``pallas_decoder.supports``) bit for bit against faid_tpu on the toy
code: FAID's EF 2 (the one-shot erasure of flip-voted weight-3 VNs),
simple-offset OMS (offset mode 0), and every (style, BF kind) pair in both
stop modes, through the plain path and the kernels' plain twins; the
kernels' coverage (``cuda_decoder.supports``, ``kernel_ids``) against
``pallas_decoder.supports``; and the static erasure rule the kernels use
(``cuda_decoder.erasing_entries``) against JAX's per-VN marks, on the toy
code and on 50G-PON."""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code.qc_matrix import load_code as jload_code
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import BFConfig as JBFConfig
from faid_tpu.config import DecodeMethod as JMethod
from faid_tpu.config import DecoderConfig as JDecoderConfig
from faid_tpu.config import FaidLutFamily as JFamily
from faid_tpu.decoders import luts as jluts
from faid_tpu.decoders.core import build_decoder as jbuild_decoder
from faid_tpu.decoders.core import build_stats_decoder as jbuild_stats
from faid_tpu.decoders.core import ingest_llrs as jingest
from faid_tpu.golden.model import decode_golden
from faid_tpu.ops import cn_update as jcn
from faid_tpu.ops import pallas_decoder as pk
from faid_tpu.ops import syndrome as jsyn
from faid_tpu_torch.config import BFConfig, DecodeMethod, DecoderConfig
from faid_tpu_torch.convert import code_from_arrays
from faid_tpu_torch.decoders.core import build_decoder, build_stats_decoder
from faid_tpu_torch.ops import cn_update, syndrome
from faid_tpu_torch.ops import cuda_decoder as cd

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

# Each kernel style as (for_method's method, its knobs replaced): NMS at
# its own factors, OMS offset mode 0 with offset 1, and EF 2 on
# tests/test_ef2.py's pattern with the floor window open from the second
# of 6 iterations, so that the erasure fires.
STYLES = {
    cd.NMS: (DecodeMethod.NMS, dict(factor_1=26, factor_2=32)),
    cd.OMS_SELECTIVE: (DecodeMethod.OMS, {}),
    cd.OMS_OFFSET: (DecodeMethod.OMS, dict(oms_mode=0, oms_offset=1)),
    cd.FAID: (DecodeMethod.FAID_DTBF, {}),
    cd.FAID_EF1: (DecodeMethod.FAID_2B1C, {}),
    cd.FAID_EF2: (DecodeMethod.FAID_DTBF, dict(
        ef_elimination=2, floor_err_count=100000, floor_iter_thresh=4)),
}
# each BF kind's parameters: those of the method that runs it
BF_OF = {"none": None, "static": DecodeMethod.OMS_BF,
         "dtbf": DecodeMethod.FAID_DTBF, "dtbf2b1c": DecodeMethod.FAID_2B1C}
STYLE_NAMES = {cd.NMS: "nms", cd.OMS_SELECTIVE: "oms_selective",
               cd.OMS_OFFSET: "oms_offset", cd.FAID: "faid",
               cd.FAID_EF1: "faid_ef1", cd.FAID_EF2: "faid_ef2"}
PAIRS = [(s, k) for s in STYLES for k in BF_OF]
PAIR_IDS = [f"{STYLE_NAMES[s]}-{k}" for s, k in PAIRS]


def _port_code(jcode):
    return code_from_arrays(jcode.name, jcode.z, jcode.n_var, jcode.n_chk,
                            jcode.block_cols_np, jcode.shifts_np,
                            jcode.degrees_np, puncture_tail=jcode.puncture_tail)


def pair_config(style: int, kind: str, stop_mode: str) -> DecoderConfig:
    """The port's configuration of a (style, BF kind) pair."""
    method, knobs = STYLES[style]
    base = DecoderConfig.for_method(method, stop_mode=stop_mode)
    bf = (BFConfig() if BF_OF[kind] is None
          else DecoderConfig.for_method(BF_OF[kind]).bf)
    return dataclasses.replace(base, bf=bf, **knobs)


def to_jax(dcfg: DecoderConfig) -> JDecoderConfig:
    """The same configuration in faid_tpu's classes."""
    fields = {f.name: getattr(dcfg, f.name) for f in dataclasses.fields(dcfg)}
    fields.update(method=JMethod(int(dcfg.method)),
                  lut_family=JFamily(dcfg.lut_family.value),
                  bf=JBFConfig(**dataclasses.asdict(dcfg.bf)))
    return JDecoderConfig(**fields)


def _llrs(n_var, batch=64, seed=1):
    """Two 32-frame words: one with a few weak errors (MP clears it), one
    noisy (MP fails, a BF tail runs, EF 2 erases)."""
    llr = np.random.default_rng(seed).integers(-7, 8, (batch, n_var)).astype(np.int8)
    llr[:32] = np.minimum(llr[:32], -1)
    llr[:32:5, 5 * 8 + 1] = 2
    return llr


@pytest.mark.parametrize("name", ["toy", "50gpon"])
def test_flip_votes(name):
    """syndrome.flip_votes, which EF 2 reads, against JAX's."""
    jcode = jtoy_code() if name == "toy" else jload_code("50gpon")
    code = _port_code(jcode)
    unsat = np.random.default_rng(5).random(
        (2, code.n_block_rows, code.z)) < 0.3
    want = np.asarray(jax.jit(lambda u: jsyn.flip_votes(u, jcode))(
        jnp.asarray(unsat)))
    got = syndrome.flip_votes(torch.from_numpy(unsat), code)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() >= 3


def _ef2_rows(code, jcode, en, unsat, lme, jax_rows: bool):
    """One iteration of EF 2 row updates in order, the marks threaded, on
    the port's plain path or (``jax_rows``) JAX's: [(en, messages, VNs
    newly marked)] after each row, as numpy."""
    lut = jluts.table_for(JFamily.FAID3, 6)
    lut_ef = jluts.ef_table(6)
    votes = syndrome.flip_votes(torch.from_numpy(unsat), code).numpy()
    rng = np.random.default_rng(11)
    if jax_rows:
        asarr, era = jnp.asarray, jnp.zeros(en.shape, jnp.bool_)
    else:
        asarr, era = torch.from_numpy, torch.zeros(en.shape, dtype=torch.bool)
    cur = asarr(en.astype(np.int32))
    out = []
    for r in range(code.n_block_rows):
        msgs = rng.integers(-7, 8, (en.shape[0], code.degrees[r], code.z))
        ctx = dict(it=3, in_floor=True, l_m_error_sum=asarr(lme),
                   l_checksum=asarr(np.ascontiguousarray(unsat[:, r, :])),
                   votes=asarr(votes))
        before = np.array(era)
        if jax_rows:
            up = jcn.make_block_row_update(
                jcode, r, style="faid", factor_1=1, factor_2=6, oms_mode=0,
                oms_offset=0, lut=jnp.asarray(lut), lut_ef=jnp.asarray(lut_ef),
                ef_elimination=2)
            cur, m, era = up(cur, jnp.asarray(msgs.astype(np.int8)),
                             jcn.RowCtx(**ctx, era=era))
        else:
            up = cn_update.make_block_row_update(
                code, r, style="faid", oms_offset=0,
                lut=torch.from_numpy(lut.astype(np.int32)),
                lut_ef=torch.from_numpy(lut_ef.astype(np.int32)),
                ef_elimination=2)
            # the port marks ``era`` in place
            cur, m = up(cur, torch.from_numpy(msgs.astype(np.int8)),
                        cn_update.RowCtx(**ctx, era=era))
        out.append((np.asarray(cur), np.asarray(m), np.array(era) & ~before))
    return out, votes


@pytest.mark.parametrize("name", ["toy", "50gpon"])
def test_erasure_rule_is_jax_era(name):
    """The kernels' static rule (erase at the entry that starts a weight-3
    column) equals JAX's first-visit marks.  On both codes: no block
    column repeats in a block row, the rule's columns are those JAX's
    xla and Pallas decoders erase on (VN weight 3, three adjacency
    entries), and its entries are their lowest rows; and the plain row
    updates of one iteration, run in order with the marks threaded, mark
    exactly the eligible VNs of each row's starting entries.  On the toy
    code JAX's row updates give the same en, messages and marks at every
    row (on 50G-PON they cost ~18 s op by op, ~60 s jitted)."""
    jcode = jtoy_code() if name == "toy" else jload_code("50gpon")
    code = _port_code(jcode)
    adj = {}
    ge = 0
    for r in range(code.n_block_rows):
        cols = code.block_cols[r][:code.degrees[r]]
        assert len(set(cols)) == len(cols)
        for c in cols:
            adj.setdefault(c, []).append(ge)
            ge += 1
    starts = cd.erasing_entries(code)
    weight3 = {c for c in adj if jcode.vn_weight_blocks_np[c, 0] == 3}
    assert weight3 == {c for c in adj if len(adj[c]) == 3} != set()
    assert set(starts) == {adj[c][0] for c in weight3}

    rng = np.random.default_rng(7)
    unsat = rng.random((2, code.n_block_rows, code.z)) < 0.6
    lme = np.array([True, False])
    en = rng.integers(-31, 32, (2, code.n_block_cols, code.z)).astype(np.int8)
    got, votes = _ef2_rows(code, jcode, en, unsat, lme, jax_rows=False)
    eligible = (votes >= 3) & lme[:, None, None]
    ge = 0
    for r, (_, _, marked) in enumerate(got):
        want = np.zeros_like(marked)
        for e, c in enumerate(code.block_cols[r][:code.degrees[r]]):
            if ge + e in starts:
                want[:, c, :] = eligible[:, c, :]
        np.testing.assert_array_equal(marked, want, err_msg=f"row {r}")
        ge += code.degrees[r]
    assert any(m.any() for _, _, m in got)
    if name == "toy":
        want, _ = _ef2_rows(code, jcode, en, unsat, lme, jax_rows=True)
        for r, (g, w) in enumerate(zip(got, want)):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y, err_msg=f"row {r}")


@pytest.mark.parametrize("method", list(DecodeMethod), ids=lambda m: m.name)
def test_supports_matches_jax(method):
    """cuda_decoder.supports is pallas_decoder.supports over method x
    offset mode x EF x BF kind x stop mode, and kernel_ids is defined
    wherever it holds (and raises elsewhere)."""
    base = DecoderConfig.for_method(method)
    seen = set()
    for oms_mode, ef, kind, stop in itertools.product(
            (0, 1, 2), (0, 1, 2, 3), ("none", "static", "dtbf", "dtbf2b1c",
                                      "other"), ("frame", "group", "word")):
        d = dataclasses.replace(base, oms_mode=oms_mode, ef_elimination=ef,
                                stop_mode=stop,
                                bf=dataclasses.replace(base.bf, kind=kind))
        ok = cd.supports(d)
        assert ok == pk.supports(to_jax(d)), d
        if ok:
            seen.add(cd.kernel_ids(d))
        else:
            with pytest.raises(NotImplementedError):
                cd.kernel_ids(d)
    style = {DecodeMethod.NMS: {cd.NMS},
             DecodeMethod.FAID_DTBF: {cd.FAID, cd.FAID_EF1, cd.FAID_EF2},
             DecodeMethod.FAID_2B1C: {cd.FAID, cd.FAID_EF1, cd.FAID_EF2}}.get(
                 method, {cd.OMS_SELECTIVE, cd.OMS_OFFSET})
    assert seen == {(s, b) for s in style for b in range(4)}
    assert seen <= cd.KERNEL_PAIRS


def _check_decoders(code, dcfg, llr, hard, mp_iters, bf_rounds):
    """build_decoder (auto and plain), build_stats_decoder and the three
    twins on the CPU against the reference's hard decisions and counts."""
    tllr = torch.from_numpy(llr)
    for backend in ("auto", "plain"):
        out = build_decoder(code, dcfg, backend=backend)(tllr)
        np.testing.assert_array_equal(out["hard"].numpy(), hard, err_msg=backend)
        np.testing.assert_array_equal(out["mp_iters"].numpy(), mp_iters)
        np.testing.assert_array_equal(out["bf_rounds"].numpy(), bf_rounds)
    ref = np.random.default_rng(2).integers(0, 2, (llr.shape[0], code.n_info))
    stats = build_stats_decoder(code, dcfg, "cpu")(
        tllr, torch.from_numpy(ref.astype(np.int8)))
    np.testing.assert_array_equal(
        stats["err_bits"].numpy(), (hard[:, :code.n_info] != ref).sum(axis=1))
    np.testing.assert_array_equal(stats["mp_iters"].numpy(), mp_iters)
    np.testing.assert_array_equal(stats["bf_rounds"].numpy(), bf_rounds)
    if dcfg.bf.kind == "none":
        en, iters = cd.mp_decode_plain(tllr, code, dcfg)
        np.testing.assert_array_equal(en.numpy() > 0, hard)
    else:
        h, iters, rounds = cd.full_decode_plain(tllr, code, dcfg)
        np.testing.assert_array_equal(h.numpy(), hard.astype(np.int8))
        np.testing.assert_array_equal(rounds.numpy(), bf_rounds)
    np.testing.assert_array_equal(iters.numpy(), mp_iters)


@pytest.mark.parametrize("style,kind", PAIRS, ids=PAIR_IDS)
def test_every_pair_frame_mode_vs_golden(style, kind):
    """Frame stop mode: every (style, BF kind) pair against faid_tpu's
    golden model, frame by frame; EF 2's erasure changes decisions
    against EF 1 (the same LUT swap without it)."""
    jcode = jtoy_code()
    code = _port_code(jcode)
    dcfg = pair_config(style, kind, "frame")
    llr = _llrs(code.n_var)[24:56]
    gold = [decode_golden(f, jcode, to_jax(dcfg)) for f in llr]
    hard = np.stack([g["hard"] for g in gold]).astype(bool)
    mp_iters = np.array([g["mp_iters"] for g in gold])
    bf_rounds = np.array([g["bf_rounds"] for g in gold])
    _check_decoders(code, dcfg, llr, hard, mp_iters, bf_rounds)
    if kind != "none" and dcfg.stop_early:
        assert bf_rounds.sum() > 0
    if style == cd.FAID_EF2:
        ef1 = build_decoder(code, dataclasses.replace(dcfg, ef_elimination=1),
                            backend="plain")(torch.from_numpy(llr))
        assert bool((ef1["hard"].numpy() != hard).any())


# Group stop mode runs elsewhere for DecoderConfig.for_method's pairs
# (tests/test_torch_methods.py, tests/test_torch_decoder.py, against the
# Pallas kernels in interpret mode) and, below, for EF 2 with DTBF and
# simple OMS without BF; the xla decoder holds the other sixteen.
GROUP_PAIRS = [(s, k) for s, k in PAIRS
               if (s, cd.BF_IDS[k]) not in cd.SIM_PAIRS
               and (s, k) not in ((cd.FAID_EF2, "dtbf"), (cd.OMS_OFFSET, "none"))]


@pytest.mark.parametrize(
    "style,kind", GROUP_PAIRS,
    ids=[f"{STYLE_NAMES[s]}-{k}" for s, k in GROUP_PAIRS])
def test_every_pair_group_mode_vs_xla(style, kind):
    """Group stop mode (the reference's whole-word stop) against
    faid_tpu's xla decoder."""
    jcode = jtoy_code()
    code = _port_code(jcode)
    dcfg = pair_config(style, kind, "group")
    llr = _llrs(code.n_var)
    want = jax.jit(jbuild_decoder(jcode, to_jax(dcfg), backend="xla"))(
        jnp.asarray(llr))
    want = {k: np.asarray(v) for k, v in want.items()}
    _check_decoders(code, dcfg, llr, want["hard"], want["mp_iters"],
                    want["bf_rounds"])


@pytest.mark.parametrize("style,kind", [(cd.FAID_EF2, "dtbf"),
                                        (cd.OMS_OFFSET, "none")],
                         ids=["faid_ef2-dtbf", "oms_offset-none"])
def test_twins_vs_pallas_interpret(style, kind):
    """Group stop mode, batch 64: kernel B's twin against
    make_stats_decoder(interpret=True), and kernel D's (BF tail) or E's
    (none) against make_full_decoder / make_mp_decoder, through the
    wrappers' CPU path."""
    jcode = jtoy_code()
    code = _port_code(jcode)
    dcfg = pair_config(style, kind, "group")
    jdcfg = to_jax(dcfg)
    llr = _llrs(code.n_var)
    tllr = torch.from_numpy(llr)
    tables = cd.decoder_tables(code, dcfg, "cpu")
    want = jax.jit(jbuild_stats(jcode, jdcfg, backend="pallas",
                                interpret=True))(jnp.asarray(llr))
    got = cd.stats_decode(tllr, tables)
    for k, g in zip(("err_bits", "mp_iters", "bf_rounds"), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k]), err_msg=k)
    cbz = jnp.transpose(jingest(jnp.asarray(llr), jcode), (1, 0, 2))
    if kind == "none":
        w_en, w_iters = jax.jit(pk.make_mp_decoder(jcode, jdcfg, interpret=True))(cbz)
        en, iters = cd.mp_decode(tllr, tables)
        np.testing.assert_array_equal(
            en.numpy(), np.transpose(np.asarray(w_en), (1, 0, 2)).reshape(64, -1))
    else:
        w_hard, w_iters, w_bf = jax.jit(pk.make_full_decoder(
            jcode, jdcfg, interpret=True))(cbz)
        hard, iters, rounds = cd.full_decode(tllr, tables)
        np.testing.assert_array_equal(
            hard.numpy(), np.transpose(np.asarray(w_hard), (1, 0, 2)).reshape(64, -1))
        np.testing.assert_array_equal(rounds.numpy(), np.asarray(w_bf))
        assert int(rounds.sum()) > 0
    np.testing.assert_array_equal(iters.numpy(), np.asarray(w_iters).reshape(64))
    assert cd.stats_decode.launches == cd.full_decode.launches == \
        cd.mp_decode.launches == 0
