"""PyTorch port, the decoder kernels' host-side plan (ops/cuda_decoder.py
``msg_bound``, ``launch_plan``; utils/kernels.py's bindings) on the CPU:
the message bound against faid_tpu's ``_msg_bound``, and the layout of
a configuration on the card (message width, frames a block, cluster,
shared bytes) against the card's limits and csrc/decoder.cuh."""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from faid_tpu.config import DecodeMethod as JMethod
from faid_tpu.config import DecoderConfig as JDecoderConfig
from faid_tpu.config import FaidLutFamily as JFamily
from faid_tpu.ops import pallas_decoder as pk
from faid_tpu_torch import load_code
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, DecoderConfig, FaidLutFamily
from faid_tpu_torch.ops import cuda_decoder as cd
from faid_tpu_torch.utils import kernels

CSRC = Path(cd.__file__).resolve().parents[1] / "csrc"

# custom knobs the kernels run besides for_method's: offsets (FAID reads
# oms_offset as its constant's offset), NMS factors, OMS offset mode 0
OFFSETS = (-3, 0, 1, 2, 5, 7, 8, 9, 20, 48, 49, 60)
FACTORS = ((1, 6), (26, 32), (0, 0), (-1, 6), (5, -2))


def _pair(m, fam):
    return (DecoderConfig.for_method(m, lut_family=fam),
            JDecoderConfig.for_method(JMethod(int(m)), lut_family=JFamily(fam.value)))


@pytest.mark.parametrize("fam", list(FaidLutFamily), ids=lambda f: f.value)
@pytest.mark.parametrize("method", list(DecodeMethod), ids=lambda m: m.name)
def test_msg_bound_matches_jax(method, fam):
    """The port's msg_bound is faid_tpu's _msg_bound on every for_method
    configuration and LUT family, and on a grid of custom offsets,
    factors, offset modes and EF modes."""
    port, jax_cfg = _pair(method, fam)
    assert cd.msg_bound(port) == pk._msg_bound(jax_cfg)
    seen = set()
    for off in OFFSETS:
        for f1, f2 in FACTORS:
            for oms_mode in (0, 1):
                for ef in (0, 1, 2):
                    kw = dict(oms_offset=off, factor_1=f1, factor_2=f2,
                              oms_mode=oms_mode, ef_elimination=ef)
                    got = cd.msg_bound(dataclasses.replace(port, **kw))
                    assert got == pk._msg_bound(dataclasses.replace(jax_cfg, **kw)), kw
                    seen.add(got)
    # the grid reaches the 4-bit bound and no bound at all
    assert {7, None} <= seen


def _codes():
    return {"50gpon": load_code("50gpon"), "toy": toy_code()}


def _configs():
    """One configuration per kernel pair: for_method's six, and every
    other style with every BF kind (NMS, OMS with offset mode 0, FAID
    with EF 0, 1 or 2, each with the BF parameters of a method that runs
    that kind); FAID, 2B1C, EF 2 and simple OMS with an offset of 8 (a
    message reaches 8)."""
    cfgs = {}
    for m in DecodeMethod:
        for fam in FaidLutFamily:
            d = DecoderConfig.for_method(m, lut_family=fam)
            cfgs.setdefault(cd.kernel_ids(d), d)
    assert set(cfgs) == cd.SIM_PAIRS
    bfs = {cd.BF_IDS[d.bf.kind]: d.bf for d in cfgs.values()}
    styles = {cd.NMS: DecoderConfig.for_method(DecodeMethod.NMS),
              cd.OMS_SELECTIVE: DecoderConfig.for_method(DecodeMethod.OMS),
              cd.OMS_OFFSET: dataclasses.replace(
                  DecoderConfig.for_method(DecodeMethod.OMS), oms_mode=0),
              cd.FAID: DecoderConfig.for_method(DecodeMethod.FAID_DTBF),
              cd.FAID_EF1: DecoderConfig.for_method(DecodeMethod.FAID_2B1C),
              cd.FAID_EF2: dataclasses.replace(
                  DecoderConfig.for_method(DecodeMethod.FAID_DTBF), ef_elimination=2)}
    for (s, b) in sorted(cd.KERNEL_PAIRS - set(cfgs)):
        cfgs[(s, b)] = dataclasses.replace(styles[s], bf=bfs[b])
    assert set(cfgs) == cd.KERNEL_PAIRS
    out = [(f"{d.method.name}_s{s}_bf{b}", d) for (s, b), d in sorted(cfgs.items())]
    out += [(f"{label}_offset8", dataclasses.replace(styles[s], oms_offset=8))
            for label, s in (("FAID_DTBF", cd.FAID), ("FAID_2B1C", cd.FAID_EF1),
                             ("FAID_EF2", cd.FAID_EF2), ("OMS_offset", cd.OMS_OFFSET))]
    return out


@pytest.mark.parametrize("code_name", ["50gpon", "toy"])
@pytest.mark.parametrize("label,dcfg", _configs(), ids=[c[0] for c in _configs()])
def test_launch_plan(code_name, label, dcfg):
    """Frames x cluster = one 32-frame word, at most 16 blocks a cluster,
    a block's shared bytes within the card's 232,448, 4-bit messages
    exactly where the bound is <= 7, and the message region laid out as
    decoder.cuh reads it: the block's frames in lanes, 16 bits an edge
    (4 frames x 4 bits, or 2 x 8), each (row, zz) 4 x an odd number of
    words, no larger than a frame-by-frame region of odd word counts."""
    code = _codes()[code_name]
    plan = cd.launch_plan(code, dcfg)
    bound = cd.msg_bound(dcfg)
    assert plan.frames * plan.cluster == 32
    assert plan.cluster <= 16
    assert plan.fits and plan.smem_bytes + cd.STATIC_SMEM <= 232_448
    assert (plan.msg_bits == 4) == (bound is not None and bound <= 7)
    assert plan.frames == (4 if plan.msg_bits == 4 else 2)
    assert plan.frames * plan.msg_bits == 16
    # row r: z groups of 4 x an odd number of words, lane q of a check's
    # quad the words q, q + 4, q + 8, two edges of the block's frames each
    off = np.asarray(plan.msg_off)
    assert off[0] == 0 and len(off) == code.n_block_rows + 1
    words = np.diff(off) // code.z
    assert (np.diff(off) % code.z == 0).all() and (words % 8 == 4).all()
    assert (words * 32 >= code.degrees_np * plan.frames * plan.msg_bits).all()
    assert (words <= 4 * _header_int("kSlots")).all()
    # a warp's 8 checks x 4 lanes load 32 banks
    for w in set(words.tolist()):
        banks = {(zz * w + q) % 32 for zz in range(8) for q in range(4)}
        assert len(banks) == 32, w
    # no larger than the frame-by-frame region: kF frames of an odd
    # number of words a (row, zz)
    per_frame = (-(-code.degrees_np * plan.msg_bits // 32)) | 1
    assert off[-1] <= plan.frames * int((per_frame * code.z).sum())
    has_bf = dcfg.bf.kind != "none"
    tail = _tail_bytes(code, dcfg, plan.frames) if has_bf else 0
    assert tail == (cd.tail_bytes(code, dcfg, plan.frames) if has_bf else 0)
    assert plan.msg_words == max(off[-1], -(-tail // 4))
    keeps_map = has_bf or cd.kernel_ids(dcfg)[0] in (cd.OMS_SELECTIVE, cd.FAID_EF1,
                                                     cd.FAID_EF2)
    assert plan.smem_bytes == (-(-plan.frames * code.n_var // 16) * 16
                               + plan.msg_words * 4
                               + keeps_map * plan.frames * code.n_block_rows * code.z)
    if code_name == "50gpon":
        # messages 147,456 bytes at either width; at 4 bits en 17,664 +
        # messages 36,864 + map 3,072 bytes a frame, as frame by frame
        assert plan.msg_words * 4 == 147_456
        if plan.msg_bits == 4:
            assert plan.smem_bytes == 4 * (17_664 + 36_864 + 3_072 * keeps_map)
    tables = cd.decoder_tables(code, dcfg, "cpu")
    assert tables.plan == plan and tables.msg_off.tolist() == list(plan.msg_off)


def _header_int(name):
    """A constexpr int of csrc/decoder.cuh, its initializer evaluated with
    the header's earlier constants."""
    head = (CSRC / "decoder.cuh").read_text()
    consts = {}
    for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", head):
        try:
            consts[m[1]] = int(eval(m[2].replace("/", "//"), {}, dict(consts)))
        except (NameError, SyntaxError, TypeError):
            continue
    return consts[name]


def test_layout_constants_match_the_header():
    """The plan's bounds are the header's: kMaxDeg and kThreads, a lane's
    kSlots words (every row of degree <= kMaxDeg fits 4 x kSlots words a
    (row, zz)), and the frames a block and blocks a cluster by width."""
    assert _header_int("kMaxDeg") == cd.MAX_DEG
    assert _header_int("kThreads") == cd.THREADS
    assert _header_int("kGroup") == 32
    slots = _header_int("kSlots")
    assert all(cd._row_words(d) <= 4 * slots for d in range(1, cd.MAX_DEG + 1))
    assert 2 * 4 * slots >= cd.MAX_DEG
    head = (CSRC / "decoder.cuh").read_text()
    # the kernel's words a (row, zz), from the degree, are the plan's
    m = re.search(r"wr = (4 \* \(\(deg \+ 7\) / 8 \| 1\));", head)
    assert m, "row_update's words a (row, zz) not found"
    assert all(eval(m[1].replace("/", "//"), {}, {"deg": d}) == cd._row_words(d)
               for d in range(1, cd.MAX_DEG + 1))
    assert "constexpr int kFrames = kBits == 4 ? 4 : 2;" in head
    assert "constexpr int kBias = kBits == 4 ? 8 : 0;" in head
    assert "kBits == 4 ? 0x88888888u : 0u" in head   # a zero message, 8 - 0


@pytest.mark.parametrize("label,dcfg,fits", [
    ("offset 127", dataclasses.replace(DecoderConfig.for_method(DecodeMethod.FAID_DTBF),
                                       oms_offset=127), True),
    ("offset 128", dataclasses.replace(DecoderConfig.for_method(DecodeMethod.FAID_DTBF),
                                       oms_offset=128), False),
    ("OMS offset -128", dataclasses.replace(DecoderConfig.for_method(DecodeMethod.OMS),
                                            oms_mode=0, oms_offset=-128), False),
    ("NMS -131", dataclasses.replace(DecoderConfig.for_method(DecodeMethod.NMS),
                                     factor_1=-131), True),
    ("NMS -132", dataclasses.replace(DecoderConfig.for_method(DecodeMethod.NMS),
                                     factor_2=-132), False),
    ("selective OMS", dataclasses.replace(DecoderConfig.for_method(DecodeMethod.OMS),
                                          factor_1=-500, oms_offset=500), True)])
def test_constants_fit_the_lanes(label, dcfg, fits):
    """A check-node constant and its negation take a byte lane: the
    wrapper refuses, before any launch, a configuration whose constants
    can leave [-127, 127] (an offset beyond 127, an NMS factor whose
    (31 * factor) >> 5 is below -127), and takes the rest."""
    assert cd.constants_in_lanes(dcfg) == fits
    tables = cd.decoder_tables(toy_code(), dcfg, "cpu")
    if fits:
        cd.check_launch(64, tables)
    else:
        with pytest.raises(NotImplementedError, match="int8"):
            cd.check_launch(64, tables)


def _round16(n):
    return -(-n // 16) * 16


def _tail_bytes(code, dcfg, frames):
    """The BF tail's state, counted from the code: a byte per VN, a byte
    per check (the map the flips toggle), and the vote tables, a word per
    voting column, per adjacency pointer and per adjacency entry (at most
    one per entry of the code)."""
    cols = np.concatenate([code.block_cols_np[r, :d] for r, d in enumerate(code.degrees_np)])
    weight = np.bincount(cols, minlength=code.n_block_cols)
    n_vote = code.n_block_cols if dcfg.bf.kind == "static" else int((weight == dcfg.bf.gamma).sum())
    return (_round16(frames * code.n_var) + _round16(frames * code.n_block_rows * code.z)
            + 4 * (2 * n_vote + 1 + len(cols)))


@pytest.mark.parametrize("code_name", ["50gpon", "toy"])
@pytest.mark.parametrize("label,dcfg", [c for c in _configs() if c[1].bf.kind != "none"],
                         ids=[c[0] for c in _configs() if c[1].bf.kind != "none"])
def test_tail_state_fits_the_message_region(code_name, label, dcfg):
    """The BF tail's state after MP (decoder.cuh ``bf_tail``) lies inside
    the block's message region: the hard bits, then the map the flips
    toggle, then the tables of the tail's own voting columns, each part
    16-byte aligned (the map takes word atomics); and the code is one the
    tail walks (z <= 1024 threads, 16-bit map offsets)."""
    code = _codes()[code_name]
    plan = cd.launch_plan(code, dcfg)
    tables = cd.decoder_tables(code, dcfg, "cpu")
    frames, region = plan.frames, plan.msg_words * 4
    map_off = _round16(frames * code.n_var)
    tab_off = map_off + _round16(frames * code.n_block_rows * code.z)
    n_vote, n_adj = tables.vote_col.numel(), int(tables.vote_ptr[-1])
    assert n_vote == len(cd.vote_columns(code, dcfg)) and n_adj <= tables.ent_col.numel()
    assert tab_off + 4 * (2 * n_vote + 1 + n_adj) <= cd.tail_bytes(code, dcfg, frames) <= region
    assert map_off % 16 == 0 and tab_off % 16 == 0
    # the message region after en, whose size is a multiple of 16 bytes
    assert (region + _round16(frames * code.n_var)) <= plan.smem_bytes
    assert code.z <= cd.THREADS and code.n_block_rows * code.z <= 1 << 16
    cd.check_launch(64, tables)


def test_wrapper_refuses_z_above_the_threads():
    """The BF tail takes one bit a thread: a code with z > 1024 is refused
    before any launch, and z = 1024 is not."""
    dcfg = DecoderConfig.for_method(DecodeMethod.FAID_DTBF)
    cd.check_launch(64, cd.decoder_tables(toy_code(z=1024), dcfg, "cpu"))
    with pytest.raises(NotImplementedError, match="z <= 1024"):
        cd.check_launch(64, cd.decoder_tables(toy_code(z=2048), dcfg, "cpu"))


def test_code_args_match_the_header():
    """utils/kernels.py's DecoderArgs is csrc/decoder.cuh's CodeArgs field
    for field, and each entry point's ctypes signature has its C
    parameter count."""
    head = (CSRC / "decoder.cuh").read_text()
    body = head[head.index("struct CodeArgs {"):]
    body = body[:body.index("};")]
    body = re.sub(r"//[^\n]*", "", body)
    fields = [name for decl in body.split(";")[:-1] for name in
              re.findall(r"\*?\s*(\w+)\s*(?:,|$)", decl.strip())]
    assert fields == [f for f, _ in kernels.DecoderArgs._fields_]
    for src in ("stats_decoder.cu", "full_decoder.cu", "mp_decoder.cu", "fused_sim.cu"):
        text = (CSRC / src).read_text()
        m = re.search(r'extern "C" int (\w+)\(([^)]*)\)', text)
        assert len(m[2].split(",")) == len(kernels._SIGNATURES[m[1]][0]), src


def test_wide_plan_is_launched_not_refused():
    """A configuration whose messages need 8 bits takes the 8-bit plan,
    which fits on the full code; EF 2 and OMS offset mode 0 take their own
    kernel instances (8-bit with an offset of 8); a configuration outside
    pallas_decoder.supports is refused at the kernels' entry."""
    code = load_code("50gpon")
    ef2 = dataclasses.replace(DecoderConfig.for_method(DecodeMethod.FAID_DTBF),
                              ef_elimination=2)
    oms0 = dataclasses.replace(DecoderConfig.for_method(DecodeMethod.OMS), oms_mode=0)
    for d, style in ((DecoderConfig.for_method(DecodeMethod.FAID_DTBF), cd.FAID),
                     (DecoderConfig.for_method(DecodeMethod.FAID_2B1C), cd.FAID_EF1),
                     (ef2, cd.FAID_EF2), (oms0, cd.OMS_OFFSET)):
        assert cd.kernel_ids(d)[0] == style
        assert cd.decoder_tables(code, d, "cpu").plan.msg_bits == 4
        d = dataclasses.replace(d, oms_offset=8)
        t = cd.decoder_tables(code, d, "cpu")
        assert (t.plan.msg_bits, t.plan.frames, t.plan.cluster) == (8, 2, 16)
        cd.check_launch(64, t)
        assert cd.kernel_ids(d) in cd.KERNEL_PAIRS
    for bad in (dataclasses.replace(DecoderConfig.for_method(DecodeMethod.FAID_DTBF),
                                    ef_elimination=3),
                dataclasses.replace(DecoderConfig.for_method(DecodeMethod.OMS),
                                    oms_mode=2)):
        with pytest.raises(NotImplementedError, match="no decoder"):
            cd.kernel_ids(bad)


def test_build_covers_every_source():
    """utils/kernels.py compiles every csrc/*.cu and hashes every
    csrc/*.cuh; the six per-style sources instantiate the six styles of
    decoder.cuh, and only the entry points include the dispatch over all
    of them (decoder_entry.cuh), which would otherwise make each
    per-style unit compile every style's kernels."""
    assert sorted(kernels.SOURCES) == sorted(p.name for p in CSRC.glob("*.cu"))
    assert sorted(kernels.HEADERS) == sorted(p.name for p in CSRC.glob("*.cuh"))
    styles = {}
    for src in kernels.SOURCES:
        text = (CSRC / src).read_text()
        found = re.findall(r"FAID_STYLE_KERNELS\(faid::(\w+)\)", text)
        if found:
            styles[src] = found
            assert '#include "decoder_entry.cuh"' not in text
    assert sorted(s for v in styles.values() for s in v) == sorted(
        ["kNms", "kOmsSel", "kOmsOff", "kFaid", "kFaidEf1", "kFaidEf2"])
    for header in ("style_kernels.cuh", "decoder.cuh"):
        assert '#include "decoder_entry.cuh"' not in (CSRC / header).read_text()
    for src in ("stats_decoder.cu", "full_decoder.cu", "mp_decoder.cu"):
        assert '#include "decoder_entry.cuh"' in (CSRC / src).read_text()
