"""The decoder template's frames in lanes (faid_tpu_torch/csrc/decoder.cuh
``row_update``: a quad of threads updates a check for all the frames of
its block at once) on the card, where the frames of one block part ways:
frame mode with frames of one block frozen at different iterations (the
lanes written back unchanged), EF 1 and EF 2 with frames of one block on
different LUT rows and erasures, an 8-bit (2-frame) instance, and kernel
F's prologue, whose en is laid out in lanes, against kernel A then B.
Each kernel is held bit for bit to its plain twin.

The cases marked ``cuda`` need an NVIDIA GPU and skip without one; the
helper that finds the blocks whose frames part ways is checked on the CPU
too.  This file imports no JAX, so on the card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decoder_lanes.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from faid_tpu_torch import load_code, sigma_for
from faid_tpu_torch.code.encoder import make_encode_fn
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, SimConfig
from faid_tpu_torch.ops import cuda_channel as cc
from faid_tpu_torch.ops import cuda_decoder as cd
from faid_tpu_torch.ops import cuda_sim as cs
from faid_tpu_torch.ops import philox

SEED = 2026102
BATCH = 2048

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decoder kernels run only on the card")
    return torch.device("cuda")


def _setup(code, method, stop_mode, batch, snr, device, **fields):
    """The configuration, its tables, the thresholds and kernel A's LLRs
    (its plain twin on the CPU) of one round at ``snr``."""
    cfg = SimConfig(decode_method=DecodeMethod(method), max_iteration=6, mod_type=2,
                    quant_bits=4, scale=13.0, batch_per_device=batch, fake_encode=True,
                    channel_backend="fused", stop_mode=stop_mode, seed=SEED)
    dcfg = dataclasses.replace(cfg.decoder(), **fields)
    params = cc.threshold_ints(cfg, sigma_for(cfg, snr)).to(device)
    llr = cc.quantile_channel(params, seed=SEED, rnd=1, batch=batch, n_var=code.n_var,
                              n_info=code.n_info, mod_type=2, quant_bits=4)[0]
    return dcfg, cd.decoder_tables(code, dcfg, device), params, llr


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{what}: output {i} differs from the twin"


def parted_blocks(per_frame: torch.Tensor, frames: int) -> torch.Tensor:
    """The blocks (``frames`` consecutive frames) whose frames differ in
    ``per_frame`` ([batch] or [batch, ...]), as a [batch / frames] bool."""
    x = per_frame.reshape(per_frame.shape[0] // frames, frames, -1)
    return (x != x[:, :1]).flatten(1).any(dim=1)


def test_parted_blocks_helper():
    """Blocks of 4: only the blocks whose frames differ are marked."""
    v = torch.tensor([3, 3, 3, 3, 2, 3, 3, 3, 5, 5, 5, 5, 1, 1, 1, 6])
    assert parted_blocks(v, 4).tolist() == [False, True, False, True]
    rows = torch.zeros(8, 3, dtype=torch.int8)
    rows[6, 2] = 1
    assert parted_blocks(rows, 2).tolist() == [False, False, False, True]


@pytest.mark.cuda
@pytest.mark.parametrize("code_name,method,snr", [
    ("50gpon", 2, 3.6), ("50gpon", 5, 3.6), ("50gpon", 1, 3.4), ("toy", 2, 2.0)])
def test_frame_mode_frames_freeze_apart(cuda, code_name, method, snr):
    """Frame mode, where the frames of one block freeze at different
    iterations: kernels B and D (E without a tail), and F where it has
    the pair, equal their plain twins frame for frame."""
    code = load_code("50gpon") if code_name == "50gpon" else toy_code()
    dcfg, tables, params, llr = _setup(code, method, "frame", BATCH, snr, cuda)
    want_b = cd.stats_decode_plain(llr, code, dcfg)
    parted = parted_blocks(want_b[1], tables.plan.frames)
    assert int(parted.sum()) > 0, "no block whose frames freeze apart"
    _assert_equal(cd.stats_decode(llr, tables), want_b, "kernel B")
    if dcfg.bf.kind != "none":
        _assert_equal(cd.full_decode(llr, tables), cd.full_decode_plain(llr, code, dcfg),
                      "kernel D")
    else:
        _assert_equal(cd.mp_decode(llr, tables), cd.mp_decode_plain(llr, code, dcfg),
                      "kernel E")
    if cd.kernel_ids(dcfg) in cd.SIM_PAIRS:
        got = cs.fused_sim(params, tables, seed=SEED, rnd=1, batch=BATCH, mod_type=2,
                           quant_bits=4)
        _assert_equal([got[k] for k in ("err_bits", "mp_iters", "bf_rounds")], want_b,
                      "kernel F")


@pytest.mark.cuda
@pytest.mark.parametrize("stop_mode", ["group", "frame"])
@pytest.mark.parametrize("ef,snr", [(1, 3.6), (2, 3.6), (1, 3.8), (2, 3.8)])
def test_ef_frames_of_a_block_disagree(cuda, stop_mode, ef, snr):
    """EF 1 and EF 2 on the full code near the floor window (FAID-2B1C's
    gate: fewer than 50 unsatisfied checks, the last 6 iterations), where
    the frames of one block disagree on the floor row (EF 2 also on the
    erasure): the blocks with frames whose en after MP differs from EF
    one step down (EF 0 for EF 1, EF 1 for EF 2) beside frames whose en
    does not.  Kernels E and B equal their plain twins there."""
    code = load_code("50gpon")
    dcfg, _, _, llr = _setup(code, 5, stop_mode, BATCH, snr, cuda, ef_elimination=ef)
    assert (dcfg.floor_err_count, dcfg.floor_iter_thresh) == (50, 6)
    # MP alone, so that kernel E holds the en of every frame
    dcfg = dataclasses.replace(dcfg, bf=dataclasses.replace(dcfg.bf, kind="none"))
    tables = cd.decoder_tables(code, dcfg, cuda)
    want = cd.mp_decode_plain(llr, code, dcfg)
    lower = cd.mp_decode_plain(llr, code, dataclasses.replace(dcfg, ef_elimination=ef - 1))
    used = (want[0] != lower[0]).any(dim=1)
    parted = parted_blocks(used, tables.plan.frames)
    assert int(parted.sum()) > 0, "no block whose frames disagree on the floor row"
    _assert_equal(cd.mp_decode(llr, tables), want, "kernel E")
    _assert_equal(cd.stats_decode(llr, tables), cd.stats_decode_plain(llr, code, dcfg),
                  "kernel B")


@pytest.mark.cuda
@pytest.mark.parametrize("stop_mode", ["group", "frame"])
@pytest.mark.parametrize("method,fields", [
    (1, {"oms_mode": 0, "oms_offset": 8}), (5, {"oms_offset": 8}), (0, {"factor_1": 5,
                                                                          "factor_2": -2})])
def test_two_frame_instances(cuda, stop_mode, method, fields):
    """The 8-bit plan (2 frames a block in the low 16 bits of each word):
    simple-offset OMS and FAID-2B1C at an offset of 8 and NMS with a
    negative factor, kernels B and E or D, on the full code at 3.6 dB."""
    code = load_code("50gpon")
    dcfg, tables, _, llr = _setup(code, method, stop_mode, BATCH, 3.6, cuda, **fields)
    assert (tables.plan.msg_bits, tables.plan.frames) == (8, 2)
    _assert_equal(cd.stats_decode(llr, tables), cd.stats_decode_plain(llr, code, dcfg),
                  "kernel B")
    if dcfg.bf.kind == "none":
        _assert_equal(cd.mp_decode(llr, tables), cd.mp_decode_plain(llr, code, dcfg),
                      "kernel E")
    else:
        _assert_equal(cd.full_decode(llr, tables), cd.full_decode_plain(llr, code, dcfg),
                      "kernel D")


@pytest.mark.cuda
@pytest.mark.parametrize("stop_mode", ["group", "frame"])
@pytest.mark.parametrize("codewords", [False, True])
@pytest.mark.parametrize("method,offset", [(2, None), (5, None), (2, 8)])
def test_fused_prologue_equals_a_then_b(cuda, stop_mode, codewords, method, offset):
    """Kernel F's prologue writes en in lanes: its five counters equal
    kernel A then kernel B's on the same stream, frame by frame, with
    the all-zero word and with real codewords, in both widths."""
    code = load_code("50gpon")
    fields = {} if offset is None else {"oms_offset": offset}
    dcfg, tables, params, _ = _setup(code, method, stop_mode, BATCH, 3.8, cuda, **fields)
    cw = None
    if codewords:
        bits = philox.message_bits(SEED, 4, 0, BATCH, code.n_info, cuda)
        cw = make_encode_fn(code, cuda)(bits).to(torch.int8).contiguous()
    got = cs.fused_sim(params, tables, seed=SEED, rnd=4, batch=BATCH, mod_type=2,
                       quant_bits=4, cw=cw)
    llr, mod_bits, mod_syms = cc.quantile_channel(
        params, seed=SEED, rnd=4, batch=BATCH, n_var=code.n_var, n_info=code.n_info,
        mod_type=2, quant_bits=4, cw=cw)
    want = (*cd.stats_decode(llr, tables, cw), mod_bits, mod_syms)
    _assert_equal([got[k] for k in cs.COUNTERS], want, "kernel F against A then B")
