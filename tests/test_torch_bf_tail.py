"""The decoder template's BF tail (faid_tpu_torch/csrc/decoder.cuh
``bf_tail``) on the card: kernels B, D and F against their plain twins
where the tail does the work (50G-PON at 3.6 dB, batch 2048, tails up to
the round cap), for static BF, DTBF and 2B1C-DTBF, both stop modes, 4- and
8-bit messages; and the 2B1C rounds in which a frame only demotes reliable
bits, which keep its check map as it was.

The cases marked ``cuda`` need an NVIDIA GPU and skip without one; the
helper that finds the demote-only rounds is checked on the CPU too.  This
file imports no JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bf_tail.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from faid_tpu_torch import load_code, sigma_for
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, SimConfig
from faid_tpu_torch.decoders import bf as plain_bf
from faid_tpu_torch.decoders.core import build_plain_mp
from faid_tpu_torch.ops import cuda_channel as cc
from faid_tpu_torch.ops import cuda_decoder as cd
from faid_tpu_torch.ops import cuda_sim as cs
from faid_tpu_torch.ops import syndrome as syn

SEED = 2026101
BATCH = 2048

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decoder kernels run only on the card")
    return torch.device("cuda")


def _setup(code, method, stop_mode, batch, snr, device, offset=None):
    """The configuration, its tables and kernel A's LLRs (its plain twin
    on the CPU) of one round at ``snr``."""
    cfg = SimConfig(decode_method=DecodeMethod(method), max_iteration=6, mod_type=2,
                    quant_bits=4, scale=13.0, batch_per_device=batch, fake_encode=True,
                    channel_backend="fused", stop_mode=stop_mode, seed=SEED)
    dcfg = cfg.decoder()
    if offset is not None:
        dcfg = dataclasses.replace(dcfg, oms_offset=offset)
    params = cc.threshold_ints(cfg, sigma_for(cfg, snr)).to(device)
    llr = cc.quantile_channel(params, seed=SEED, rnd=1, batch=batch, n_var=code.n_var,
                              n_info=code.n_info, mod_type=2, quant_bits=4)[0]
    return dcfg, cd.decoder_tables(code, dcfg, device), params, llr


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{what}: output {i} differs from the twin"


# (method, stop mode, FAID offset): static BF (OMS_BF), DTBF (FAID_DTBF),
# 2B1C-DTBF (FAID_2B1C); an offset of 8 takes the 8-bit message width
CASES = ([(m, mode, None) for m in (3, 2, 5) for mode in ("group", "frame")]
         + [(m, mode, 8) for m in (2, 5) for mode in ("group", "frame")])


@pytest.mark.cuda
@pytest.mark.parametrize("method,stop_mode,offset", CASES)
def test_tail_kernels_match_their_twins(cuda, method, stop_mode, offset):
    """Kernels B and D, and F where it has the pair, equal their plain
    twins frame for frame at 3.6 dB, where frames run their tails to the
    round cap."""
    code = load_code("50gpon")
    dcfg, tables, params, llr = _setup(code, method, stop_mode, BATCH, 3.6, cuda, offset)
    assert tables.plan.msg_bits == (4 if offset is None else 8)
    want_b = cd.stats_decode_plain(llr, code, dcfg)
    _assert_equal(cd.stats_decode(llr, tables), want_b, "kernel B")
    _assert_equal(cd.full_decode(llr, tables), cd.full_decode_plain(llr, code, dcfg),
                  "kernel D")
    assert int(want_b[2].max()) == dcfg.bf.max_iter, "no frame ran its tail to the cap"
    if cd.kernel_ids(dcfg) in cd.SIM_PAIRS:
        # kernel F: kernel A's channel on the same stream, then the decoder
        got = cs.fused_sim(params, tables, seed=SEED, rnd=1, batch=BATCH, mod_type=2,
                           quant_bits=4)
        _assert_equal([got[k] for k in ("err_bits", "mp_iters", "bf_rounds")], want_b,
                      "kernel F")


def demote_only_rounds(en: torch.Tensor, code, bfc, group: bool):
    """The plain 2B1C-DTBF machine (decoders/bf.py ``run_dtbf``) on the
    post-MP ``en`` [batch, C, Z], round by round: (per frame the rounds
    before its last in which it demoted a reliable bit and flipped none,
    the final decisions, the rounds), the counts [batch] int32.  A kernel
    that toggled the check map on a demote would read other votes in the
    round after such a round."""
    hard = hard_ch = syn.hard_decision(en)
    thr = bfc.reliability_threshold
    hard2 = (en >= thr) | (en <= -thr)
    eligible = torch.as_tensor(code.vn_weight_blocks_np == bfc.gamma, device=en.device)[None]
    batch = en.shape[0]
    i32 = dict(dtype=torch.int32, device=en.device)
    th = torch.full((batch,), bfc.gamma, **i32)
    l0 = torch.zeros(batch, **i32)
    l1 = torch.zeros(batch, **i32)
    t = torch.ones(batch, dtype=torch.bool, device=en.device)
    found = torch.zeros(batch, **i32)
    rounds = torch.zeros(batch, **i32)
    pending = torch.zeros(batch, dtype=torch.bool, device=en.device)
    for _ in range(bfc.max_iter):
        count = syn.error_count(syn.unsat_checks(hard, code))
        if not bool((count > 0).any()):
            break
        dirty = plain_bf.group_any(count > 0) if group else count > 0
        # a demote-only round counts once the frame runs another round
        found += (pending & dirty).to(torch.int32)
        votes = syn.flip_votes(syn.unsat_checks(hard, code), code)
        th2, l0n, l1n = plain_bf._dtbf_threshold(th, l0, l1, t, bfc)
        score = votes + bfc.alpha * (hard ^ hard_ch).to(torch.int32)
        flip = eligible & (score >= th2[:, None, None]) & dirty[:, None, None]
        big = (th2 >= bfc.gamma)[:, None, None]
        xor3 = big & flip
        small = ~big & flip
        changed = xor3 | (small & ~hard2)
        demoted = small & hard2
        pending = dirty & demoted.any(dim=(1, 2)) & ~changed.any(dim=(1, 2))
        hard, hard2 = hard ^ xor3, hard2 ^ xor3
        hard = hard ^ (small & ~hard2)
        hard2 = hard2 ^ (small & hard2)
        th = torch.where(dirty, th2, th)
        l0 = torch.where(dirty, l0n, l0)
        l1 = torch.where(dirty, l1n, l1)
        t = torch.where(dirty, flip.any(dim=(1, 2)), t)
        rounds += dirty.to(torch.int32)
    return found, hard, rounds


@pytest.mark.parametrize("stop_mode", ["group", "frame"])
def test_demote_only_rounds_helper(stop_mode):
    """The stepped machine ends where run_dtbf ends (the same decisions
    after the same rounds), and the toy code's waterfall has demote-only
    rounds for it to find."""
    toy = toy_code()
    dcfg, _, _, llr = _setup(toy, 5, stop_mode, 256, 2.0, "cpu")
    en, _ = build_plain_mp(toy, dcfg)(llr)
    found, hard, rounds = demote_only_rounds(en, toy, dcfg.bf, stop_mode == "group")
    assert int((found > 0).sum()) > 0
    want_hard, want_rounds = plain_bf.run_dtbf(
        syn.hard_decision(en), toy, dcfg.bf, group=stop_mode == "group", two_bit=True, llr=en)
    assert torch.equal(hard, want_hard) and torch.equal(rounds, want_rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("code_name,stop_mode,snr", [
    ("toy", "group", 2.0), ("toy", "frame", 2.0), ("50gpon", "group", 3.6)])
def test_demote_only_rounds_keep_the_map(cuda, code_name, stop_mode, snr):
    """Frames whose 2B1C tail has a round that only demotes, then runs on:
    kernels B and D decide them as the plain twin does, round for round.
    (On 50G-PON such rounds come only in group mode, where a clean frame of
    a dirty word can demote; the toy code has them in both modes.)"""
    code = toy_code() if code_name == "toy" else load_code("50gpon")
    dcfg, tables, _, llr = _setup(code, 5, stop_mode, BATCH, snr, cuda)
    en, _ = build_plain_mp(code, dcfg)(llr)
    found = demote_only_rounds(en, code, dcfg.bf, stop_mode == "group")[0] > 0
    assert int(found.sum()) > 0, "no frame has a demote-only round"
    want_b = cd.stats_decode_plain(llr, code, dcfg)
    want_d = cd.full_decode_plain(llr, code, dcfg)
    got_b, got_d = cd.stats_decode(llr, tables), cd.full_decode(llr, tables)
    _assert_equal([g[found] for g in got_b], [w[found] for w in want_b], "kernel B")
    _assert_equal([g[found] for g in got_d], [w[found] for w in want_d], "kernel D")
