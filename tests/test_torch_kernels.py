"""The port's one launch seam (faid_tpu_torch/utils/kernels.py): every
kernel wrapper asks ``kernel_device`` where to run, takes its plain twin
on the CPU and launches through ``launch``, which counts each launch
under the kernel's letter in ``kernels.launches``.

On the CPU each wrapper (kernels A-G and the message stream M, on the toy
code) returns its plain twin's output and counts nothing.  The case
marked ``cuda`` needs an NVIDIA GPU and skips without one: there each
wrapper's call adds exactly one to its own letter, and ``launch_info``'s
occupancy query adds none.  This file imports no JAX, so on the card it
runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from faid_tpu_torch import sigma_for
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, DecoderConfig, SimConfig
from faid_tpu_torch.ops import cuda_channel as cc
from faid_tpu_torch.ops import cuda_decoder as cd
from faid_tpu_torch.ops import cuda_sim as cs
from faid_tpu_torch.ops import philox, qam_plan
from faid_tpu_torch.utils import kernels

SEED, RND, BATCH = 2026181, 3, 64
LETTERS = "ABCDEFGM"

torch.set_num_threads(1)


def _cases(device) -> dict:
    """By kernel letter: (the wrapper's call on ``device``, its plain
    twin's call on the CPU), every input made beforehand so that a call
    launches nothing but its own kernel."""
    code = toy_code()
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, mod_type=2, quant_bits=4,
                    scale=13.0, batch_per_device=BATCH, channel_backend="fused",
                    seed=SEED)
    params = cc.threshold_ints(cfg, sigma_for(cfg, 2.0))
    ch = dict(seed=SEED, rnd=RND, batch=BATCH, n_var=code.n_var, quant_bits=4)
    stats = dict(n_info=code.n_info, mod_type=2)
    llr = cc.quantile_channel_map_plain(params, **ch)[0]
    dtbf, oms = cfg.decoder(), DecoderConfig.for_method(DecodeMethod.OMS)
    q16 = dataclasses.replace(cfg, mod_type=4, interleave_depth=2)
    qparams = qam_plan.plan_threshold_ints(q16, sigma_for(q16, 9.0))
    qkw = dict(seed=SEED, rnd=RND, batch=BATCH, n_var=code.n_var, mod_type=4,
               depth=2, quant_bits=4, scale=13.0)
    sim = dict(seed=SEED, rnd=RND, batch=BATCH, mod_type=2, quant_bits=4)

    p_dev, llr_dev = params.to(device), llr.to(device)
    t_dtbf, t_oms = (cd.decoder_tables(code, d, device) for d in (dtbf, oms))
    q_tables = cc.qam_tables(qparams.to(device), 4, 4, 13.0)
    return {
        "A": (lambda: cc.quantile_channel(p_dev, **ch, **stats),
              lambda: cc.quantile_channel_plain(params, **ch, **stats)),
        "B": (lambda: cd.stats_decode(llr_dev, t_dtbf),
              lambda: cd.stats_decode_plain(llr, code, dtbf)),
        "C": (lambda: cc.quantile_channel_map(p_dev, **ch),
              lambda: cc.quantile_channel_map_plain(params, **ch)),
        "D": (lambda: cd.full_decode(llr_dev, t_dtbf),
              lambda: cd.full_decode_plain(llr, code, dtbf)),
        "E": (lambda: cd.mp_decode(llr_dev, t_oms),
              lambda: cd.mp_decode_plain(llr, code, oms)),
        "F": (lambda: cs.fused_sim(p_dev, t_dtbf, **sim),
              lambda: cs.fused_sim_plain(params, code, dtbf, **sim)),
        "G": (lambda: cc.quantile_channel_qam(q_tables, **qkw),
              lambda: cc.quantile_channel_qam_plain(qparams, **qkw)),
        "M": (lambda: philox.message_bits(SEED, RND, 0, BATCH, code.n_info, device),
              lambda: philox.message_bits_plain(SEED, RND, 0, BATCH, code.n_info,
                                                "cpu")),
    }


def _tensors(out) -> list:
    values = out.values() if isinstance(out, dict) else out
    if isinstance(values, torch.Tensor):
        return [values.cpu()]
    return [t.cpu() for t in values]


def _assert_equal(got, want, letter):
    got, want = _tensors(got), _tensors(want)
    assert len(got) == len(want), letter
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{letter}: output {i} differs from the plain twin"


@pytest.mark.parametrize("letter", LETTERS)
def test_cpu_call_takes_the_plain_twin(letter):
    call, plain = _cases("cpu")[letter]
    before = kernels.launches.copy()
    got = call()
    assert kernels.launches == before
    _assert_equal(got, plain(), letter)


def test_kernel_device_of_a_cpu_tensor():
    t = torch.zeros(2)
    assert kernels.kernel_device(t) is None
    assert kernels.kernel_device(t, torch.zeros(3), torch.device("cpu")) is None
    assert kernels.kernel_device("cpu") is None


def test_kernel_device_refuses_a_meta_tensor():
    with pytest.raises(ValueError, match="device meta"):
        kernels.kernel_device(torch.zeros(2, device="meta"))


def test_kernel_device_refuses_operands_on_two_devices():
    with pytest.raises(ValueError, match="on cpu and on meta"):
        kernels.kernel_device(torch.zeros(2), torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="on cpu and on meta"):
        kernels.kernel_device(torch.zeros(2), torch.device("meta"))


def test_every_entry_point_has_a_letter():
    """Each kernel entry of the library counts under one letter of its
    own; the error-string query is no kernel."""
    assert set(kernels.KERNEL_LETTERS) == set(kernels._SIGNATURES) - {"faid_error_string"}
    assert sorted(kernels.KERNEL_LETTERS.values()) == list(LETTERS)


@pytest.mark.cuda
def test_each_launch_counts_once_under_its_letter():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels launch only on the card")
    cases = _cases(torch.device("cuda"))
    for letter, (call, plain) in cases.items():
        before = kernels.launches.copy()
        got = call()
        torch.cuda.synchronize()
        assert {k: kernels.launches[k] - before[k] for k in LETTERS} == \
            {k: int(k == letter) for k in LETTERS}, letter
        _assert_equal(got, plain(), letter)
    code = toy_code()
    for kernel, method in (("B", 2), ("D", 2), ("E", 1), ("F", 2)):
        tables = cd.decoder_tables(code, DecoderConfig.for_method(DecodeMethod(method)),
                                   "cuda")
        before = kernels.launches.copy()
        info = cd.launch_info(kernel, tables, BATCH)
        assert kernels.launches == before, kernel
        assert info["active"] > 0 and info["frames"] == tables.plan.frames, kernel
