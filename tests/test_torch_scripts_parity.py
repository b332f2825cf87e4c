"""PyTorch port, the decoder scripts and the op model on the CPU
(faid_tpu_torch/scripts/backend_parity.py, bench_decoder.py,
roofline.py): their inputs against the JAX scripts', the port's plain
decoder on them against faid_tpu's xla decoder, their refusal of the
CPU, and the op model's counts worked by hand on the toy code."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_jax import unoptimized_jax_compiles  # noqa: F401

from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import DecodeMethod as JDecodeMethod
from faid_tpu.config import DecoderConfig as JDecoderConfig
from faid_tpu.decoders.core import build_decoder as jbuild_decoder
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import BFConfig, DecodeMethod, DecoderConfig, SimConfig
from faid_tpu_torch.decoders.core import build_decoder
from faid_tpu_torch.ops import cuda_decoder as cd
from faid_tpu_torch.scripts import backend_parity, bench_decoder, roofline

torch.set_num_threads(1)


def _jax_inputs(seed, words, batch, n_var):
    """scripts/backend_parity.py's inputs, as written there."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(words):
        snr = [3.3, 3.7, 4.1][w % 3]
        sigma = 1.0 / np.sqrt(0.8444444 * 2 * 10 ** (snr / 10))
        y = -1.0 + sigma * rng.standard_normal((batch, n_var))
        out.append(np.clip(np.round(y * 13.0), -7, 7).astype(np.int8))
    return out


@pytest.mark.parametrize("seed,batch,n_var", [(20260817, 128, 17664), (7, 32, 96)])
def test_backend_parity_inputs_are_the_jax_scripts(seed, batch, n_var):
    rng = np.random.default_rng(seed)
    got = [backend_parity.inputs(rng, w, batch, n_var) for w in range(4)]
    for a, b in zip(got, _jax_inputs(seed, 4, batch, n_var)):
        assert a.dtype == np.int8 and np.array_equal(a, b)


def test_bench_decoder_inputs_are_the_jax_scripts():
    sigma = SimConfig().sigma_at(4.0)
    rng = np.random.default_rng(0)
    for x in bench_decoder.bench_inputs(32, 96, sigma, 3):
        y = -1.0 + sigma * rng.standard_normal((32, 96))
        assert np.array_equal(x, np.clip(np.trunc(y * 13.0), -7, 7).astype(np.int8))


@pytest.mark.parametrize("method", range(6))
def test_plain_decoder_on_the_inputs_equals_jax_xla(method):
    """On the toy code, the port's plain decoder (the twin backend_parity
    holds the kernels to) equals faid_tpu's xla decoder on the script's
    inputs: hard bits, mp_iters, bf_rounds."""
    dcfg = backend_parity.method_config(method)
    jd = JDecoderConfig.for_method(JDecodeMethod(method), max_iter=6,
                                   factor_1=dcfg.factor_1, factor_2=dcfg.factor_2)
    jdec = jax.jit(jbuild_decoder(jtoy_code(), jd, backend="xla"))
    tdec = build_decoder(toy_code(), dcfg, backend="plain")
    rng = np.random.default_rng(backend_parity.build_argparser().parse_args([]).seed)
    for w in range(3):
        llr = backend_parity.inputs(rng, w, 32, 96)
        want = jdec(llr)
        got = tdec(torch.from_numpy(llr))
        for k in backend_parity.KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("module", [backend_parity, bench_decoder, roofline])
def test_measurements_refuse_the_cpu(module):
    with pytest.raises(SystemExit) as e:
        module.main(["--device", "cpu"])
    assert "CUDA --device" in str(e.value)


def test_backend_parity_refuses_the_cpu_before_any_decode():
    with pytest.raises(SystemExit):
        backend_parity.run_parity(toy_code(), "cpu", 32, 1, [2], 0)


def test_bound():
    # 3.35e9 bytes take 1 ms at 3.35 TB/s; 16.727e9 int32 ops 1 ms
    assert roofline.bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert roofline.bound(0, 64 * 132 * 1.98e9 * 1e-3) == (pytest.approx(1.0),
                                                           "operations")
    assert roofline.bound(3.35e9, 2 * 64 * 132 * 1.98e9 * 1e-3)[1] == "operations"
    # the encoder's int8 product against the tensor cores' peak
    assert roofline.bound(0, 1979e12 * 1e-3, roofline.PEAK_INT8_OPS_PER_S)[0] == \
        pytest.approx(1.0)
    # 2 frames of 96 bits, 4-bit quantizer (L = 7): 20 + 28 + 6 a bit, the
    # key schedule once
    assert roofline.channel_ops(2, 96, 7) == 192 * 54 + 18


def _counts(*pairs):
    mp, bf = zip(*pairs)
    return (torch.tensor(mp, dtype=torch.int32), torch.tensor(bf, dtype=torch.int32))


def test_decoder_ops_by_hand_on_the_toy_code():
    """The toy code: Z 8, 4 block rows of degree 6 (24 entries: 192
    edges), 96 VNs, 32 checks; block columns 3 and 4 have weight 3 (the
    DTBF vote: 16 bits)."""
    code = toy_code()
    assert (int(code.degrees_np.sum()) * code.z, code.n_var, code.n_chk) == (192, 96, 32)

    # FAID_DTBF: 20 ops an edge, 4 a check; a sweep an iteration and the
    # one that finds the word clean; where MP ran out (6), the tail's
    # hard decisions (96), its sweeps (rounds + the clean one, 192 each)
    # and its rounds (16 vote bits x (3 + 4))
    t = cd.decoder_tables(code, DecoderConfig.for_method(DecodeMethod.FAID_DTBF), "cpu")
    assert t.vote_col.tolist() == [3, 4]
    per_mp, per_sweep = 192 * 20 + 32 * 4, 192 + 96
    frame0 = 2 * per_mp + 3 * per_sweep                       # converged at 2
    frame1 = 6 * per_mp + 6 * per_sweep + 96 + 4 * 192 + 3 * 16 * 7   # 3 BF rounds
    assert roofline.decoder_ops(code, t, *_counts((2, 0), (6, 3))) == frame0 + frame1
    assert frame0 + frame1 == 8800 + 26736

    # NMS: no early stop, no tail: 17 an edge, 6 a check
    t = cd.decoder_tables(code, DecoderConfig.for_method(DecodeMethod.NMS), "cpu")
    assert roofline.decoder_ops(code, t, *_counts((6, 0), (6, 0))) == \
        2 * 6 * (192 * 17 + 32 * 6)

    # a fixed-iteration FAID decode (the roofline's level 1): no sweep
    fixed = dataclasses.replace(DecoderConfig.for_method(DecodeMethod.FAID_DTBF),
                                stop_early=False, bf=BFConfig())
    t = cd.decoder_tables(code, fixed, "cpu")
    assert roofline.decoder_ops(code, t, *_counts((6, 0))) == 6 * per_mp

    # selective OMS keeps the map (an add a check a sweep), static BF votes
    # every column (its 24 entries x Z) and then 3 ops a VN a round
    t = cd.decoder_tables(code, DecoderConfig.for_method(DecodeMethod.OMS_BF), "cpu")
    per_mp_oms = 192 * 18 + 32 * 22
    want = (6 * per_mp_oms + 6 * (192 + 96 + 32) + 96 + 2 * 192
            + 1 * (24 * 8 + 3 * 96))
    assert roofline.decoder_ops(code, t, *_counts((6, 1))) == want
    assert roofline.style_key(t.dcfg) == "oms_selective"


def test_roofline_stages_on_the_toy_code():
    """measure() on the toy code with the card's clocks replaced by fakes:
    every stage of the round runs (the kernels' plain twins here), with
    its bytes and operations counted from this run's inputs, its bound and
    its share of the (fake) time; and the three levels."""
    calls = []

    def fake_ms(fn, reps):
        fn()
        calls.append(reps)
        return 2.0

    res = roofline.measure(toy_code(), "cpu", batch=64, reps=3, time_ms=fake_ms,
                           profile=lambda *a: {"idle_share": None}, card="cpu")
    stages = res["stages"]
    assert tuple(stages) == ("message stream", "encoder", "noise", "modem",
                             "quantizer", "A", "C", "G", "B", "E", "F")
    for name, s in stages.items():
        want = roofline.bound(s["bytes"], s["ops"],
                              roofline.PEAK_INT8_OPS_PER_S if name == "encoder"
                              else roofline.PEAK_INT32_OPS_PER_S)
        assert (s["bound_ms"], s["bound_by"]) == want
        assert s["share"] == s["bound_ms"] / 2.0 and s["card"] == "cpu"
        assert s["kernel_launches"] == {}          # no kernel on the CPU
    # 64 frames of the toy code: F moves its five counters, A its LLRs and
    # two counts; E decodes every frame 6 fixed iterations (no sweep)
    assert stages["F"]["bytes"] == 5 * 4 * 64
    assert stages["A"]["bytes"] == 64 * 96 + 2 * 4 * 64
    assert stages["A"]["ops"] == roofline.channel_ops(64, 96, 7)
    assert stages["E"]["ops"] == 64 * 6 * (192 * 20 + 32 * 4)
    assert stages["F"]["ops"] == stages["A"]["ops"] + stages["B"]["ops"]
    lv = res["levels"]
    assert lv["fixed"]["mp_iters_per_s"] == 64 * 6 / 2e-3
    assert lv["early_stop"]["speedup_vs_fixed"] == 1.0
    assert set(lv["pipeline"]) >= {"round_ms", "kernel_f_ms", "a_then_b_ms"}
    assert all(r == 3 for r in calls)
