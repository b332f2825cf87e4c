"""PyTorch port, the Monte-Carlo round with real codewords and in frame
stop mode (faid_tpu_torch/ops/cuda_sim.py, sim/pipeline.py) against
faid_tpu on the toy code: kernel F's plain twin against the port's emit
LLRs pushed through the JAX stats kernel in interpret mode
(make_stats_decoder, both stop modes, the codeword as its reference)
and reduce_mod_stats; supports_sim against pallas_decoder.supports_sim;
the round's counters and its replay; the CLI without --fake-encode."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code.encoder import make_encode_fn as jmake_encode
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import SimConfig as JSimConfig
from faid_tpu.decoders.core import build_stats_decoder as jbuild_stats
from faid_tpu.ops import pallas_channel as pc
from faid_tpu.ops import pallas_decoder as pk
from faid_tpu.sim.pipeline import _histogram as jhistogram
from faid_tpu_torch import build_debug_step, build_sim_loop, build_sim_step, cli, sigma_for
from faid_tpu_torch.code.encoder import make_encode_fn
from faid_tpu_torch.code.qc_matrix import load_code
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import SimConfig
from faid_tpu_torch.ops import cuda_channel, cuda_decoder, cuda_sim, philox
from faid_tpu_torch.sim import pipeline, runner

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _cfg(cls, **kw):
    base = dict(decode_method=2, max_iteration=6, mod_type=2, quant_bits=4,
                batch_per_device=64, fake_encode=False, channel_backend="fused",
                stop_mode="frame", seed=7)
    base.update(kw)
    return cls(**base)


# (method, stop mode, fake encode, mod type, quantizer bits): each value
# of each axis at least once, NMS at its own factors 26/32
CASES = [
    (2, "group", True, 2, 4), (2, "frame", False, 2, 4),
    (4, "frame", True, 1, 3), (4, "group", False, 2, 6),
    (5, "frame", False, 1, 6), (5, "group", True, 2, 3),
    (0, "frame", False, 2, 4), (0, "group", True, 1, 4),
]


@pytest.mark.parametrize("method,stop_mode,fake,mod_type,quant_bits", CASES)
def test_fused_sim_twin_vs_pallas_interpret(method, stop_mode, fake, mod_type,
                                            quant_bits):
    """Kernel F's twin (build_fused_sim on the CPU) against the JAX
    composition of the same frames: the port's emit LLRs through
    make_stats_decoder(interpret=True) with the codeword's info bits as
    its reference (none for the all-zero word), and emit's ModCalErr map
    through reduce_mod_stats.  Toy code, batch 64, 1.0 dB."""
    jcode = jtoy_code()
    code = toy_code()
    kw = dict(decode_method=method, stop_mode=stop_mode, fake_encode=fake,
              mod_type=mod_type, quant_bits=quant_bits)
    if method == 0:
        kw.update(factor_1=26, factor_2=32)
    cfg, jcfg = _cfg(SimConfig, **kw), _cfg(JSimConfig, **kw)
    sigma = sigma_for(cfg, 1.0)
    cw = None
    if not fake:
        u = philox.message_bits(3, 9, 0, 64, code.n_info, "cpu")
        cw = make_encode_fn(code, "cpu")(u)
    got = cuda_sim.build_fused_sim(code, cfg, "cpu")(cw, 3, 9, sigma)
    llr, mod_err = cuda_sim.build_fused_sim_emit(code, cfg, "cpu")(cw, 3, 9, sigma)
    ref = None if fake else jnp.asarray(cw[:, :code.n_info].numpy())
    want = jax.jit(jbuild_stats(jcode, jcfg.decoder(), backend="pallas",
                                interpret=True))(jnp.asarray(llr.numpy()), ref)
    mb, ms = pc.reduce_mod_stats(jnp.asarray(mod_err.numpy()), code.n_info,
                                 mod_type)
    want = {**{k: np.asarray(v) for k, v in want.items()},
            "mod_error_bits": np.asarray(mb), "mod_error_symbols": np.asarray(ms)}
    for k in cuda_sim.COUNTERS:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert (got["err_bits"] > 0).any() and (got["mod_error_bits"] > 0).any()
    if method != 0:
        # group mode stops whole 32-frame words, frame mode single frames
        words = got["mp_iters"].view(-1, 32)
        spread = bool((words.amax(dim=1) != words.amin(dim=1)).any())
        assert spread == (stop_mode == "frame")


SIM_CONFIGS = [
    dict(), dict(mod_type=1), dict(mod_type=4), dict(quant_bits=1),
    dict(quant_bits=6), dict(batch_per_device=48), dict(stop_mode="group"),
    dict(decode_method=5, fake_encode=True),
]


@pytest.mark.parametrize("kw", SIM_CONFIGS)
def test_supports_sim_matches_jax(kw):
    for jcode in (jtoy_code(), jtoy_code(z=9, n_block_cols=12, n_block_rows=4)):
        code = toy_code(z=jcode.z, n_block_cols=jcode.n_block_cols,
                        n_block_rows=jcode.n_block_rows)
        assert cuda_sim.supports_sim(code, _cfg(SimConfig, **kw)) == \
            pk.supports_sim(jcode, _cfg(JSimConfig, **kw))


def _jax_round(jcode, jcfg, ix, cw, params):
    """The JAX composition of one round with codewords ``cw`` on the words
    ``ix``: staircase mirrored by the codeword, reduce_mod_stats,
    build_stats_decoder(xla) against the codeword's info bits."""
    n_info = jcode.n_info
    mask = -(jnp.asarray(cw) != 0).astype(jnp.int32)
    llr, err = pc.staircase(jnp.asarray(ix), mask, jnp.asarray(params),
                            jcfg.quant_bits)
    mb, ms = pc.reduce_mod_stats(err, n_info, jcfg.mod_type)
    out = jbuild_stats(jcode, jcfg.decoder(), backend="xla")(
        llr, jnp.asarray(cw[:, :n_info]))
    err_bits = np.asarray(out["err_bits"])
    mb, ms = np.asarray(mb), np.asarray(ms)
    frame_err = err_bits > 0
    dcfg = jcfg.decoder()
    return {
        "test_frames": ix.shape[0], "error_bits": int(err_bits.sum()),
        "error_frames": int(frame_err.sum()),
        "lt3_frames": int((frame_err & (err_bits < 3)).sum()),
        "mod_error_bits": int(mb.sum()), "mod_error_symbols": int(ms.sum()),
        "mod_error_frames": int((mb > 0).sum()),
        "mp_iters": int(np.asarray(out["mp_iters"]).sum()),
        "bf_rounds": int(np.asarray(out["bf_rounds"]).sum()),
        "mp_hist": np.asarray(jhistogram(out["mp_iters"], dcfg.max_iter + 1)).tolist(),
        "bf_hist": np.asarray(jhistogram(out["bf_rounds"],
                                         dcfg.bf.max_iter + 1)).tolist(),
    }


@pytest.mark.parametrize("stop_mode", ["group", "frame"])
def test_step_with_codewords_matches_jax_composition(monkeypatch, rng, stop_mode):
    """build_sim_step on the CPU with real codewords, counter for counter,
    against the JAX composition: the JAX encoder on the port's message
    bits, the channel's words injected into both."""
    jcode = jtoy_code()
    code = toy_code()
    cfg = _cfg(SimConfig, stop_mode=stop_mode)
    jcfg = _cfg(JSimConfig, stop_mode=stop_mode)
    words = rng.integers(-2**31, 2**31, (64, code.n_var), dtype=np.int64).astype(np.int32)

    def fake_words(seed, rnd, frame0, batch, n_bits, device):
        assert (frame0, batch, n_bits) == (0, 64, code.n_var)
        return torch.from_numpy(words).to(device)

    monkeypatch.setattr(philox, "channel_words", fake_words)
    sigma = sigma_for(cfg, 1.5)
    got = {k: v.tolist() for k, v in build_sim_step(code, cfg, "cpu")(4, 2, sigma).items()}
    u = philox.message_bits(4, 2, 0, 64, code.n_info, "cpu").numpy()
    cw = np.asarray(jmake_encode(jcode)(jnp.asarray(u)))
    params = cuda_channel.threshold_ints(cfg, sigma).numpy()
    want = _jax_round(jcode, jcfg, words, cw, params)
    assert got == want
    assert got["error_frames"] > 0 and got["bf_rounds"] > 0
    # the composed path (kernels A then B on a card) counts the same
    composed = build_sim_step(code, cfg, "cpu", fuse=False)(4, 2, sigma)
    assert {k: v.tolist() for k, v in composed.items()} == got


def test_debug_step_with_codewords():
    """The replay's codewords are the encoder's of the regenerated message
    bits, its LLRs are the channel's for those codewords, and its error
    bits sum to the step's."""
    code = toy_code()
    for stop_mode in ("group", "frame"):
        cfg = _cfg(SimConfig, stop_mode=stop_mode)
        sigma = sigma_for(cfg, 1.5)
        sr = philox.stream_round(2, 5)
        a = build_sim_step(code, cfg, "cpu")(11, sr, sigma)
        b = build_debug_step(code, cfg, "cpu")(11, sr, sigma)
        u = philox.message_bits(11, sr, 0, 64, code.n_info, "cpu")
        cw = make_encode_fn(code, "cpu")(u)
        assert torch.equal(b["cw"], cw) and cw.any()
        llr, _, _ = cuda_channel.quantile_channel(
            cuda_channel.threshold_ints(cfg, sigma), seed=11, rnd=sr, batch=64,
            n_var=code.n_var, n_info=code.n_info, mod_type=2, quant_bits=4, cw=cw)
        assert torch.equal(b["llr"], llr)
        assert int(a["error_bits"]) == int(b["err_bits"].sum()) > 0
        assert int(a["error_frames"]) == int((b["err_bits"] > 0).sum())
        np.testing.assert_array_equal(
            b["err_bits"].numpy(),
            (b["hard"][:, :code.n_info] != cw[:, :code.n_info].bool()).sum(1).numpy())


def test_cpu_rounds_launch_no_kernel():
    """On the CPU every kernel's wrapper takes its plain twin: the round,
    its replay and the composed path launch nothing."""
    wrappers = (cuda_sim.fused_sim, cuda_sim.fused_sim_emit,
                cuda_channel.quantile_channel, cuda_channel.quantile_channel_map,
                cuda_decoder.stats_decode, cuda_decoder.full_decode,
                cuda_decoder.mp_decode)
    for w in wrappers:
        w.launches = 0
    code = toy_code()
    cfg = _cfg(SimConfig, batch_per_device=32)
    build_sim_loop(code, cfg, 2, "cpu")(0, sigma_for(cfg, 2.0), 0)
    build_sim_loop(code, cfg, 1, "cpu", fuse=False)(0, sigma_for(cfg, 2.0), 0)
    build_debug_step(code, cfg, "cpu")(0, 0, sigma_for(cfg, 2.0))
    assert [w.launches for w in wrappers] == [0] * len(wrappers)
    # the replay of a fused round goes through emit, as on the card
    assert pipeline._fuses(code, cfg)
    assert not pipeline._fuses(code, dataclasses.replace(cfg, backend="plain"))


def test_fused_sim_refuses_bad_arguments():
    code = toy_code()
    cfg = _cfg(SimConfig)
    with pytest.raises(ValueError):
        cuda_sim.build_fused_sim(code, dataclasses.replace(cfg, batch_per_device=48),
                                 "cpu")
    sim = cuda_sim.build_fused_sim(code, cfg, "cpu")
    with pytest.raises(ValueError):      # real codewords need cw
        sim(None, 0, 0, 1.0)
    fake = cuda_sim.build_fused_sim(code, dataclasses.replace(cfg, fake_encode=True),
                                    "cpu")
    with pytest.raises(ValueError):
        fake(torch.zeros((64, code.n_var), dtype=torch.int8), 0, 0, 1.0)
    t = cuda_decoder.decoder_tables(code, cfg.decoder(), "cpu")
    with pytest.raises(ValueError):      # the reference word's shape
        cuda_decoder.stats_decode(torch.zeros((64, code.n_var), dtype=torch.int8), t,
                                  torch.zeros((64, code.n_info - 1), dtype=torch.int8))


def test_cli_with_codewords_on_cpu(tmp_path, monkeypatch):
    """The campaign command without --fake-encode, in frame stop mode, on
    the toy code: it writes the tables, dumps failing frames whose error
    positions are the replay's against the encoder's codewords, and
    resumes from its checkpoint."""
    monkeypatch.setattr(runner, "load_code", lambda name: toy_code())
    out = tmp_path / "out"
    args = ["--method", "2", "--channel-backend", "fused", "--stop-mode", "frame",
            "--batch", "32", "--snr-start", "2", "--snr-pass", "1", "--snr-end",
            "2.5", "--min-frames", "64", "--max-rounds", "2", "--collect-errors",
            "--seed", "5", "--quiet", "--device", "cpu", "--out", str(out)]
    assert cli.main(args) == 0
    st = json.loads((out / "checkpoint.json").read_text())
    assert st["stream"] == philox.STREAM_TAG
    counters = st["results"][0]["counters"]
    # one sync of rounds_per_sync (8) rounds of 32 frames
    assert counters["test_frames"] == 256 and counters["error_frames"] > 0
    line = (out / "errorindex.txt").read_text().splitlines()[0]
    tag, positions = line.split(" : ")
    words = tag.split()
    rnd, frame = int(words[5]), int(words[7])
    code = toy_code()
    cfg = _cfg(SimConfig, batch_per_device=32, seed=5)
    dbg = build_debug_step(code, cfg, "cpu")(5, philox.stream_round(0, rnd),
                                              cfg.sigma_at(2.0))
    bad = np.nonzero(dbg["hard"][frame, :code.n_info].numpy()
                     != dbg["cw"][frame, :code.n_info].numpy().astype(bool))[0]
    assert positions == " ".join(f"b{p // code.z + 1}+{p % code.z}" for p in bad)
    assert dbg["cw"].any()
    before = (out / "Result.txt").read_bytes()
    assert cli.main(args) == 0
    assert (out / "Result.txt").read_bytes() == before


def test_full_code_round_with_codewords_on_cpu():
    """One 32-frame word of the 50G-PON code with real codewords at a high
    SNR: the encoder's codewords go through the fused round's twin
    cleanly, and the channel saw them (ModCalErr counts stay those of
    the noise, not of the codeword's ones)."""
    code = load_code("50gpon")
    cfg = _cfg(SimConfig, batch_per_device=32, stop_mode="group")
    out = build_sim_step(code, cfg, "cpu")(1, 0, sigma_for(cfg, 6.0))
    assert int(out["error_frames"]) == 0
    assert 0 < int(out["mod_error_bits"]) < 32 * code.n_info // 100
