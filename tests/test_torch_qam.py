"""PyTorch port, the 16/64/256-QAM quantile channel and the float-chain
slice (faid_tpu_torch/ops/qam_plan.py, ops/cuda_channel.py
``quantile_channel_qam`` -- kernel G's plain twin -- and the xla / QAM
branches of sim/pipeline.py) against faid_tpu on the CPU."""

from __future__ import annotations

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu.config import SimConfig as JSimConfig
from faid_tpu.decoders.core import build_stats_decoder as jbuild_stats
from faid_tpu.ops import modem as jmodem
from faid_tpu.ops import pallas_channel as pc
from faid_tpu.sim import runner as jrunner
from faid_tpu.sim.pipeline import build_sim_step as jbuild_sim_step
from faid_tpu_torch import MonteCarloRunner, build_debug_step, build_sim_step, cli
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, DecoderConfig, SimConfig
from faid_tpu_torch.ops import cuda_channel as cc
from faid_tpu_torch.ops import cuda_sim, philox, qam_plan
from faid_tpu_torch.sim import pipeline, runner
from faid_tpu_torch.utils import kernels

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _jax_params(cfg, sigma):
    return np.asarray(jax.jit(lambda s: pc._plan_threshold_ints(cfg, s))(
        jnp.float32(sigma)))


def _words(rng, shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("quant_bits", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("mod_type", [2, 4, 6, 8])
def test_plan_matches_jax(mod_type, quant_bits):
    """The plan (endpoints, every level's intervals and base) and the
    magnitudes equal the JAX package's, at two scales."""
    for scale in (13.0, 7.25):
        assert qam_plan._plan(mod_type, quant_bits, scale) == \
            pc._plan(mod_type, quant_bits, scale)
    np.testing.assert_array_equal(qam_plan._MAGNITUDES[mod_type],
                                  pc._MAGNITUDES[mod_type])


@pytest.mark.parametrize("mod_type", [4, 6, 8])
@pytest.mark.parametrize("quant_bits", [3, 4, 6])
@pytest.mark.parametrize("snr", [2.0, 9.0, 16.0])
def test_plan_thresholds_within_float32_error(mod_type, quant_bits, snr):
    """Both packages compute the plan's thresholds in float32; torch's and
    XLA's ndtr differ in the last bits.  The bound of
    test_torch_channel.py::test_thresholds_within_float32_error on each
    small-side grid count: max(256, 1e-5 * count)."""
    cfg = SimConfig(mod_type=mod_type, quant_bits=quant_bits)
    sigma = cfg.sigma_at(snr)
    want = _jax_params(JSimConfig(mod_type=mod_type, quant_bits=quant_bits),
                       sigma).astype(np.int64)
    got = qam_plan.plan_threshold_ints(cfg, sigma)
    assert got.dtype == torch.int32 and got.shape == want.shape
    got = got.numpy().astype(np.int64)
    small_g = np.minimum(2**31 - got, got + 2**31 + 1)
    small_w = np.minimum(2**31 - want, want + 2**31 + 1)
    bound = np.maximum(256, 1e-5 * np.maximum(small_g, small_w))
    assert (np.abs(small_g - small_w) <= bound).all(), got - want


@pytest.mark.parametrize("mod_type,quant_bits", [
    (2, 4), (4, 3), (4, 6), (6, 4), (6, 5), (8, 2), (8, 6)])
def test_staircase_qam_bit_exact(rng, mod_type, quant_bits):
    """Same rail words (some right on the thresholds: the compares are
    strict), same bits, same thresholds -> the same per-level LLRs and
    hard decisions as faid_tpu's staircase_qam."""
    cfg = JSimConfig(mod_type=mod_type, quant_bits=quant_bits)
    params = _jax_params(cfg, cfg.sigma_at(6.0))
    h = mod_type // 2
    shape = (8, 200)
    ix = _words(rng, shape)
    flat = params.reshape(-1)
    ix[0, :min(200, flat.size)] = flat[:200]
    ix[1, :min(200, flat.size)] = flat[:200] + 1
    ix[2, :min(200, flat.size)] = flat[:200] - 1
    bits = rng.integers(0, 2, (h,) + shape).astype(np.int32)
    rows = [[params[m, j] for j in range(params.shape[1])]
            for m in range(params.shape[0])]
    with jax.disable_jit():
        wq, wh = pc.staircase_qam(
            jnp.asarray(ix), jnp.asarray(bits[0]),
            [jnp.asarray(b) for b in bits[1:]], rows, mod_type=mod_type,
            quant_bits=quant_bits, scale=cfg.scale)
    gq, gh = qam_plan.staircase_qam(
        torch.from_numpy(ix), torch.from_numpy(bits[0]),
        [torch.from_numpy(b) for b in bits[1:]], torch.from_numpy(params.copy()),
        mod_type=mod_type, quant_bits=quant_bits, scale=cfg.scale)
    for lev in range(h):
        np.testing.assert_array_equal(gq[lev].numpy(), np.asarray(wq[lev]))
        np.testing.assert_array_equal(gh[lev].numpy(), np.asarray(wh[lev]))


def _jax_rail_composition(cw, ix_rail, params, mod_type, depth, quant_bits,
                          scale):
    """faid_tpu's rail layout of the QAM channel (``inner_jnp`` with the
    wrapper's interleave and deinterleave) on the given rail words."""
    b, n = cw.shape
    h, nsym = mod_type // 2, n // mod_type
    rows = [[params[m, j] for j in range(params.shape[1])]
            for m in range(params.shape[0])]
    with jax.disable_jit():
        grp = jmodem.interleave(jnp.asarray(cw), depth).reshape(
            b, nsym, h, 2).astype(jnp.int32)
        qs, hards = pc.staircase_qam(
            jnp.asarray(ix_rail), grp[:, :, 0, :],
            [grp[:, :, i, :] for i in range(1, h)], rows, mod_type=mod_type,
            quant_bits=quant_bits, scale=scale)
        errs = [hards[0]] + [hards[i] ^ grp[:, :, i, :] for i in range(1, h)]
        q = jnp.stack(qs, axis=2).reshape(b, n).astype(jnp.int8)
        err = jnp.stack(errs, axis=2).reshape(b, n).astype(jnp.int8)
        return (np.asarray(jmodem.deinterleave(q, depth)),
                np.asarray(jmodem.deinterleave(err, depth)))


@pytest.mark.parametrize("mod_type", [4, 6, 8])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("quant_bits", [3, 4, 6])
def test_kernel_g_twin_matches_jax_rail_layout(rng, mod_type, depth,
                                               quant_bits):
    """Kernel G's plain twin against the JAX package's rail composition on
    the port's rail words (rail r of the interleaved frame takes stream
    word r), with a random codeword, toy-code width, a frame offset."""
    n, batch = 96, 6
    cfg = SimConfig(mod_type=mod_type, quant_bits=quant_bits,
                    interleave_depth=depth)
    sigma = cfg.sigma_at(2.0 + 1.5 * mod_type)
    params = qam_plan.plan_threshold_ints(cfg, sigma)
    cw = rng.integers(0, 2, (batch, n)).astype(np.int8)
    kw = dict(seed=9, rnd=philox.stream_round(1, 4), batch=batch, n_var=n,
              mod_type=mod_type, depth=depth, quant_bits=quant_bits,
              scale=cfg.scale, frame0=3)
    tables = cc.qam_tables(params, mod_type, quant_bits, cfg.scale)
    kernels.launches.clear()
    got = cc.quantile_channel_qam(tables, cw=torch.from_numpy(cw), **kw)
    assert kernels.launches["G"] == 0       # the CPU twin
    ix = philox.channel_words(9, kw["rnd"], 3, batch, 2 * (n // mod_type),
                              "cpu").numpy().reshape(batch, -1, 2)
    want = _jax_rail_composition(cw, ix, params.numpy(), mod_type, depth,
                                 quant_bits, cfg.scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < got[1].float().mean() < 0.5
    # the all-zero word is cw=None
    zero = cc.quantile_channel_qam(tables, **kw)
    want0 = _jax_rail_composition(np.zeros_like(cw), ix, params.numpy(),
                                  mod_type, depth, quant_bits, cfg.scale)
    np.testing.assert_array_equal(zero[0].numpy(), want0[0])


def test_qam_channel_rejects_bad_args():
    cfg = SimConfig(mod_type=4, quant_bits=4)
    params = qam_plan.plan_threshold_ints(cfg, 0.3)
    kw = dict(seed=0, rnd=0, batch=2, n_var=96, mod_type=4, depth=1,
              quant_bits=4, scale=13.0)
    tables = cc.qam_tables(params, 4, 4, 13.0)
    cc.quantile_channel_qam(tables, **kw)
    for bad in (dict(mod_type=2), dict(quant_bits=1), dict(depth=5),
                dict(n_var=98), dict(quant_bits=6), dict(depth=0)):
        with pytest.raises(ValueError):
            cc.quantile_channel_qam(tables, **{**kw, **bad})
    with pytest.raises(ValueError):
        cc.quantile_channel_qam(tables._replace(params=params.to(torch.int64)), **kw)
    with pytest.raises(ValueError):
        cc.quantile_channel_qam(tables, cw=torch.zeros(2, 95, dtype=torch.int8),
                                **kw)
    with pytest.raises(ValueError):
        cc.quantile_channel_qam(tables._replace(params=params.to("meta")), **kw)
    # 64-QAM at depth 3 on the full code: whole symbols and whole rows,
    # though 17664 is not a multiple of 6 * 3
    p6 = qam_plan.plan_threshold_ints(SimConfig(mod_type=6), 0.3)
    cc._check_qam_args(p6, 2, 17664, 6, 3, 4, 13.0, None)


def test_plan_table_layout():
    """Kernel G's flat plan table holds every level's intervals and base:
    walking it as the kernel does gives staircase_qam's LLRs."""
    rng = np.random.default_rng(5)
    for mod, qb in ((4, 4), (8, 6)):
        cfg = SimConfig(mod_type=mod, quant_bits=qb)
        params = qam_plan.plan_threshold_ints(cfg, cfg.sigma_at(12.0))
        table = qam_plan.plan_table(mod, qb, 13.0).tolist()
        h = mod // 2
        starts, bases, ent = table[:3 * h + 1], table[3 * h + 1:4 * h + 1], \
            table[4 * h + 1:]
        assert len(ent) == starts[-1]
        ix = _words(rng, (400,))
        bits = rng.integers(0, 2, (h, 400)).astype(np.int32)
        q, hard = qam_plan.staircase_qam(
            torch.from_numpy(ix), torch.from_numpy(bits[0]),
            [torch.from_numpy(b) for b in bits[1:]], params, mod_type=mod,
            quant_bits=qb, scale=13.0)
        P = params.numpy()
        for e in range(0, 400, 37):
            m = int("".join(str(b) for b in bits[1:, e]) or "0", 2)
            ixe = int(ix[e]) ^ -int(bits[0, e])

            def count(a, b):
                n = 0
                for v in ent[a:b]:
                    lo, hi = (v & 0xFFFF) - 1, (v >> 16) - 1
                    n += ((lo < 0 or ixe > P[m, lo])
                          and (hi < 0 or ixe < P[m, hi]))
                return n
            for lev in range(h):
                s = starts[3 * lev:3 * lev + 4]
                qq = bases[lev] + count(s[0], s[1]) - count(s[1], s[2])
                if lev == 0 and bits[0, e]:
                    qq = -qq
                lo, hi = cc._QUANT_LIMITS[qb]
                assert min(max(qq, lo), hi) == int(q[lev][e])
                assert count(s[2], s[3]) == int(hard[lev][e])


def _cfg(**kw):
    base = dict(decode_method=DecodeMethod.FAID_DTBF, max_iteration=6,
                mod_type=4, interleave_depth=2, batch_per_device=32,
                fake_encode=False, channel_backend="xla", stop_mode="group",
                seed=5)
    base.update(kw)
    return SimConfig(**base), JSimConfig(**base)


def _fields(cfg):
    return {f.name: (v.value if hasattr(v, "value") else v)
            for f in dataclasses.fields(cfg)
            for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("stop_mode", ["group", "frame"])
def test_debug_llrs_through_jax_decoder_give_step_counters(stop_mode):
    """The slice on the toy code: the port's build_debug_step (float chain,
    16-QAM, depth 2, real codewords) gives LLRs and float LLRs that the
    JAX package's xla stats decoder and reduce_mod_stats turn into the
    port's build_sim_step counters for the same round."""
    cfg, jcfg = _cfg(stop_mode=stop_mode)
    code = toy_code()
    sigma = cfg.sigma_at(7.0)
    rnd = philox.stream_round(0, 3)
    dbg = build_debug_step(code, cfg, "cpu")(5, rnd, sigma)
    step = build_sim_step(code, cfg, "cpu")(5, rnd, sigma)
    n_info = code.n_info
    cw = dbg["cw"].numpy()
    assert cw.any()
    with jax.disable_jit():
        out = jbuild_stats(jtoy_code(), jcfg.decoder(), backend="xla")(
            jnp.asarray(dbg["llr"].numpy()), jnp.asarray(cw[:, :n_info] != 0))
        err_map = (dbg["soft"].numpy() > 0) ^ (cw != 0)
        mb, ms = pc.reduce_mod_stats(jnp.asarray(err_map), n_info, 4)
    err_bits = np.asarray(out["err_bits"])
    np.testing.assert_array_equal(err_bits, dbg["err_bits"].numpy())
    want = {"error_bits": int(err_bits.sum()),
            "error_frames": int((err_bits > 0).sum()),
            "lt3_frames": int(((err_bits > 0) & (err_bits < 3)).sum()),
            "mod_error_bits": int(np.asarray(mb).sum()),
            "mod_error_symbols": int(np.asarray(ms).sum()),
            "mod_error_frames": int((np.asarray(mb) > 0).sum()),
            "mp_iters": int(np.asarray(out["mp_iters"]).sum()),
            "bf_rounds": int(np.asarray(out["bf_rounds"]).sum())}
    assert {k: int(step[k]) for k in want} == want
    assert want["error_frames"] > 0 and want["mod_error_bits"] > 0
    # the float LLRs are the chain's, not the dequantized LLRs
    assert not torch.equal(dbg["soft"], dbg["llr"].float() / cfg.scale)


@pytest.mark.parametrize("mod_type,depth,quant_bits", [(4, 2, 4), (1, 3, 1)])
def test_step_matches_jax_float_chain_step(monkeypatch, mod_type, depth,
                                           quant_bits):
    """The whole round against faid_tpu's build_sim_step (xla channel, xla
    decoder) on the toy code with the all-zero word: the port's noise
    stream replaced by the normal draws JAX's step makes, every counter
    and histogram equal."""
    cfg, jcfg = _cfg(mod_type=mod_type, interleave_depth=depth,
                     quant_bits=quant_bits, fake_encode=True)
    code, jcode = toy_code(), jtoy_code()
    sigma = cfg.sigma_at(7.0 if mod_type == 4 else 2.0)
    key = jax.random.key(21)
    shape = ((32, code.n_var) if mod_type == 1
             else (32, code.n_var // mod_type, 2))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], shape,
                                         dtype=jnp.float32))

    def fake(seed, rnd, frame0, batch, n, device):
        assert (frame0, batch) == (0, 32) and n == noise[0].size
        return torch.from_numpy(noise.reshape(32, -1).copy())

    monkeypatch.setattr(philox, "normal_noise", fake)
    got = {k: v.tolist() for k, v in
           build_sim_step(code, cfg, "cpu")(0, 0, sigma).items()}
    with jax.disable_jit():
        want = jbuild_sim_step(jcode, jcfg, backend="xla")(key,
                                                           jnp.float32(sigma))
    want = {k: np.asarray(v).tolist() for k, v in want.items()}
    assert got == want
    assert got["mod_error_bits"] > 0 and got["error_frames"] > 0


def test_fused_vs_xla_statistics_16qam():
    """Kernel G's twin and the float chain at the statistics level on the
    toy code (pre-decoder BER and mean MP iterations), 16-QAM depth 2:
    the same law through different streams."""
    code = toy_code()
    out = {}
    for backend in ("xla", "fused"):
        cfg, _ = _cfg(channel_backend=backend, batch_per_device=512,
                      fake_encode=True)
        loop = pipeline.build_sim_loop(code, cfg, 4, "cpu")
        out[backend] = {k: int(v) for k, v in loop(1, cfg.sigma_at(6.0), 0).items()
                        if v.dim() == 0}
    nbits = 4 * 512 * code.n_info
    bx, bf = (out[b]["mod_error_bits"] / nbits for b in ("xla", "fused"))
    pbar = (bx + bf) / 2
    se = math.sqrt(2 * pbar * (1 - pbar) / nbits)
    assert abs(bx - bf) < 6 * se, (bx, bf, se)
    ix, if_ = (out[b]["mp_iters"] / (4 * 512) for b in ("xla", "fused"))
    assert abs(ix - if_) < 0.3, (ix, if_)


def test_kernel_f_is_not_the_float_chain(monkeypatch):
    """Kernel F (the whole quantile round) takes channel_backend "fused"
    only: the float chain at mod 1/2 composes its channel with kernel B,
    as JAX's _resolve_fused_sim requires "fused"."""
    code = toy_code()
    for mod in (1, 2):
        for backend, fuses in (("xla", False), ("fused", True)):
            cfg, jcfg = _cfg(mod_type=mod, interleave_depth=1,
                             channel_backend=backend)
            assert cuda_sim.supports_sim(code, cfg)
            assert pipeline._fuses(code, cfg) == fuses
    cfg, _ = _cfg(mod_type=2, interleave_depth=1, fake_encode=True)
    kernels.launches.clear()
    calls = []
    real = philox.normal_noise
    monkeypatch.setattr(philox, "normal_noise",
                        lambda *a: calls.append(a) or real(*a))
    build_sim_step(code, cfg, "cpu")(0, 0, 0.5)
    assert len(calls) == 1 and kernels.launches["F"] == 0


def test_check_ported_covers_the_slice():
    """What this slice ports builds, on the CPU and (checked before any
    table reaches the card) on a CUDA device; bad values still raise;
    FAID's EF 2 decodes, an EF outside 0-2 raises."""
    code = toy_code()
    for kw in (dict(), dict(mod_type=1, quant_bits=1),
               dict(mod_type=8, interleave_depth=3, quant_bits=6),
               dict(channel_backend="fused", mod_type=6, quant_bits=3),
               dict(channel_backend="fused", mod_type=2, interleave_depth=3)):
        cfg, _ = _cfg(**kw)
        pipeline.check_ported(cfg, "cuda")
        build_sim_step(code, cfg, "cpu")
        build_debug_step(code, cfg, "cpu")
    for kw in (dict(channel_backend="pallas"), dict(mod_type=3),
               dict(quant_bits=7), dict(interleave_depth=0)):
        with pytest.raises(ValueError):
            pipeline.check_ported(_cfg(**kw)[0], "cpu")
    with pytest.raises(ValueError, match="interleaver"):
        build_sim_step(code, _cfg(interleave_depth=5)[0], "cpu")
    ef2 = _cfg(decode_method=DecodeMethod.FAID_2B1C)[0]
    ef2_dcfg = dataclasses.replace(ef2.decoder(), ef_elimination=2)
    assert isinstance(ef2_dcfg, DecoderConfig)
    out = pipeline.build_stats_decoder(code, ef2_dcfg, "cpu")(
        torch.zeros((32, code.n_var), dtype=torch.int8))
    assert out["err_bits"].shape == (32,)
    with pytest.raises(NotImplementedError, match="no decoder"):
        pipeline.build_stats_decoder(
            code, dataclasses.replace(ef2_dcfg, ef_elimination=3), "cpu")
    # a 1-bit quantizer with the quantile channel falls back to the float
    # chain, with the JAX package's warning
    cfg, _ = _cfg(channel_backend="fused", mod_type=2, interleave_depth=1,
                  quant_bits=1)
    with pytest.warns(UserWarning, match="falling back"):
        step = build_sim_step(code, cfg, "cpu")
    assert int(step(0, 0, 0.5)["test_frames"]) == 32
    with pytest.warns(UserWarning, match="falling back"):
        debug = build_debug_step(code, cfg, "cpu")
    assert debug(0, 0, 0.5)["llr"].abs().max() == 31


def _run_cli(tmp_path, name, extra):
    out = tmp_path / name
    args = ["--batch", "32", "--snr-start", "7", "--snr-pass", "1",
            "--snr-end", "8.5", "--min-frames", "32", "--max-rounds", "1",
            "--method", "2", "--quiet", "--device", "cpu", "--out", str(out),
            *extra]
    assert cli.main(args) == 0
    return out, cli.config_from_args(cli.build_argparser().parse_args(args))


@pytest.mark.parametrize("extra", [
    [], ["--mod-type", "4", "--interleave", "2"],
    ["--mod-type", "4", "--interleave", "2", "--channel-backend", "fused"]])
def test_cli_default_flags_on_cpu(tmp_path, monkeypatch, extra):
    """The CLI with its own defaults (the float chain, real codewords)
    and at 16-QAM on both channels, on the toy code: it writes Result,
    demod and iterCount, byte-equal to faid_tpu's writers for the same
    counters, and its checkpoint records the configuration."""
    monkeypatch.setattr(runner, "load_code", lambda name: toy_code())
    out, cfg = _run_cli(tmp_path, "run", extra)
    assert cfg.channel_backend == ("fused" if "fused" in extra else "xla")
    assert cfg.mod_type == (4 if extra else 2) and not cfg.fake_encode
    rows = (out / "Result.txt").read_text().splitlines()
    assert [r.split()[0] for r in rows[1:]] == ["7.00", "8.00"]
    assert (out / "demod.txt").read_text().count("\n") == 3
    assert (out / "iterCount.txt").exists()
    st = json.loads((out / "checkpoint.json").read_text())
    assert st["config_fingerprint"] == runner.config_fingerprint(
        cfg, device_type="cpu")
    # the tables are the bytes faid_tpu's writers give for the same results
    j = object.__new__(jrunner.MonteCarloRunner)
    j.cfg, j.code = JSimConfig(**_fields(cfg)), jtoy_code()
    j.results = [jrunner.SnrResult(r["snr_db"], r["counters"], r["seconds"],
                                   r["err_chunks"]) for r in st["results"]]
    for name, method in (("Result.txt", "write_result_txt"),
                         ("demod.txt", "write_demod_txt"),
                         ("iterCount.txt", "write_itercount_txt")):
        getattr(j, method)(tmp_path / f"j_{name}")
        assert (out / name).read_bytes() == \
            (tmp_path / f"j_{name}").read_bytes(), name


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_qam_tables_byte_equal_to_jax(tmp_path, backend):
    """Result.txt and demod.txt (the ModSER denominator is n_info /
    mod_type) of a 16-QAM sweep, written by the port and by faid_tpu from
    the same results, are the same bytes."""
    cfg, _ = _cfg(channel_backend=backend, batch_per_device=32,
                  snr_start=5.0, snr_pass=1.5, snr_end=6.6, min_frames=64,
                  min_frame_errors=0, rounds_per_sync=2, max_iteration=2)
    r = MonteCarloRunner(cfg, code=toy_code(), device="cpu")
    r.run()
    assert len(r.results) == 2 and r.results[0].counters["mod_error_bits"] > 0
    j = object.__new__(jrunner.MonteCarloRunner)
    j.cfg, j.code = JSimConfig(**_fields(cfg)), jtoy_code()
    j.results = [jrunner.SnrResult(x.snr_db, x.counters, x.seconds,
                                   x.err_chunks) for x in r.results]
    for name, method in (("Result.txt", "write_result_txt"),
                         ("demod.txt", "write_demod_txt")):
        getattr(r, method)(tmp_path / f"t_{name}")
        getattr(j, method)(tmp_path / f"j_{name}")
        assert (tmp_path / f"t_{name}").read_bytes() == \
            (tmp_path / f"j_{name}").read_bytes(), name
    assert r.report_rows() == j.report_rows()
