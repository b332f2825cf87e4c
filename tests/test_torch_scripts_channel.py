"""PyTorch port, the channel-parity script and what the scripts share
(faid_tpu_torch/scripts/channel_parity.py, _common.py) on the CPU: the
float64 erfc oracle against the JAX script's, the histogram on the toy
code, both channel backends' FER rows, the z test and the artifact
writer."""

from __future__ import annotations

import importlib.util
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jax import unoptimized_jax_compiles  # noqa: F401

from faid_tpu.config import SimConfig as JSimConfig
from faid_tpu.ops import pallas_channel as pc
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import SimConfig
from faid_tpu_torch.scripts import _common, channel_parity

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_script():
    """scripts/channel_parity.py, the JAX package's, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_channel_parity", _common.REPO / "scripts" / "channel_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sigma32(mod, snr):
    return float(np.float32(SimConfig(mod_type=mod).sigma_at(snr)))


@pytest.mark.parametrize("mod,snr", [(2, 3.6), (2, 4.0), (1, 4.0)])
def test_bin_probs_match_the_jax_oracle(jax_script, mod, snr):
    sigma = _sigma32(mod, snr)
    got = channel_parity.analytic_bin_probs(SimConfig(mod_type=mod), sigma)
    want = jax_script.analytic_bin_probs(JSimConfig(mod_type=mod), sigma)
    assert got.keys() == want.keys() == set(range(-7, 8))
    for m in want:
        assert abs(got[m] - want[m]) <= 1e-12
    assert abs(sum(got.values()) - 1.0) <= 1e-12


@pytest.mark.parametrize("mod,snr", [(4, 8.1), (6, 12.9), (8, 17.0)])
def test_level_probs_match_the_jax_oracle(jax_script, mod, snr):
    sigma = _sigma32(mod, snr)
    for level in range(mod // 2):
        got = channel_parity.analytic_level_probs(SimConfig(mod_type=mod), sigma,
                                                  level)
        want = jax_script.analytic_level_probs(JSimConfig(mod_type=mod), sigma,
                                               level)
        assert got.keys() == want.keys()
        for m in want:
            assert abs(got[m] - want[m]) <= 1e-12
        assert all(p >= -1e-15 for p in got.values())


def test_stream_id_is_the_jax_scripts(jax_script):
    for parts in (("xla", "qpsk", 3.6), ("hist", "16qam", 8.1), (20260820, "OMS", 4.0)):
        assert _common.stream_id(*parts) == jax_script.stream_id(*parts)


@pytest.mark.parametrize("label,mod,snr", [("qpsk", 2, 4.0), ("bpsk", 1, 2.0),
                                           ("16qam", 4, 8.1)])
def test_hist_row_on_the_toy_code_lies_in_the_law(label, mod, snr):
    """The plain twins' draws (kernel C's, kernel G's) histogrammed on the
    CPU hold every bin to the law's z limit; a row names its launches."""
    code = toy_code()
    rec = channel_parity.hist_row(code, "cpu", label, mod, snr, batch=64, launches=6)
    assert rec["consistent"], rec
    nlev = max(mod // 2, 1)
    assert len(rec["levels"]) == nlev and rec["launches"] == 6
    for lv in rec["levels"]:
        assert lv["draws"] == 6 * 64 * code.n_var // nlev
        assert lv["outside"] == 0 and lv["max_abs_z"] <= channel_parity.HIST_Z
        assert sum(b["observed"] for b in lv["bins"]) == lv["draws"]
    assert all(n == 0 for n in rec["kernels"].values())    # no kernel on the CPU
    if nlev == 1:
        assert rec["draws"] == rec["levels"][0]["draws"]


def _jax_thresholds(mod, quant_bits, sigma):
    """faid_tpu's thresholds: _threshold_ints at BPSK/QPSK, the plan's at
    16-256-QAM (XLA's float32 ndtr, erfc in the tails)."""
    f = pc._threshold_ints if mod in (1, 2) else pc._plan_threshold_ints
    cfg = JSimConfig(mod_type=mod, quant_bits=quant_bits)
    return np.asarray(jax.jit(lambda s: f(cfg, s))(jnp.float32(sigma)))


@pytest.mark.parametrize("mod,quant_bits,snrs", [
    (1, 4, (3.6, 8.0, 12.0)), (2, 4, (3.6, 8.0, 12.0)), (2, 6, (3.6, 6.0)),
    (4, 4, (8.1, 12.0)), (4, 6, (8.1,)), (6, 4, (12.9, 16.0)), (8, 6, (17.0, 20.0))])
def test_threshold_tails_match_jax(mod, quant_bits, snrs):
    """Every quantizer step's probability on the 2^-32 grid (a threshold's
    small side) equals the JAX package's within float32 rounding, deep
    tails included: the step of 16-QAM's q = +7 at 8.1 dB (probability
    8.3e-9) holds 36 words of 2^32 in both, not 0.  channel_parity's
    histograms (~5.4e8 draws a level) found that step never drawn in the
    port, where the JAX package's TPU run drew it."""
    from faid_tpu_torch.ops import cuda_channel as cc
    from faid_tpu_torch.ops import qam_plan

    for snr in snrs:
        cfg = SimConfig(mod_type=mod, quant_bits=quant_bits)
        sigma = _sigma32(mod, snr)
        got = (cc.threshold_ints(cfg, sigma) if mod in (1, 2)
               else qam_plan.plan_threshold_ints(cfg, sigma)).numpy().astype(np.int64)
        want = _jax_thresholds(mod, quant_bits, sigma).astype(np.int64)
        small_g = np.minimum(2**31 - 1 - got, got + 2**31)
        small_w = np.minimum(2**31 - 1 - want, want + 2**31)
        assert (np.abs(small_g - small_w) <= 2 + 1e-5 * small_w).all(), \
            (snr, small_g - small_w)


def test_judge_level_flags_a_wrong_law():
    """A histogram drawn from another SNR's law fails the bin test, and a
    draw outside the quantizer's range fails on its own."""
    code = toy_code()
    counts, cfg, sigma = channel_parity.hist_counts(code, "cpu", 2, 2.0, 64, 8, 0, 1)
    right = channel_parity.analytic_bin_probs(cfg, sigma)
    wrong = channel_parity.analytic_bin_probs(cfg, _sigma32(2, 6.0))
    assert channel_parity.judge_level(counts[0], right)["consistent"]
    assert not channel_parity.judge_level(counts[0], wrong)["consistent"]
    stray = counts[0].clone()
    stray[0] += 1                       # q = -8: outside the 4-bit range
    res = channel_parity.judge_level(stray, right)
    assert res["outside"] == 1 and not res["consistent"]


def test_fer_row_on_the_toy_code():
    """Both backends' counters, their z's and the TPU row's comparison."""
    code = toy_code()
    tpu = {("qpsk", 2.0): {c: {"frames": 256, "errors": 100,
                               "mod_error_bits": 900} for c in ("xla", "fused")}}
    row = channel_parity.fer_row(code, "cpu", "qpsk", 2, 2.0, 6, 1, batch=64,
                                 rounds_per_call=2, min_errors=5, max_rounds=4,
                                 tpu_rows=tpu)
    for chan in ("xla", "fused"):
        r = row[chan]
        assert r["frames"] % 128 == 0 and 5 <= r["errors"] <= r["frames"]
        assert r["mod_error_bits"] > 0
    want = _common.two_prop_z(row["xla"]["errors"], row["xla"]["frames"],
                              row["fused"]["errors"], row["fused"]["frames"])
    assert row["z_fer"] == round(want, 3)
    assert set(row["vs_tpu"]) == {"xla", "fused"}
    assert row["consistent"] == (abs(row["z_fer"]) <= 4 and abs(row["z_mod_ber"]) <= 4
                                 and all(v["consistent"]
                                         for v in row["vs_tpu"].values()))


def _jax_z(ex, fx, ef, ff):
    """scripts/channel_parity.py's z, as written there."""
    p = (ex + ef) / (fx + ff) if (ex + ef) else 0.0
    se = math.sqrt(p * (1 - p) * (1 / fx + 1 / ff)) if p > 0 else 0.0
    return ((ex / fx) - (ef / ff)) / se if se else 0.0


@pytest.mark.parametrize("counts", [(7828, 51200, 7945, 51200), (30, 71680, 33, 2048),
                                    (0, 204800, 2, 204800), (51150, 51200, 51149, 51200),
                                    (2048, 2048, 2048, 2048), (0, 2048, 0, 4096)])
def test_two_prop_z_is_the_jax_formula(counts):
    assert _common.two_prop_z(*counts) == _jax_z(*counts)


def test_consistent_rows():
    # a row of FER 1.0 is held by equality, never by a division by zero
    assert _common.consistent(2048, 2048, 2048, 2048) == (None, True)
    assert _common.consistent(2047, 2048, 2048, 2048) == (None, False)
    assert _common.consistent(512, 512, 2048, 2048) == (None, True)
    # two rows without an error are equal
    assert _common.consistent(0, 204800, 0, 204800) == (None, True)
    z, ok = _common.consistent(354, 2048, 360, 2048)
    assert ok and z == _common.two_prop_z(354, 2048, 360, 2048)
    z, ok = _common.consistent(100, 2048, 354, 2048)
    assert not ok and z < -4


def test_reference_rows_read_the_jax_artifacts():
    rows = _common.validation_rows("group")
    assert rows["FAID_DTBF", 3.8]["error_frames"] == 30
    assert len(_common.validation_rows("frame")) == 18
    floor = _common.floor_rows()["FAID_DTBF", 3.9, "group"]
    assert (floor["error_frames"], floor["frames"]) == (20, 6955008)
    assert _common.reference_fer("NMS", 1, 6)[0] == 1.0
    assert len(_common.channel_parity_rows()["histograms"]) == 4


def test_writer_refuses_the_jax_artifacts(tmp_path):
    jax_files = sorted(_common.DOCS.glob("*.json")) + sorted(_common.DOCS.glob("*.md"))
    assert len(jax_files) >= 15
    for p in jax_files:
        before = p.read_bytes()
        with pytest.raises(ValueError):
            _common.write_json(p, {"rows": []})
        with pytest.raises(ValueError):
            _common.write_artifact(p.parent / ".." / "docs" / p.name, "x")
        assert p.read_bytes() == before
    out = _common.write_json(tmp_path / "a" / "b.json", {"x": 1})
    assert out.read_text() == '{\n "x": 1\n}\n'
    assert _common.artifact_path(_common.OUT_DIR / "roofline.json").parent == \
        _common.OUT_DIR.resolve()


def test_card_line_on_the_cpu():
    assert _common.card_line("cpu") == "cpu"
