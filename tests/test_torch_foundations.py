"""PyTorch port, foundations: config, LUTs, codes, conversion, Philox,
and the port's independence from JAX."""

from __future__ import annotations

import dataclasses
import enum
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from faid_tpu import config as jcfg
from faid_tpu.code import qc_matrix as jqc
from faid_tpu.code import toy as jtoy
from faid_tpu.decoders import luts as jluts
from faid_tpu_torch import config as tcfg
from faid_tpu_torch import convert
from faid_tpu_torch.code import qc_matrix as tqc
from faid_tpu_torch.code import toy as ttoy
from faid_tpu_torch.decoders import luts as tluts
from faid_tpu_torch.ops import fixed_point as tfp
from faid_tpu_torch.ops import philox

REPO = Path(__file__).resolve().parents[1]


def _plain(obj):
    """Dataclass -> nested dict with enums as their values."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


def _code_fields(code):
    return {f.name: getattr(code, f.name)
            for f in dataclasses.fields(code)}


@pytest.mark.parametrize("method", list(jcfg.DecodeMethod))
@pytest.mark.parametrize("stop_mode", ["frame", "group"])
def test_decoder_config_matches(method, stop_mode):
    j = jcfg.DecoderConfig.for_method(method, max_iter=5, stop_mode=stop_mode)
    t = tcfg.DecoderConfig.for_method(tcfg.DecodeMethod(int(method)),
                                      max_iter=5, stop_mode=stop_mode)
    assert _plain(t) == _plain(j)


def test_sim_config_matches():
    j, t = jcfg.SimConfig(), tcfg.SimConfig()
    assert _plain(t) == _plain(j)
    assert _plain(t.decoder()) == _plain(j.decoder())
    assert t.sigma() == j.sigma()
    for mod in (1, 2):
        for snr in (3.6, 4.0, -8.0):
            assert (tcfg.SimConfig(mod_type=mod).sigma_at(snr)
                    == jcfg.SimConfig(mod_type=mod).sigma_at(snr))
    hash(t)


@pytest.mark.parametrize("family", list(jcfg.FaidLutFamily))
@pytest.mark.parametrize("max_iter", [3, 6, 9])
def test_luts_match(family, max_iter):
    np.testing.assert_array_equal(
        tluts.table_for(tcfg.FaidLutFamily(family.value), max_iter),
        jluts.table_for(family, max_iter))
    np.testing.assert_array_equal(tluts.ef_table(max_iter),
                                  jluts.ef_table(max_iter))


def test_load_code_matches():
    j, t = jqc.load_code("50gpon"), tqc.load_code("50gpon")
    assert _code_fields(t) == _code_fields(j)
    np.testing.assert_array_equal(t.vn_weight_blocks_np, j.vn_weight_blocks_np)
    assert t.n_info == 14592 and t.max_deg == 23


@pytest.mark.parametrize("kw", [{}, dict(z=16, n_block_cols=10, n_block_rows=3,
                                         row_degree=5, seed=3)])
def test_toy_code_matches(kw):
    j, t = jtoy.toy_code(**kw), ttoy.toy_code(**kw)
    assert _code_fields(t) == _code_fields(j)
    np.testing.assert_array_equal(t.h_dense(), j.h_dense())


@pytest.mark.parametrize("name", ["50gpon", "toy"])
def test_convert_round_trips_jax_arrays(name):
    j = jqc.load_code("50gpon") if name == "50gpon" else jtoy.toy_code()
    t = convert.code_from_arrays(j.name, j.z, j.n_var, j.n_chk,
                                 j.block_cols_np, j.shifts_np, j.degrees_np,
                                 puncture_tail=j.puncture_tail)
    assert _code_fields(t) == _code_fields(j)
    lut = jluts.table_for(jcfg.FaidLutFamily.FAID3, 6)
    ef = jluts.ef_table(6)
    tl, te = convert.tables_from_arrays(lut, ef, "cpu")
    assert tl.dtype == te.dtype == torch.int32 and tl.is_contiguous()
    np.testing.assert_array_equal(tl.numpy(), lut)
    np.testing.assert_array_equal(te.numpy(), ef)
    with pytest.raises(ValueError):
        convert.tables_from_arrays(lut[:, :7], ef, "cpu")


def test_sat8_and_limits():
    from faid_tpu.ops import fixed_point as jfp

    assert tfp._QUANT_LIMITS == jfp._QUANT_LIMITS
    assert (tfp.SAT_POS_VAR, tfp.SAT_NEG_VAR, tfp.SAT_POS_MSG) == (
        jfp.SAT_POS_VAR, jfp.SAT_NEG_VAR, jfp.SAT_POS_MSG)
    x = np.arange(-300, 300, dtype=np.int32)
    np.testing.assert_array_equal(tfp.sat8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jfp.sat8(x)))


def test_port_imports_no_jax():
    """The port runs where there is no JAX: importing every module of it,
    and the multi-process checks' rank module, must load neither jax nor
    faid_tpu."""
    mods = ["faid_tpu_torch", "faid_tpu_torch.convert",
            "faid_tpu_torch.code.toy", "faid_tpu_torch.decoders.core",
            "faid_tpu_torch.decoders.bf", "faid_tpu_torch.ops.cn_update",
            "faid_tpu_torch.ops.cuda_channel", "faid_tpu_torch.ops.cuda_decoder",
            "faid_tpu_torch.ops.philox", "faid_tpu_torch.ops.syndrome",
            "faid_tpu_torch.ops.modem", "faid_tpu_torch.ops.channel",
            "faid_tpu_torch.ops.qam_plan",
            "faid_tpu_torch.sim.pipeline", "faid_tpu_torch.sim.runner",
            "faid_tpu_torch.cli", "faid_tpu_torch.utils.kernels",
            "faid_tpu_torch.utils.profile", "faid_tpu_torch.parallel.mesh",
            "faid_tpu_torch.bench",
            "faid_tpu_torch.scripts._common",
            "faid_tpu_torch.scripts.fer_validation",
            "faid_tpu_torch.scripts.channel_parity",
            "faid_tpu_torch.scripts.floor_campaign",
            "faid_tpu_torch.scripts.roofline",
            "faid_tpu_torch.scripts.backend_parity",
            "faid_tpu_torch.scripts.bench_decoder",
            # the ranks of the multi-process checks (tests and chip_smoke.py)
            "_torch_dist"]
    prog = ("import importlib, sys\n"
            "sys.path.insert(0, 'tests')\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'faid_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", prog], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# --- Philox4x32-10: a scalar pure-Python version, written from the
# Random123 definition, against the port's tensor version.

def _philox_scalar(ctr, key):
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(10):
        if i:
            k0, k1 = (k0 + w0) & 0xFFFFFFFF, (k1 + w1) & 0xFFFFFFFF
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & 0xFFFFFFFF,
                          (p0 >> 32) ^ c3 ^ k1, p0 & 0xFFFFFFFF)
    return c0, c1, c2, c3


# Random123's known-answer vectors for philox4x32-10.
_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", _KAT)
def test_philox_known_answers(ctr, key, want):
    assert _philox_scalar(ctr, key) == want
    got = philox.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                              for c in ctr), *key)
    assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("seed,rnd,frame0", [
    (0, 0, 0), (12345, 7, 3), (2**64 - 1, 2**40 + 5, 2**31)])
def test_philox_stream_matches_scalar(seed, rnd, frame0):
    batch, n = 3, 22       # n % 4 != 0: the last counter's tail is unused
    got = philox.channel_words(seed, rnd, frame0, batch, n, "cpu")
    assert got.dtype == torch.int32 and got.shape == (batch, n)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for f in range(batch):
        for bit in range(n):
            w = _philox_scalar((bit // 4, frame0 + f, rnd & 0xFFFFFFFF,
                                rnd >> 32), key)[bit % 4]
            assert int(got[f, bit]) == (w - 2**32 if w >= 2**31 else w)


def test_philox_stream_independent_of_geometry():
    """A frame's words do not depend on which batch drew it."""
    whole = philox.channel_words(9, 4, 0, 8, 40, "cpu")
    part = philox.channel_words(9, 4, 5, 3, 40, "cpu")
    np.testing.assert_array_equal(whole[5:].numpy(), part.numpy())
    other = philox.channel_words(9, 5, 0, 8, 40, "cpu")
    assert (other != whole).float().mean() > 0.99
