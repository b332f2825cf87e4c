"""PyTorch port, kernel G's cell table (faid_tpu_torch/ops/qam_plan.py
``cell_table`` and ``staircase_qam_cells``, the lookup the kernel does)
against the interval walk (``staircase_qam``) on the CPU: on every
threshold, threshold +- 1 and both ends of the int32 range, where a
random word ties with probability |U| / 2^32; on crafted thresholds; and
where the table is made (``ThresholdCache``, once per sigma) and checked
(``quantile_channel_qam``)."""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.ops import pallas_channel as pc
from faid_tpu_torch import build_sim_loop
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, SimConfig
from faid_tpu_torch.ops import cuda_channel as cc
from faid_tpu_torch.ops import qam_plan

torch.set_num_threads(1)

IMIN, IMAX = -(2**31), 2**31 - 1
MODS = (4, 6, 8)
BITS = (2, 3, 4, 5, 6)
# 5 dB, each modulation's speed point (its waterfall + 0.4 dB; chip_smoke.py
# QAM_POINTS), 30 dB
SNRS = {4: (5.0, 7.9, 30.0), 6: (5.0, 12.9, 30.0), 8: (5.0, 17.0, 30.0)}


def _params(mod, bits, snr):
    cfg = SimConfig(mod_type=mod, quant_bits=bits)
    return qam_plan.plan_threshold_ints(cfg, cfg.sigma_at(snr))


def _edge_words(params, rng, n_random=4096):
    """Every distinct threshold, each +- 1, both ends of the int32 range
    and their neighbours, 0, -1, and ``n_random`` seeded words."""
    vals = torch.unique(params.to(torch.int64))
    w = torch.cat([vals, vals + 1, vals - 1,
                   torch.tensor([IMIN, IMIN + 1, IMAX - 1, IMAX, 0, -1]),
                   torch.from_numpy(rng.integers(IMIN, IMAX + 1, n_random))])
    return w[(w >= IMIN) & (w <= IMAX)].to(torch.int32)


def _every_rail(words, mod):
    """(ix, sign, mag_bits): each word for both sign bits and every row m,
    mirrored so that the mirrored word is the given one in every case."""
    h, nmag = mod // 2, 2 ** (mod // 2 - 1)
    n = len(words)
    sign = torch.arange(2).repeat_interleave(nmag * n).to(torch.int32)
    m = torch.arange(nmag).repeat_interleave(n).repeat(2)
    ix = words.repeat(2 * nmag) ^ -sign
    return ix, sign, [((m >> (h - 1 - lv)) & 1).to(torch.int32) for lv in range(1, h)]


def _assert_cells_equal_walk(params, mod, bits, words):
    cells = qam_plan.cell_table(params, mod, bits, 13.0)
    ix, sign, mag = _every_rail(words, mod)
    kw = dict(mod_type=mod, quant_bits=bits)
    wq, wh = qam_plan.staircase_qam(ix, sign, mag, params, scale=13.0, **kw)
    gq, gh = qam_plan.staircase_qam_cells(ix, sign, mag, cells, **kw)
    for lev in range(mod // 2):
        # the channel writes int8: the walk's LLR modulo 2^8
        np.testing.assert_array_equal(gq[lev].numpy(), wq[lev].to(torch.int8).numpy())
        np.testing.assert_array_equal(gh[lev].numpy(), wh[lev].numpy())
    # the words include real ties: a word equal to one of its row's
    # thresholds in every row
    for row in params:
        assert torch.isin(words, row).any()
    return cells


@pytest.mark.parametrize("snr_i", [0, 1, 2])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mod", MODS)
def test_cells_equal_walk_on_edge_words(mod, bits, snr_i):
    """Plan thresholds at 5 dB, the speed point and 30 dB (saturated
    INT_MIN / INT_MAX entries and repeated values in every row): the
    lookup equals the walk on every threshold, +- 1, the extremes and
    4096 random words, both signs, every row."""
    params = _params(mod, bits, SNRS[mod][snr_i])
    rng = np.random.default_rng(1000 * mod + 10 * bits + snr_i)
    _assert_cells_equal_walk(params, mod, bits, _edge_words(params, rng))


@pytest.mark.parametrize("kind", ["crafted", "one_value"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mod", MODS)
def test_cells_equal_walk_on_crafted_thresholds(mod, bits, kind):
    """Any int32 thresholds, not only the plan's: seeded random words with
    repeats, a threshold's neighbour (an open cell with no word in it)
    and both extremes (the levels then count overlapping intervals), and
    rows of one repeated value (U = {v, INT_MAX})."""
    rng = np.random.default_rng(7 * mod + bits)
    shape = _params(mod, bits, 10.0).shape
    if kind == "crafted":
        p = rng.integers(IMIN, IMAX + 1, shape)
        p[:, 1::5] = p[:, :1]                              # repeats
        p[:, 2::5] = np.minimum(p[:, :1] + 1, IMAX)        # an empty open cell
        p[:, 3::7] = IMIN
        p[:, 4::7] = IMAX
        params = torch.from_numpy(p).to(torch.int32)
    else:
        params = torch.from_numpy(rng.integers(IMIN, IMAX + 1, (shape[0], 1))
                                  .repeat(shape[1], axis=1)).to(torch.int32)
    cells = _assert_cells_equal_walk(params, mod, bits, _edge_words(params, rng))
    if kind == "one_value":
        assert cells.shape[1] == 4         # U = {v, INT_MAX}: s = 2


def test_cells_anchor_jax_walk():
    """16-QAM 4-bit at its speed point: the lookup against faid_tpu's own
    ``staircase_qam``, op by op, on the edge words, both signs, both
    rows."""
    cfg = SimConfig(mod_type=4, quant_bits=4)
    params = _params(4, 4, 7.9)
    words = _edge_words(params, np.random.default_rng(3), n_random=0)
    ix, sign, mag = _every_rail(words, 4)
    rows = [[params[m, j].item() for j in range(params.shape[1])]
            for m in range(params.shape[0])]
    with jax.disable_jit():
        wq, wh = pc.staircase_qam(
            jnp.asarray(ix.numpy()), jnp.asarray(sign.numpy()),
            [jnp.asarray(b.numpy()) for b in mag],
            [[jnp.int32(v) for v in r] for r in rows], mod_type=4,
            quant_bits=4, scale=cfg.scale)
    cells = qam_plan.cell_table(params, 4, 4, cfg.scale)
    gq, gh = qam_plan.staircase_qam_cells(ix, sign, mag, cells, mod_type=4,
                                          quant_bits=4)
    for lev in range(2):
        np.testing.assert_array_equal(gq[lev].numpy(), np.asarray(wq[lev]))
        np.testing.assert_array_equal(gh[lev].numpy(), np.asarray(wh[lev]))


def test_threshold_cache_builds_the_table_once_per_sigma(monkeypatch):
    """The 16-QAM fused loop on the toy code, on the CPU: two runs at one
    sigma build one cell table, a second sigma one more; none is built a
    round."""
    built = []
    real = cc.cell_table

    def counting(*args, **kw):
        built.append(args[0].clone())
        return real(*args, **kw)

    monkeypatch.setattr(cc, "cell_table", counting)
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, max_iteration=6,
                    mod_type=4, interleave_depth=2, batch_per_device=8,
                    fake_encode=False, channel_backend="fused",
                    stop_mode="frame", seed=5)
    loop = build_sim_loop(toy_code(), cfg, 3, "cpu")
    s1, s2 = cfg.sigma_at(8.0), cfg.sigma_at(9.0)
    out = loop(5, s1, 0)
    assert int(out["test_frames"]) == 24
    loop(5, s1, 3)
    assert len(built) == 1
    loop(5, s2, 0)
    assert len(built) == 2
    # each table was made from its own sigma's thresholds
    assert torch.equal(built[0], qam_plan.plan_threshold_ints(cfg, s1))
    assert torch.equal(built[1], qam_plan.plan_threshold_ints(cfg, s2))
    tables = cc.ThresholdCache(cfg, "cpu")(s2)
    assert torch.equal(tables.cells, real(tables.params, 4, cfg.quant_bits, cfg.scale))


def _kernel_limits():
    """csrc/qam_channel.cu's layout constants, which its C entry checks."""
    src = (Path(cc.__file__).parents[1] / "csrc" / "qam_channel.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kEntryBytes", "kRowSkew", "kMaxSteps", "kMaxSharedBytes")}


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mod", MODS)
def test_worst_case_table_fits_shared_memory(mod, bits):
    """Every threshold of every row distinct (the kernel must not count on
    the plan's repeats): the table's width is ``cell_width`` and fits the
    C entry's limits (its search steps, its shared memory), and the
    lookup still equals the walk."""
    shape = _params(mod, bits, 10.0).shape
    rng = np.random.default_rng(mod * bits)
    p = np.stack([rng.choice(2**32 - 1, shape[1], replace=False) - 2**31
                  for _ in range(shape[0])])
    params = torch.from_numpy(p).to(torch.int32)
    cells = _assert_cells_equal_walk(params, mod, bits,
                                     _edge_words(params, rng, n_random=256))
    width = qam_plan.cell_width(shape[1])
    assert cells.shape == (shape[0], width, 6)
    lim = _kernel_limits()
    assert lim["kEntryBytes"] == 4 * qam_plan.CELL_ENTRY_WORDS
    assert width <= 2 ** lim["kMaxSteps"]
    assert shape[0] * (width * lim["kEntryBytes"] + lim["kRowSkew"]) <= lim["kMaxSharedBytes"]


def test_wrapper_checks_the_table():
    """quantile_channel_qam takes the thresholds and their cell table as
    one ``QamTables``, and rejects tables made for another configuration
    or a cell table that does not match the thresholds."""
    cfg = SimConfig(mod_type=4, quant_bits=4)
    params = _params(4, 4, 7.9)
    tables = cc.qam_tables(params, 4, 4, cfg.scale)
    assert torch.equal(tables.cells, qam_plan.cell_table(params, 4, 4, cfg.scale))
    kw = dict(seed=0, rnd=0, batch=2, n_var=96, mod_type=4, depth=2,
              quant_bits=4, scale=cfg.scale)
    got = cc.quantile_channel_qam(tables, **kw)
    want = cc.quantile_channel_qam_plain(params, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cells = tables.cells
    for bad in (cells[:1], cells[..., :5].contiguous(), cells.to(torch.int64),
                cells.transpose(0, 1), cells.reshape(2, -1), cells.to("meta")):
        with pytest.raises(ValueError):
            cc.quantile_channel_qam(tables._replace(cells=bad), **kw)
    # tables made for another width, scale or modulation
    for other in (cc.qam_tables(_params(4, 3, 7.9), 4, 3, cfg.scale),
                  tables._replace(scale=12.0),
                  cc.qam_tables(_params(6, 4, 12.9), 6, 4, cfg.scale)):
        with pytest.raises(ValueError):
            cc.quantile_channel_qam(other, **kw)
