"""PyTorch port, the campaign scripts on the CPU at the toy code's size
(faid_tpu_torch/scripts/fer_validation.py, floor_campaign.py): the stop
rule's counters against build_sim_step's, the rows and the table, the
streams, and the floor campaign's resume, path and upper bound."""

from __future__ import annotations

import json

import pytest
import torch

from faid_tpu_torch import build_sim_step
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.ops import philox
from faid_tpu_torch.scripts import _common, fer_validation, floor_campaign

torch.set_num_threads(1)

MIN_FRAMES, MIN_ERRORS, MAX_ROUNDS, BATCH = 128, 12, 16, 64


@pytest.fixture(scope="module")
def rows():
    return fer_validation.run_validation(
        toy_code(), "cpu", [2.0], [2, 1], BATCH, "group", MIN_FRAMES, MIN_ERRORS,
        MAX_ROUNDS)


def test_rows_equal_the_steps_of_the_rounds_the_rule_took(rows):
    """Each row's counters are build_sim_step's summed over the point's
    stream rounds 0 .. rounds - 1, and the stop rule took exactly those:
    the rule held after the last call and not before it."""
    code = toy_code()
    for row, m in zip(rows, (2, 1)):
        cfg = fer_validation.validation_config(m, BATCH, "group")
        step = build_sim_step(code, cfg, "cpu")
        point = fer_validation.point_of(m, 0)
        assert row["stream_point"] == point
        c = dict.fromkeys(("test_frames", "error_frames", "error_bits", "mp_iters",
                           "bf_rounds"), 0)
        done_before = None
        for r in range(row["rounds"]):
            if r % fer_validation.ROUNDS == 0:
                done_before = (c["test_frames"] >= MIN_FRAMES
                               and c["error_frames"] >= MIN_ERRORS)
            out = step(cfg.seed, philox.stream_round(point, r), cfg.sigma_at(2.0))
            for k in c:
                c[k] += int(out[k])
        assert not done_before
        assert ((c["test_frames"] >= MIN_FRAMES and c["error_frames"] >= MIN_ERRORS)
                or row["rounds"] >= MAX_ROUNDS)
        assert row["frames"] == c["test_frames"] == row["rounds"] * BATCH
        assert row["error_frames"] == c["error_frames"]
        tf = c["test_frames"]
        assert row["fer"] == c["error_frames"] / tf
        assert row["ber"] == c["error_bits"] / (tf * code.n_info)
        assert row["avg_mp_iters"] == c["mp_iters"] / tf
        assert row["avg_bf_rounds"] == c["bf_rounds"] / tf
        assert row["mbit_s"] == pytest.approx(tf * code.n_info / row["seconds"] / 1e6)
        assert row["card"] == "cpu"


def test_row_keys_and_table(rows):
    jax_keys = set(next(iter(_common.validation_rows("group").values())))
    assert jax_keys <= set(rows[0])
    ref = {(r["method"], 2.0): {"frames": r["frames"], "error_frames": r["error_frames"]}
           for r in rows}
    assert fer_validation.hold_to(rows, ref)
    assert all(r["consistent"] and r["z"] is not None for r in rows)
    md = fer_validation.markdown(rows, "cpu", "group").splitlines()
    table = [line for line in md if line.startswith("| ")]
    assert len(table) == 1 + len(rows)
    for line, r in zip(table[1:], rows):
        assert line.startswith(f"| {r['method']} | 2.0 | {r['frames']} | "
                               f"{r['error_frames']} |")
    # a point the JAX package never ran is not judged
    other = [dict(rows[0], snr_db=9.9)]
    assert fer_validation.hold_to(other, ref) and other[0]["consistent"] is None


def test_no_two_points_share_a_stream():
    points = [fer_validation.point_of(m, s) for m in range(6) for s in range(3)]
    assert len(set(points)) == len(points)
    assert fer_validation.WARM_POINT not in points
    # a point's rounds never reach the next point's stream
    assert all(philox.stream_round(p, 400 - 1) < philox.stream_round(q, 0)
               for p, q in zip(sorted(points), sorted(points)[1:]))


def test_main_writes_both_files(tmp_path, monkeypatch):
    """main() on the CPU at the toy code: both artifacts, exit 1 where a
    row is inconsistent with its JAX row (the toy code's FER is not the
    50G-PON code's)."""
    import faid_tpu_torch.code.qc_matrix as qc

    monkeypatch.setattr(qc, "load_code", lambda name: toy_code())
    rc = fer_validation.main(["--device", "cpu", "--snrs", "3.6", "--methods", "2",
                              "--batch", "64", "--max-rounds", "4",
                              "--stop-mode", "group", "--out", str(tmp_path / "V.md"),
                              "--json-out", str(tmp_path / "v.json")])
    rows = json.loads((tmp_path / "v.json").read_text())
    assert len(rows) == 1 and rows[0]["jax_row"]["frames"] == 2048
    assert rc == (0 if rows[0]["consistent"] else 1)
    assert "| FAID_DTBF | 3.6 |" in (tmp_path / "V.md").read_text()


# --- the floor campaign

FLOOR = dict(batch=64, rounds=2, calls=2, target_errors=10**6)


def _counters(row):
    keys = ("frames", "error_frames", "fer", "ber", "avg_mp_iters", "avg_bf_rounds")
    return {k: row[k] for k in keys}


def test_floor_resume_equals_one_run(tmp_path):
    """A campaign stopped at half its frame budget, rerun with the whole
    budget, equals one run of the whole budget, counter for counter."""
    code = toy_code()
    whole = 16 * 64
    half_row = floor_campaign.run_campaign(code, "cpu", 2, 3.0, tmp_path / "a" / "f.json",
                                           max_frames=whole // 2, **FLOOR)
    assert half_row["frames"] == whole // 2 and "partial" not in half_row
    resumed = floor_campaign.run_campaign(code, "cpu", 2, 3.0, tmp_path / "a" / "f.json",
                                          max_frames=whole, **FLOOR)
    one = floor_campaign.run_campaign(code, "cpu", 2, 3.0, tmp_path / "b" / "f.json",
                                      max_frames=whole, **FLOOR)
    assert resumed["frames"] == whole and _counters(resumed) == _counters(one)
    assert _counters(half_row) != _counters(one)
    assert resumed["error_frames"] > 0
    # the file keeps one row a key; the checkpoint lies beside it
    assert json.loads((tmp_path / "a" / "f.json").read_text()) == [resumed]
    assert floor_campaign.checkpoint_path(tmp_path / "a" / "f.json",
                                          "FAID_DTBF").exists()
    # a rerun under the same rule runs no round and keeps the row
    again = floor_campaign.run_campaign(code, "cpu", 2, 3.0, tmp_path / "a" / "f.json",
                                        max_frames=whole, **FLOOR)
    assert again == resumed
    # without the row, the checkpoint alone gives it back (nothing ran)
    (tmp_path / "a" / "f.json").unlink()
    again = floor_campaign.run_campaign(code, "cpu", 2, 3.0, tmp_path / "a" / "f.json",
                                        max_frames=whole, **FLOOR)
    assert _counters(again) == _counters(one) and again["mbit_s"] is None


def test_floor_rows_are_merged_and_methods_draw_their_own_streams(tmp_path):
    code = toy_code()
    out = tmp_path / "f.json"
    a = floor_campaign.run_campaign(code, "cpu", 2, 3.0, out, max_frames=256, **FLOOR)
    b = floor_campaign.run_campaign(code, "cpu", 5, 3.0, out, max_frames=256, **FLOOR)
    rows = json.loads(out.read_text())
    assert [(r["method"], r["snr_db"], r["stop_mode"]) for r in rows] == [
        ("FAID_DTBF", 3.0, "group"), ("FAID_2B1C", 3.0, "group")]
    assert rows == [a, b]
    seeds = {floor_campaign.campaign_config(m, snr, 64, 2, 2, mode, 20260820, 20, 256).seed
             for m in (2, 5) for snr in (3.9, 4.0) for mode in ("group", "frame")}
    assert len(seeds) == 8


def test_floor_out_follows_snr_and_stop_mode():
    assert (floor_campaign.default_out(3.9, "group")
            == _common.OUT_DIR / "floor_group_39.json")
    assert floor_campaign.default_out(4.1, "frame").name == "floor_frame_41.json"
    assert floor_campaign.default_out(4.05, "group").name == "floor_group_40p5.json"
    for snr in (3.6, 3.9, 4.0, 4.1):
        p = floor_campaign.default_out(snr, "group")
        assert p.parent == _common.OUT_DIR and p != _common.DOCS / "floor_group_40.json"
    args = floor_campaign.build_argparser().parse_args(["--snr", "3.9"])
    assert args.out is None and args.stop_mode == "group"
    with pytest.raises(ValueError):
        floor_campaign.run_campaign(toy_code(), "cpu", 2, 4.0,
                                    _common.DOCS / "floor_group_40.json", **FLOOR)


def test_zero_error_row_has_the_rule_of_three():
    c = {"test_frames": 120_012_800, "error_frames": 0, "error_bits": 0,
         "mp_iters": 2 * 120_012_800, "bf_rounds": 0}
    row = floor_campaign.make_row("OMS_BF", 4.0, "group", c, 14592, 4096, 2.0, "cpu",
                                  partial=True)
    assert row["fer_ub95"] == 3.0 / 120_012_800 and row["fer"] == 0.0
    assert row["partial"] is True
    c["error_frames"] = 1
    row = floor_campaign.make_row("OMS_BF", 4.0, "group", c, 14592, 4096, 2.0, "cpu",
                                  partial=False)
    assert "fer_ub95" not in row and "partial" not in row
