"""The check against a broken program: the whole run on the CPU
(a rehearsal skips only the look for a card), with the timed path broken
underneath, has to come out not correct, once for each fault that a
cell can have; and the control (benchmark/control.py), the reference in
bfloat16 thresholds put in the program's place, has to fail the check on
three seeds."""

import pytest
import torch

from benchmark import control, harness

CELL = "qpsk.codewords-4.0dB"


def _stale(runner):
    """A step that returns its state unchanged: every sync the first one's
    counters again."""
    loop, first = runner.loop, []

    def stale(seed, sigma, round0):
        out = loop(seed, sigma, round0)
        if not first:
            first.append({k: v.clone() for k, v in out.items()})
        return {k: v.clone() for k, v in first[0].items()}

    runner.loop = stale


def _half_batch(runner):
    """Half the batch left out: each round's counters are its first half's,
    doubled."""
    import dataclasses

    from faid_tpu_torch.sim.pipeline import build_sim_loop

    cfg = dataclasses.replace(runner.cfg, batch_per_device=runner.cfg.batch_per_device // 2)
    half = build_sim_loop(runner.code, cfg, runner.rounds_per_sync, runner.device)
    runner.loop = lambda seed, sigma, round0: {
        k: 2 * v for k, v in half(seed, sigma, round0).items()}


def _altered(runner, monkeypatch):
    """An answer altered where it is produced: kernel F's twin counts one
    more error bit in frame 0 of every round."""
    from faid_tpu_torch.ops import cuda_sim

    sim = cuda_sim.fused_sim

    def altered(*args, **kwargs):
        out = sim(*args, **kwargs)
        out["err_bits"] = out["err_bits"].clone()
        out["err_bits"][0] += 1
        return out

    monkeypatch.setattr(cuda_sim, "fused_sim", altered)


def _sigma(runner, monkeypatch):
    """The program's SNR-to-sigma step off by 2%: the reference works sigma
    out from the SNR itself, so it sees the other noise."""
    sigma_at = type(runner.cfg).sigma_at
    monkeypatch.setattr(type(runner.cfg), "sigma_at",
                        lambda cfg, snr_db: 1.02 * sigma_at(cfg, snr_db))


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered", "sigma"])
def test_a_broken_round_is_not_correct(fault, monkeypatch):
    breaks = {"stale": _stale, "half_batch": _half_batch,
              "altered": lambda r: _altered(r, monkeypatch),
              "sigma": lambda r: _sigma(r, monkeypatch)}[fault]
    opts = harness.Options(CELL, 2**32 + 3, 0.5, False, rehearse=True)
    rc, line, gaps = harness.lead_main(opts, 0.0, fault=breaks)
    assert rc == 0
    assert line["correct"] is False and line["checked"]["counter_gap"]["value"] > 0


def test_the_exchange_left_out_is_not_correct():
    """Rank 0 of four keeps its own counters where the all-reduce would
    have summed the ranks' (the collective still runs, so no rank
    waits)."""
    def local(runner):
        from faid_tpu_torch.parallel import mesh

        reduce = mesh.all_reduce_counters

        def keep_local(stats):
            reduce({k: v.clone() for k, v in stats.items()})
            return stats

        mesh.all_reduce_counters = keep_local

    # the several-chip path, on the one-chip cell's traffic at world 4
    opts = harness.Options("qpsk.zero-word-4.0dB", 17, 0.5, False,
                           world=4, rehearse=True)
    from faid_tpu_torch.parallel import mesh

    reduce = mesh.all_reduce_counters
    try:
        rc, line, _ = harness.lead_main(opts, 0.0, fault=local)
    finally:
        mesh.all_reduce_counters = reduce
    assert rc == 0
    assert line["correct"] is False and line["checked"]["counter_gap"]["value"] > 0


@pytest.mark.parametrize("cell", ["qpsk.zero-word-4.0dB", "16qam.codewords-7.5dB"])
def test_the_control_fails_the_check(cell):
    for seed in (3, 2**31 + 1, 2**33 + 7):
        assert control.control_gaps(cell, seed, rehearse=True)["counter_gap"] > 0


def test_the_control_at_the_cells_size(card):
    """On the card: the control at the cell's own size fails the check."""
    got = control.control_gaps("qpsk.zero-word-4.0dB", 2**31 + 5, rehearse=False,
                               device=card)
    assert got["counter_gap"] > 0
    torch.cuda.empty_cache()
