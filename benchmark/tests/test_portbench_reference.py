"""The reference (benchmark/reference/) against the port's plain path on
the toy code: counter for counter, in both stop modes, on both channels'
plain twins (QPSK's staircase and 16-QAM's plan), with the all-zero word
and with codewords.  The toy code's shape is copied from the port's
object, as data."""

import pytest
import torch

from benchmark.reference import channel, encoder, philox
from benchmark.reference.code import code_from_arrays, load_code
from benchmark.reference.config import Deployment
from benchmark.reference.round import RoundReference
from faid_tpu_torch.code.encoder import make_encode_fn
from faid_tpu_torch.code.qc_matrix import load_code as port_load_code
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, SimConfig
from faid_tpu_torch.ops import cuda_channel
from faid_tpu_torch.ops import philox as port_philox
from faid_tpu_torch.ops.qam_plan import plan_threshold_ints
from faid_tpu_torch.sim.pipeline import build_sim_loop

SEED = 4_000_000_017


def _ref_code(c):
    return code_from_arrays(c.name, c.z, c.n_var, c.n_chk, c.block_cols,
                            c.shifts, c.degrees, c.puncture_tail)


@pytest.mark.parametrize("mod,depth,snr", [(2, 1, 2.0), (4, 2, 6.0)])
@pytest.mark.parametrize("stop_mode", ["group", "frame"])
@pytest.mark.parametrize("fake", [True, False])
def test_sync_counters_equal_port(mod, depth, snr, stop_mode, fake):
    code = toy_code()
    cfg = SimConfig(mod_type=mod, interleave_depth=depth, fake_encode=fake,
                    stop_mode=stop_mode, channel_backend="fused",
                    batch_per_device=64, seed=SEED,
                    decode_method=DecodeMethod.FAID_DTBF)
    sigma = cfg.sigma_at(snr)
    loop = build_sim_loop(code, cfg, 3, "cpu", frame0=64)
    prog = {k: v.tolist()
            for k, v in loop(SEED, sigma, port_philox.stream_round(0, 6)).items()}
    dep = Deployment(mod_type=mod, interleave_depth=depth, stop_mode=stop_mode,
                     batch_per_device=64)
    ref = RoundReference(_ref_code(code), dep, "cpu", fake_encode=fake)
    assert ref.sync_counters(SEED, sigma, 0, 6, 3, 64, 64) == prog
    assert prog["error_frames"] > 0 and prog["bf_rounds"] > 0


def test_code_and_thresholds_equal_port():
    ours, port = load_code("50gpon"), port_load_code("50gpon")
    assert (ours.block_cols, ours.shifts, ours.degrees, ours.puncture_tail) == (
        port.block_cols, port.shifts, port.degrees, port.puncture_tail)
    for mod, depth, snr in [(2, 1, 4.0), (4, 2, 7.5)]:
        dep = Deployment(mod_type=mod, interleave_depth=depth)
        cfg = SimConfig(mod_type=mod, interleave_depth=depth)
        sigma = dep.sigma_at(snr)
        assert sigma == cfg.sigma_at(snr)
        if mod == 2:
            assert torch.equal(channel.threshold_ints(dep, sigma),
                               cuda_channel.threshold_ints(cfg, sigma))
        else:
            from benchmark.reference.qam import plan_threshold_ints as ours_plan

            assert torch.equal(ours_plan(dep, sigma), plan_threshold_ints(cfg, sigma))


def test_streams_and_encoder_equal_port():
    code = toy_code()
    u = philox.message_bits(SEED, 5, 3, 32, code.n_info, "cpu")
    assert torch.equal(u, port_philox.message_bits(SEED, 5, 3, 32, code.n_info, "cpu"))
    assert torch.equal(philox.channel_words(SEED, 5, 3, 32, code.n_var, "cpu"),
                       port_philox.channel_words(SEED, 5, 3, 32, code.n_var, "cpu"))
    assert torch.equal(encoder.make_encode_fn(_ref_code(code), "cpu")(u),
                       make_encode_fn(code, "cpu")(u))


def test_bfloat16_thresholds_move():
    """The control's channel differs from the configuration's."""
    dep = Deployment()
    sigma = dep.sigma_at(4.0)
    assert not torch.equal(channel.threshold_ints(dep, sigma),
                           channel.threshold_ints(dep, sigma, torch.bfloat16))
