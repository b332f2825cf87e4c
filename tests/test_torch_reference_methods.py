"""The benchmark's plain reference (benchmark/reference/) against the
port's plain round for every reference decoder, on the toy code: a sync's
counters, counter for counter, for the six ``DecodeMethod``s in both stop
modes, with the all-zero word and with codewords, on the quantile
channel (QPSK).  FAID-2B1C runs at the hybrid-precision scale 12.5, the
others at 13; NMS at factors 26 / 32, where its messages are not all 0.
At 2 dB every method fails frames and every BF tail runs."""

import pytest

from benchmark.reference.code import code_from_arrays
from benchmark.reference.config import Deployment
from benchmark.reference.round import RoundReference
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.config import DecodeMethod, DecoderConfig, SimConfig
from faid_tpu_torch.ops import philox
from faid_tpu_torch.sim.pipeline import build_sim_loop

SEED = 4_000_000_017
SNR_DB = 2.0
BATCH = 64
SETTINGS = {DecodeMethod.NMS: dict(factor_1=26, factor_2=32),
            DecodeMethod.FAID_2B1C: dict(scale=12.5)}


@pytest.mark.parametrize("fake", [True, False], ids=["zero_word", "codewords"])
@pytest.mark.parametrize("stop_mode", ["group", "frame"])
@pytest.mark.parametrize("method", list(DecodeMethod), ids=lambda m: m.name)
def test_sync_counters_equal_port(method, stop_mode, fake):
    code = toy_code()
    kw = SETTINGS.get(method, {})
    cfg = SimConfig(mod_type=2, fake_encode=fake, stop_mode=stop_mode,
                    channel_backend="fused", batch_per_device=BATCH, seed=SEED,
                    decode_method=method, **kw)
    sigma = cfg.sigma_at(SNR_DB)
    loop = build_sim_loop(code, cfg, 3, "cpu", frame0=BATCH)
    prog = {k: v.tolist()
            for k, v in loop(SEED, sigma, philox.stream_round(0, 6)).items()}
    dep = Deployment(decode_method=int(method), stop_mode=stop_mode,
                     batch_per_device=BATCH, **kw)
    assert dep.sigma_at(SNR_DB) == sigma
    ref_code = code_from_arrays(code.name, code.z, code.n_var, code.n_chk,
                                code.block_cols, code.shifts, code.degrees,
                                code.puncture_tail)
    ref = RoundReference(ref_code, dep, "cpu", fake_encode=fake)
    assert ref.sync_counters(SEED, sigma, 0, 6, 3, BATCH, BATCH) == prog
    assert prog["error_frames"] > 0
    if DecoderConfig.for_method(method).bf.kind != "none":
        assert prog["bf_rounds"] > 0
