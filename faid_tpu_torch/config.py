"""Typed simulation config: the runtime ``Profile.txt`` knobs and the
compile-time decoder ``#define``s of the reference simulator, as frozen
(hashable) dataclasses.

Field for field the same as ``faid_tpu.config`` (tests/test_torch_foundations.py
holds the two equal), so a configuration means the same run in both
packages.  Pure Python: no torch, no numpy.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class DecodeMethod(enum.IntEnum):
    """Profile.txt DecodeMethod 0-5."""

    NMS = 0
    OMS = 1
    FAID_DTBF = 2
    OMS_BF = 3
    OMS_DTBF = 4
    FAID_2B1C = 5


class FaidLutFamily(enum.Enum):
    """FAID V2C table families (#define FAID3 / FAID32 / FAID2, and the
    2B1C decoder's own set)."""

    FAID3 = "faid3"
    FAID32 = "faid32"
    FAID2 = "faid2"
    FAID_2B1C = "faid_2b1c"


@dataclasses.dataclass(frozen=True)
class BFConfig:
    """Bit-flipping post-processor parameters (DTBF / static BF / 2B1C)."""

    kind: str = "none"          # none | static | dtbf | dtbf2b1c
    max_iter: int = 0           # _maxBFiter
    delta: int = 1              # _delta: threshold decrement
    l0: int = 50                # _L0: rounds at the max threshold
    l1: int = 0                 # _L1: rounds at the sub-max threshold
    alpha: int = 1              # _alpha
    gamma: int = 3              # flip-eligible column weight
    static_vote_cap: int = 5    # static BF: flip if vote >= min(max_vote, 5)
    reliability_threshold: int = 13  # 2B1C |LLR| >= 13 marks reliable


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Per-decoder algorithm parameters."""

    method: DecodeMethod = DecodeMethod.FAID_DTBF
    max_iter: int = 6           # MP iterations
    factor_1: int = 1           # NMS normalizer / OMS clipping threshold
    factor_2: int = 6
    oms_mode: int = 0           # 0 simple, 1 selective
    oms_offset: int = 1         # simple-OMS offset constant
    stop_early: bool = True
    ef_elimination: int = 0     # 0/1/2 (FAID only)
    floor_err_count: int = 100  # selective/EF gate on #unsatisfied checks
    floor_iter_thresh: int = 4  # selective/EF gate on remaining iterations
    lut_family: FaidLutFamily = FaidLutFamily.FAID3
    sign_backtrack: bool = True
    # Early-stop granularity: "frame" freezes each frame once its
    # syndrome is clean; "group" keeps a whole 32-frame word updating
    # until every frame in it is clean (the reference's SIMD word).
    stop_mode: str = "frame"
    bf: BFConfig = BFConfig()

    @staticmethod
    def for_method(method: DecodeMethod, max_iter: int = 6,
                   factor_1: int = 1, factor_2: int = 6,
                   lut_family: "FaidLutFamily | None" = None,
                   stop_mode: str = "frame") -> "DecoderConfig":
        """Each reference decoder's compiled-in configuration.

        ``lut_family`` overrides the FAID V2C table selection; it is
        ignored for non-FAID methods and for 2B1C (own table set)."""
        m = DecodeMethod(method)
        base = dict(method=m, max_iter=max_iter,
                    factor_1=factor_1, factor_2=factor_2,
                    stop_mode=stop_mode)
        if m == DecodeMethod.NMS:
            return DecoderConfig(**base, oms_mode=0, stop_early=False,
                                 bf=BFConfig())
        if m == DecodeMethod.OMS:
            return DecoderConfig(**base, oms_mode=1, oms_offset=1,
                                 floor_err_count=100, floor_iter_thresh=4,
                                 bf=BFConfig())
        if m == DecodeMethod.FAID_DTBF:
            return DecoderConfig(**base, oms_mode=0, oms_offset=0,
                                 ef_elimination=0, floor_err_count=0,
                                 floor_iter_thresh=-1,
                                 lut_family=lut_family or FaidLutFamily.FAID3,
                                 bf=BFConfig(kind="dtbf", max_iter=10,
                                             delta=1, l0=50, l1=0, alpha=1))
        if m == DecodeMethod.OMS_BF:
            return DecoderConfig(**base, oms_mode=1, oms_offset=1,
                                 floor_err_count=100, floor_iter_thresh=4,
                                 bf=BFConfig(kind="static", max_iter=50))
        if m == DecodeMethod.OMS_DTBF:
            return DecoderConfig(**base, oms_mode=1, oms_offset=1,
                                 floor_err_count=100, floor_iter_thresh=4,
                                 bf=BFConfig(kind="dtbf", max_iter=50,
                                             delta=1, l0=0, l1=50, alpha=1))
        if m == DecodeMethod.FAID_2B1C:
            return DecoderConfig(**base, oms_mode=0, oms_offset=0,
                                 ef_elimination=1, floor_err_count=50,
                                 floor_iter_thresh=6,
                                 lut_family=FaidLutFamily.FAID_2B1C,
                                 bf=BFConfig(kind="dtbf2b1c", max_iter=10,
                                             delta=1, l0=100, l1=0, alpha=1))
        raise ValueError(m)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full Monte-Carlo simulation config (Profile.txt equivalent)."""

    snr_start: float = 3.0
    snr_pass: float = 0.1
    snr_end: float = 5.0
    decode_method: DecodeMethod = DecodeMethod.FAID_DTBF
    max_iteration: int = 6
    mod_type: int = 2           # 1 BPSK, 2 QPSK, 4 16QAM, 6 64QAM, 8 256QAM
    interleave_depth: int = 1
    factor_1: int = 1
    factor_2: int = 6
    scale: float = 13.0         # quantizer scale
    quant_bits: int = 4
    file_name: str = "50GPON-CP12"
    z: int = 256
    fake_encode: bool = False   # all-zero codeword path
    faid_lut: str = "faid3"
    seed: int = 0
    min_frames: int = 1000
    min_frame_errors: int = 20
    max_frames_per_snr: int | None = None
    giveup_zero_error_frames: int | None = None
    batch_per_device: int = 256
    rounds_per_sync: int = 8
    backend: str = "auto"
    # "xla" = the float chain (ops/channel.py), "fused" = the quantile
    # channel (ops/cuda_channel.py)
    channel_backend: str = "xla"
    stop_mode: str = "frame"
    rate_override: float | None = 0.8444444

    @property
    def rate(self) -> float:
        if self.rate_override is not None:
            return self.rate_override
        return 14592.0 / 17280.0

    def file_name_key(self) -> str:
        name = self.file_name.lower()
        if "50gpon" in name or "50g" in name:
            return "50gpon"
        return name

    def decoder(self) -> DecoderConfig:
        return DecoderConfig.for_method(
            self.decode_method, self.max_iteration, self.factor_1,
            self.factor_2, lut_family=FaidLutFamily(self.faid_lut),
            stop_mode=self.stop_mode)

    def sigma(self) -> float:
        return self.sigma_at(self.snr_start)

    def sigma_at(self, snr_db: float) -> float:
        """Noise sigma from Eb/N0; BPSK has the extra factor 2 inside the
        square root."""
        snr_lin = 10.0 ** (0.1 * snr_db)
        if self.mod_type == 1:
            return 1.0 / math.sqrt(2.0 * self.rate * self.mod_type * snr_lin)
        return 1.0 / math.sqrt(self.rate * self.mod_type * snr_lin)
