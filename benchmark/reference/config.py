"""The decoder configurations of the reference methods, and a cell's
deployment as the reference reads it.

``DecodeMethod``, ``FaidLutFamily``, ``BFConfig`` and ``DecoderConfig``
(with ``for_method``) are a frozen copy of faid_tpu_torch/config.py at
commit f97303742a3ef9c90c8903c33bcd676948a22a11.  ``Deployment`` holds
the fields of a configuration file (benchmark/configs/) that a round
depends on, with ``SimConfig.sigma_at``'s formula.
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
class Deployment:
    """A configuration file's settings of the round."""

    code: str = "50gpon"
    mod_type: int = 2
    interleave_depth: int = 1
    decode_method: int = 2
    max_iteration: int = 6
    factor_1: int = 1
    factor_2: int = 6
    faid_lut: str = "faid3"
    stop_mode: str = "group"
    quant_bits: int = 4
    scale: float = 13.0
    channel_backend: str = "fused"
    batch_per_device: int = 2048
    rate_override: float | None = 0.8444444

    @classmethod
    def from_config(cls, config: dict) -> "Deployment":
        """The fields of a configuration file's ``settings``."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config["settings"].items() if k in names})

    @property
    def rate(self) -> float:
        if self.rate_override is not None:
            return self.rate_override
        return 14592.0 / 17280.0

    def decoder(self) -> DecoderConfig:
        return DecoderConfig.for_method(
            DecodeMethod(self.decode_method), self.max_iteration,
            self.factor_1, self.factor_2,
            lut_family=FaidLutFamily(self.faid_lut), stop_mode=self.stop_mode)

    def sigma_at(self, snr_db: float) -> float:
        """Noise sigma from Eb/N0; BPSK has the extra factor 2 inside the
        square root."""
        snr_lin = 10.0 ** (0.1 * snr_db)
        if self.mod_type == 1:
            return 1.0 / math.sqrt(2.0 * self.rate * self.mod_type * snr_lin)
        return 1.0 / math.sqrt(self.rate * self.mod_type * snr_lin)
