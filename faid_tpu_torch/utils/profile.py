"""Profile.txt compatibility: parse the reference's fixed-order key-value
config (reference CTool.cpp:588-621) into a SimConfig, and write one back.

The port's own copy of ``faid_tpu.utils.profile``, over the port's
``config.py`` (tests/test_torch_runner.py holds the two equal).

Token order (whitespace-delimited, labels ignored):
  "Simulation parameter" StartSNR SNRPass EndSNR DecodeMethod MaxIteration
  "Modulation Parameter:" modType InterleaveModType "NMS Factor:" Factor_1
  Factor_2 noFrames scale "Matrix Factor" FileName Z
"""

from __future__ import annotations

from pathlib import Path

from ..config import DecodeMethod, SimConfig


def parse_profile(path: str | Path) -> SimConfig:
    toks = Path(path).read_text().split()
    it = iter(toks)

    def skip(n):
        for _ in range(n):
            next(it)

    def val():
        next(it)          # label
        return next(it)

    skip(2)               # "Simulation parameter"
    snr_start = float(val())
    snr_pass = float(val())
    snr_end = float(val())
    decode_method = int(val())
    max_iteration = int(val())
    skip(2)               # "Modulation Parameter:"
    mod_type = int(val())
    interleave = int(val())
    skip(2)               # "NMS Factor:"
    factor_1 = int(val())
    factor_2 = int(val())
    nb_frames = int(val())
    scale = float(val())
    skip(2)               # "Matrix Factor"
    file_name = val()
    z = int(val())

    return SimConfig(
        snr_start=snr_start, snr_pass=snr_pass, snr_end=snr_end,
        decode_method=DecodeMethod(decode_method),
        max_iteration=max_iteration, mod_type=mod_type,
        interleave_depth=interleave, factor_1=factor_1, factor_2=factor_2,
        scale=scale, file_name=file_name, z=z,
        # nb_frames was the per-SIMD-word frame count (always 32); the
        # device batch is independent, but keep a sensible multiple.
        batch_per_device=max(256, nb_frames),
    )


def write_profile(cfg: SimConfig, path: str | Path) -> None:
    text = f"""Simulation parameter
StartSNR: {cfg.snr_start:g}
SNRPass: {cfg.snr_pass:g}
EndSNR: {cfg.snr_end:g}
DecodeMethod: {int(cfg.decode_method)}
MaxIteration: {cfg.max_iteration}
Modulation Parameter:
modType: {cfg.mod_type}
InterleaveModType: {cfg.interleave_depth}
NMS  Factor:
Factor_1: {cfg.factor_1}
Factor_2: {cfg.factor_2}
noFrames: 32
scale: {cfg.scale:g}
Matrix Factor
FileName: {cfg.file_name}
Z: {cfg.z}
"""
    Path(path).write_text(text)
