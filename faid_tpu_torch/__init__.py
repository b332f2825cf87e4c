"""faid_tpu_torch - the PyTorch / CUDA port of ``faid_tpu``, the 50G-PON
LDPC Monte-Carlo simulator, for NVIDIA Hopper (H100).

It mirrors ``faid_tpu``'s layout and module names.  Plain tensor code is
PyTorch; each TPU kernel on the ported paths is a hand-written CUDA
kernel in ``csrc/``, built with nvcc at first use:

  A  quantile channel + ModCalErr counts   ops/cuda_channel.py  (sweep,
                                           where F does not take the
                                           round)
  B  stats decoder                         ops/cuda_decoder.py  (same)
  C  quantile channel + ModCalErr map      ops/cuda_channel.py  (replay,
                                           also as ops/cuda_sim.py
                                           ``fused_sim_emit``)
  D  full decoder (hard decisions)         ops/cuda_decoder.py  (replay,
                                           methods with a BF tail)
  E  MP-only decoder (final LLRs)          ops/cuda_decoder.py  (replay,
                                           NMS and OMS)
  F  the whole round: channel, decoder     ops/cuda_sim.py      (sweep)
     and the five per-frame counters
  G  16/64/256-QAM quantile channel +      ops/cuda_channel.py  (sweep and
     ModCalErr map                                              replay)

The float channel chain (``channel_backend="xla"``, the default: modem,
AWGN on the noise stream of ops/philox.py, quantizer) is plain PyTorch,
ops/channel.py.  Real codewords come from the message stream (ops/philox.py) through the
encoder (code/encoder.py), a PyTorch int8 matrix product.

It imports torch and numpy, never JAX.  Entry points run on ``cuda``
unless the caller asks for the CPU, where each kernel's plain twin runs.

Public API:
    load_code()                      the 50G-PON QC-LDPC code object
    SimConfig / DecoderConfig        typed configuration
    build_sim_step / build_sim_loop  one Monte-Carlo round / many, on a device
    build_debug_step                 the exact replay of one round's frames
    MonteCarloRunner                 the SNR sweep with checkpoint/resume,
                                     result tables and error-frame dumps
                                     (command line: python -m faid_tpu_torch.cli)
"""

from .code.qc_matrix import QCCode, load_code
from .config import BFConfig, DecodeMethod, DecoderConfig, FaidLutFamily, SimConfig
from .sim.pipeline import build_debug_step, build_sim_loop, build_sim_step, sigma_for
from .sim.runner import MonteCarloRunner

__all__ = [
    "QCCode", "load_code",
    "BFConfig", "DecodeMethod", "DecoderConfig", "FaidLutFamily", "SimConfig",
    "build_debug_step", "build_sim_loop", "build_sim_step", "sigma_for",
    "MonteCarloRunner",
]
