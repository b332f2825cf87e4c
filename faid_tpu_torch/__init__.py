"""faid_tpu_torch - the PyTorch / CUDA port of ``faid_tpu``, the 50G-PON
LDPC Monte-Carlo simulator, for NVIDIA Hopper (H100).

It mirrors ``faid_tpu``'s layout and module names.  Plain tensor code is
PyTorch; each TPU kernel on the ported path is a hand-written CUDA
kernel in ``csrc/`` (ops/cuda_channel.py, ops/cuda_decoder.py), built
with nvcc at first use.  It imports torch and numpy, never JAX.

Public API:
    load_code()                      the 50G-PON QC-LDPC code object
    SimConfig / DecoderConfig        typed configuration
    build_sim_step / build_sim_loop  one Monte-Carlo round / many, on a device
"""

from .code.qc_matrix import QCCode, load_code
from .config import BFConfig, DecodeMethod, DecoderConfig, FaidLutFamily, SimConfig
from .sim.pipeline import build_sim_loop, build_sim_step, sigma_for

__all__ = [
    "QCCode", "load_code",
    "BFConfig", "DecodeMethod", "DecoderConfig", "FaidLutFamily", "SimConfig",
    "build_sim_loop", "build_sim_step", "sigma_for",
]
