"""The card a run measured on, as nvidia-smi names it.

A frozen copy of faid_tpu_torch/scripts/_common.py ``card_line`` at commit
f97303742a3ef9c90c8903c33bcd676948a22a11.
"""

from __future__ import annotations

import subprocess

import torch


def card_line(device) -> str:
    """The card of ``device`` as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives it (e.g. "NVIDIA H100 80GB HBM3, 700.00
    W"), or "cpu".  Raises OSError or subprocess.SubprocessError where
    nvidia-smi cannot read a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
