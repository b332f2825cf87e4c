"""What the port's scripts share: the card a run measured on, the kernels'
launch counts, the stream separator, the two-proportion z test, the
readers of the JAX package's artifacts (``docs/*.json``) and the writer
of the port's own (``docs/torch_h100/``), which never overwrites one of
the JAX package's."""

from __future__ import annotations

import json
import math
import subprocess
import zlib
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
DOCS = REPO / "docs"                  # the JAX package's artifacts
OUT_DIR = DOCS / "torch_h100"         # the port's
Z_LIMIT = 4.0
# the JAX package's method names (docs/*.json)
METHOD_NAMES = {0: "NMS", 1: "OMS", 2: "FAID_DTBF", 3: "OMS_BF", 4: "OMS_DTBF",
                5: "FAID_2B1C"}


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


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by its letter; a wrapper adds one to its
    ``launches`` where it launches its kernel, and nowhere else."""
    from ..ops import cuda_channel as cc
    from ..ops import cuda_decoder as cd
    from ..ops import cuda_sim as cs

    return {"A": cc.quantile_channel, "B": cd.stats_decode,
            "C": cc.quantile_channel_map, "D": cd.full_decode, "E": cd.mp_decode,
            "F": cs.fused_sim, "emit": cs.fused_sim_emit,
            "G": cc.quantile_channel_qam}


def launch_counts() -> dict[str, int]:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The launches of each kernel since ``launch_counts()`` read
    ``before``."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def stream_id(*parts) -> int:
    """A stream separator independent of PYTHONHASHSEED (crc32 of the
    parts, 31 bits), as scripts/channel_parity.py makes it."""
    return zlib.crc32("/".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


def two_prop_z(e1, n1, e2, n2) -> float:
    """The pooled two-proportion z of e1/n1 - e2/n2, the formula of
    scripts/channel_parity.py; 0.0 where the pooled proportion is 0 or 1."""
    p = (e1 + e2) / (n1 + n2)
    se = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2)) if 0 < p < 1 else 0.0
    return (e1 / n1 - e2 / n2) / se if se else 0.0


def consistent(e1, n1, e2, n2, limit: float = Z_LIMIT) -> tuple[float | None, bool]:
    """(z, |z| <= limit) of the rows e1/n1 and e2/n2.  A row of FER 1.0 is
    held by equality (the other must be 1.0 too), as are two rows without
    an error: z would divide by zero there, and is None."""
    if e1 == n1 or e2 == n2:
        return None, e1 == n1 and e2 == n2
    if e1 == e2 == 0:
        return None, True
    z = two_prop_z(e1, n1, e2, n2)
    return z, abs(z) <= limit


def _read(name: str):
    return json.loads((DOCS / name).read_text())


def reference_fer(method: str, factor_1: int, factor_2: int,
                  source: str = "ref") -> tuple[float, int]:
    """The QPSK 3.6 dB row of ``method`` in docs/refcheck_fer_compare.json:
    the reference simulator's (``source="ref"``, group stop mode) or the
    JAX package's frame stop mode run (``"frame"``), as (FER, frames)."""
    for r in _read("refcheck_fer_compare.json")["rows"]:
        if (r["method"] == method and r["snr_db"] == 3.6 and r["mod_type"] == 2
                and r["depth"] == 1 and r["lut"] == "faid3"
                and r["scale"] == 13.0 and r["factor_1"] == factor_1
                and r["factor_2"] == factor_2):
            return r[f"{source}_fer"], r[f"{source}_frames"]
    raise KeyError(f"no {method} QPSK 3.6 dB row in docs/refcheck_fer_compare.json")


def fer_z(error_frames: int, frames: int, method: str = "FAID_DTBF",
          factor_1: int = 1, factor_2: int = 6, source: str = "ref") -> float:
    """Two-proportion z of an FER against ``reference_fer``'s row,
    printed."""
    ref_fer, ref_n = reference_fer(method, factor_1, factor_2, source)
    z = two_prop_z(error_frames, frames, ref_fer * ref_n, ref_n)
    print(f"{method} FER {error_frames / frames:.6f} over {frames} frames vs "
          f"{source} row {ref_fer} over {ref_n}: z = {z:.3f}")
    return z


def validation_rows(stop_mode: str) -> dict:
    """The JAX package's FER waterfall on the TPU by (method, snr_db):
    docs/validation.json (frame stop mode) or docs/validation_group.json
    (group)."""
    name = {"frame": "validation.json", "group": "validation_group.json"}[stop_mode]
    return {(r["method"], r["snr_db"]): r for r in _read(name)}


def floor_rows() -> dict:
    """docs/floor_group.json's rows by (method, snr_db, stop_mode)."""
    return {(r["method"], r["snr_db"], r.get("stop_mode", "group")): r
            for r in _read("floor_group.json")}


def channel_parity_rows() -> dict:
    """docs/channel_parity.json: ``points`` (FER rows of both channel
    backends) and ``histograms``."""
    return _read("channel_parity.json")


def artifact_path(path) -> Path:
    """``path`` resolved; ValueError where it is one of the JAX package's
    artifacts, a file directly under docs/ (the port's lie under
    docs/torch_h100/)."""
    p = Path(path).resolve()
    if p.parent == DOCS.resolve():
        raise ValueError(f"{p} is the JAX package's artifact; the port writes "
                         f"under {OUT_DIR.relative_to(REPO)}/")
    return p


def write_artifact(path, text: str) -> Path:
    """Writes ``text`` to ``path`` (made whole before it replaces the old
    file), which ``artifact_path`` admits; returns the path."""
    p = artifact_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(text)
    tmp.replace(p)
    return p


def write_json(path, obj) -> Path:
    return write_artifact(path, json.dumps(obj, indent=1) + "\n")
