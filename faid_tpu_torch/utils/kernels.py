"""Build and load the package's CUDA kernels.

The sources in ``faid_tpu_torch/csrc/`` are compiled at first use with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and linked into one shared library with a plain C interface,
bound with ``ctypes``.  The library lands in
``build/faid_tpu_torch/`` at the checkout's root (``.gitignore`` lists
``build/``), named by a hash of the sources and flags, so an edited
source builds anew and an unchanged one loads the cached library.
Nothing here runs at import time; a failed build raises.

Every kernel wrapper goes through one seam: ``kernel_device`` sends a
CPU tensor to the plain twin and picks the CUDA device to launch on,
``launch`` calls the entry point on that device's current stream, adds
one to the kernel's letter in ``launches`` and raises on a bad status.
Kernels B and F add each block's SM cycles of the prologue, MP and the
BF tail to their device's ``phase_clocks``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "faid_tpu_torch"
SOURCES = ("quantile_channel.cu", "stats_decoder.cu", "full_decoder.cu",
           "mp_decoder.cu", "fused_sim.cu", "qam_channel.cu", "decoder_nms.cu",
           "decoder_oms_selective.cu", "decoder_oms_offset.cu", "decoder_faid.cu",
           "decoder_faid_ef1.cu", "decoder_faid_ef2.cu", "message_stream.cu")
HEADERS = ("philox.cuh", "staircase.cuh", "decoder.cuh", "decoder_entry.cuh",
           "style_kernels.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int


class DecoderArgs(ctypes.Structure):
    """The decoder kernels' code tables and parameters, field for field
    csrc/decoder.cuh ``CodeArgs``; the entry points take a pointer."""

    _fields_ = ([(name, _P) for name in (
                    "row_ptr", "ent_col", "ent_shift", "vote_col", "vote_ptr",
                    "vote_row", "vote_shift", "lut", "lut_ef")]
                + [(name, _I) for name in (
                    "n_var", "n_info", "z", "n_rows", "n_entries",
                    "punct_start", "max_iter", "stop_early", "factor_1",
                    "factor_2", "offset", "sign_backtrack", "floor_err_count",
                    "floor_iter_thresh", "n_vote", "gamma", "bf_max_iter",
                    "delta", "l0_max", "l1_max", "alpha", "vote_cap",
                    "reliability")]
                + [("msg_off", _P), ("msg_words", _I)]
                + [(name, _P) for name in ("ef_ptr", "ef_row", "ef_shift")])


_ARGS = ctypes.POINTER(DecoderArgs)
# C signatures of the entry points; every pointer and the stream are
# c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    "faid_quantile_channel": (
        [_P, _P, _P, _P, _P] + [_I] * 7
        + [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, _P], _I),
    "faid_quantile_channel_map": (
        [_P] * 4 + [_I] * 5
        + [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, _P], _I),
    "faid_qam_channel": (
        [_P] * 4 + [_I] * 8
        + [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, _P], _I),
    "faid_stats_decoder": ([_I] * 4 + [_P] * 5 + [_I, _P, _ARGS, _I, _P, _P], _I),
    "faid_full_decoder": ([_I] * 4 + [_P] * 4 + [_ARGS, _I, _P, _P], _I),
    "faid_mp_decoder": ([_I] * 3 + [_P] * 3 + [_ARGS, _I, _P, _P], _I),
    "faid_fused_sim": (
        [_I] * 4 + [_P] * 8 + [_I] * 4
        + [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, _ARGS, _I, _P, _P], _I),
    "faid_message_bits": (
        [_P, _I, _I, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, _P], _I),
    "faid_error_string": ([_I], ctypes.c_char_p),
}
# the kernel each entry point launches, by its letter
KERNEL_LETTERS = {
    "faid_quantile_channel": "A", "faid_stats_decoder": "B",
    "faid_quantile_channel_map": "C", "faid_full_decoder": "D",
    "faid_mp_decoder": "E", "faid_fused_sim": "F", "faid_qam_channel": "G",
    "faid_message_bits": "M"}
# the decoder entries, which take the DecoderArgs and an info address
_TAKES_INFO = frozenset(n for n, (a, _) in _SIGNATURES.items() if _ARGS in a)
# launches of each kernel by its letter, counted by ``launch``
launches = collections.Counter()
# the decoder phases whose cycles kernels B and F count, in
# csrc/decoder.cuh's order (``phase_clocks``)
PHASES = ("prologue", "mp", "tail")
_phase_clocks: dict[torch.device, torch.Tensor] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfaid_tpu_torch_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) of the current library's build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is not cached."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        objs = [tmp.with_suffix(f".{Path(s).stem}.o") for s in SOURCES]

        def compile_one(src, obj):
            t = time.perf_counter()
            p = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True, check=False)
            return p.returncode, f"nvcc {src}: {time.perf_counter() - t:.1f} s\n{p.stdout}"

        # one nvcc per source, all at once; each log is headed by its wall time
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            done = list(pool.map(compile_one, SOURCES, objs))
        logs = [log for _, log in done]
        link = None
        if all(rc == 0 for rc, _ in done):
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True, check=False)
        for o in objs:
            o.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            tmp.unlink(missing_ok=True)
            out = "\n".join(logs) + ("" if link is None else link.stderr)
            raise RuntimeError(f"nvcc failed:\n{out}")
        so.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


# csrc/decoder.cuh kNoCluster: no cluster of a decoder launch fits
NO_CLUSTER = 0x10000


def check(status: int) -> None:
    """Raise if a kernel entry point returned a CUDA error, or found that
    no cluster of its launch fits on the device."""
    if status == NO_CLUSTER:
        raise RuntimeError("the decoder's launch fits no cluster on this device "
                           "(cudaOccupancyMaxActiveClusters gave 0)")
    if status:
        msg = library().faid_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({status})")


def kernel_device(t, *others) -> torch.device | None:
    """Where a wrapper runs ``t`` (a tensor or a device): None for the CPU
    (its plain twin), else the indexed CUDA device to launch its kernel
    on.  Raises ValueError for any other device, or where one of
    ``others`` (tensors or devices: the tables', the params') is on
    another device than ``t``."""
    dev = _device(t)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain twin for device {dev}")
    for o in others:
        if _device(o) != dev:
            raise ValueError(f"operands on {dev} and on {_device(o)}: a kernel "
                             "takes them on one device")
    return None if dev.type == "cpu" else dev


def _device(x) -> torch.device:
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == "cuda" and dev.index is None:
        # tensors created on "cuda" report the indexed current device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def phase_clocks(device) -> torch.Tensor | None:
    """The [3] int64 tensor on CUDA device ``device`` to which every launch
    of kernels B and F adds its blocks' SM cycles of the prologue (the
    channel or the LLR ingest), MP and the BF tail (``PHASES``); made at
    first use and never reset, so a reader takes differences.  None for
    the CPU, whose plain twins count no cycles."""
    dev = kernel_device(device)
    if dev is None:
        return None
    if dev not in _phase_clocks:
        _phase_clocks[dev] = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
    return _phase_clocks[dev]


def ptr(t: torch.Tensor | None):
    """A tensor's address for an entry point; None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def launch(entry: str, device: torch.device, *args, info=None) -> None:
    """Call entry point ``entry`` with ``args`` on ``device`` (as
    ``kernel_device`` gave it) and its current stream.  The decoder
    entries (B, D, E, F) take ``info`` last: an int[4] address to query
    the launch instead of making it, which counts nothing; every other
    call adds one to the kernel's letter in ``launches``."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        # the raw handle of the current stream, as torch's generated
        # kernels take it: no Stream object a call
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        if entry in _TAKES_INFO:
            status = fn(*args, stream, info)
        else:
            status = fn(*args, stream)
    if info is None:
        launches[KERNEL_LETTERS[entry]] += 1
    check(status)
