"""Build and load the package's CUDA kernels.

The sources in ``faid_tpu_torch/csrc/`` are compiled at first use with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and linked into one shared library with a plain C interface,
bound with ``ctypes``.  The library lands in
``build/faid_tpu_torch/`` at the checkout's root (``.gitignore`` lists
``build/``), named by a hash of the sources and flags, so an edited
source builds anew and an unchanged one loads the cached library.
Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "faid_tpu_torch"
SOURCES = ("quantile_channel.cu", "stats_decoder.cu", "full_decoder.cu",
           "mp_decoder.cu", "fused_sim.cu", "qam_channel.cu", "decoder_nms.cu",
           "decoder_oms_selective.cu", "decoder_oms_offset.cu", "decoder_faid.cu",
           "decoder_faid_ef1.cu", "decoder_faid_ef2.cu")
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
    "faid_stats_decoder": ([_I] * 4 + [_P] * 5 + [_I, _ARGS, _I, _P, _P], _I),
    "faid_full_decoder": ([_I] * 4 + [_P] * 4 + [_ARGS, _I, _P, _P], _I),
    "faid_mp_decoder": ([_I] * 3 + [_P] * 3 + [_ARGS, _I, _P, _P], _I),
    "faid_fused_sim": (
        [_I] * 4 + [_P] * 7 + [_I] * 4
        + [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, _ARGS, _I, _P, _P], _I),
    "faid_error_string": ([_I], ctypes.c_char_p),
}


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
