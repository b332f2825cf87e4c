#!/usr/bin/env python3
"""Time variants of the decoder template's main-path instance on one GPU.

    python3 scripts/decoder_variants.py [--reference OLD/stats_decoder.cu]

Builds kernel B (faid_tpu_torch/csrc/stats_decoder.cu with
csrc/decoder.cuh) as it stands and with each source variant below, each
into its own library under build/variants/, checks every variant's
outputs equal on the FAID_DTBF configuration in group stop mode at
4.0 dB and 3.6 dB (the DTBF tail runs there), and times its group-mode
FAID_DTBF instance at 4.0 dB, batch 2048, on the 50G-PON code, in turns
(six timings each, the order reversed every other turn).
``--reference`` adds an earlier stats_decoder.cu, with the decoder.cuh
it includes beside it, whose C entry has the form before frame mode
(style, BF kind, the eight buffers, the code arguments, batch, stream),
for example both files from ``git show <commit>:faid_tpu_torch/csrc/...``
of the commit before frame mode; it is built and timed beside the
variants.  Prints each variant's ptxas registers and spills.

Variants (text substitutions on csrc/decoder.cuh):
  as_is     the source as it stands
  unpacked  the row update keeps its contributions one to a register
  smem      the row's column offsets and shifts are read from shared
            memory instead of being kept from pass 1 to pass 2
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from faid_tpu_torch import load_code, sigma_for  # noqa: E402
from faid_tpu_torch.config import DecodeMethod, SimConfig  # noqa: E402
from faid_tpu_torch.ops import cuda_channel as cc  # noqa: E402
from faid_tpu_torch.ops import cuda_decoder as cd  # noqa: E402
from faid_tpu_torch.utils import kernels  # noqa: E402

CSRC = REPO / "faid_tpu_torch" / "csrc"
OUT = REPO / "build" / "variants"
BATCH, SEED = 2048, 20261016


def unpacked(h: str) -> str:
    """The row's contributions in an int array, one to a register."""
    subs = (("    uint32_t vcp[kMaxDeg / 4] = {};\n", "    int vc[kMaxDeg];\n"),
            ("        vcp[e >> 2] |= static_cast<uint32_t>(v & 0xff) << (8 * (e & 3));\n",
             "        vc[e] = v;\n"),
            ("        const int v = static_cast<int8_t>(vcp[e >> 2] >> (8 * (e & 3)));\n",
             "        const int v = vc[e];\n"))
    for old, new in subs:
        assert h.count(old) == 1, old
        h = h.replace(old, new)
    return h


def smem(h: str) -> str:
    old = "  const int odd = deg & 1;\n  for (int i = threadIdx.x; i < kGroup * z;"
    assert old in h
    h = h.replace(old, """  const int odd = deg & 1;
  __shared__ int s_off[kMaxDeg], s_sh[kMaxDeg];
  if (threadIdx.x < deg) {
    s_off[threadIdx.x] = a.ent_col[e0 + threadIdx.x] * z;
    s_sh[threadIdx.x] = a.ent_shift[e0 + threadIdx.x];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kGroup * z;""")
    idx = "enf[a.ent_col[e0 + e] * z + wrap(zz + a.ent_shift[e0 + e], z)]"
    assert h.count(idx) == 2
    return h.replace(idx, "enf[s_off[e] + wrap(zz + s_sh[e], z)]")


VARIANTS = {"as_is": lambda h: h, "unpacked": unpacked, "smem": smem}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared")


def build(reference: Path | None) -> dict:
    """name -> (library path, True for the reference's C entry)."""
    head = (CSRC / "decoder.cuh").read_text()
    stats = (CSRC / "stats_decoder.cu").read_text()
    jobs = {}
    for name, fn in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "decoder.cuh").write_text(fn(head))
        (d / "stats_decoder.cu").write_text(stats)
        for h in kernels.HEADERS:
            if h != "decoder.cuh":
                (d / h).write_text((CSRC / h).read_text())
        jobs[name] = (d / "lib.so", d / "stats_decoder.cu", False)
    if reference is not None:
        jobs["reference"] = (OUT / "reference.so", reference, True)
    nvcc = kernels._nvcc()
    procs = {n: subprocess.Popen([nvcc, *FLAGS, "-o", str(so), str(src)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, (so, src, _) in jobs.items()}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{log[-4000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            # the group-mode FAID_DTBF instance: (kStats, kFaid, kBfDtbf,
            # group), or the reference's (kStats, kFaid, kBfDtbf)
            if "Function properties" in line and (
                    "ILi0ELi2ELi2ELb0EE" in line
                    or (jobs[n][2] and "ILi0ELi2ELi2EEE" in line)):
                print(f"{n}: {lines[i + 1].strip()}; {lines[i + 2].strip()}")
    return {n: (so, ref) for n, (so, _, ref) in jobs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("scripts/decoder_variants.py needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(args.reference)
    dev = torch.device("cuda:0")
    code = load_code("50gpon")
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, mod_type=2,
                    quant_bits=4, scale=13.0, batch_per_device=BATCH,
                    fake_encode=True, channel_backend="fused",
                    stop_mode="group", seed=SEED)
    dcfg = cfg.decoder()
    t = cd.decoder_tables(code, dcfg, dev)
    en, hard = (torch.empty((BATCH, code.n_var), dtype=torch.int8, device=dev)
                for _ in range(2))
    msgs = torch.empty((BATCH, int(t.ent_col.numel()), code.z),
                       dtype=torch.int8, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    entry = {}
    for n, (so, ref) in libs.items():
        f = ctypes.CDLL(str(so)).faid_stats_decoder
        args = ctypes.POINTER(kernels.DecoderArgs)
        f.argtypes = ([I, I] + [P] * 8 + [args, I, P] if ref else
                      [I] * 3 + [P] * 9 + [I, args, I, P])
        f.restype = I
        entry[n] = (f, ref)

    def run(n, llr):
        f, ref = entry[n]
        out = [torch.empty(BATCH, dtype=torch.int32, device=dev) for _ in range(3)]
        stream = torch.cuda.current_stream().cuda_stream
        bufs = [llr.data_ptr(), en.data_ptr(), msgs.data_ptr(), hard.data_ptr(),
                None, *(o.data_ptr() for o in out)]
        cargs, _ = cd.code_args(t)
        if ref:
            st = f(cd.FAID, cd.BF_IDS["dtbf"], *bufs, cargs, BATCH, stream)
        else:     # group mode, the all-zero reference word
            st = f(cd.FAID, cd.BF_IDS["dtbf"], 0, *bufs, None, 0, cargs, BATCH,
                   stream)
        kernels.check(st)
        return out

    def ms(n, llr, reps=10):
        run(n, llr)
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            run(n, llr)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    llr = {}
    for snr, rnd in ((4.0, 9), (3.6, 1)):
        params = cc.threshold_ints(cfg, sigma_for(cfg, snr)).to(dev)
        llr[snr] = cc.quantile_channel(
            params, seed=SEED, rnd=rnd, batch=BATCH, n_var=code.n_var,
            n_info=code.n_info, mod_type=2, quant_bits=4)[0]
        want = [x.clone() for x in run("as_is", llr[snr])]
        for n in entry:
            same = all(torch.equal(a, b) for a, b in zip(run(n, llr[snr]), want))
            print(f"{n} at {snr} dB: outputs equal to as_is: {same}")
            if not same:
                sys.exit(1)
    times = {n: [] for n in entry}
    order = list(entry)
    for turn in range(6):
        for n in (order if turn % 2 == 0 else order[::-1]):
            times[n].append(ms(n, llr[4.0]))
    for n, v in times.items():
        print(f"kernel B FAID_DTBF at 4.0 dB, batch {BATCH}, {n}: "
              + " ".join(f"{x:.4f}" for x in v)
              + f" ms; mean {sum(v) / len(v):.4f} ms")


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"{time.perf_counter() - t0:.1f} s")
