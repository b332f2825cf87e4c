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
it includes beside it, whose C entry has the form of the global-memory
template (style, BF kind, frame mode, the nine buffers, ref_stride, the
code arguments, batch, stream), for example both files from ``git show
<commit>:faid_tpu_torch/csrc/...`` of a commit before the cluster
design; it is built and timed beside the variants (its code arguments
are a prefix of today's).  Prints each variant's ptxas registers and
spills.

Variants (text substitutions on csrc/decoder.cuh):
  as_is       the source as it stands (1024 threads a block)
  threads512  512 threads a block (up to 128 registers a thread)
  lut_reg     the FAID LUT rows packed into a register per row update
  rt_smem     the row's (column * z, shift) pairs staged in shared memory
  word_flag   group mode's sweep stops in the whole cluster at the first
              unsatisfied check (three rotating cluster_or slots)
  all_three   lut_reg, rt_smem and word_flag
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


def threads(n: int):
    def sub(h: str) -> str:
        old = "constexpr int kThreads = 1024;"
        assert h.count(old) == 1
        return h.replace(old, f"constexpr int kThreads = {n};")
    return sub


def subst(h: str, subs) -> str:
    for old, new in subs:
        assert h.count(old) == 1, old
        h = h.replace(old, new)
    return h


def lut_reg(h: str) -> str:
    """The FAID LUT rows packed 4 bits an entry into a register per row
    update, in place of a shared-memory read per edge and pass."""
    return subst(h, (
        ("  for (int i = threadIdx.x; i < kF * z; i += kThreads) {\n    const int f = i / z, zz = i - f * z;\n    if (kFrame && !s_act[f]) continue;\n    int8_t* enf",
         "  uint32_t lutw = 0, lutw_ef = 0;\n  if constexpr (kIsFaid<kStyle>) {\n#pragma unroll\n    for (int j = 0; j < 8; ++j) {\n      lutw |= static_cast<uint32_t>(s_lut[j]) << (4 * j);\n      if constexpr (kStyle == kFaidEf1) lutw_ef |= static_cast<uint32_t>(s_lut_ef[j]) << (4 * j);\n    }\n  }\n  for (int i = threadIdx.x; i < kF * z; i += kThreads) {\n    const int f = i / z, zz = i - f * z;\n    if (kFrame && !s_act[f]) continue;\n    int8_t* enf"),
        ("    const int* lut = s_lut;\n    if constexpr (kStyle == kFaidEf1) lut = eff ? s_lut_ef : s_lut;\n",
         "    const uint32_t lw = kStyle == kFaidEf1 && eff ? lutw_ef : lutw;\n"),
        ("          mag = lut[min(abs(v), 7)];", "          mag = static_cast<int>((lw >> (4 * min(abs(v), 7))) & 15u);"),
        ("        if constexpr (kIsFaid<kStyle>) cmp = lut[min(abs(v), 7)];",
         "        if constexpr (kIsFaid<kStyle>) cmp = static_cast<int>((lw >> (4 * min(abs(v), 7))) & 15u);")))


def rt_smem(h: str) -> str:
    """The row's (column * z, shift) pairs staged in shared memory, one
    extra barrier a row, in place of two uniform global loads per edge."""
    return subst(h, (
        ("  const int m0 = __ldg(a.msg_off + r), wr = (__ldg(a.msg_off + r + 1) - m0) / z;\n",
         "  const int m0 = __ldg(a.msg_off + r), wr = (__ldg(a.msg_off + r + 1) - m0) / z;\n  __shared__ int s_rt[kMaxDeg];\n  if (threadIdx.x < deg)\n    s_rt[threadIdx.x] = (__ldg(a.ent_col + e0 + threadIdx.x) * z << 16) | __ldg(a.ent_shift + e0 + threadIdx.x);\n  __syncthreads();\n"),
        ("        idx[e] = vn_index(a, e0 + e, zz);\n",
         "        idx[e] = (s_rt[e] >> 16) + wrap(zz + (s_rt[e] & 0xffff), z);\n")))


OLD_OR = """  if (mine) s_or[parity] = 1;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  int any = 0;
  if (threadIdx.x < kCl) any = *cl.map_shared_rank(s_or + parity, threadIdx.x);
  if (threadIdx.x == 0) s_or[parity ^ 1] = 0;
  parity ^= 1;
  return __syncthreads_or(any);
"""
NEW_OR = """  if (mine) s_or[parity] = 1;
  __syncthreads();
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x < kCl && s_or[parity]) *cl.map_shared_rank(s_or + parity, threadIdx.x) = 1;
  if (threadIdx.x == 0) s_or[parity == 2 ? 0 : parity + 1] = 0;
  cl.sync();
  const bool any = static_cast<volatile int*>(s_or)[parity];
  parity = parity == 2 ? 0 : parity + 1;
  return any;
"""


def word_flag(h: str) -> str:
    """Three rotating slots; a block that finds its frames dirty marks
    every block's slot of the word (distributed shared memory), so the
    sweep stops in the whole cluster at the first unsatisfied check, and
    each block reads only its own slot after the cluster barrier."""
    return subst(h, (
        (OLD_OR, NEW_OR),
        ("  __shared__ int s_or[2];", "  __shared__ int s_or[3];"),
        ("  if (threadIdx.x < 2) s_or[threadIdx.x] = 0;", "  if (threadIdx.x < 3) s_or[threadIdx.x] = 0;"),
        ("    if (found) *seen = 1;\n",
         "    if (found) {\n      cg::cluster_group cl = cg::this_cluster();\n"
         "      for (int b = 0; b < kGroup / kF; ++b)\n"
         "        *cl.map_shared_rank(const_cast<int*>(seen), b) = 1;\n    }\n")))


VARIANTS = {"as_is": lambda h: h, "threads512": threads(512),
            "lut_reg": lut_reg, "rt_smem": rt_smem,
            "word_flag": word_flag,
            "all_three": lambda h: word_flag(rt_smem(lut_reg(h)))}
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
            # group, 4-bit), or the reference's (kStats, kFaid, kBfDtbf,
            # group)
            if "Function properties" in line and (
                    "ILi0ELi2ELi2ELb0ELi4EE" in line
                    or (jobs[n][2] and "ILi0ELi2ELi2ELb0EE" in line)):
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
    # the reference's global-memory scratch
    en, hard = (torch.empty((BATCH, code.n_var), dtype=torch.int8, device=dev)
                for _ in range(2))
    msgs = torch.empty((BATCH, int(t.ent_col.numel()), code.z),
                       dtype=torch.int8, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    entry = {}
    for n, (so, ref) in libs.items():
        f = ctypes.CDLL(str(so)).faid_stats_decoder
        args = ctypes.POINTER(kernels.DecoderArgs)
        f.argtypes = ([I] * 3 + [P] * 9 + [I, args, I, P] if ref else
                      kernels._SIGNATURES["faid_stats_decoder"][0])
        f.restype = I
        entry[n] = (f, ref)

    def run(n, llr):
        f, ref = entry[n]
        out = [torch.empty(BATCH, dtype=torch.int32, device=dev) for _ in range(3)]
        stream = torch.cuda.current_stream().cuda_stream
        cargs, _ = cd.code_args(t)
        # group mode, the all-zero reference word
        if ref:
            st = f(cd.FAID, cd.BF_IDS["dtbf"], 0, llr.data_ptr(), en.data_ptr(),
                   msgs.data_ptr(), hard.data_ptr(), None,
                   *(o.data_ptr() for o in out), None, 0, cargs, BATCH, stream)
        else:
            st = f(cd.FAID, cd.BF_IDS["dtbf"], 0, t.plan.msg_bits, llr.data_ptr(),
                   *(o.data_ptr() for o in out), None, 0, cargs, BATCH, stream, None)
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
