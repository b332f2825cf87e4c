"""Decoded info-bit throughput (Mbit/s) of the Monte-Carlo round on one
GPU, the port's counterpart of the repository's ``bench.py``:

    python -m faid_tpu_torch.bench [--encode fake|random] [--channel ...]

The workload is ``bench.py``'s, with its defaults: the 50G-PON code,
QPSK, the quantile channel (``fused``: kernel F takes the whole round),
FAID+DTBF (method 2, 6 MP iterations), group stop mode, batch 2048, 4.0
dB, the all-zero codeword (``--encode random``: messages from the
stream through the encoder).

Timing: one warm call of ``build_sim_loop`` (``--rounds`` rounds), then
``--calls`` calls with distinct first rounds, all queued, and one
synchronize at the end.  The time is read from CUDA events around the
queued calls; the host's wall time is printed beside it.

Prints ONE JSON line on stdout:
  {"metric", "value", "unit": "Mbit/s", "vs_baseline", "encode",
   "baseline_same_workload", "device"}
and a context line on stderr.  The metric's name is the port's own, so
no TPU figure of ``bench_baseline.json`` is compared with it; its
baselines live in ``faid_tpu_torch/bench_baseline.json``, one entry per
workload and card (encode, channel, stop mode, method, batch, SNR, the
device's name), each naming the card's power limit.  ``vs_baseline`` is
null where the file holds no entry for the run's key; the file is
written only under ``--update-baseline``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

METRIC = "faid_tpu_torch_decoded_info_throughput"
BASELINE_PATH = Path(__file__).parent / "bench_baseline.json"


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faid_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2048,
                    help="frames per round")
    ap.add_argument("--rounds", type=int, default=25,
                    help="rounds per build_sim_loop call")
    ap.add_argument("--calls", type=int, default=8,
                    help="timed calls, all queued before one synchronize")
    ap.add_argument("--snr", type=float, default=4.0)
    ap.add_argument("--method", type=int, default=2, choices=range(6))
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "plain"],
                    help="decoder backend (plain: --device cpu only)")
    ap.add_argument("--channel", type=str, default="fused",
                    choices=["xla", "fused"],
                    help="channel backend: fused, the quantile channel "
                         "(kernel F with the decoder); xla, the float chain")
    ap.add_argument("--stop-mode", default="group", choices=["frame", "group"])
    ap.add_argument("--encode", default="fake", choices=["fake", "random"],
                    help="fake: the all-zero codeword (the reference's "
                         "FAKE_ENCODE run path); random: messages from the "
                         "stream through the encoder")
    ap.add_argument("--update-baseline", action="store_true",
                    help="record this run as its workload's baseline")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch twins)")
    return ap


def bench_config(args):
    """The ``SimConfig`` of the flags' workload."""
    from .config import DecodeMethod, SimConfig

    return SimConfig(decode_method=DecodeMethod(args.method), max_iteration=6,
                     mod_type=2, batch_per_device=args.batch, seed=0,
                     stop_mode=args.stop_mode, fake_encode=args.encode == "fake",
                     channel_backend=args.channel, backend=args.backend)


def run(code, cfg, rounds: int, calls: int, snr: float, device) -> dict:
    """Times ``calls`` queued calls of ``build_sim_loop(code, cfg, rounds)``
    after a warm one.  Returns frames, the device seconds (CUDA events; on
    the CPU the wall), the host's wall seconds, Mbit/s of decoded info bits
    on the device seconds, and the counters summed over the timed calls."""
    from .sim.pipeline import build_sim_loop

    device = torch.device(device)
    cuda = device.type == "cuda"
    loop = build_sim_loop(code, cfg, rounds, device)
    sigma = cfg.sigma_at(snr)
    warm = loop(cfg.seed, sigma, 0)
    if cuda:
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    outs = [loop(cfg.seed, sigma, (c + 1) * rounds) for c in range(calls)]
    if cuda:
        end.record()
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1e3 if cuda else wall_s
    stats = {k: sum(o[k] for o in outs).tolist() for k in warm}
    frames = cfg.batch_per_device * rounds * calls
    return {"frames": frames, "device_s": device_s, "wall_s": wall_s,
            "mbit_s": frames * code.n_info / device_s / 1e6, "stats": stats}


def card(device) -> dict:
    """The device's name and, on a GPU, its power limit as nvidia-smi
    reports it."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"name": torch.cuda.get_device_name(index), "power_limit": limit}


def workload_key(cfg, snr: float, encode: str, device_name: str) -> str:
    return (f"encode={encode} channel={cfg.channel_backend} "
            f"stop_mode={cfg.stop_mode} method={int(cfg.decode_method)} "
            f"batch={cfg.batch_per_device} snr={snr:g} device={device_name}")


def result_line(measured: dict, cfg, snr: float, encode: str, dev: dict,
                baseline_path: Path = BASELINE_PATH,
                update: bool = False) -> dict:
    """The JSON line of a run; writes ``baseline_path`` only when
    ``update``."""
    base = (json.loads(baseline_path.read_text()) if baseline_path.exists()
            else {"metric": METRIC, "unit": "Mbit/s", "baselines": {}})
    key = workload_key(cfg, snr, encode, dev["name"])
    entry = base["baselines"].get(key)
    value = measured["mbit_s"]
    if update:
        base["baselines"][key] = {"value": value, "device": dev["name"],
                                  "power_limit": dev["power_limit"]}
        baseline_path.write_text(json.dumps(base, indent=2) + "\n")
    return {"metric": METRIC, "value": round(value, 3), "unit": "Mbit/s",
            "vs_baseline": round(value / entry["value"], 4) if entry else None,
            "encode": encode,
            "baseline_same_workload": round(entry["value"], 3) if entry else None,
            "device": dev}


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from .cli import _device
    from .code.qc_matrix import load_code
    from .sim.pipeline import _fuses

    device = _device(args.device)
    code = load_code("50gpon")
    cfg = bench_config(args)
    measured = run(code, cfg, args.rounds, args.calls, args.snr, device)
    dev = card(device)
    print(json.dumps(result_line(measured, cfg, args.snr, args.encode, dev,
                                 update=args.update_baseline)))
    s = measured["stats"]
    print(f"# channel={args.channel} stop_mode={args.stop_mode} "
          f"backend={args.backend} encode={args.encode} "
          f"fused_sim_kernel={_fuses(code, cfg)} frames={measured['frames']} "
          f"device_s={measured['device_s']:.4f} wall={measured['wall_s']:.4f}s "
          f"fer={s['error_frames']}/{s['test_frames']} "
          f"avg_it={s['mp_iters'] / max(s['test_frames'], 1):.2f} "
          f"device={dev['name']} power_limit={dev['power_limit']}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
