"""A rank of a small torch.distributed world, for the port's multi-process
checks (tests/test_torch_parallel.py on the CPU, chip_smoke.py phase 22
on one GPU).  It imports torch and faid_tpu_torch only: never JAX, never a
test module.

    RANK=r WORLD_SIZE=W MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_dist.py SPEC.json

SPEC.json:
  device   the rank's torch device ("cpu", "cuda:0")
  backend  the process group's backend (default gloo)
  out      a directory; the rank writes its results to ``rank<r>.json``
  loops    [{name, code: "toy" | "50gpon", cfg: SimConfig fields, rounds,
            snr, round0}]: ``build_sharded_sim_loop`` of each, its
           counters and its kernel launches
  runner   {code, cfg, max_rounds, collect}: ``MonteCarloRunner`` in the
           world, its checkpoint and files under ``<out>/rank<r>/``, the
           error dump if ``collect``, then a second runner resumed from
           the checkpoint (its rounds counted)
  timing   {code, cfg, rounds, snr, calls}: ``build_sim_loop`` and
           ``build_sharded_sim_loop`` timed in turns (CUDA events, ms a
           call), and ``all_reduce_counters`` of one call's counters (ms)
  cli      {toy, argv}: instead of the above, run ``python -m
           faid_tpu_torch.cli`` with ``argv`` plus ``--out <out>/rank<r>``
           (its own ``--multihost`` joins the world), on the toy code if
           ``toy``

It joins the world itself (except in ``cli`` mode).  Over gloo the
tensors stay on the rank's device, a GPU's too: gloo, unlike nccl, takes
several ranks on one card.  ``launch`` starts a world of these ranks and
returns their results.
"""

from __future__ import annotations

import datetime
import json
import os
import runpy
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from faid_tpu_torch import (MonteCarloRunner, build_sim_loop,  # noqa: E402
                            load_code)
from faid_tpu_torch.code.toy import toy_code  # noqa: E402
from faid_tpu_torch.config import DecodeMethod, SimConfig  # noqa: E402
from faid_tpu_torch.parallel.mesh import (  # noqa: E402
    all_reduce_counters, build_sharded_sim_loop, frame0, make_mesh)
from faid_tpu_torch.scripts._common import launch_counts  # noqa: E402
from faid_tpu_torch.sim import runner as runner_mod  # noqa: E402
from faid_tpu_torch.utils import kernels  # noqa: E402

TIMEOUT_S = 120


def launches(reset: bool = False) -> dict:
    counts = launch_counts()
    if reset:
        kernels.launches.clear()
    return counts


def sim_config(fields: dict) -> SimConfig:
    fields = dict(fields)
    if "decode_method" in fields:
        fields["decode_method"] = DecodeMethod(fields["decode_method"])
    return SimConfig(**fields)


def get_code(name: str):
    return toy_code() if name == "toy" else load_code(name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_loops(spec: dict, mesh) -> dict:
    out = {}
    for case in spec["loops"]:
        cfg = sim_config(case["cfg"])
        loop = build_sharded_sim_loop(get_code(case["code"]), cfg, mesh,
                                      case["rounds"])
        launches(reset=True)
        stats = loop(cfg.seed, cfg.sigma_at(case["snr"]), case["round0"])
        stats = {k: v.tolist() for k, v in stats.items()}
        out[case["name"]] = {"counters": stats, "launches": launches()}
    return out


def run_runner(spec: dict, mesh, rank_dir: Path) -> dict:
    job = spec["runner"]
    if mesh.rank == 0:
        rank_dir.mkdir(parents=True, exist_ok=True)
    cfg = sim_config(job["cfg"])
    code = get_code(job["code"])
    kw = dict(code=code, mesh=mesh, checkpoint_path=rank_dir / "checkpoint.json",
              max_rounds_per_snr=job["max_rounds"],
              temp_txt_path=rank_dir / "Temp.txt")
    launches(reset=True)
    t0 = time.perf_counter()
    r = MonteCarloRunner(cfg, **kw)
    r.run()
    sync(mesh.device)
    sweep_s = time.perf_counter() - t0
    sweep_launches = launches(reset=True)
    r.write_result_txt(rank_dir / "Result.txt")
    r.write_demod_txt(rank_dir / "demod.txt")
    r.write_itercount_txt(rank_dir / "iterCount.txt")
    dumped = r.collect_error_frames(rank_dir) if job["collect"] else 0
    sync(mesh.device)
    replay_launches = launches(reset=True)

    # a rerun resumes from rank 0's checkpoint: no round runs on any rank
    resumed = MonteCarloRunner(cfg, **kw)
    calls = []
    loop = resumed.loop
    resumed.loop = lambda *a: calls.append(a) or loop(*a)
    resumed.run()
    return {"sweep_s": sweep_s, "sweep_launches": sweep_launches,
            "replay_launches": replay_launches, "dumped": dumped,
            "counters": [res.counters for res in r.results],
            "resumed_counters": [res.counters for res in resumed.results],
            "resume_calls": len(calls), "resume_launches": launches()}


def _event_ms(fn, reps: int) -> float:
    """Mean CUDA-event ms of ``reps`` queued calls of fn."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_timing(spec: dict, mesh) -> dict:
    job = spec["timing"]
    cfg = sim_config(job["cfg"])
    code = get_code(job["code"])
    rounds, calls = job["rounds"], job["calls"]
    sigma = cfg.sigma_at(job["snr"])
    sharded = build_sharded_sim_loop(code, cfg, mesh, rounds)
    plain = build_sim_loop(code, cfg, rounds, mesh.device,
                           frame0=frame0(cfg, mesh))
    loops = {"plain": lambda: plain(cfg.seed, sigma, 100),
             "sharded": lambda: sharded(cfg.seed, sigma, 100)}
    for fn in loops.values():
        fn()
    ms = {"plain": [], "sharded": []}
    for name in ("plain", "sharded", "sharded", "plain"):
        ms[name].append(_event_ms(loops[name], calls))
    stats = plain(cfg.seed, sigma, 100)
    all_reduce_counters(stats)          # nccl sets up its communicator here
    reduce_ms = _event_ms(lambda: all_reduce_counters(stats), 20)
    t0 = time.perf_counter()
    for _ in range(20):
        all_reduce_counters(stats)["test_frames"].item()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    return {"plain_ms": ms["plain"], "sharded_ms": ms["sharded"],
            "all_reduce_ms": reduce_ms, "all_reduce_host_ms": host_ms,
            "values": sum(v.numel() for v in stats.values())}


def run_cli(spec: dict, rank_dir: Path) -> dict:
    job = spec["cli"]
    if job["toy"]:
        runner_mod.load_code = lambda name: toy_code()
    sys.argv = ["faid_tpu_torch.cli", *job["argv"], "--out", str(rank_dir)]
    launches(reset=True)
    try:
        runpy.run_module("faid_tpu_torch.cli", run_name="__main__")
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    return {"rc": rc, "launches": launches()}


def main() -> int:
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(os.environ["RANK"])
    out = Path(spec["out"])
    rank_dir = out / f"rank{rank}"
    torch.set_num_threads(1)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "cli" in spec:
        result = {"cli": run_cli(spec, rank_dir)}
    else:
        dist.init_process_group(
            spec.get("backend", "gloo"), init_method="env://",
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            mesh = make_mesh(device)
            result = {"rank": mesh.rank, "size": mesh.size}
            if spec.get("loops"):
                result["loops"] = run_loops(spec, mesh)
            if spec.get("runner"):
                result["runner"] = run_runner(spec, mesh, rank_dir)
            if spec.get("timing"):
                result["timing"] = run_timing(spec, mesh)
        finally:
            dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    return 0


def result_rows(text: str) -> list:
    """Result.txt's rows without the Time(s) column."""
    return [r.split()[:-1] for r in text.splitlines()]


def dump_as_world1(text: str, batch: int) -> list:
    """An error dump's lines with ``dev d ... frame f`` written as ``dev 0
    ... frame d * batch + f``: the same frame of a one-rank run at W *
    batch."""
    lines = []
    for line in text.splitlines():
        tag, rest = line.split(" : ")
        w = tag.split()
        if (w[2], w[6]) != ("dev", "frame"):
            raise ValueError(f"not a dump line: {line}")
        w[3], w[7] = "0", str(int(w[3]) * batch + int(w[7]))
        lines.append(" ".join(w) + " : " + rest)
    return lines


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(spec: dict, world: int, timeout_s: float,
           torchrun: bool = False) -> list[dict]:
    """Runs ``world`` ranks of this module on ``spec`` (its ``out``
    directory is made) and returns their results in rank order: W
    processes with torchrun's variables set here, or, with ``torchrun``,
    ``python -m torch.distributed.run --standalone``.  Raises if a rank
    fails or the world outlasts ``timeout_s`` seconds (every process is
    then killed)."""
    out = Path(spec["out"])
    out.mkdir(parents=True, exist_ok=True)
    path = out / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    me = str(Path(__file__).resolve())
    if torchrun:
        cmds = [([sys.executable, "-m", "torch.distributed.run", "--standalone",
                  f"--nproc-per-node={world}", me, str(path)], env)]
    else:
        base = dict(env, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(free_port()))
        cmds = [([sys.executable, me, str(path)],
                 dict(base, RANK=str(r), LOCAL_RANK=str(r)))
                for r in range(world)]
    procs, logs = [], []
    for i, (cmd, e) in enumerate(cmds):
        log = open(out / f"proc{i}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=e, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = "\n".join((out / f"proc{i}.log").read_text()[-3000:]
                          for i in range(len(procs)))
        raise RuntimeError(f"a rank failed or timed out (exit codes {rcs}):\n"
                           f"{tails}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


if __name__ == "__main__":
    raise SystemExit(main())
