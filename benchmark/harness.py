"""One run of a cell: the program's campaign runner at the cell's SNR
point for a measured window, then the readings, the reference check and
the result line.

A run is one process per chip.  Rank 0 is the process that ``run.py``
starts; on a cell of several chips it starts the other ranks as
processes of their own (``--rank r``), which join one torch.distributed
world on a free localhost port and run the runner's ``--multihost`` path
(parallel/mesh.py): rank r draws frames r * batch .. of every round and
the counters are summed over the ranks every sync.  Rank 0 waits for
each, reads what each left in the run's directory, and prints the line.

The window: ``MonteCarloRunner.run_point`` at the CLI's cadence
(``rounds_per_sync`` rounds a loop call), with its checkpoint and
``Temp.txt`` in a directory of its own under ``TMPDIR``, its stopping
rule and budgets out of reach.  The benchmark wraps the runner's loop
call, which is where a sync starts; it ends the window at the start of
the sync after the first whole sync that starts at or past ``--seconds``
(rank 0 decides, the others read its decision from the run's directory
before the sync that it names).  One warm sync before the window runs
at a stream round no window round uses.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import random
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import tracing
from .registry import ROOT, Registry

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "faid_tpu")
# what a sync of the runner reports, and the check compares
COUNTERS = ("test_frames", "error_bits", "error_frames", "lt3_frames",
            "mod_error_bits", "mod_error_symbols", "mod_error_frames",
            "mp_iters", "bf_rounds", "mp_hist", "bf_hist")
# the runner's stopping rule and budgets, out of the window's reach
NEVER = 2**62
MAX_ROUNDS = 2**31
# a rehearsal's frames a round on the toy code
REHEARSAL_BATCH = 64
# syncs of the window the check compares, drawn from the seed
CHECK_SYNCS = 1
# a trace run's profiled syncs: CUDA activity only, then with the host's
TRACE_SYNCS = 16
BREAKDOWN_SYNCS = 4


class StopStretch(Exception):
    """Raised at a loop call to end a stretch of the runner's syncs."""


@dataclasses.dataclass
class Options:
    workload: str
    seed: int
    seconds: float
    trace: bool
    rank: int = 0
    world: int = 1
    port: int = 0
    rundir: str = ""
    rehearse: bool = False


class Syncs:
    """The runner's loop call, wrapped: each sync's host times, the
    counters after it, and the end of each stretch of syncs.

    Times (``time.perf_counter``) of sync i: ``calls[i]`` when the runner
    calls the loop, ``returns[i]`` when the loop returns (the round's work
    is enqueued), ``reports[i]`` when the runner hands the counters to
    the progress callback (it has read them from the device); the sync
    lasts until the next loop call, so the runner's ``Temp.txt`` and
    checkpoint writes fall inside it."""

    def __init__(self, loop, opts: Options, stop_file: Path):
        self.inner = loop
        self.opts, self.stop_file = opts, stop_file
        self.calls, self.returns, self.reports, self.snapshots = [], [], [], []
        self.stop_at = None       # the sync index whose loop call stops
        self.deadline = None      # the window's, on rank 0's clock
        self.ends = []            # (first sync, stop sync, stop time) a stretch
        self.first = 0
        self.on_call = None       # hook(sync index) at each loop call
        self.phases = tracing.Phases()

    def start(self, n_syncs: int | None = None, seconds: float | None = None):
        """Arms the next stretch: ``n_syncs`` syncs, or a window of
        ``seconds``."""
        self.first = len(self.calls)
        self.stop_at = None if n_syncs is None else self.first + n_syncs
        self.deadline = seconds

    def loop(self, seed, sigma, round0):
        now = time.perf_counter()
        k = len(self.calls)
        self.phases.enter(None)
        if self.on_call is not None:
            self.on_call(k)
        if self.stop_at is None and self.deadline is not None and k > self.first:
            if self.opts.rank == 0:
                if now - self.calls[self.first] >= self.deadline:
                    self.stop_at = k + 1
                    if self.opts.world > 1:
                        tmp = self.stop_file.with_suffix(".tmp")
                        tmp.write_text(str(self.stop_at))
                        tmp.replace(self.stop_file)
            elif self.stop_file.exists():
                self.stop_at = int(self.stop_file.read_text())
        if self.stop_at is not None and k >= self.stop_at:
            if k > self.stop_at:
                raise RuntimeError(f"sync {k} ran past the stop at {self.stop_at}")
            self.ends.append((self.first, k, now))
            raise StopStretch
        self.calls.append(now)
        self.phases.enter("loop_call")
        out = self.inner(seed, sigma, round0)
        self.returns.append(time.perf_counter())
        self.phases.enter("counter_wait")
        return out

    def progress(self, snr_db, counters):
        self.reports.append(time.perf_counter())
        self.snapshots.append(counters)
        self.phases.enter("runner_writes")

    def durations(self, i: int) -> list[float]:
        """Each sync's seconds in stretch i: from its loop call to the next."""
        a, b, t = self.ends[i]
        starts = self.calls[a:b] + [t]
        return [y - x for x, y in zip(starts, starts[1:])]

    def counters(self, a: int, b: int) -> dict:
        """The counters of syncs a .. b - 1 (the runner's sums)."""
        hi = self.snapshots[b - 1]
        lo = self.snapshots[a - 1] if a > 0 else None
        return {k: (hi[k] if lo is None else _sub(hi[k], lo[k])) for k in COUNTERS}


def _sub(a, b):
    return [x - y for x, y in zip(a, b)] if isinstance(a, list) else a - b


def _gap(a, b) -> int:
    """The absolute gap of two counters, summed over a histogram's
    buckets."""
    if isinstance(a, list):
        if len(a) != len(b):
            return NEVER
        return sum(abs(x - y) for x, y in zip(a, b))
    return abs(a - b)


def sim_config(config: dict, cell: dict, seed: int, rehearse: bool):
    """The program's ``SimConfig`` of the cell: the configuration's
    settings at the cell's one SNR point, stopping rule and budgets out
    of reach."""
    from faid_tpu_torch.config import DecodeMethod, SimConfig

    s = dict(config["settings"])
    s.pop("code")
    if rehearse:
        s["batch_per_device"] = REHEARSAL_BATCH
    return SimConfig(
        snr_start=cell["snr_db"], snr_pass=1.0, snr_end=cell["snr_db"] + 0.5,
        decode_method=DecodeMethod(s.pop("decode_method")),
        fake_encode=cell["encode"] == "zero_word", seed=seed,
        rounds_per_sync=cell["rounds_per_sync"], min_frames=NEVER,
        min_frame_errors=NEVER, max_frames_per_snr=None,
        giveup_zero_error_frames=None, backend="auto", **s)


def sample_syncs(seed: int, n_syncs: int, n: int) -> list[int]:
    """The syncs the check compares, drawn from the seed."""
    return sorted(random.Random(seed * 7919 + 17).sample(range(n_syncs),
                                                         min(n, n_syncs)))


def _codes(config: dict, rehearse: bool):
    """(the program's code, the reference's code) of the configuration;
    a rehearsal's toy code, the reference's made from its arrays."""
    from faid_tpu_torch.code.qc_matrix import load_code

    from .reference.code import code_from_arrays
    from .reference.code import load_code as ref_load_code

    if rehearse:
        from faid_tpu_torch.code.toy import toy_code

        c = toy_code()
        return c, code_from_arrays(c.name, c.z, c.n_var, c.n_chk, c.block_cols,
                                   c.shifts, c.degrees, c.puncture_tail)
    name = config["settings"]["code"]
    return load_code(name), ref_load_code(name)


@contextlib.contextmanager
def stage_spans(on: bool):
    """Spans around the program's stages inside a round, for a trace run:
    the message stream, the encoder, the QAM path's ModCalErr reduction
    and the all-reduce of the counters, whose host seconds a call it
    yields (empty where ``on`` is false).  Each wraps a module attribute
    that the program looks up when it calls or builds the stage; no file
    of the program changes, and each is restored on the way out."""
    host: list[float] = []
    if not on:
        yield host
        return
    from faid_tpu_torch.ops import philox
    from faid_tpu_torch.parallel import mesh
    from faid_tpu_torch.sim import pipeline

    saved = [(philox, "message_bits"), (pipeline, "make_encode_fn"),
             (pipeline, "mod_stats"), (mesh, "all_reduce_counters")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    make_encode, reduce = pipeline.make_encode_fn, mesh.all_reduce_counters

    def timed_reduce(stats):
        t = time.perf_counter()
        out = reduce(stats)
        host.append(time.perf_counter() - t)
        return out

    philox.message_bits = tracing.stage_span(philox.message_bits, "message_stream")
    pipeline.make_encode_fn = lambda *a, **k: tracing.stage_span(
        make_encode(*a, **k), "encoder")
    pipeline.mod_stats = tracing.stage_span(pipeline.mod_stats, "mod_stats")
    mesh.all_reduce_counters = tracing.stage_span(timed_reduce, "all_reduce")
    try:
        yield host
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _profile_stretch(runner, syncs: Syncs, n_active: int, cpu: bool,
                     device) -> dict:
    """Profiles ``n_active`` syncs of the runner after one warm-up sync
    under the profiler: the events and the stretch's syncs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if cpu or not acts:
        acts.append(ProfilerActivity.CPU)
    got = {}

    def ready(p):
        got["events"] = p.events()

    syncs.phases.on = cpu
    syncs.start(n_syncs=1 + n_active)
    with profile(activities=acts, on_trace_ready=ready,
                 schedule=schedule(wait=0, warmup=1, active=n_active, repeat=1)) as prof:
        first = len(syncs.calls)
        syncs.on_call = lambda k: prof.step() if k > first else None
        try:
            runner.run_point(progress=syncs.progress)
        except StopStretch:
            pass
        finally:
            syncs.on_call = None
            syncs.phases.on = False
            syncs.phases.enter(None)
    a, b, t = syncs.ends[-1]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"events": got.get("events", []), "first": a + 1, "stop": b,
            "window_s": t - syncs.calls[a + 1]}


def run_rank(opts: Options, t_start: float, fault=None) -> dict:
    """Rank ``opts.rank``'s part of a run; ``fault(runner)``, where given,
    breaks the program under the window (the benchmark's own tests)."""
    import torch

    reg = Registry()
    cell = reg.cell(opts.workload)
    config = reg.config(cell["config"])
    if opts.rehearse:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", opts.rank)
        torch.cuda.set_device(device)
    rundir = Path(opts.rundir)
    if opts.world > 1:
        import datetime

        import torch.distributed as dist

        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{opts.port}", rank=opts.rank,
            world_size=opts.world, timeout=datetime.timedelta(seconds=120))
    try:
        with stage_spans(opts.trace) as reduce_host:
            return _run_rank(opts, t_start, fault, cell, config, device, rundir,
                             reduce_host)
    finally:
        gc.unfreeze()
        if opts.world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run_rank(opts, t_start, fault, cell, config, device, rundir,
              reduce_host) -> dict:
    import torch

    from faid_tpu_torch.ops import philox
    from faid_tpu_torch.parallel.mesh import make_mesh
    from faid_tpu_torch.sim.runner import MonteCarloRunner

    cuda = device.type == "cuda"
    cfg = sim_config(config, cell, opts.seed, opts.rehearse)
    code, ref_code = _codes(config, opts.rehearse)
    if cuda:
        from faid_tpu_torch.utils import kernels

        kernels.library()
    lead = opts.rank == 0
    # every rank names the files, as the CLI's ranks do; rank 0 alone
    # reads and writes them
    runner = MonteCarloRunner(
        cfg, code=code, mesh=make_mesh(device),
        checkpoint_path=rundir / "checkpoint.json",
        max_rounds_per_snr=MAX_ROUNDS, temp_txt_path=rundir / "Temp.txt")
    if fault is not None:
        fault(runner)
    syncs = Syncs(runner.loop, opts, rundir / "stop")
    runner.loop = syncs.loop
    sigma = cfg.sigma_at(cell["snr_db"])
    # the warm sync: a stream round of another SNR point than the window's
    warm = syncs.inner(cfg.seed, sigma, philox.stream_round(1, 0))
    {k: v.tolist() for k, v in warm.items()}
    # what set-up made stays: the collector's passes in the window skip it
    gc.collect()
    gc.freeze()
    syncs.start(seconds=opts.seconds)
    try:
        runner.run_point(progress=syncs.progress)
        raise RuntimeError("the runner finished its point inside the window")
    except StopStretch:
        pass
    a, b, t_end = syncs.ends[0]
    out = {"rank": opts.rank, "setup_s": syncs.calls[a] - t_start,
           "window_s": t_end - syncs.calls[a], "durations": syncs.durations(0),
           "loop_s": [syncs.returns[i] - syncs.calls[i] for i in range(a, b)],
           "writes_s": [(syncs.calls[i + 1] if i + 1 < b else t_end)
                        - syncs.reports[i] for i in range(a, b)],
           "syncs": b - a, "batch": cfg.batch_per_device,
           "rounds_per_sync": cfg.rounds_per_sync}
    if cuda:
        torch.cuda.synchronize(device)
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        out["kind"] = torch.cuda.get_device_name(device)
    if opts.trace:
        # a rehearsal profiles a sync: the CPU's plain path is thousands of
        # operators a round
        n_a, n_b = (1, 1) if opts.rehearse else (TRACE_SYNCS, BREAKDOWN_SYNCS)
        seg_a = _profile_stretch(runner, syncs, n_a, False, device)
        out["profile"] = {
            "window_s": seg_a["window_s"], "first": seg_a["first"],
            "stop": seg_a["stop"], **tracing.device_summary(seg_a["events"])}
        del seg_a
        seg_b = _profile_stretch(runner, syncs, n_b, True, device)
        out["breakdown"] = tracing.breakdown(seg_b["events"])
        del seg_b
        # the window's all-reduces: the warm sync made the first
        out["allreduce_host_s"] = reduce_host[1:1 + (b - a)]
        if lead:
            p = out["profile"]
            out["profile"]["counters"] = syncs.counters(p["first"], p["stop"])
    n_window = b - a
    checked = sample_syncs(opts.seed, n_window, CHECK_SYNCS)
    program = [syncs.counters(k, k + 1) for k in checked]
    window_counters = syncs.counters(a, b)
    del runner, syncs, warm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["checked_syncs"] = checked
    t = time.perf_counter()
    out["reference"] = reference_counters(ref_code, config, cell, opts, device,
                                          checked)
    out["reference_s"] = time.perf_counter() - t
    if lead:
        out["program"] = program
        out["window_counters"] = window_counters
    return out


def reference_counters(ref_code, config, cell, opts, device, checked,
                       threshold_dtype=None) -> list[dict]:
    """The reference's counters of this rank's frames in each checked
    sync, in the order of ``checked``; sigma, as everything else, worked
    out again from the cell's SNR."""
    import torch

    from .reference.config import Deployment
    from .reference.round import RoundReference

    dep = Deployment.from_config(config)
    if opts.rehearse:
        dep = dataclasses.replace(dep, batch_per_device=REHEARSAL_BATCH)
    ref = RoundReference(ref_code, dep, device,
                         fake_encode=cell["encode"] == "zero_word",
                         threshold_dtype=threshold_dtype or torch.float32)
    rps, batch = cell["rounds_per_sync"], dep.batch_per_device
    sigma = dep.sigma_at(cell["snr_db"])
    with torch.no_grad():
        return [ref.sync_counters(opts.seed, sigma, 0, k * rps, rps,
                                  opts.rank * batch, batch) for k in checked]


def judge(ranks: list[dict]) -> tuple[int, dict]:
    """The check: (counter_gap, the gaps by counter).  counter_gap is the
    largest absolute gap between the runner's counts and the reference's
    over every counter and histogram bucket of the checked syncs (the
    reference summed over the ranks' frames), and the window's frames
    against the rounds it ran."""
    from .reference.round import add

    lead = ranks[0]
    if not lead["checked_syncs"]:
        raise RuntimeError("the check drew no sync")
    if any(r["checked_syncs"] != lead["checked_syncs"] for r in ranks):
        raise RuntimeError("the ranks checked different syncs")
    gaps = {}
    for i, k in enumerate(lead["checked_syncs"]):
        ref = None
        for r in ranks:
            ref = r["reference"][i] if ref is None else add(ref, r["reference"][i])
        prog = lead["program"][i]
        for name in COUNTERS:
            gaps[f"sync{k}.{name}"] = _gap(prog[name], ref[name])
    frames = (lead["syncs"] * lead["rounds_per_sync"] * lead["batch"] * len(ranks))
    gaps["window.test_frames"] = abs(lead["window_counters"]["test_frames"] - frames)
    return max(gaps.values()), gaps


def p95(values: list[float]) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94]


@dataclasses.dataclass
class Readings:
    """What a per-layer metric reads: the cell, its configuration, each
    rank's run (``ranks``; rank 0's first), the device and the
    benchmark's reference code (the program's is never handed over)."""

    cell: dict
    config: dict
    ranks: list
    device: object
    ref_code: object
    seed: int
    rehearse: bool

    @property
    def lead(self) -> dict:
        return self.ranks[0]

    @property
    def profiled(self) -> bool:
        return "profile" in self.lead and not self.rehearse

    def profile_rounds(self) -> int:
        p = self.lead["profile"]
        return (p["stop"] - p["first"]) * self.lead["rounds_per_sync"]

    def ops(self, match, ranks=None) -> tuple[int, float]:
        """(count, device seconds) over every rank (or those of ``ranks``)
        of the profiled operations whose name ``match(name)`` accepts."""
        n, s = 0, 0.0
        for r in self.ranks if ranks is None else ranks:
            for name, (c, sec) in r["profile"]["ops"].items():
                if match(name):
                    n, s = n + c, s + sec
        return n, s

    def launch_seconds(self, match, per_rank: int) -> float | None:
        """The device seconds of ``per_rank`` launches a rank of the
        operations that ``match(name)`` accepts, summed over the ranks.
        The profiler now and then drops an event, more often with several
        processes on the host: a rank's launches that it dropped count at
        the mean device time of those it kept.  None where a rank kept
        fewer than nine tenths of them, or more than ``per_rank``."""
        total = 0.0
        for r in self.ranks:
            n, s = self.ops(match, [r])
            if n < 0.9 * per_rank or n > per_rank or s <= 0:
                return None
            total += s / n * per_rank
        return total


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stderr_fd():
    """This process's standard error for a child's output, where it is a
    file; else the child keeps its own."""
    try:
        return sys.stderr.fileno()
    except (AttributeError, OSError, ValueError):
        return None


def _child_argv(opts: Options, rank: int) -> list[str]:
    argv = [sys.executable, str(Path(__file__).with_name("run.py")),
            "--workload", opts.workload, "--seed", str(opts.seed),
            "--seconds", str(opts.seconds), "--trace", str(int(opts.trace)),
            "--rank", str(rank), "--world", str(opts.world),
            "--port", str(opts.port), "--rundir", opts.rundir]
    return argv + (["--rehearse"] if opts.rehearse else [])


def build_kernels() -> None:
    """Builds the program's kernel library in a process of its own where the
    checkout has none yet; every rank then loads it.  A run whose own
    process had built it read 2-8% slower in its window than the runs after
    it; after a build in another process the first run read as the rest."""
    from faid_tpu_torch.utils import kernels

    if not kernels.library_path().exists():
        subprocess.run([sys.executable, "-c", "from faid_tpu_torch.utils import "
                        "kernels; kernels.library()"], cwd=ROOT, check=True,
                       stdout=_stderr_fd())


def child_main(opts: Options, t_start: float) -> int:
    """A rank other than 0: its part of the run, with the forbidden modules
    that it loaded, left in the run's directory for rank 0."""
    out = run_rank(opts, t_start)
    out["forbidden"] = forbidden_loaded()
    path = Path(opts.rundir) / f"rank{opts.rank}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(out))
    tmp.replace(path)
    return 0


def lead_main(opts: Options, t_start: float, fault=None):
    """Rank 0: starts the other ranks, runs its own part, waits for each
    and makes the result line.  Returns (exit code, line, the check's
    gaps by counter); the line is None where a rank failed or loaded a
    forbidden module."""
    base = Path(tempfile.gettempdir())
    rundir = Path(tempfile.mkdtemp(prefix="portbench-", dir=base))
    opts = dataclasses.replace(opts, rundir=str(rundir))
    children = []
    try:
        if not opts.rehearse:
            build_kernels()
        if opts.world > 1:
            opts = dataclasses.replace(opts, port=_free_port())
            for r in range(1, opts.world):
                children.append(subprocess.Popen(_child_argv(opts, r),
                                                 stdout=_stderr_fd(), cwd=ROOT))
        lead = run_rank(opts, t_start, fault)
        ranks = [lead]
        for r, p in enumerate(children, start=1):
            if p.wait(timeout=300) != 0:
                print(f"rank {r} exited with {p.returncode}", file=sys.stderr)
                return 1, None, None
            ranks.append(json.loads((rundir / f"rank{r}.json").read_text()))
        for r, got in enumerate(ranks[1:], start=1):
            if got["forbidden"]:
                print(f"rank {r} loaded {', '.join(got['forbidden'])}: nothing "
                      "the run runs may import JAX or the JAX package",
                      file=sys.stderr)
                return 3, None, None
        return (0, *make_line(opts, ranks))
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(rundir, ignore_errors=True)


def make_line(opts: Options, ranks: list[dict]) -> dict:
    import torch

    from . import card

    reg = Registry()
    cell = reg.cell(opts.workload)
    config = reg.config(cell["config"])
    lead = ranks[0]
    gap, gaps = judge(ranks)
    frames = lead["syncs"] * lead["rounds_per_sync"] * lead["batch"] * len(ranks)
    counted = lead["window_counters"]["test_frames"]
    device = torch.device("cpu") if opts.rehearse else torch.device("cuda", 0)
    _, ref_code = _codes(config, opts.rehearse)
    metrics = {}
    if opts.trace:
        r = Readings(cell, config, ranks, device, ref_code, opts.seed, opts.rehearse)
        for m in reg.per_layer(opts.workload):
            value = reg.reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        n_info = ref_code.n_info
        e2e = {"info_mbit_s": frames * n_info / lead["window_s"] / 1e6,
               "sync_ms_p95": p95(lead["durations"]) * 1e3,
               "setup_s": lead["setup_s"]}
        for m in reg.end_to_end(opts.workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    line = {"correct": gap == 0, "attempted": frames,
            "failed": abs(frames - counted)}
    if opts.rehearse:
        # a CPU run's numbers are no device metric
        line["metrics"] = {}
        line["rehearsal_metrics"] = sorted(metrics)
        line["device"] = {"platform": "cpu", "kind": "cpu", "count": len(ranks),
                          "memory_peak_bytes": 0}
    else:
        line["metrics"] = metrics
        line["device"] = {"platform": "gpu", "kind": lead["kind"], "count": len(ranks),
                          "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
        if opts.trace:
            line["device"]["busy_s"] = statistics.fmean(
                r["profile"]["busy_s"] for r in ranks)
            line["device"]["window_s"] = lead["profile"]["window_s"]
        line["card"] = card.card_line(device)
    if opts.trace:
        line["breakdown"] = lead["breakdown"]
    line["syncs"] = lead["syncs"]
    line["reference_s"] = max(r["reference_s"] for r in ranks)
    line["window_sync_ms"] = lead["window_s"] / lead["syncs"] * 1e3
    if opts.trace:
        p = lead["profile"]
        line["profile_sync_ms"] = p["window_s"] / (p["stop"] - p["first"]) * 1e3
    line["checked"] = {"counter_gap": {"value": gap, "limit": 0}}
    return line, gaps


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules in ``sys.modules``, compared whole."""
    tops = {name.partition(".")[0] for name in sys.modules}
    return sorted(tops & set(FORBIDDEN_MODULES))
