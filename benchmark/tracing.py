"""Reading the profiler over a stretch of the runner's syncs.

Two profiles, because the host's own tracing slows a host-paced round:
a CUDA-only one gives the device's busy time and each kernel's count
and device time (``device_summary``); a CPU and CUDA one, with the
benchmark's spans open (``Phases``, ``STAGES``), gives each kernel's
stage by the span it was launched in and the device's idle gaps by what
the host was doing (``breakdown``).
"""

from __future__ import annotations

import bisect
import re

SPAN = "portbench."
# the host's phases of a sync, one after the other
PHASES = ("loop_call", "counter_wait", "runner_writes")
# spans the benchmark opens around the program's calls inside a loop call
STAGES = ("message_stream", "encoder", "mod_stats", "all_reduce")

_DECODER_OUT = {"0": "kernel_B", "1": "kernel_D", "2": "kernel_E", "3": "kernel_F",
                "kStats": "kernel_B", "kHard": "kernel_D", "kEn": "kernel_E",
                "kSim": "kernel_F"}
_DECODER = re.compile(r"decoder_kernel<\s*(?:\((?:faid::)?Out\))?\s*(?:faid::)?(\w+)")
_QUANTILE = re.compile(r"quantile_channel_kernel<\s*(true|false|1|0)")


def kernel_class(name: str) -> str | None:
    """The short name of a kernel of the program's library (``kernel_A``
    .. ``kernel_G``), of an nccl kernel (``nccl``) or of a library GEMM
    (``encoder``: the program's one matrix product); None for the rest."""
    m = _DECODER.search(name)
    if m:
        return _DECODER_OUT.get(m.group(1))
    if "qam_channel_kernel" in name:
        return "kernel_G"
    m = _QUANTILE.search(name)
    if m:
        return "kernel_A" if m.group(1) in ("true", "1") else "kernel_C"
    if "nccl" in name.lower():
        return "nccl"
    if re.search(r"gemm|cutlass|xmma", name, re.IGNORECASE):
        return "encoder"
    return None


def is_copy(name: str) -> bool:
    """Memcpy and memset activities: device operations, not kernels."""
    return name.startswith(("Memcpy", "Memset"))


def _device_events(events):
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA]


def merged(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_summary(events) -> dict:
    """Of a CUDA-only profile's events: the device's busy seconds (the
    union of its operations' intervals), and each operation's count and
    device seconds by name."""
    dev = _device_events(events)
    ops: dict[str, list] = {}
    for name, s, e in dev:
        c = ops.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) / 1e6
    busy = sum(e - s for s, e in merged((s, e) for _, s, e in dev)) / 1e6
    return {"busy_s": busy, "ops": ops}


def _stage_of(event) -> str | None:
    p = event
    while p is not None:
        if p.name.startswith(SPAN) and p.name[len(SPAN):] in STAGES:
            return p.name[len(SPAN):]
        p = p.cpu_parent
    return None


def short_name(kernel: str, stage: str | None) -> str:
    """A device operation's name in the breakdown."""
    cls = kernel_class(kernel)
    if cls:
        return cls
    if stage:
        return stage
    if kernel.startswith("Memcpy"):
        return "counter_read"
    return "reductions" if not kernel.startswith("Memset") else "memset"


def breakdown(events, top: int = 10) -> dict:
    """Of a CPU and CUDA profile with the spans open: the device seconds
    of each short name, and the device's idle seconds in each of the
    host's phases (a gap between two device operations counts for the
    phase at its middle), each list longest first.  The program's kernels,
    nccl's and a GEMM's are named by their device events; every other
    operation by the stage's span it was launched in (``short_name``),
    from the kernels the profiler ties to each host event."""
    from torch.autograd import DeviceType

    dev = _device_events(events)
    by_name: dict[str, float] = {}
    for name, s, e in dev:
        cls = kernel_class(name)
        if cls:
            by_name[cls] = by_name.get(cls, 0.0) + (e - s) / 1e6
    phases = []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith(SPAN) and e.name[len(SPAN):] in PHASES:
            phases.append((e.time_range.start, e.time_range.end,
                           e.name[len(SPAN):]))
        if e.kernels:
            stage = _stage_of(e)
            for k in e.kernels:
                if kernel_class(k.name) is None:
                    key = short_name(k.name, stage)
                    by_name[key] = by_name.get(key, 0.0) + k.duration / 1e6
    phases.sort()
    gaps: dict[str, float] = {}
    if phases:
        busy = merged((s, e) for _, s, e in dev)
        t0, t1 = phases[0][0], max(p[1] for p in phases)
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        starts = [p[0] for p in phases]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            g0, g1 = max(g0, t0), min(g1, t1)
            if g1 <= g0:
                continue
            i = bisect.bisect_right(starts, (g0 + g1) / 2) - 1
            name = phases[i][2] if i >= 0 else "outside"
            gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:top]

    return {"device_ops": ranked(by_name), "idle_gaps": ranked(gaps)}


class Phases:
    """The host's phase spans of each sync (``PHASES``), opened and closed
    as the sync moves on; a no-op unless ``on``."""

    def __init__(self):
        self.on = False
        self._open = None

    def enter(self, phase: str | None):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if self.on and phase is not None:
            import torch

            self._open = torch.autograd.profiler.record_function(SPAN + phase)
            self._open.__enter__()


def stage_span(fn, stage: str):
    """``fn`` with a span of ``stage`` around each call."""
    import functools

    import torch

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.autograd.profiler.record_function(SPAN + stage):
            return fn(*args, **kwargs)

    return wrapped
