"""Data parallelism over processes for the Monte-Carlo pipeline
(``faid_tpu.parallel.mesh``).

The reference runs one shared-nothing pthread worker per core and sums
their counters after ``pthread_join`` (reference main.cpp:164-182).  The
JAX package runs one batch shard per device of a ``jax.sharding.Mesh``
and ``psum``s the counters.  Here each process of a ``torch.distributed``
world (one per GPU, as ``torchrun`` starts them) runs its own rounds, and
the counters of a call are summed with one all-reduce.

The ranks' frames are disjoint by the stream contract (ops/philox.py):
rank r draws frames ``r * b .. (r + 1) * b - 1`` of each round, where b
is ``cfg.batch_per_device``.  So a world of W ranks at batch b counts
exactly the frames of one rank at batch W * b, counter for counter.
(The JAX package folds the device index into the key instead, so its
sharded run draws other frames than its one-device run.)

The reduction runs over the default process group that the caller set
up (cli.py ``--multihost``: nccl on GPUs, gloo on the CPU); this module
does not choose the backend.  Only counters cross ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..code.qc_matrix import QCCode
from ..config import SimConfig
from ..sim.pipeline import build_sim_loop, build_sim_step
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A world of ``size`` processes; this process is ``rank`` and runs
    on ``device``."""

    rank: int
    size: int
    device: torch.device


def make_mesh(device=None) -> Mesh:
    """The default process group's world, or a world of one where no
    group is initialized.  ``device`` defaults to ``cuda``.  Every rank
    must run on the same device type: the float chain's draws, and so a
    checkpoint's fingerprint, depend on it."""
    device = torch.device("cuda" if device is None else device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(0, 1, device)
    mesh = Mesh(dist.get_rank(), dist.get_world_size(), device)
    if mesh.size > 1:
        types = [None] * mesh.size
        dist.all_gather_object(types, device.type)
        if len(set(types)) != 1:
            raise ValueError(f"the ranks run on device types {types}: a "
                             "world runs on one device type")
    return mesh


def _check_world(cfg: SimConfig, mesh: Mesh) -> None:
    """The world's frames must be global frame indices of the stream.
    Every rank checks the whole world, so that all ranks refuse together
    and none waits on a collective that a refusing rank will not join."""
    if mesh.size * cfg.batch_per_device > 2**32:
        raise ValueError(
            f"{mesh.size} ranks of {cfg.batch_per_device} frames exceed the "
            "stream's 2^32 frames a round")


def frame0(cfg: SimConfig, mesh: Mesh) -> int:
    """This rank's first global frame of a round."""
    return mesh.rank * cfg.batch_per_device


def all_reduce_counters(stats: dict) -> dict:
    """Sums a dict of int32 counter tensors over the default group with
    ONE all-reduce of one packed int64 tensor; returns the same keys,
    shapes and dtype.  int32 sums wrap as the one-rank loop's do, so the
    result equals the one-rank sum bit for bit."""
    with trace.span("mesh.all_reduce"):
        flat = torch.cat([v.reshape(-1).to(torch.int64)
                          for v in stats.values()])
        dist.all_reduce(flat)
        out, i = {}, 0
        for k, v in stats.items():
            out[k] = flat[i:i + v.numel()].reshape(v.shape).to(v.dtype)
            i += v.numel()
        return out


def build_sharded_sim_step(code: QCCode, cfg: SimConfig,
                           mesh: Mesh) -> Callable:
    """Returns step(seed, rnd, sigma) -> the dict of int32 counters of
    ``build_sim_step``, summed over the world's ranks (the same on every
    rank): ``cfg.batch_per_device`` frames on each rank, ``mesh.size``
    times that a round.  At size 1 it is ``build_sim_step``."""
    _check_world(cfg, mesh)
    step = build_sim_step(code, cfg, mesh.device, frame0=frame0(cfg, mesh))
    if mesh.size == 1:
        return step
    return lambda seed, rnd, sigma: all_reduce_counters(step(seed, rnd, sigma))


def build_sharded_sim_loop(code: QCCode, cfg: SimConfig, mesh: Mesh,
                           rounds: int) -> Callable:
    """Like ``build_sharded_sim_step``, for ``rounds`` rounds a call, the
    counters summed on each rank's device and then reduced once:
    loop(seed, sigma, round0) -> the counters of ``build_sim_loop`` over
    the world's frames."""
    _check_world(cfg, mesh)
    loop = build_sim_loop(code, cfg, rounds, mesh.device,
                          frame0=frame0(cfg, mesh))
    if mesh.size == 1:
        return loop
    return lambda seed, sigma, round0: all_reduce_counters(
        loop(seed, sigma, round0))
