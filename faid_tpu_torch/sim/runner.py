"""Monte-Carlo SNR-sweep runner: the reference's ``main()`` loop
(reference main.cpp:17-231), ``faid_tpu.sim.runner``.

Per SNR point it repeats ``build_sharded_sim_loop`` calls
(parallel/mesh.py; ``build_sim_loop`` in a world of one) until the
reference's stopping rule holds (>= min_frames AND >= min_frame_errors,
reference main.cpp:164, 209-211), then emits one result row.  Rows match
the ``Result.txt`` schema (main.cpp:117-119, 220-223) plus the
``demod.txt`` columns (main.cpp:224-226).  File formats and semantics are
the JAX runner's.

In a world of several ranks every rank runs the sweep on its slice of
each round's frames and takes the same stop decisions from the reduced
counters.  Unlike the JAX runner, where every host writes the same
files, rank 0 alone writes ``checkpoint.json``, ``Temp.txt``, the result
tables and the error dumps, and rank 0 alone reads the checkpoint, whose
state it sends to the other ranks: no filesystem is assumed to be
shared.  Rank 0's dump replays every rank's slice.

Checkpoint/resume: state is a JSON snapshot of ``(seed, per-SNR
counters, round index)``; resume is exact because round ``rnd`` of SNR
point ``snr_idx`` draws stream round ``philox.stream_round(snr_idx,
rnd)``, for its message bits and its channel words alike.  Unlike the
JAX runner, the checkpoint's config fingerprint also hashes the world
size and the streams' tag (``philox.STREAM_TAG``), so a checkpoint
written by ``faid_tpu``, by another world size or for other random
streams starts fresh instead of merging statistics of other frames
(which would also make the replay dump the wrong frames).  With
``fake_encode`` in the fingerprint, that covers whatever the message
stream changes.

Each sync (one loop call of ``rounds_per_sync`` rounds, the counter read,
the bookkeeping and the writes) is one record of the campaign's spans
(utils/trace.py), with the device's idle time before its first launch.
On a CUDA device the counter read also takes the decoder's phase clocks
(utils/kernels.py ``phase_clocks``) and adds the sync's SM cycles of each
phase to the record's counters (``PHASE_COUNTERS``), apart from the
statistics that the runner sums and checkpoints.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..code.qc_matrix import QCCode, load_code
from ..config import SimConfig
from ..ops import philox
from ..parallel.mesh import Mesh, build_sharded_sim_loop, make_mesh
from ..utils import kernels, trace
from .pipeline import build_debug_step, quantile_draws

COUNTER_KEYS = (
    "test_frames", "error_bits", "error_frames", "lt3_frames",
    "mod_error_bits", "mod_error_symbols", "mod_error_frames",
    "mp_iters", "bf_rounds",
)
# Vector-valued counters (iteration histograms) accumulated elementwise.
HIST_KEYS = ("mp_hist", "bf_hist")
# A sync record's counters of the decoder kernel's SM cycles in each phase,
# summed over its blocks (the order of utils/kernels.py ``PHASES``).
PHASE_COUNTERS = tuple(f"decoder.{p}_cycles" for p in kernels.PHASES)


# Oldest error-bearing round ranges kept per SNR point: enough to replay
# far more frames than any forensic dump asks for, while keeping
# checkpoint.json bounded at low SNR where every chunk has errors.
MAX_ERR_CHUNKS = 256


def itercount_ref_lines(bf_hist, bf_cap: int, word_exact: bool) -> list[str]:
    """The reference's iterCount.txt lines (CSimulate.cpp:171-179):
    ``i: count`` for nonzero buckets of BF rounds USED, i = 1..cap.
    The decoders' return value counts UP from 0 per BF round
    (CDecoder_OMSBF.cpp:2968-3510), so it is rounds used.  ``bf_hist`` is
    likewise indexed by rounds used per frame; bucket 0 (converged
    without BF) is skipped exactly as the reference's print loop starting
    at 1 skips it.  ``word_exact`` divides by the 32-frame word size
    (valid under stop_mode='group' where all frames of a word share one
    BF loop), making the output byte-exact vs the reference binary."""
    lines = []
    for used in range(1, bf_cap + 1):
        n = int(bf_hist[used]) if used < len(bf_hist) else 0
        if word_exact:
            if n % 32:
                raise ValueError("group-mode histogram not word-aligned")
            n //= 32
        if n:
            lines.append(f"{used}: {n}\n")
    return lines


def _add_counter(a, b):
    if isinstance(a, list):
        if len(a) != len(b):
            raise ValueError(
                f"histogram length mismatch {len(a)} != {len(b)} - "
                "checkpoint from an incompatible config?")
        return [x + y for x, y in zip(a, b)]
    return a + b


# Fields that change WHEN the sweep stops or HOW it executes, not what
# any Monte-Carlo round computes: resuming under a different value of
# these must keep the accumulated statistics.  backend is neutral because
# each kernel is bit-exact against its plain twin; rounds_per_sync only
# re-chunks rounds whose results are a pure function of (seed, snr_idx,
# round) regardless of chunking.
_FINGERPRINT_NEUTRAL_FIELDS = (
    "min_frames", "min_frame_errors", "max_frames_per_snr",
    "giveup_zero_error_frames", "backend", "rounds_per_sync",
)


def config_fingerprint(cfg: SimConfig, world_size: int = 1,
                       device_type: str = "cuda") -> str:
    """Stable hash of every result-affecting config field, the world size
    and the random stream's tag, and, where the float chain draws the
    round, the device type.  Stored in checkpoints so resuming under a
    changed method/SNR-grid/batch/world size/stream starts fresh instead
    of silently merging incompatible state, while changes to
    stopping-rule/execution fields (deepening a sweep, switching the
    bit-exact backend) keep the checkpoint.  The float chain's noise
    (erfinv) differs between device types, so its rounds, and the
    replay of their error chunks, belong to one device type; the
    quantile channels' kernels are bit-exact against their CPU twins, so
    their checkpoints move between devices."""
    d = dataclasses.asdict(cfg)
    for k in _FINGERPRINT_NEUTRAL_FIELDS:
        d.pop(k, None)
    d["world_size"] = world_size
    d["stream"] = philox.STREAM_TAG
    if not quantile_draws(cfg):
        d["device_type"] = device_type
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class SnrResult:
    snr_db: float
    counters: dict
    seconds: float
    # [start, end) round ranges in which >=1 frame error occurred -
    # enough to replay and dump the exact failing frames later.
    err_chunks: list = dataclasses.field(default_factory=list)

    def rates(self, n_info: int, mod_type: int) -> dict:
        c = self.counters
        tf = max(c["test_frames"], 1)
        # The reference floors error counts at 1 when computing the rate
        # ("assume one is wrong", main.cpp:186-188).
        ber = max(c["error_bits"], 1) / (tf * n_info)
        fer = max(c["error_frames"], 1) / tf
        return {
            "snr_db": self.snr_db,
            "test_frames": c["test_frames"],
            "error_frames": c["error_frames"],
            "error_bits": c["error_bits"],
            "fer": fer,
            "ber": ber,
            "lt3_frames": c["lt3_frames"],
            "mod_ber": c["mod_error_bits"] / (tf * n_info),
            "mod_ser": c["mod_error_symbols"] / (tf * n_info / mod_type),
            "mod_fer": c["mod_error_frames"] / tf,
            "avg_mp_iters": c["mp_iters"] / tf,
            "avg_bf_rounds": c["bf_rounds"] / tf,
            "seconds": self.seconds,
        }


def snr_points(cfg: SimConfig) -> list[float]:
    """[start, end) by pass, matching the reference's float loop
    (main.cpp:136)."""
    pts = []
    snr = cfg.snr_start
    while snr < cfg.snr_end - 1e-9:
        pts.append(round(snr, 6))
        snr += cfg.snr_pass
    return pts


class MonteCarloRunner:
    """Drives the sharded sim loop over an SNR sweep with checkpointing.

    ``mesh`` (parallel/mesh.py ``make_mesh``) is the world the sweep runs
    in, a world of one on ``device`` (default ``cuda``) when None; a mesh
    brings its own device.  Every rank constructs the runner and calls
    the same methods; the writers and ``collect_error_frames`` do their
    work on rank 0 alone."""

    def __init__(self, cfg: SimConfig, code: QCCode | None = None,
                 device=None, mesh: Mesh | None = None,
                 checkpoint_path: str | Path | None = None,
                 max_rounds_per_snr: int = 100000,
                 temp_txt_path: str | Path | None = None):
        if mesh is None:
            mesh = make_mesh(device)
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        self.cfg = cfg
        self.mesh = mesh
        self.world_size = mesh.size
        self._lead = mesh.rank == 0
        self.temp_txt_path = Path(temp_txt_path) if temp_txt_path else None
        self.code = code if code is not None else load_code(cfg.file_name_key())
        self.device = mesh.device
        self._device_type = mesh.device.type
        self.rounds_per_sync = max(1, cfg.rounds_per_sync)
        self.loop = build_sharded_sim_loop(self.code, cfg, mesh,
                                           self.rounds_per_sync)
        self._phases = kernels.phase_clocks(self.device)
        self._phases_seen = None
        self.checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        self.max_rounds_per_snr = max_rounds_per_snr
        self.results: list[SnrResult] = []
        self._state = {"snr_idx": 0, "round": 0,
                       "counters": self._zero_counters(),
                       "err_chunks": []}
        if self.checkpoint_path:
            self._load_checkpoint()

    def _zero_counters(self) -> dict:
        dcfg = self.cfg.decoder()
        z = {k: 0 for k in COUNTER_KEYS}
        z["mp_hist"] = [0] * (dcfg.max_iter + 1)
        z["bf_hist"] = [0] * (max(dcfg.bf.max_iter, 1) + 1)
        return z

    # -- checkpointing ------------------------------------------------------
    def _load_checkpoint(self):
        """Rank 0 reads the checkpoint, if there is one, and every rank
        takes its state from rank 0."""
        st = None
        if self._lead and self.checkpoint_path.exists():
            st = json.loads(self.checkpoint_path.read_text())
        if self.world_size > 1:
            box = [st]
            dist.broadcast_object_list(box, src=0)
            st = box[0]
        if st is None or st.get("seed") != self.cfg.seed:
            return  # no checkpoint, or a different experiment; start fresh
        fp = config_fingerprint(self.cfg, self.world_size, self._device_type)
        if st.get("config_fingerprint") != fp:
            if self._lead:
                warnings.warn(
                    "checkpoint was written by a different simulation "
                    "config, world size, random stream or float-chain "
                    f"device type (fingerprint {st.get('config_fingerprint')} "
                    f"!= {fp}); starting fresh",
                    stacklevel=3)
            return
        self._state = st["state"]
        self._state.setdefault("err_chunks", [])
        self.results = [SnrResult(r["snr_db"], r["counters"], r["seconds"],
                                  r.get("err_chunks", []))
                        for r in st["results"]]

    def _save_checkpoint(self):
        if not (self.checkpoint_path and self._lead):
            return
        with trace.span("runner.checkpoint"):
            st = {"seed": self.cfg.seed,
                  "config_fingerprint": config_fingerprint(
                      self.cfg, self.world_size, self._device_type),
                  "world_size": self.world_size,
                  "stream": philox.STREAM_TAG,
                  "state": self._state,
                  "results": [dataclasses.asdict(r) for r in self.results]}
            data = json.dumps(st).encode()
            tmp = self.checkpoint_path.with_suffix(".tmp")
            tmp.write_bytes(data)
            tmp.replace(self.checkpoint_path)
        trace.count("runner.checkpoint_bytes", len(data))

    # -- core loop ----------------------------------------------------------
    def _write_temp_txt(self, snr_db: float, c: dict):
        """Live progress file, rewritten every sync - the reference
        truncates and rewrites Temp.txt each round with the in-flight
        SNR point's row plus its RNG-seed resume dump
        (main.cpp:194-207).  Same columns incl. the assume-one-is-wrong
        FER/BER floor; the seed C-array is replaced by the exact resume
        state (the stream is counter-based, checkpoint.json restores the
        point bit-exactly)."""
        if not (self.temp_txt_path and self._lead):
            return
        with trace.span("runner.temp_txt"):
            n_info = self.code.n_info
            tf = max(c["test_frames"], 1)
            fer = max(c["error_frames"], 1) / tf
            ber = max(c["error_bits"], 1) / (tf * n_info)
            lines = [
                f"{snr_db:>5g}\t{c['test_frames']:>20d}\t"
                f"{c['error_frames']:>15d}\t{c['error_bits']:>20d}\t"
                f"{fer:>20.6g}\t{ber:>20.6g}\t{c['lt3_frames']:>15d}\t\n",
                f"resume: seed={self.cfg.seed} "
                f"snr_idx={self._state['snr_idx']} "
                f"round={self._state['round']} "
                f"(exact resume via checkpoint.json; the stream is "
                f"counter-based)\n",
            ]
            tmp = self.temp_txt_path.with_suffix(".tmp")
            tmp.write_text("".join(lines))
            tmp.replace(self.temp_txt_path)

    def _stop_satisfied(self, c: dict) -> bool:
        return (c["test_frames"] >= self.cfg.min_frames
                and c["error_frames"] >= self.cfg.min_frame_errors)

    def _budget_exhausted(self, c: dict) -> bool:
        """Sweep-economics early abort (the reference has none and burns
        its full round budget on zero-error deep-floor points): a hard
        per-point frame budget, plus a give-up rule once a point is
        clearly past the waterfall (zero errors after N frames)."""
        cfg = self.cfg
        if (cfg.max_frames_per_snr is not None
                and c["test_frames"] >= cfg.max_frames_per_snr):
            return True
        if (cfg.giveup_zero_error_frames is not None
                and c["error_frames"] == 0
                and c["test_frames"] >= cfg.giveup_zero_error_frames):
            return True
        return False

    def run_snr(self, snr_idx: int, snr_db: float,
                progress=None) -> SnrResult:
        cfg = self.cfg
        sigma = cfg.sigma_at(snr_db)
        c = self._state["counters"]
        t0 = time.monotonic()
        rnd = self._state["round"]
        sync = 0
        if self._phases is not None:
            # what ran before this point's first sync is none of its cycles
            self._phases_seen = self._phases.tolist()
        while (not self._stop_satisfied(c) and rnd < self.max_rounds_per_snr
               and not self._budget_exhausted(c)):
            # the sync's last round must stay inside this point's rounds
            philox.stream_round(snr_idx, rnd + self.rounds_per_sync - 1)
            # the sync's device events lie outside the loop call's span,
            # so that it times the enqueue alone: a record costs the host
            # 15-60 us (H100)
            with trace.sync(snr_idx, rnd, self.rounds_per_sync, self.device), \
                    trace.span("runner.sync"):
                with trace.span("runner.loop_call"):
                    raw = self.loop(cfg.seed, sigma,
                                    philox.stream_round(snr_idx, rnd))
                trace.launched()
                with trace.span("runner.counter_read"):
                    stats = {k: v.tolist() for k, v in raw.items()}
                    self._count_phases()
                with trace.span("runner.bookkeeping"):
                    for k in c:
                        c[k] = _add_counter(c[k], stats[k])
                    chunks = self._state["err_chunks"]
                    errors = stats["error_frames"] > 0
                    if errors and len(chunks) < MAX_ERR_CHUNKS:
                        chunks.append([rnd, rnd + self.rounds_per_sync])
                    elif errors and not self._state.get("err_chunks_truncated"):
                        # No silent caps: later forensics replay only
                        # covers the recorded ranges, so say so once per
                        # SNR point.
                        self._state["err_chunks_truncated"] = True
                        warnings.warn(
                            f"SNR {snr_db:g} dB: error-chunk recording "
                            f"capped at {MAX_ERR_CHUNKS} ranges; "
                            "collect_error_frames will only replay the "
                            "oldest error-bearing rounds", stacklevel=2)
                    rnd += self.rounds_per_sync
                    sync += 1
                    self._state["round"] = rnd
                if progress:
                    with trace.span("runner.progress"):
                        progress(snr_db, dict(c))
                self._write_temp_txt(snr_db, c)
                if sync % 8 == 0:
                    self._save_checkpoint()
        seconds = time.monotonic() - t0
        return SnrResult(snr_db, dict(c), seconds,
                         list(self._state["err_chunks"]))

    def _count_phases(self) -> None:
        """Adds the decoder's cycles in each phase since the last read to
        the open sync's counters.  Read after the sync's counters, the
        clocks hold every launch of the sync, with no wait of their own."""
        if self._phases is None:
            return
        now = self._phases.tolist()
        for name, a, b in zip(PHASE_COUNTERS, now, self._phases_seen):
            trace.count(name, a - b)
        self._phases_seen = now

    def run(self, progress=None) -> list[SnrResult]:
        """Run every pending SNR point; returns all results."""
        while self.run_point(progress) is not None:
            pass
        return self.results

    def run_point(self, progress=None) -> SnrResult | None:
        """Run the next pending SNR point to its stopping rule; None once
        the sweep is done."""
        pts = snr_points(self.cfg)
        i = self._state["snr_idx"]
        if i >= len(pts):
            return None
        try:
            res = self.run_snr(i, pts[i], progress)
        except KeyboardInterrupt:
            # Partial progress survives: the next run with the same
            # checkpoint path resumes mid-SNR-point (reference parity:
            # Temp.txt seeds let a killed sweep continue, main.cpp:200).
            self._save_checkpoint()
            raise
        self.results.append(res)
        self._state["snr_idx"] = i + 1
        self._state["round"] = 0
        self._state["counters"] = self._zero_counters()
        self._state["err_chunks"] = []
        self._state["err_chunks_truncated"] = False
        self._save_checkpoint()
        return res

    def point_counters(self) -> dict:
        """The counters of the pending SNR point so far: zero at its start,
        a resumed or reopened point's from before."""
        return dict(self._state["counters"])

    def reopen_last_point(self) -> bool:
        """Hands the last finished SNR point back to the sweep where its
        counters meet neither the stopping rule nor the budget of this
        runner's config (a deeper rule than the one it finished under: more
        errors, a larger frame budget).  ``run_point`` then continues it
        from its next round, as a resume continues a point cut off mid-way,
        so the point's counters equal one run under the deeper rule.
        Returns True where it reopened the point."""
        if not self.results:
            return False
        res = self.results[-1]
        c = res.counters
        if self._stop_satisfied(c) or self._budget_exhausted(c):
            return False
        self.results.pop()
        self._state = {
            "snr_idx": len(self.results),
            # every round adds batch frames on every rank
            "round": c["test_frames"] // (self.cfg.batch_per_device
                                          * self.world_size),
            "counters": dict(c), "err_chunks": list(res.err_chunks),
            "err_chunks_truncated": False}
        return True

    # -- reporting ----------------------------------------------------------
    def report_rows(self) -> list[dict]:
        return [r.rates(self.code.n_info, self.cfg.mod_type)
                for r in self.results]

    def write_result_txt(self, path: str | Path):
        """Result.txt-compatible table (reference main.cpp:117-119)."""
        if not self._lead:
            return
        rows = self.report_rows()
        hdr = (f"{'SNR':>6} {'TestFrame':>10} {'ErrorFrame':>10} "
               f"{'ErrorBits':>10} {'FER':>12} {'BER':>12} "
               f"{'LT3ErrBitFrame':>14} {'Time(s)':>9}\n")
        lines = [hdr]
        for r in rows:
            lines.append(
                f"{r['snr_db']:>6.2f} {r['test_frames']:>10d} "
                f"{r['error_frames']:>10d} {r['error_bits']:>10d} "
                f"{r['fer']:>12.4e} {r['ber']:>12.4e} "
                f"{r['lt3_frames']:>14d} {r['seconds']:>9.2f}\n")
        Path(path).write_text("".join(lines))

    def write_itercount_txt(self, path: str | Path,
                            ref_format: bool = False):
        """Iteration-histogram table per SNR point - the reference appends
        the BF-iteration histogram to iterCount.txt (CSimulate.cpp:171-179);
        here both MP and BF histograms.

        ``ref_format=True`` emits the reference's exact ``i: count``
        lines instead, keyed by BF rounds USED, zero-count lines skipped.
        The reference increments once per 32-frame SIMD word
        (CSimulate.cpp:149,171-179); under stop_mode='group' with
        batch % 32 == 0 every frame of a word shares one BF loop, so the
        word count is exactly the frame count / 32 and the output is
        byte-exact.  Under stop_mode='frame' counts stay per frame."""
        if not self._lead:
            return
        lines = []
        bf_cap = self.cfg.decoder().bf.max_iter
        word_exact = (self.cfg.stop_mode == "group"
                      and self.cfg.batch_per_device % 32 == 0)
        for r in self.results:
            mp = r.counters.get("mp_hist", [])
            bf = r.counters.get("bf_hist", [])
            if ref_format:
                lines.extend(itercount_ref_lines(bf, bf_cap, word_exact))
                continue
            lines.append(f"SNR {r.snr_db:.2f}\n")
            lines.append("  mp_iters " +
                         " ".join(str(x) for x in mp) + "\n")
            lines.append("  bf_rounds " +
                         " ".join(str(x) for x in bf) + "\n")
        Path(path).write_text("".join(lines))

    def collect_error_frames(self, out_dir: str | Path,
                             max_frames: int = 256) -> int:
        """Replay the rounds that produced frame errors and dump the exact
        failing frames - errorindex.txt (info-bit block+offset per Z
        circulant), errordecode.txt (decoded hard bits of the erroneous
        positions), errorllr.txt (their quantized channel LLRs) and
        errorfloat.txt (their float LLRs on the float chain, llr / scale
        on the quantile channel), the reference's collectflag dumps
        (CLDPC.cpp:4877-4991; main.cpp:190-192).  Exact because every
        round's message bits, channel words and noise are a pure function
        of (seed, snr_idx, round, frame); on a CUDA device the replay runs
        the round's channel (kernel C or G, or the float chain), then
        kernel D (a BF tail) or E (none).  The errors are the decoded info bits
        that differ from the frame's codeword.  Rank 0 replays every
        rank's slice of a round, rank d's as ``dev d`` with its frames
        numbered from 0 (the JAX dump's format: frame f of ``dev d`` is
        the round's frame d * batch + f); another rank dumps nothing.
        Returns the number of frames dumped."""
        if not self._lead:
            return 0
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        b = self.cfg.batch_per_device
        debugs = [build_debug_step(self.code, self.cfg, self.device, d * b)
                  for d in range(self.world_size)]
        z = self.code.z
        n_info = self.code.n_info

        def replays():
            """(snr_db, d, rnd, rank d's replayed slice) of every round
            with errors."""
            for snr_idx, res in enumerate(self.results):
                sigma = self.cfg.sigma_at(res.snr_db)
                for r0, r1 in res.err_chunks:
                    for rnd in range(r0, r1):
                        sr = philox.stream_round(snr_idx, rnd)
                        for d, debug in enumerate(debugs):
                            yield (res.snr_db, d, rnd,
                                   debug(self.cfg.seed, sr, sigma))

        dumped = 0
        names = ("errorindex.txt", "errordecode.txt", "errorllr.txt",
                 "errorfloat.txt")
        files = [open(out_dir / n, "w") for n in names]
        f_idx, f_dec, f_llr, f_flt = files
        try:
            for snr_db, d, rnd, out in replays():
                err_bits = out["err_bits"].cpu().numpy()
                bad = np.nonzero(err_bits)[0]
                if bad.size == 0:
                    continue
                hard = out["hard"].cpu().numpy()
                cw = out["cw"].cpu().numpy()
                llr = out["llr"].cpu().numpy()
                soft = out["soft"].cpu().numpy()
                for f in bad:
                    pos = np.nonzero(
                        hard[f, :n_info] != cw[f, :n_info].astype(bool))[0]
                    tag = (f"snr {snr_db:.2f} dev {d} round {rnd} "
                           f"frame {int(f)} errs {int(err_bits[f])}")
                    f_idx.write(tag + " : " + " ".join(
                        f"b{p // z + 1}+{p % z}" for p in pos) + "\n")
                    f_dec.write(tag + " : " + " ".join(
                        str(int(hard[f, p])) for p in pos) + "\n")
                    f_llr.write(tag + " : " + " ".join(
                        str(int(llr[f, p])) for p in pos) + "\n")
                    f_flt.write(tag + " : " + " ".join(
                        f"{float(soft[f, p]):.6f}" for p in pos) + "\n")
                    dumped += 1
                    if dumped >= max_frames:
                        return dumped
        finally:
            for f in files:
                f.close()
        return dumped

    def write_demod_txt(self, path: str | Path):
        """demod.txt-compatible table (reference main.cpp:224-226)."""
        if not self._lead:
            return
        rows = self.report_rows()
        lines = [f"{'SNR':>6} {'ModFER':>12} {'ModBER':>12} {'ModSER':>12}\n"]
        for r in rows:
            lines.append(f"{r['snr_db']:>6.2f} {r['mod_fer']:>12.4e} "
                         f"{r['mod_ber']:>12.4e} {r['mod_ser']:>12.4e}\n")
        Path(path).write_text("".join(lines))
