"""Deep error-floor FER campaign on the GPU (the port of
scripts/floor_campaign.py).

    python -m faid_tpu_torch.scripts.floor_campaign --methods 2 --snr 3.9
        [--target-errors 20] [--max-frames 120000000] [--stop-mode group]
        -> docs/torch_h100/floor_group_39.json

Each method runs at one SNR point through the round of ``build_sim_loop``
(QPSK, the all-zero codeword, the quantile channel: kernel F on the card)
until ``--target-errors`` frame errors or ``--max-frames`` frames, and its
row, keyed by (method, snr_db, stop_mode), is merged into ``--out``,
whose default follows ``--snr`` and ``--stop-mode``.  A row without an
error carries ``fer_ub95`` = 3 / frames (the rule of three); a row whose
campaign is still running carries ``partial``.  A row that
docs/floor_group.json also has is held to it by the two-proportion z.

The campaign is ``MonteCarloRunner``'s sweep of that one point: a sync
is ``--calls`` x ``--rounds`` rounds (the JAX script's calls between two
reads of the counters), the counters are summed on the host as Python
ints, and each method keeps a checkpoint beside ``--out``.  So a killed
or capped call resumes on rerun where the checkpoint left it (it is
saved every 8 syncs), and a row that stopped at its budget continues when
the command is rerun with a larger ``--max-frames`` or
``--target-errors``: the rounds are the same stream rounds, and the row
equals one run under the larger rule.  Each method draws its own stream
(the seed is ``stream_id`` of --seed, the method, the SNR and the stop
mode).  ``seconds`` and ``mbit_s`` are those of the frames this call ran.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from . import _common


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faid_tpu_torch.scripts.floor_campaign",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--methods", default="3,4,5")
    ap.add_argument("--snr", type=float, default=4.0)
    ap.add_argument("--target-errors", type=int, default=20)
    ap.add_argument("--max-frames", type=int, default=120_000_000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--stop-mode", default="group", choices=["frame", "group"])
    ap.add_argument("--seed", type=int, default=20260820)
    ap.add_argument("--out", default=None,
                    help="rows (default docs/torch_h100/floor_<stop mode>_"
                         "<10 x snr>.json, e.g. floor_group_39.json at 3.9 dB)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    return ap


def default_out(snr: float, stop_mode: str) -> Path:
    """docs/torch_h100/floor_<stop mode>_<10 x snr>.json: 39 for 3.9 dB,
    40p5 for 4.05."""
    tag = f"{snr * 10:g}".replace(".", "p")
    return _common.OUT_DIR / f"floor_{stop_mode}_{tag}.json"


def checkpoint_path(out: Path, method_name: str) -> Path:
    return out.with_name(f"{out.stem}.{method_name}.checkpoint.json")


def campaign_config(method: int, snr: float, batch: int, rounds: int,
                    calls: int, stop_mode: str, seed: int, target_errors: int,
                    max_frames: int):
    """The runner's config of one method's campaign at ``snr``."""
    from ..config import DecodeMethod, SimConfig

    m = DecodeMethod(method)
    return SimConfig(
        decode_method=m, max_iteration=6, mod_type=2, batch_per_device=batch,
        seed=_common.stream_id(seed, m.name, snr, stop_mode),
        stop_mode=stop_mode, fake_encode=True, channel_backend="fused",
        snr_start=snr, snr_pass=1.0, snr_end=snr + 0.5, min_frames=0,
        min_frame_errors=target_errors, max_frames_per_snr=max_frames,
        rounds_per_sync=rounds * calls)


def make_row(method_name: str, snr: float, stop_mode: str, c: dict,
             n_info: int, frames_run: int, seconds: float, card: str,
             partial: bool) -> dict:
    tf = max(c["test_frames"], 1)
    row = {"method": method_name, "snr_db": snr, "stop_mode": stop_mode,
           "frames": c["test_frames"], "error_frames": c["error_frames"],
           "fer": c["error_frames"] / tf, "ber": c["error_bits"] / tf / n_info,
           "avg_mp_iters": c["mp_iters"] / tf,
           "avg_bf_rounds": c["bf_rounds"] / tf,
           "mbit_s": frames_run * n_info / seconds / 1e6 if frames_run else None,
           "seconds": seconds, "card": card}
    if c["error_frames"] == 0:
        row["fer_ub95"] = 3.0 / tf        # rule of three
    if partial:
        row["partial"] = True             # run still in flight / killed
    return row


def rowkey(r: dict) -> tuple:
    return (r["method"], r["snr_db"], r.get("stop_mode", "group"))


def merge_row(out: Path, row: dict) -> None:
    rows = json.loads(out.read_text()) if out.exists() else []
    _common.write_json(out, [r for r in rows if rowkey(r) != rowkey(row)] + [row])


def run_campaign(code, device, method: int, snr: float, out, *,
                 target_errors: int = 20, max_frames: int = 120_000_000,
                 batch: int = 2048, rounds: int = 25, calls: int = 8,
                 stop_mode: str = "group", seed: int = 20260820) -> dict:
    """One method's campaign, its row merged into ``out`` after every sync
    (``partial``) and at its end; returns the final row."""
    from ..sim.runner import MonteCarloRunner

    out = _common.artifact_path(out)
    cfg = campaign_config(method, snr, batch, rounds, calls, stop_mode, seed,
                          target_errors, max_frames)
    name = cfg.decode_method.name
    runner = MonteCarloRunner(cfg, code=code, device=device,
                              checkpoint_path=checkpoint_path(out, name),
                              max_rounds_per_snr=-(-max_frames // batch))
    runner.reopen_last_point()
    done = runner.results             # the point, finished under this rule
    if done:
        key = (name, snr, stop_mode)
        rows = json.loads(out.read_text()) if out.exists() else []
        kept = [r for r in rows if rowkey(r) == key and not r.get("partial")]
        if kept:
            return kept[0]            # nothing to run: the row stands
    card = _common.card_line(device)
    start = (done[-1].counters if done else runner.point_counters())["test_frames"]
    t0 = time.monotonic()

    def row_of(c, partial):
        return make_row(name, snr, stop_mode, c, code.n_info,
                        c["test_frames"] - start, time.monotonic() - t0, card,
                        partial)

    def progress(_snr_db, c):
        row = row_of(c, True)
        merge_row(out, row)
        print(f"{name:10s} {snr} dB  {c['test_frames'] / 1e6:.1f}M frames  "
              f"{c['error_frames']} err  {row['mbit_s']:.0f} Mbit/s ({card})  "
              f"{row['seconds']:.0f}s", flush=True)

    res = runner.run_point(progress) or done[-1]
    row = row_of(res.counters, False)
    merge_row(out, row)
    print(f"{name}: FER {row['fer']:.3e} ({row['error_frames']}/{row['frames']})"
          f"  -> {out}", flush=True)
    return row


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..cli import _device
    from ..code.qc_matrix import load_code

    device = _device(args.device)
    out = Path(args.out) if args.out else default_out(args.snr, args.stop_mode)
    code = load_code("50gpon")
    ref = _common.floor_rows()
    ok = True
    for m in (int(x) for x in args.methods.split(",")):
        row = run_campaign(code, device, m, args.snr, out,
                           target_errors=args.target_errors,
                           max_frames=args.max_frames, batch=args.batch,
                           rounds=args.rounds, calls=args.calls,
                           stop_mode=args.stop_mode, seed=args.seed)
        j = ref.get(rowkey(row))
        if j is not None:
            z, row["consistent"] = _common.consistent(
                row["error_frames"], row["frames"], j["error_frames"], j["frames"])
            row["z"] = None if z is None else round(z, 3)
            row["jax_row"] = {"frames": j["frames"], "error_frames": j["error_frames"]}
            merge_row(out, row)
            print(f"{row['method']} {row['snr_db']} dB against docs/floor_group.json's "
                  f"{j['error_frames']}/{j['frames']}: z {row['z']}, consistent "
                  f"{row['consistent']}")
            ok &= row["consistent"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
