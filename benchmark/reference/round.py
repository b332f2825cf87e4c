"""One Monte-Carlo round's counters, and a sync's, worked out plainly.

For frames ``frame0 .. frame0 + batch - 1`` of stream round ``rnd``: the
message bits from the stream and the encoder (or the all-zero word), the
quantile channel on thresholds made from sigma, the ModCalErr counts,
the plain decoder and the info-bit errors, reduced to the counters that
faid_tpu_torch/sim/pipeline.py's round returns (its docstring lists
them).  A sync is ``rounds`` consecutive rounds of one SNR point, their
counters summed, as the runner sums the loop's.
"""

from __future__ import annotations

import torch

from . import philox
from .channel import binary_channel, mod_stats, qam_channel, threshold_ints
from .code import QCCode
from .config import Deployment
from .decoder import stats_decode
from .encoder import make_encode_fn
from .qam import plan_threshold_ints

COUNTERS = ("test_frames", "error_bits", "error_frames", "lt3_frames",
            "mod_error_bits", "mod_error_symbols", "mod_error_frames",
            "mp_iters", "bf_rounds")
HISTOGRAMS = ("mp_hist", "bf_hist")


def _histogram(x: torch.Tensor, length: int) -> list[int]:
    return torch.bincount(torch.clamp(x.to(torch.int64), 0, length - 1),
                          minlength=length).tolist()


def add(a: dict, b: dict) -> dict:
    """Counter dicts summed key by key, histograms bucket by bucket."""
    return {k: ([x + y for x, y in zip(a[k], b[k])] if isinstance(a[k], list)
                else a[k] + b[k]) for k in a}


class RoundReference:
    """The rounds of one deployment on ``device``.  ``fake_encode`` sends
    the all-zero word; ``threshold_dtype`` is the float type of the
    channel's probabilities (float32, as the configurations state)."""

    def __init__(self, code: QCCode, dep: Deployment, device, *,
                 fake_encode: bool, threshold_dtype=torch.float32):
        if dep.channel_backend != "fused":
            raise NotImplementedError("the reference draws the quantile "
                                      "channel only")
        if code.n_var % dep.mod_type or code.n_var % dep.interleave_depth:
            raise ValueError("n_var is not a whole number of symbols and of "
                             "interleaver rows")
        self.code, self.dep = code, dep
        self.device = torch.device(device)
        self.dcfg = dep.decoder()
        self.threshold_dtype = threshold_dtype
        self.encode = None if fake_encode else make_encode_fn(code, self.device)
        self._params = {}

    def thresholds(self, sigma: float) -> torch.Tensor:
        if sigma not in self._params:
            make = (threshold_ints if self.dep.mod_type in (1, 2)
                    else plan_threshold_ints)
            self._params[sigma] = make(self.dep, sigma,
                                       self.threshold_dtype).to(self.device)
        return self._params[sigma]

    def codewords(self, seed: int, rnd: int, frame0: int, batch: int):
        """The round's codewords [batch, n_var] int8, None for the zero
        word."""
        if self.encode is None:
            return None
        return self.encode(philox.message_bits(
            seed, rnd, frame0, batch, self.code.n_info, self.device))

    def round_counters(self, seed: int, rnd: int, sigma: float, frame0: int,
                       batch: int) -> dict:
        code, dep = self.code, self.dep
        cw = self.codewords(seed, rnd, frame0, batch)
        params = self.thresholds(sigma)
        if dep.mod_type in (1, 2):
            llr, err = binary_channel(params, seed=seed, rnd=rnd, batch=batch,
                                      n_var=code.n_var, quant_bits=dep.quant_bits,
                                      frame0=frame0, cw=cw)
        else:
            llr, err = qam_channel(params, seed=seed, rnd=rnd, batch=batch,
                                   n_var=code.n_var, mod_type=dep.mod_type,
                                   depth=dep.interleave_depth,
                                   quant_bits=dep.quant_bits, scale=dep.scale,
                                   frame0=frame0, cw=cw)
        mod_bits, mod_syms = mod_stats(err, code.n_info, dep.mod_type)
        err_bits, mp_iters, bf_rounds = stats_decode(llr, code, self.dcfg, cw)
        frame_err = err_bits > 0
        ints = {
            "test_frames": batch,
            "error_bits": err_bits.sum(),
            "error_frames": frame_err.sum(),
            "lt3_frames": (frame_err & (err_bits < 3)).sum(),
            "mod_error_bits": mod_bits.sum(),
            "mod_error_symbols": mod_syms.sum(),
            "mod_error_frames": (mod_bits > 0).sum(),
            "mp_iters": mp_iters.sum(),
            "bf_rounds": bf_rounds.sum(),
        }
        out = {k: int(v) for k, v in ints.items()}
        out["mp_hist"] = _histogram(mp_iters, self.dcfg.max_iter + 1)
        out["bf_hist"] = _histogram(bf_rounds, max(self.dcfg.bf.max_iter, 1) + 1)
        return out

    def sync_counters(self, seed: int, sigma: float, snr_idx: int, round0: int,
                      rounds: int, frame0: int, batch: int) -> dict:
        """The counters of rounds ``round0 .. round0 + rounds - 1`` of SNR
        point ``snr_idx``, summed."""
        total = None
        for rnd in range(round0, round0 + rounds):
            c = self.round_counters(seed, philox.stream_round(snr_idx, rnd),
                                    sigma, frame0, batch)
            total = c if total is None else add(total, c)
        return total
