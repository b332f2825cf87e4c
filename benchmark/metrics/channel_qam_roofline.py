"""channel_qam_roofline: the share of kernel G's device time (the
16/64/256-QAM quantile channel, csrc/qam_channel.cu) that the least time
of its work takes on the H100: 100 x bound / device time over the
profiled syncs.

The work is ``qam_least_ops`` (benchmark/opmodel.py, frozen) on the
cell's own thresholds, worked out again from sigma by the reference
(``plan_threshold_ints``), and on each rail's threshold row, which the
sent word's magnitude bits choose: the reference regenerates every
profiled round's codewords from the seed.  The bytes: the LLRs and the
ModCalErr map written, the codewords read.  G runs once a round on each
rank; launches that the profiler dropped count at the mean device time
of the rest (``Readings.launch_seconds``)."""

import torch

from benchmark import opmodel
from benchmark.reference import philox
from benchmark.reference.config import Deployment
from benchmark.reference.qam import interleave, magnitude_index, plan_threshold_ints
from benchmark.reference.round import RoundReference

KERNEL_G = "qam_channel_kernel"


def read(r):
    if not r.profiled:
        return None
    p = r.lead["profile"]
    rps = r.lead["rounds_per_sync"]
    rounds = range(p["first"] * rps, p["stop"] * rps)
    seconds = r.launch_seconds(lambda name: KERNEL_G in name, len(rounds))
    if seconds is None:
        return None
    n = len(rounds) * len(r.ranks)
    code, dep = r.ref_code, Deployment.from_config(r.config)
    mod, h, depth = dep.mod_type, dep.mod_type // 2, dep.interleave_depth
    batch, nsym = dep.batch_per_device, code.n_var // dep.mod_type
    params = plan_threshold_ints(dep, dep.sigma_at(r.cell["snr_db"]))
    ref = RoundReference(code, dep, r.device,
                         fake_encode=r.cell["encode"] == "zero_word")
    per_row = torch.zeros(params.shape[0], dtype=torch.int64)
    with torch.no_grad():
        for rank in range(len(r.ranks)):
            for rnd in rounds:
                cw = ref.codewords(r.seed, philox.stream_round(0, rnd),
                                   rank * batch, batch)
                if cw is None:
                    per_row[0] += batch * 2 * nsym
                    continue
                grp = interleave(cw, depth).reshape(batch, nsym, h, 2)
                m = magnitude_index([grp[:, :, i] for i in range(1, h)])
                per_row += torch.bincount(torch.as_tensor(m).reshape(-1),
                                          minlength=params.shape[0]).cpu()
    ops = opmodel.qam_least_ops_counts(params, per_row, n, mod, dep.quant_bits)
    n_bytes = n * batch * code.n_var * (2 if r.cell["encode"] == "zero_word" else 3)
    least_ms, _ = opmodel.bound(n_bytes, ops)
    return 100 * least_ms / 1e3 / seconds
