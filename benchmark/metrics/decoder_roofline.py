"""decoder_roofline: the share of the decoder kernels' device time that the
least time of their work takes on the H100 (benchmark/opmodel.py, frozen):
100 x bound / device time, over the profiled syncs of every rank.

The work is counted from the code file and the runner's counters of the
same syncs, never from the program's objects: the MP iterations, sweeps,
DTBF rounds and tails of ``decoder_ops_from_histograms`` on the syncs'
iteration histograms, the error count (an add per info bit), and where
kernel F ran the round its channel prologue (``channel_ops`` a launch).
The kernels are found by the names below, one launch a round on each
rank; launches that the profiler dropped count at the mean device time
of the rest (``Readings.launch_seconds``)."""

import re

from benchmark import opmodel
from benchmark.reference.config import Deployment

# csrc/decoder.cuh ``decoder_kernel<kOut, ...>``: kOut 3 (kSim) is kernel
# F, the whole round; 0 (kStats) kernel B, the stats decoder
_OUT = r"decoder_kernel<\s*(?:\((?:faid::)?Out\))?\s*(?:faid::)?"
KERNEL_F = re.compile(_OUT + r"(?:3|kSim)\b")
KERNEL_B = re.compile(_OUT + r"(?:0|kStats)\b")


def read(r):
    if not r.profiled:
        return None
    code = r.ref_code
    dep = Deployment.from_config(r.config)
    tables = opmodel.code_tables(code, dep.decoder())
    counters = r.lead["profile"]["counters"]
    sim = r.ops(KERNEL_F.search)[0] > 0
    if sim == (r.ops(KERNEL_B.search)[0] > 0):
        return None
    seconds = r.launch_seconds((KERNEL_F if sim else KERNEL_B).search,
                               r.profile_rounds())
    if seconds is None:
        return None
    batch = dep.batch_per_device
    launches = r.profile_rounds() * len(r.ranks)
    ops = (opmodel.decoder_ops_from_histograms(code, tables, counters["mp_hist"],
                                               counters["bf_hist"])
           + counters["test_frames"] * code.n_info)
    if sim:
        # F's channel prologue; it writes its five counters
        ops += launches * opmodel.channel_ops(batch, code.n_var, opmodel.QUANT_L)
        n_bytes = launches * 5 * 4 * batch
    else:
        # B reads the LLRs and writes three counters
        n_bytes = launches * (batch * code.n_var + 3 * 4 * batch)
    least_ms, _ = opmodel.bound(n_bytes, ops)
    return 100 * least_ms / 1e3 / seconds
