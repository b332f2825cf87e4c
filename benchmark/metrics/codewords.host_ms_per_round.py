"""codewords.host_ms_per_round: the host's milliseconds a round inside the
round itself of the message stream (``philox.message_bits``) and the
encoder (code/encoder.py), over the window's rounds: the program's own
spans ``pipeline.message_stream`` and ``pipeline.encoder``.  None with
the all-zero word, which has neither."""

from benchmark.metrics._program_spans import span_ns, window

STAGES = ("pipeline.message_stream", "pipeline.encoder")


def read(r):
    recs = window(r)
    if not recs or not any(s in x["spans"] for x in recs for s in STAGES):
        return None
    ns = sum(span_ns(x, s) for x in recs for s in STAGES)
    return ns / sum(x["rounds"] for x in recs) / 1e6
