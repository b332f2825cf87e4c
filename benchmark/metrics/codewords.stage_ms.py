"""codewords.stage_ms: the device milliseconds of one round's message
stream and encoder alone at the cell's batch (the program's
``philox.message_bits``, then ``code/encoder.py``'s encode): CUDA events
over 20 calls after a warm one, as faid_tpu_torch/scripts/roofline.py
times a stage.  Read once the window and the check are over."""

from benchmark import opmodel

REPS = 20


def read(r):
    if not r.profiled or r.cell["encode"] != "codewords":
        return None
    from faid_tpu_torch.code.encoder import make_encode_fn
    from faid_tpu_torch.code.qc_matrix import load_code
    from faid_tpu_torch.ops import philox

    code = load_code(r.config["settings"]["code"])
    batch = r.config["settings"]["batch_per_device"]
    encode = make_encode_fn(code, r.device)

    def stage():
        return encode(philox.message_bits(r.seed, 5, 0, batch, code.n_info,
                                          r.device))

    return opmodel.cuda_ms(stage, REPS)
