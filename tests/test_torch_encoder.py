"""PyTorch port, the encoder and the message stream
(faid_tpu_torch/code/encoder.py, ops/philox.py ``message_bits``) against
faid_tpu.code.encoder: the same codewords for the same message bits on
the full 50G-PON code and on a toy code, H c = 0, the reference
codeword fixture, the toy projection matrix, and the message stream's
determinism and disjointness from the channel's words."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax import unoptimized_jax_compiles  # noqa: F401
from faid_tpu.code import encoder as jenc
from faid_tpu.code.qc_matrix import load_code as jload_code
from faid_tpu.code.toy import toy_code as jtoy_code
from faid_tpu_torch.code import encoder
from faid_tpu_torch.code.qc_matrix import load_code
from faid_tpu_torch.code.toy import toy_code
from faid_tpu_torch.ops import philox

# The suite runs in several worker processes on one CPU: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


CODEWORD = (Path(__file__).parent.parent / "faid_tpu" / "code" / "data"
            / "50gpon_codeword.npz")


@pytest.mark.parametrize("which,batch", [("50gpon", 8), ("toy", 20), ("toy", 3)])
def test_encode_matches_jax(which, batch):
    """The port's encode against make_encode_fn on the same message bits
    (from the port's message stream), and H c = 0 for every frame; batch
    3 goes through the padded product."""
    if which == "toy":
        jcode, code = jtoy_code(), toy_code()
    else:
        jcode, code = jload_code("50gpon"), load_code("50gpon")
    u = philox.message_bits(13, 4, 0, batch, code.n_info, "cpu")
    got = encoder.make_encode_fn(code, "cpu")(u)
    want = np.asarray(jenc.make_encode_fn(jcode)(jnp.asarray(u.numpy())))
    assert got.dtype == torch.int8 and got.shape == (batch, code.n_var)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got[:, :code.n_info], u)                 # systematic
    assert (jenc.syndrome_weight_np(jcode, got.numpy()) == 0).all()
    assert (encoder.syndrome_weight(code, got) == 0).all()
    assert got[:, code.n_info:].any()


def test_zero_message_and_reference_codeword():
    """The zero message encodes to the zero word; the reference authors'
    own codeword (faid_tpu/code/data/50gpon_codeword.npz) is re-encoded
    from its info bits and satisfies every check."""
    code = load_code("50gpon")
    encode = encoder.make_encode_fn(code, "cpu")
    zero = encode(torch.zeros((2, code.n_info), dtype=torch.int8))
    assert not zero.any()
    c = np.load(CODEWORD)["codeword"].astype(np.int8)
    assert 0 < c.sum() < code.n_var
    got = encode(torch.from_numpy(c[None, :code.n_info].copy()))
    np.testing.assert_array_equal(got[0].numpy(), c)
    p = encoder.encoder_matrix(code)
    np.testing.assert_array_equal((p.astype(np.int64) @ c[:code.n_info]) % 2,
                                  c[code.n_info:])
    assert int(encoder.syndrome_weight(code, torch.from_numpy(c[None]))[0]) == 0


@pytest.mark.parametrize("kw", [{}, dict(z=16, n_block_cols=10, n_block_rows=3)])
def test_toy_encoder_matrix_matches_jax(kw):
    """The numpy elimination gives the JAX package's projection matrix,
    which the port never writes to disk."""
    got = encoder.encoder_matrix(toy_code(**kw))
    want = jenc.encoder_matrix(jtoy_code(**kw))
    np.testing.assert_array_equal(got, want)
    assert not got.flags.writeable
    h = toy_code(**kw).h_dense()
    np.testing.assert_array_equal(
        encoder.solve_parity_projection(h, toy_code(**kw).n_info), got)
    with pytest.raises(ValueError, match="singular"):
        encoder.solve_parity_projection(np.zeros_like(h), toy_code(**kw).n_info)


def test_message_stream():
    """Message bits are a pure function of (seed, round, frame, bit), fair,
    and drawn from counters the channel never uses."""
    a = philox.message_bits(5, 9, 0, 6, 300, "cpu")
    assert a.dtype == torch.int8 and a.shape == (6, 300)
    assert set(a.unique().tolist()) == {0, 1}
    assert torch.equal(philox.message_bits(5, 9, 0, 6, 300, "cpu"), a)
    # any frame, any prefix of the bits, whatever the batch
    assert torch.equal(philox.message_bits(5, 9, 4, 2, 300, "cpu"), a[4:])
    assert torch.equal(philox.message_bits(5, 9, 0, 6, 100, "cpu"), a[:, :100])
    for other in (philox.message_bits(6, 9, 0, 6, 300, "cpu"),
                  philox.message_bits(5, 10, 0, 6, 300, "cpu")):
        assert 0.4 < float((other != a).float().mean()) < 0.6
    big = philox.message_bits(1, 0, 0, 64, 14592, "cpu").float()
    assert abs(float(big.mean()) - 0.5) < 0.005
    # bit j of a frame: bit j % 32 of word (j // 32) % 4 of the call j // 128,
    # whose counter has the top bit of word 0 set
    w = philox.philox4x32(*(torch.tensor([v], dtype=torch.int64) for v in
                            (2**31 | 1, 3, 9, 0)), 5, 0)
    j = 128 + 2 * 32 + 7
    assert int(a[3, j]) == (int(w[2]) >> 7) & 1
    # the channel's counters keep word 0 below 2^31 for any codeword length
    ch = philox.channel_words(5, 9, 0, 6, 300, "cpu")
    w_ch = philox.philox4x32(*(torch.tensor([v], dtype=torch.int64) for v in
                               (1, 3, 9, 0)), 5, 0)
    assert int(ch[3, 4 + 2]) == int(philox._as_int32(w_ch[2]))
    assert int(w_ch[2]) != int(w[2])
    with pytest.raises(ValueError):
        philox.message_bits(5, 9, 2**32 - 1, 2, 10, "cpu")


def test_encode_refuses_bad_input():
    code = toy_code()
    encode = encoder.make_encode_fn(code, "cpu")
    for bad in (torch.zeros((4, code.n_info), dtype=torch.int32),
                torch.zeros((4, code.n_info + 1), dtype=torch.int8),
                torch.zeros((code.n_info,), dtype=torch.int8)):
        with pytest.raises(ValueError):
            encode(bad)
