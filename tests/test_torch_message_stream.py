"""The message stream's kernel (faid_tpu_torch/csrc/message_stream.cu,
ops/philox.py ``message_bits``) against its plain twin
``message_bits_plain``, bit for bit, and the dispatch by device: a CPU
tensor takes the plain twin, a CUDA one launches the kernel once.

The cases marked ``cuda`` need an NVIDIA GPU and skip without one.  This
file imports no JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_message_stream.py
"""

from __future__ import annotations

import pytest
import torch

from faid_tpu_torch.ops import philox
from faid_tpu_torch.utils import kernels

FULL = 14592                       # 50G-PON's information bits
SEED, RND = 2024101, 5

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the message stream's kernel runs "
                    "only on the card")
    return torch.device("cuda")


def _launched(seed, rnd, frame0, batch, n_bits, device):
    """The kernel's bits, checked to take exactly one launch."""
    before = kernels.launches["M"]
    bits = philox.message_bits(seed, rnd, frame0, batch, n_bits, device)
    assert kernels.launches["M"] == before + 1
    return bits


def _check_kernel(seed, rnd, frame0, batch, n_bits, device):
    got = _launched(seed, rnd, frame0, batch, n_bits, device)
    assert got.dtype == torch.int8 and got.shape == (batch, n_bits)
    assert got.device.type == "cuda" and got.is_contiguous()
    want = philox.message_bits_plain(seed, rnd, frame0, batch, n_bits, "cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_bits",
                         [(2048, FULL), (32, FULL)]
                         + [(b, n) for n in (10, 100, 127, 128, 129, 300)
                            for b in (1, 17, 64)])
def test_kernel_matches_plain(cuda, batch, n_bits):
    _check_kernel(SEED, RND, 0, batch, n_bits, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,rnd,frame0,batch,n_bits", [
    (SEED, RND, 4096, 64, 300),                        # frame0 > 0
    (SEED, RND, 1000, 2048, FULL),
    (SEED, RND, 2**32 - 17, 17, 129),                  # the last frames
    (SEED, RND, 2**32 - 2048, 2048, FULL),
    (2**40 + 12345, RND, 0, 64, FULL),                 # a seed >= 2^32
    (2**64 - 1, RND, 3, 17, 100),
    (SEED, philox.stream_round(3, 7), 0, 2048, FULL),  # a round >= 2^32
    (SEED, philox.stream_round(3, 7), 64, 17, 300),
])
def test_kernel_stream_points(cuda, seed, rnd, frame0, batch, n_bits):
    _check_kernel(seed, rnd, frame0, batch, n_bits, cuda)


@pytest.mark.cuda
def test_kernel_on_the_current_stream(cuda):
    """The launch goes to the caller's current stream, not the default."""
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        got = _launched(SEED, RND, 0, 256, FULL, cuda)
    side.synchronize()
    assert torch.equal(got.cpu(), philox.message_bits_plain(SEED, RND, 0, 256, FULL, "cpu"))


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
@pytest.mark.parametrize("seed,rnd,frame0,batch,n_bits", [
    (SEED, RND, 0, 17, 10), (SEED, RND, 0, 3, 129), (SEED, RND, 9, 5, 300),
    (2**40 + 12345, philox.stream_round(3, 7), 2**32 - 4, 4, 1000),
])
def test_cpu_takes_the_plain_twin(device, seed, rnd, frame0, batch, n_bits):
    before = kernels.launches["M"]
    got = philox.message_bits(seed, rnd, frame0, batch, n_bits, device)
    assert kernels.launches["M"] == before
    assert torch.equal(got, philox.message_bits_plain(seed, rnd, frame0, batch,
                                                      n_bits, "cpu"))


def test_other_devices_and_bad_frames_refused():
    with pytest.raises(ValueError, match="for device meta"):
        philox.message_bits(SEED, RND, 0, 2, 10, "meta")
    with pytest.raises(ValueError):
        philox.message_bits(SEED, RND, 2**32 - 1, 2, 10, "cpu")


def test_entry_point_matches_the_source():
    """The kernel's source is one of the library's; its C entry's signature
    is held by the ``cuda`` cases above, whose stream points (a seed and a
    round past 2^32, frame0 near 2^32) differ where an argument is cut."""
    assert "message_stream.cu" in kernels.SOURCES
    assert "faid_message_bits" in kernels._SIGNATURES
