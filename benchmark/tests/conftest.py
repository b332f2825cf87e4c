"""The benchmark's own tests.  They run on the CPU; a test that needs the
card takes the ``card`` fixture, which skips without one.

    python -m pytest benchmark/tests -q
"""

import pytest
import torch


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    """One intra-op thread: the tests run the plain path on small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
