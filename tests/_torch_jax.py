"""What the port's test files share about the JAX references they run.

Import the fixture by name into a test module; it is autouse, so it then
applies to every test there:

    from _torch_jax import unoptimized_jax_compiles  # noqa: F401
"""

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def unoptimized_jax_compiles():
    """The JAX references compile many small programs, for which XLA's
    optimization passes cost more CPU than they save; they change no
    integer result and no single float operation's rounding."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)
