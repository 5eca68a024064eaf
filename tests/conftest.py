"""Test configuration: CPU with an 8-device virtual mesh unless told otherwise.

Mirrors SURVEY.md section 4's multi-host-without-a-pod strategy: sharding
tests run on a virtual CPU mesh; sharded-vs-single-device equality is the
invariant.  JAX_PLATFORMS defaults to cpu here; tests marked `gpu` need a
card and skip without one (run them with JAX_PLATFORMS=cuda on the card).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from peba1.utils.cache import enable_compile_cache  # noqa: E402

# Persistent compile cache: amortizes the expensive XLA CPU compiles (the
# one-program shard_map forms are tens of minutes cold; warm they are
# seconds).  Only graphs over 10s of compile are cached to keep it small.
enable_compile_cache(min_compile_secs=10.0)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bounded_jit_state():
    """Drop compiled executables between test modules.

    The full suite compiles hundreds of XLA CPU executables in one process;
    with all of them kept live, the CPU client's JIT has been observed to
    segfault inside backend_compile_and_load partway through the run
    (deterministically at the same compile, while the same tests pass in any
    smaller subset).  Clearing the jit caches at module boundaries bounds the
    accumulated state; module-scoped fixtures (keys etc.) are unaffected and
    per-module recompiles are covered by the persistent cache below.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(42)


@pytest.fixture(scope="session")
def toy_keys(rng):
    """Shared TOY keyset (keygen is the slowest fixture -- do it once)."""
    from peba1 import keys
    from peba1.params import TOY

    return keys.keygen(rng, TOY)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none (decided
    here, never at import time, so every xdist worker collects the same
    tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda on the card)")
    return jax.devices()[0]
