"""Test configuration.

Tests run on the CPU with a faked 8-device mesh ("test multi-device
without a cluster") and with x64 enabled so that numerical parity can be
asserted at f64 tolerances.  Environment variables must be set before jax
initializes its backends, hence at module import.  Tests marked ``gpu``
skip here (see the ``gpu`` fixture); chip_smoke.py runs those checks on
the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_backend_optimization_level" not in _flags:
    # XLA:CPU's LLVM backend at opt > 0 contracts/reassociates across the
    # double-float error-free transformations, corrupting df32 chains
    # (1.1e-8 -> 5.4e-4 on the beta=8 rebuild — NOTES.md round-4 log);
    # opt 0 restores true df numerics AND cuts suite wall time ~2.5x
    # (the suite is compile-dominated).
    _flags = (_flags + " --xla_backend_optimization_level=0").strip()
os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: the suite is compile-dominated, and cache
# keys include backend + flags so the CPU/x64/opt-0 programs never collide
# with production GPU entries
from dqmc_tpu import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop each test module's compiled programs when it ends.  XLA:CPU
    maps every executable into memory; a worker that keeps hundreds of
    large multiword programs alive eventually crashes inside
    backend_compile.  The persistent compile cache keeps re-compiles
    cheap."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU.  Decided here, at run time, and
    never while a module is imported, so every worker collects the same
    tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
