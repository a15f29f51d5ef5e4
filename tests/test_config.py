import pytest

from dqmc_tpu.config import Parameters

EXAMPLE = """
[Lattice]
L1 = 6
L2 = 6

[hubbard]
U = 4.0                        # On-site interaction strength
t =  1.0                        ; alt comment
mu = -0.1

[simulation]
beta = 4.0
nt = 40
n_therms = 2_000
symmetric = true
name = "hello world"

[ParallelTempering]
enabled = false
betas = 5.0, 4.5, 4.0, 3.5, 3.0, 2.5
"""


def test_basic_types():
    p = Parameters.from_string(EXAMPLE)
    assert p.get_int("Lattice", "L1") == 6
    assert p.get_float("hubbard", "U") == 4.0
    assert p.get_float("hubbard", "t") == 1.0  # inline ';' comment stripped
    assert p.get_float("hubbard", "mu") == -0.1
    assert p.get_int("simulation", "n_therms") == 2000  # underscore numeral
    assert p.get_bool("simulation", "symmetric") is True
    assert p.get_bool("ParallelTempering", "enabled") is False
    assert p.get_str("simulation", "name") == "hello world"  # quotes stripped


def test_float_list():
    p = Parameters.from_string(EXAMPLE)
    assert p.get_float_list("ParallelTempering", "betas") == [
        5.0, 4.5, 4.0, 3.5, 3.0, 2.5]


def test_defaults_and_missing():
    p = Parameters.from_string(EXAMPLE)
    assert p.get_bool("simulation", "nope", False) is False
    assert p.get_int("simulation", "nope", 7) == 7
    assert p.get_float("nosection", "x", 1.5) == 1.5
    with pytest.raises(KeyError):
        p.get_int("simulation", "nope")
    with pytest.raises(KeyError):
        p.get_str("nosection", "x")


def test_has_and_global_section():
    p = Parameters.from_string("a = 1\n[s]\nb = 2\n")
    assert p.has_section("global") and p.has_key("global", "a")
    assert p.get_int("global", "a") == 1
    assert p.has_key("s", "b") and not p.has_key("s", "a")


def test_int_accepts_float_literal():
    # reference reads nt with getDouble in one place, getInt in another
    p = Parameters.from_string("[s]\nnt = 40.0\n")
    assert p.get_int("s", "nt") == 40


def test_reference_example_file():
    """examples/basic is the in-repo copy of the reference's own example."""
    import os
    p = Parameters(os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples", "basic", "parameters.in"))
    assert p.get_int("Lattice", "L1") == 6
    assert p.get_float("simulation", "beta") == 4.0
    assert p.get_int("simulation", "n_stab") == 10
    assert p.get_bool("simulation", "isMeasureUnequalTime") is False


def test_defaulted_f64_enables_x64_subprocess():
    """Regression: a CPU run with NO [simulation] dtype resolves to f64 and
    must flip jax_enable_x64 — without it every array silently truncated
    to f32 (caught as a ~1e-0 self-check error on a run claiming f64).
    Needs a subprocess: the test session itself pre-enables x64."""
    import os
    import subprocess
    import sys

    code = """
import jax
jax.config.update("jax_platforms", "cpu")
from dqmc_tpu.config import Parameters
from dqmc_tpu.run import _resolve_dtype
params = Parameters.from_string('''
[simulation]
beta = 2.0
''')
dtype, df = _resolve_dtype(params)
import jax.numpy as jnp
assert dtype == jnp.float64 and not df
assert jax.config.jax_enable_x64, "x64 not enabled for defaulted f64"
assert jnp.zeros(1).dtype == jnp.float64
print("X64_OK")
"""
    env = dict(os.environ, JAX_ENABLE_X64="0")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "X64_OK" in out.stdout, out.stderr[-1500:]
