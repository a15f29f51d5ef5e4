"""The platform -> path decisions (dqmc_tpu.platform), the errors for the
options the GPU translation removed, the compile-cache location rules,
chip_smoke.py's refusal of a machine without a GPU, and sampling without
h5py installed."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from dqmc_tpu import compile_cache, platform
from dqmc_tpu.config import Parameters
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard, RepulsiveHubbard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(kind, L=4):
    cls = AttractiveHubbard if kind == "attractive" else RepulsiveHubbard
    return cls.build(square_lattice(L, L), U=4.0, t=1.0, mu=0.0, beta=2.0,
                     nt=8, dtype=jnp.float64)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("kind", ["attractive", "repulsive"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_site_update_choice(backend, dtype, kind, sharded, monkeypatch):
    """The Triton kernel only for GPU + f32 + one stored flavor + an
    unsharded batch; XLA delayed updates for every other GPU case; the
    rank-1 reference loop on the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    got = platform.site_update(_model(kind), dtype, sharded=sharded)
    if backend == "cpu":
        want = "scan"
    elif dtype == jnp.float32 and kind == "attractive" and not sharded:
        want = "pallas"
    else:
        want = "delayed"
    assert got == want


def test_site_update_large_lattice_leaves_kernel(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.site_update(_model("attractive", L=17),
                                jnp.float32) == "delayed"


@pytest.mark.parametrize("backend,dtype,jit", [
    ("cpu", jnp.float64, False), ("gpu", jnp.float32, True)])
def test_dtype_and_multiword_jit(backend, dtype, jit, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert platform.default_dtype() == dtype
    assert platform.jit_multiword() is jit


def test_unknown_backend_is_an_error(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.backend()
    with pytest.raises(RuntimeError):
        platform.site_update(_model("attractive"), jnp.float32)


def test_require_gpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        platform.require_gpu("the thing")


_BASE = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 2.0
nt = 8
n_therms = 2
n_sweeps = 2
n_bins = 1
n_stab = 4
dtype = float64
{extra}
"""


@pytest.mark.parametrize("extra,exc,match", [
    ("engine = fused", ValueError, "engine = fused was removed"),
    ("site_update = pallas", RuntimeError, "needs a GPU"),
    ("site_update = magic", ValueError, "site_update must be"),
])
def test_removed_and_bad_options_raise(extra, exc, match):
    from dqmc_tpu.run import make_engine_config
    params = Parameters.from_string(_BASE.format(extra=extra))
    with pytest.raises(exc, match=match):
        make_engine_config(params, _model("attractive"))


@pytest.mark.parametrize("site_update,want", [
    ("auto", dict(use_pallas=False, delay_rank=0, submatrix_rank=0)),
    ("delayed", dict(use_pallas=False, delay_rank=32, submatrix_rank=0)),
    ("submatrix", dict(use_pallas=False, delay_rank=0, submatrix_rank=32)),
])
def test_engine_config_from_parameters(site_update, want):
    from dqmc_tpu.run import make_engine_config
    params = Parameters.from_string(
        _BASE.format(extra=f"site_update = {site_update}"))
    cfg = make_engine_config(params, _model("attractive"))
    for k, v in want.items():
        assert getattr(cfg, k) == v


def test_submatrix_with_pallas_kernel_raises():
    from dqmc_tpu.engine import EngineConfig
    with pytest.raises(ValueError, match="no Pallas kernel"):
        EngineConfig(nt=8, n_stab=2, use_pallas=True, submatrix_rank=8)


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert path == compile_cache.cache_dir()      # no pid / time in it
    assert compile_cache.enable() == path
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the module uses it and sets no
    directory of its own (JAX reads the variable itself)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    assert compile_cache.enable() == str(tmp_path / "cc")
    assert (tmp_path / "cc").is_dir()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_ignores_removed_variable(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setenv("DQMC_COMPILE_CACHE", "off")
    assert compile_cache.enable() == os.path.join(REPO, ".jax_cache")


def _run(cmd, cwd, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run(cmd, cwd=cwd, env=e, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_refuses_cpu(tmp_path):
    """No GPU: non-zero exit and no result line, both from the checkout
    and from a directory holding chip_smoke.py alone."""
    out = _run([sys.executable, os.path.join(REPO, "chip_smoke.py")], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "lone"
    lone.mkdir()
    (lone / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    out = _run([sys.executable, "chip_smoke.py", "--four"], lone)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_NO_H5PY = r"""
import sys
sys.modules["h5py"] = None          # any import of h5py now fails
import jax
jax.config.update("jax_platforms", "cpu")
from dqmc_tpu.config import Parameters
from dqmc_tpu.run import run_simulation
from dqmc_tpu.analysis import cli      # importable without h5py
from dqmc_tpu.io.spool import read_spool
params = Parameters.from_string(sys.argv[2])
s = run_simulation(params, out_dir=sys.argv[1], verbose=False)
bins = sorted({b for _, b, _ in read_spool(sys.argv[1] + "/data_0.spool")})
print("BINS", bins, s.n_bins)
"""


def test_sampling_without_h5py(tmp_path):
    """Sampling never imports h5py: with it blocked, a spool-sink run
    completes, keeps its binary log (readable by the Python reader) and
    says on stderr that the HDF5 conversion needs h5py."""
    cfg = _BASE.format(extra="").replace("n_bins = 1", "n_bins = 2") \
        + "[io]\nsink = spool\n"
    out = _run([sys.executable, "-c", _NO_H5PY, str(tmp_path / "res"), cfg],
               tmp_path, PYTHONPATH=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BINS [0, 1] 2" in out.stdout
    assert "needs h5py" in out.stderr
    assert (tmp_path / "res" / "data_0.spool").exists()
    assert not (tmp_path / "res" / "data_0.h5").exists()
