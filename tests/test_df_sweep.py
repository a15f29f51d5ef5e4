"""Hybrid df32 sweep engine: wiring + stabilized parity vs the f64 engine.

Tolerance note: the suite runs XLA:CPU at --xla_backend_optimization_level=0
(tests/conftest.py), where the jitted df engine carries its true tier
(~1e-9 at this beta; at default opt level CPU codegen corrupts fused df
graphs to ~1e-5 — NOTES.md).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dqmc_tpu.engine import EngineConfig  # noqa: E402
from dqmc_tpu.engine.df_sweep import (  # noqa: E402
    df_aux_build,
    df_aux_from,
    df_sweep_pair,
    init_state_df,
)
from dqmc_tpu.engine.sweep import rebuild_stack_and_greens  # noqa: E402
from dqmc_tpu.lattice import square_lattice  # noqa: E402
from dqmc_tpu.models import AttractiveHubbard  # noqa: E402
from dqmc_tpu.ops import df32  # noqa: E402

jax.config.update("jax_enable_x64", True)

KW = dict(U=4.0, t=1.0, mu=-0.1, beta=4.0, nt=20)


@pytest.fixture(scope="module")
def setup():
    lat = square_lattice(4, 4)
    m32 = AttractiveHubbard.build(lat, dtype=jnp.float32, **KW)
    m64 = AttractiveHubbard.build(lat, dtype=jnp.float64, **KW)
    aux = df_aux_build(lat, **KW)
    cfg = EngineConfig(nt=KW["nt"], n_stab=5)
    return lat, m32, m64, aux, cfg


def test_df_aux_equivalence(setup):
    """Host-side aux build == x64 model-twin aux build, bit for bit."""
    lat, m32, m64, aux, cfg = setup
    aux2 = df_aux_from(m64)
    for a, b in zip(jax.tree_util.tree_leaves(aux),
                    jax.tree_util.tree_leaves(aux2)):
        assert bool(jnp.all(a == b))


def test_df_sweep_stabilized_parity(setup):
    """After sweeps, G_df must equal the f64 engine's rebuild on the SAME
    final fields — the stabilization path carries df accuracy."""
    lat, m32, m64, aux, cfg = setup
    st = init_state_df(m32, aux, cfg, jax.random.PRNGKey(7))
    for _ in range(3):
        st = df_sweep_pair(m32, aux, cfg, st)
    assert 0.1 < float(st.acc_sum) / 6 < 0.9
    _, G64, ld64 = rebuild_stack_and_greens(m64, cfg,
                                            st.fields.astype(jnp.int32))
    err = float(jnp.max(jnp.abs(df32.to_f64(st.G_df) - G64)))
    assert err < 1e-6, err          # true df tier at beta=4 (~1e-9)
    # the f32 working G tracks the df rebuild it was reset from
    assert float(jnp.max(jnp.abs(st.G - st.G_df.hi))) == 0.0
    assert abs(float(st.log_det_M[0]) - float(ld64[0])) < 1e-2


def test_df_sweep_walker_vmap(setup):
    """The engine vmaps over a walker axis (the production layout)."""
    lat, m32, m64, aux, cfg = setup
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    init = jax.vmap(lambda k: init_state_df(m32, aux, cfg, k))(keys)
    step = jax.vmap(lambda s: df_sweep_pair(m32, aux, cfg, s))
    out = step(init)
    assert out.G.shape == (3, 1, 16, 16)
    assert np.isfinite(np.asarray(out.err_max)).all()
    # walkers decorrelate: different keys -> different fields
    f = np.asarray(out.fields)
    assert not np.array_equal(f[0], f[1])


def test_df_sweep_two_flavor_repulsive():
    """The df parity tier serves the 2-flavor repulsive model: after
    sweeps, G_df (both flavors) must match the f64 engine's rebuild on
    the same final fields, and the chain stays sign-free at half
    filling."""
    from dqmc_tpu.models import RepulsiveHubbard

    kw = dict(U=4.0, t=1.0, mu=0.0, beta=4.0, nt=20)
    lat = square_lattice(4, 4)
    m32 = RepulsiveHubbard.build(lat, dtype=jnp.float32, **kw)
    m64 = RepulsiveHubbard.build(lat, dtype=jnp.float64, **kw)
    aux = df_aux_build(lat, n_flavor=2, **kw)
    assert aux.expv.hi.shape == (2, 4)
    cfg = EngineConfig(nt=kw["nt"], n_stab=5)

    st = init_state_df(m32, aux, cfg, jax.random.PRNGKey(11))
    for _ in range(3):
        st = df_sweep_pair(m32, aux, cfg, st)
    assert 0.1 < float(st.acc_sum) / 6 < 0.9
    assert float(st.sign) == 1.0            # PH-symmetric: sign-free
    _, G64, ld64 = rebuild_stack_and_greens(m64, cfg,
                                            st.fields.astype(jnp.int32))
    assert G64.shape == (2, 16, 16)
    err = float(jnp.max(jnp.abs(df32.to_f64(st.G_df) - G64)))
    assert err < 1e-6, err
    assert float(jnp.max(jnp.abs(st.G - st.G_df.hi))) == 0.0
    np.testing.assert_allclose(np.asarray(st.log_det_M),
                               np.asarray(ld64), atol=1e-2)


def test_df_sweep_deterministic(setup):
    """Same key -> bit-identical trajectory."""
    lat, m32, m64, aux, cfg = setup
    a = df_sweep_pair(m32, aux, cfg,
                      init_state_df(m32, aux, cfg, jax.random.PRNGKey(3)))
    b = df_sweep_pair(m32, aux, cfg,
                      init_state_df(m32, aux, cfg, jax.random.PRNGKey(3)))
    assert bool(jnp.all(a.fields == b.fields))
    assert bool(jnp.all(a.G == b.G))


@pytest.mark.parametrize("nt", [20, 23])          # exact and ragged-tail
def test_stack_inplace_matches_concat(nt):
    """DQMC_STACK_INPLACE=1 (carried-write stack, round-4 stretch-memory
    path) must produce bit-identical state to the scan-slots+concat
    assembly, through init and a forward+backward sweep pair."""
    import os

    lat = square_lattice(4, 4)
    kw = dict(U=4.0, t=1.0, mu=-0.1, beta=4.0, nt=nt)
    m32 = AttractiveHubbard.build(lat, dtype=jnp.float32, **kw)
    aux = df_aux_build(lat, **kw)
    cfg = EngineConfig(nt=nt, n_stab=5)
    key = jax.random.PRNGKey(5)

    def run():
        s = init_state_df(m32, aux, cfg, key)
        return df_sweep_pair(m32, aux, cfg, s)

    old = os.environ.get("DQMC_STACK_INPLACE")
    try:
        os.environ["DQMC_STACK_INPLACE"] = "0"
        jax.clear_caches()
        a = run()
        os.environ["DQMC_STACK_INPLACE"] = "1"
        jax.clear_caches()
        b = run()
    finally:
        jax.clear_caches()
        if old is None:
            os.environ.pop("DQMC_STACK_INPLACE", None)
        else:
            os.environ["DQMC_STACK_INPLACE"] = old
    for la, lb in zip(jax.tree_util.tree_leaves(a),
                      jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
