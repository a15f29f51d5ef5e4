"""The slice engine on the configurations the removed fused block kernel
used to serve: stability over several sweep pairs (one and two flavors),
ragged nt % n_stab != 0 blocks, and the unaligned 6x6 lattice (ns = 36).
The site-update schemes must realize one chain, so the XLA delayed and
submatrix arms are checked against the rank-1 reference scan."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dqmc_tpu.engine import EngineConfig, init_state, sweep, sweep_pair
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard, RepulsiveHubbard


def _setup(cls=AttractiveHubbard, W=2, L=4, beta=4.0, nt=12, n_stab=3,
           seed=0, mu=-0.1):
    lat = square_lattice(L, L)
    model = cls.build(lat, U=4.0, t=1.0, mu=mu, beta=beta, nt=nt,
                      dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    keys = jax.random.split(jax.random.PRNGKey(seed), W)
    states = jax.vmap(lambda k: init_state(model, cfg, k))(keys)
    return model, cfg, states


def _pair(model, cfg, states):
    return jax.jit(jax.vmap(lambda s: sweep_pair(model, cfg, s)))(states)


def test_sweep_pair_stays_stable():
    """Several delayed-update sweep pairs keep the self-check error below
    the reference's 1e-6 warning (dqmc.cpp:390) and a sane acceptance
    rate (dtau = 0.1, the reference example's)."""
    model, cfg, states = _setup(L=4, beta=4.0, nt=40, n_stab=5, seed=3)
    cfg = dataclasses.replace(cfg, delay_rank=8)
    for _ in range(3):
        states = _pair(model, cfg, states)
    assert np.isfinite(np.asarray(states.G)).all()
    assert float(jnp.max(states.err_max)) < 1e-6
    acc = float(jnp.mean(states.acc_sum)) / 6.0
    assert 0.2 < acc < 0.9


def test_two_flavor_sweep_stays_stable():
    """Doped repulsive model: stabilization error at f64 noise, sane
    acceptance, and the Metropolis sign stays +-1."""
    model, cfg, s = _setup(RepulsiveHubbard, nt=12, n_stab=3, mu=-0.6,
                           seed=2, beta=3.0)
    cfg = dataclasses.replace(cfg, delay_rank=8)
    for _ in range(3):
        s = _pair(model, cfg, s)
    assert float(jnp.max(s.err_max)) < 1e-8
    acc = float(jnp.mean(s.acc_sum)) / 6.0
    assert 0.1 < acc < 0.95
    assert set(np.unique(np.asarray(s.sign))) <= {-1.0, 1.0}


@pytest.mark.parametrize("scheme", ["delayed", "submatrix"])
@pytest.mark.parametrize("shape", ["ragged", "unaligned"])
def test_schemes_match_scan(shape, scheme):
    """nt=13 with n_stab=5 (a short tail block, dqmc.cpp:14-18) and the
    reference's 6x6 lattice (ns=36, not a multiple of the rank 8): both
    sweep directions realize the rank-1 scan's exact chain."""
    if shape == "ragged":
        model, cfg, states = _setup(nt=13, n_stab=5, seed=4)
    else:
        model, cfg, states = _setup(L=6, nt=12, n_stab=3, seed=4)
    field = {"delayed": "delay_rank", "submatrix": "submatrix_rank"}[scheme]
    arm = dataclasses.replace(cfg, **{field: 8})
    for forward in (True, False):
        run = lambda c, s: jax.jit(jax.vmap(
            lambda w: sweep(model, c, w, forward=forward)))(s)
        want, got = run(cfg, states), run(arm, states)
        np.testing.assert_array_equal(np.asarray(got.fields),
                                      np.asarray(want.fields))
        np.testing.assert_allclose(np.asarray(got.G), np.asarray(want.G),
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(got.acc_sum),
                                   np.asarray(want.acc_sum), rtol=1e-12)
        states = want


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_pair_reduction_matches_einsum(dtype):
    """The one-hot site-pair -> displacement reduction runs as a plain dot
    in the input's own dtype (f64 is native on the CPU and the GPU); it
    must equal a direct einsum over the one-hot matrix."""
    from dqmc_tpu.measure.context import make_context
    from dqmc_tpu.measure.transforms import site_to_r_batched

    lat = square_lattice(4, 4)
    ctx = make_context(lat, dtype)
    assert ctx.pair_cols is not None
    ns = lat.n_sites
    nd = lat.L1 * lat.L2 * lat.n_orb ** 2
    rng = np.random.default_rng(1)
    chis = jnp.asarray(rng.standard_normal((3, ns, ns)), dtype)
    got = site_to_r_batched(chis, ctx)
    onehot = (np.asarray(ctx.pair_cols)[:, None] == np.arange(nd)[None, :])
    want = np.einsum("bk,kd->bd", np.asarray(chis, np.float64).reshape(3, -1),
                     onehot.astype(np.float64)) / ctx.n_cells
    assert got.dtype == dtype
    np.testing.assert_allclose(np.asarray(got, np.float64).reshape(3, -1),
                               want, atol=1e-12 if dtype == jnp.float64
                               else 1e-5)
