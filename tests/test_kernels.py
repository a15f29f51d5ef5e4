"""Site-update equivalence tests: every implementation must realize the
exact same Markov chain.  The Triton site kernel runs here in the Pallas
interpreter; its compiled form runs only on a GPU (chip_smoke.py and the
gpu-marked test below)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dqmc_tpu.engine.sweep import (
    draw_slice_randoms,
    local_update_core,
    local_update_slice,
    local_update_slice_delayed,
)
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard
from dqmc_tpu.ops.kernels import metropolis_slice_update_batched, site_update_fn

# the kernel entry the engine uses, in the interpreter
pallas_site_update = site_update_fn(16, interpret=True)


def setup(ns=16):
    lat = square_lattice(4, 4)
    m = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=4.0, nt=16,
                                dtype=jnp.float64)
    rng = np.random.default_rng(5)
    G = jnp.asarray(rng.standard_normal((1, ns, ns)) * 0.2 + 0.5 * np.eye(ns))
    fl = jnp.asarray(rng.integers(0, 4, ns), jnp.int32)
    return m, G, fl


def test_single_walker_kernel_matches_scan():
    m, G, fl = setup()
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        G1, f1, a1, s1 = local_update_slice(m, key, G, fl)
        G2, f2, a2 = pallas_site_update(m, key, G, fl)
        assert bool((f1 == f2).all())
        np.testing.assert_allclose(np.asarray(G1), np.asarray(G2), atol=1e-13)
        np.testing.assert_allclose(float(a1), float(a2))
        assert float(s1) == 1.0  # attractive model is sign-free


def test_delayed_matches_scan_bitwise():
    m, G, fl = setup()
    key = jax.random.PRNGKey(9)
    G1, f1, a1, s1 = local_update_slice(m, key, G, fl)
    for k in (4, 5, 16):
        G2, f2, a2, s2 = local_update_slice_delayed(m, key, G, fl, k)
        assert bool((f1 == f2).all())
        np.testing.assert_allclose(np.asarray(G1), np.asarray(G2), atol=1e-12)
        assert float(s1) == float(s2)


def test_submatrix_matches_scan_bitwise():
    """The submatrix (bordered-Woodbury) scheme realizes the exact chain of
    the rank-1 scan: same decisions, same sign, G to f64 rounding."""
    from dqmc_tpu.engine.sweep import local_update_slice_submatrix

    m, G, fl = setup()
    key = jax.random.PRNGKey(9)
    G1, f1, a1, s1 = local_update_slice(m, key, G, fl)
    for k in (4, 5, 16):
        G2, f2, a2, s2 = local_update_slice_submatrix(m, key, G, fl, k)
        assert bool((f1 == f2).all())
        np.testing.assert_allclose(np.asarray(G1), np.asarray(G2), atol=1e-11)
        np.testing.assert_allclose(float(a1), float(a2))
        assert float(s1) == float(s2)


def test_submatrix_two_flavor_sign_flips():
    """Submatrix scheme on the doped repulsive model: per-flavor bordered
    inverses, negative-ratio sign bookkeeping identical to the scan."""
    from dqmc_tpu.engine.sweep import local_update_slice_submatrix
    from dqmc_tpu.models import RepulsiveHubbard

    lat = square_lattice(4, 4)
    ns = 16
    m = RepulsiveHubbard.build(lat, U=6.0, t=1.0, mu=-0.8, beta=4.0, nt=16,
                               dtype=jnp.float64)
    rng = np.random.default_rng(21)
    G = jnp.asarray(rng.standard_normal((2, ns, ns)) * 0.3 + 0.5 * np.eye(ns))
    fl = jnp.asarray(rng.integers(0, 4, ns), jnp.int32)
    saw_flip = False
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        G1, f1, a1, s1 = local_update_slice(m, key, G, fl)
        G2, f2, a2, s2 = local_update_slice_submatrix(m, key, G, fl, 8)
        assert bool((f1 == f2).all())
        np.testing.assert_allclose(np.asarray(G1), np.asarray(G2), atol=1e-10)
        assert float(s1) == float(s2)
        saw_flip = saw_flip or float(s1) < 0
    assert saw_flip, "test inputs produced no sign flip to verify"


def test_submatrix_sweep_matches_scan_sweep():
    """Full sweep_pair with submatrix_rank: same chain as the scan engine."""
    from dqmc_tpu.engine import EngineConfig, init_state, sweep_pair

    lat = square_lattice(4, 4)
    m = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=2.0, nt=8,
                                dtype=jnp.float64)
    cfg_scan = EngineConfig(nt=8, n_stab=2)
    cfg_sub = EngineConfig(nt=8, n_stab=2, submatrix_rank=8)
    s0 = init_state(m, cfg_scan, jax.random.PRNGKey(43))
    s1 = sweep_pair(m, cfg_scan, s0)
    s2 = sweep_pair(m, cfg_sub, s0)
    assert bool((s1.fields == s2.fields).all())
    assert float(s1.sign) == float(s2.sign)
    np.testing.assert_allclose(np.asarray(s1.G), np.asarray(s2.G), atol=1e-10)
    np.testing.assert_allclose(float(s1.acc_sum), float(s2.acc_sum))


def test_batched_kernel_matches_shared_order_core():
    m, G1w, _ = setup()
    ns, W = 16, 4
    rng = np.random.default_rng(6)
    G = jnp.asarray(rng.standard_normal((W, 1, ns, ns)) * 0.2
                    + 0.5 * np.eye(ns))
    fl = jnp.asarray(rng.integers(0, 4, (W, ns)), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), W)

    G2, f2, a2 = metropolis_slice_update_batched(m, keys, G, fl, k_delay=16,
                                                 interpret=True)
    order, _, _ = draw_slice_randoms(keys[0], ns, jnp.float64)
    for w in range(W):
        _, props, us = draw_slice_randoms(keys[w], ns, jnp.float64)
        Gw, fw, aw, _ = local_update_core(m, G[w], fl[w], order, props, us)
        assert bool((fw == f2[w]).all()), f"walker {w}"
        np.testing.assert_allclose(np.asarray(Gw), np.asarray(G2[w]),
                                   atol=1e-12)
        np.testing.assert_allclose(float(aw), float(a2[w]))


def test_custom_vmap_dispatches_to_batched():
    """vmap(pallas_site_update) must produce the batched kernel's results."""
    m, _, _ = setup()
    ns, W = 16, 4
    rng = np.random.default_rng(8)
    G = jnp.asarray(rng.standard_normal((W, 1, ns, ns)) * 0.2
                    + 0.5 * np.eye(ns))
    fl = jnp.asarray(rng.integers(0, 4, (W, ns)), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(13), W)

    G1, f1, a1 = jax.vmap(
        lambda k, g, f: pallas_site_update(m, k, g, f))(keys, G, fl)
    G2, f2, a2 = metropolis_slice_update_batched(m, keys, G, fl, k_delay=16,
                                                 interpret=True)
    assert bool((f1 == f2).all())
    np.testing.assert_allclose(np.asarray(G1), np.asarray(G2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2))


def test_one_flavor_multiblock_matches_scan():
    """ns = 36 on a 64-lane block with rank-16 flushes: three flush blocks,
    the last one ragged (4 live sites), padded lanes untouched — every
    walker still realizes its own stream."""
    lat = square_lattice(6, 6)
    m = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=4.0, nt=16,
                                dtype=jnp.float64)
    ns, W = 36, 4
    rng = np.random.default_rng(55)
    G = jnp.asarray(rng.standard_normal((W, 1, ns, ns)) * 0.2
                    + 0.5 * np.eye(ns))
    fl = jnp.asarray(rng.integers(0, 4, (W, ns)), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(57), W)
    G2, f2, a2 = metropolis_slice_update_batched(m, keys, G, fl,
                                                 k_delay=16, interpret=True)
    order, _, _ = draw_slice_randoms(keys[0], ns, jnp.float64)
    for w in range(W):
        _, props, us = draw_slice_randoms(keys[w], ns, jnp.float64)
        Gw, fw, aw, _ = local_update_core(m, G[w], fl[w], order, props, us)
        assert bool((fw == f2[w]).all()), f"walker {w}"
        np.testing.assert_allclose(np.asarray(Gw), np.asarray(G2[w]),
                                   atol=1e-12)


def test_custom_vmap_model_batched_runs_one_kernel():
    """vmap over (model, state) — the replica-axis case — dispatches to the
    flat batched kernel with per-replica coupling scalars (shared
    state-independent visit order from keys[0], per-replica
    proposals/uniforms), matching the sequential oracle per replica."""
    lat = square_lattice(4, 4)
    ns, R = 16, 2
    models = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=b, nt=16,
                                  dtype=jnp.float64) for b in (2.0, 4.0)])
    rng = np.random.default_rng(3)
    G = jnp.asarray(rng.standard_normal((R, 1, ns, ns)) * 0.2
                    + 0.5 * np.eye(ns))
    fl = jnp.asarray(rng.integers(0, 4, (R, ns)), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(17), R)

    G1, f1, a1 = jax.vmap(pallas_site_update)(models, keys, G, fl)
    order, _, _ = draw_slice_randoms(keys[0], ns, jnp.float64)
    for r in range(R):
        mr = jax.tree_util.tree_map(lambda x: x[r], models)
        _, props, us = draw_slice_randoms(keys[r], ns, jnp.float64)
        Gr, fr, ar, _ = local_update_core(mr, G[r], fl[r], order, props, us)
        assert bool((fr == f1[r]).all())
        np.testing.assert_allclose(np.asarray(Gr), np.asarray(G1[r]),
                                   atol=1e-12)
        np.testing.assert_allclose(float(ar), float(a1[r]))


def test_double_vmap_replica_by_walker_flattens():
    """vmap(vmap(...)) — replicas outside, walkers inside — must flatten to
    one (R*W) batch and match the per-(replica,walker) oracle."""
    lat = square_lattice(4, 4)
    ns, R, W = 16, 2, 3
    models = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=b, nt=16,
                                  dtype=jnp.float64) for b in (2.0, 4.0)])
    rng = np.random.default_rng(4)
    G = jnp.asarray(rng.standard_normal((R, W, 1, ns, ns)) * 0.2
                    + 0.5 * np.eye(ns))
    fl = jnp.asarray(rng.integers(0, 4, (R, W, ns)), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(23), R * W).reshape(R, W, -1)

    G1, f1, a1 = jax.vmap(lambda m, k, g, f: jax.vmap(
        lambda kk, gg, ff: pallas_site_update(m, kk, gg, ff))(k, g, f))(
            models, keys, G, fl)
    # the flat batch draws its shared order from the FIRST flattened key
    order, _, _ = draw_slice_randoms(keys[0, 0], ns, jnp.float64)
    for r in range(R):
        mr = jax.tree_util.tree_map(lambda x: x[r], models)
        for w in range(W):
            _, props, us = draw_slice_randoms(keys[r, w], ns, jnp.float64)
            Gr, fr, ar, _ = local_update_core(mr, G[r, w], fl[r, w], order,
                                              props, us)
            assert bool((fr == f1[r, w]).all()), (r, w)
            np.testing.assert_allclose(np.asarray(Gr), np.asarray(G1[r, w]),
                                       atol=1e-12)


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("L", [6, 8, 10, 16])
def test_site_kernel_interpret_matches_delayed(L, k, W):
    """The Triton kernel (interpreter) against the XLA delayed scheme over
    padded (36 -> 64, 100 -> 128) and exact (64, 256) lattices, both flush
    ranks and a single- and multi-walker batch: same decisions, same G.
    W = 1 draws the order from its own key, so it also equals the
    unbatched delayed path exactly."""
    ns = L * L
    lat = square_lattice(L, L)
    m = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=4.0, nt=16,
                                dtype=jnp.float64)
    rng = np.random.default_rng(L * 100 + k + W)
    G = jnp.asarray(rng.standard_normal((W, 1, ns, ns)) * 0.1
                    + 0.5 * np.eye(ns))
    fl = jnp.asarray(rng.integers(0, 4, (W, ns)), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(L + k), W)
    G2, f2, a2 = metropolis_slice_update_batched(m, keys, G, fl, k_delay=k,
                                                 interpret=True)
    assert G2.shape == G.shape and f2.shape == fl.shape and a2.shape == (W,)
    order, _, _ = draw_slice_randoms(keys[0], ns, jnp.float64)
    for w in range(W):
        _, props, us = draw_slice_randoms(keys[w], ns, jnp.float64)
        Gw, fw, aw, _ = local_update_core(m, G[w], fl[w], order, props, us)
        assert bool((fw == f2[w]).all()), f"walker {w}"
        np.testing.assert_allclose(np.asarray(G2[w]), np.asarray(Gw),
                                   atol=1e-11)
        np.testing.assert_allclose(float(a2[w]), float(aw))
    if W == 1:
        Gd, fd, ad, _ = local_update_slice_delayed(m, keys[0], G[0], fl[0], k)
        assert bool((fd == f2[0]).all())
        np.testing.assert_allclose(np.asarray(G2[0]), np.asarray(Gd),
                                   atol=1e-11)


def test_site_kernel_refuses_cpu_without_interpreter():
    """The compiled kernel never falls back to the interpreter: on the CPU
    it raises, both called directly and through the engine."""
    from dqmc_tpu.engine import EngineConfig, init_state, sweep_pair

    m, G, fl = setup()
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        metropolis_slice_update_batched(m, keys, jnp.stack([G, G]),
                                        jnp.stack([fl, fl]))
    lat = square_lattice(4, 4)
    m2 = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=2.0, nt=8,
                                 dtype=jnp.float64)
    cfg = EngineConfig(nt=8, n_stab=2, use_pallas=True)
    s0 = init_state(m2, EngineConfig(nt=8, n_stab=2), jax.random.PRNGKey(1))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        jax.vmap(lambda s: sweep_pair(m2, cfg, s))(
            jax.tree_util.tree_map(lambda x: x[None], s0))


def test_site_kernel_rejects_unsupported_shapes():
    from dqmc_tpu.models import RepulsiveHubbard
    from dqmc_tpu.ops.kernels import MAX_SITES, flush_rank, padded_sites

    assert [padded_sites(n) for n in (4, 16, 36, 64, 100, 144, 256)] == [
        16, 16, 64, 64, 128, 256, 256]
    assert flush_rank(8, 64) == 16 and flush_rank(32, 16) == 16
    assert flush_rank(32, 256) == 32
    keys = jax.random.split(jax.random.PRNGKey(0), 1)
    lat = square_lattice(4, 4)
    rep = RepulsiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0, beta=2.0, nt=8,
                                 dtype=jnp.float64)
    with pytest.raises(ValueError, match="one stored flavor"):
        metropolis_slice_update_batched(
            rep, keys, jnp.zeros((1, 2, 16, 16)), jnp.zeros((1, 16), jnp.int32),
            interpret=True)
    n = 17 * 17
    assert n > MAX_SITES
    m, _, _ = setup()
    with pytest.raises(ValueError, match="ns <="):
        metropolis_slice_update_batched(
            m, keys, jnp.zeros((1, 1, n, n)), jnp.zeros((1, n), jnp.int32),
            interpret=True)


@pytest.mark.gpu
def test_site_kernel_compiled_matches_core(gpu):
    """On the card: the compiled kernel at the headline width (ns = 256,
    f32, 16 walkers) against the XLA delayed scheme on the same stream —
    same accept mask, max|dG| <= 1e-4 at full f32 matmul precision."""
    L, W = 16, 16
    ns = L * L
    lat = square_lattice(L, L)
    m = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0, beta=8.0, nt=160,
                                dtype=jnp.float32)
    rng = np.random.default_rng(3)
    G = jnp.asarray(rng.standard_normal((W, 1, ns, ns)) * 0.05
                    + 0.5 * np.eye(ns), jnp.float32)
    fl = jnp.asarray(rng.integers(0, 4, (W, ns)), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), W)
    with jax.default_matmul_precision("highest"):
        G2, f2, _ = metropolis_slice_update_batched(m, keys, G, fl)
        order, _, _ = draw_slice_randoms(keys[0], ns, jnp.float32)
        for w in range(W):
            _, props, us = draw_slice_randoms(keys[w], ns, jnp.float32)
            Gw, fw, _, _ = local_update_core(m, G[w], fl[w], order, props,
                                             us)
            assert bool((fw == f2[w]).all())
            assert float(jnp.max(jnp.abs(Gw - G2[w]))) <= 1e-4
