"""Engine-level df32 parity probe vs the f64 engine rebuild."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dqmc_tpu.engine import EngineConfig  # noqa: E402
from dqmc_tpu.engine.parity import parity_rebuild_greens  # noqa: E402
from dqmc_tpu.engine.sweep import rebuild_stack_and_greens  # noqa: E402
from dqmc_tpu.lattice import square_lattice  # noqa: E402
from dqmc_tpu.models import AttractiveHubbard  # noqa: E402
from dqmc_tpu.ops import df32  # noqa: E402

jax.config.update("jax_enable_x64", True)


def test_parity_rebuild_matches_f64_engine():
    """G(0,0) from the df32 parity rebuild must match the f64 engine's
    rebuild on the same fields at the df accuracy tier (~1e-8 at beta=8;
    see tests/test_df_linalg.py's module docstring for the tier and for
    why an earlier round's 1e-10 xfail compared against a numerically
    void dense-f64 oracle)."""
    lat = square_lattice(4, 4)
    nt, n_stab, beta = 40, 5, 8.0
    m64 = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=beta,
                                  nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    rng = np.random.default_rng(11)
    fields = jnp.asarray(rng.integers(0, 4, (nt, lat.n_sites)), jnp.int32)

    _, G64, logdet64 = rebuild_stack_and_greens(m64, cfg, fields)
    Gdf, logdet_df = parity_rebuild_greens(m64, cfg, fields)

    err = float(jnp.max(jnp.abs(df32.to_f64(Gdf) - G64[0])))
    assert err < 1e-7, err
    assert abs(float(logdet_df) - float(logdet64[0])) < 1e-5


def test_tf_parity_rebuild_beats_1e10_vs_gold():
    """North star at the ENGINE level (BASELINE.md parity row): the tf32
    rebuild of G(0,0) from a fixed field configuration lands under 1e-10
    vs a 60-digit mpmath gold built from the engine's own f64 B
    ingredients — at beta=8, where the f64 stabilized chain itself
    carries ~e-10 error (tests/test_tf_linalg.py module doc)."""
    import mpmath
    from mpmath import mp
    from dqmc_tpu import hsfield
    from dqmc_tpu.ops import tf32

    lat = square_lattice(4, 4)
    nt, n_stab, beta = 40, 5, 8.0
    m64 = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=beta,
                                  nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    rng = np.random.default_rng(11)
    ns = lat.n_sites
    fields = jnp.asarray(rng.integers(0, 4, (nt, ns)), jnp.int32)

    Gtf, _ = parity_rebuild_greens(m64, cfg, fields, nm=tf32)

    g = float(np.asarray(m64.g, np.float64))
    eta = np.asarray(hsfield.ETA, np.float64)
    expv = np.exp(g * eta)
    expK = np.asarray(m64.expK, np.float64)
    f_np = np.asarray(fields)
    with mp.workdps(60):
        eK = mp.matrix([[mp.mpf(expK[i, j]) for j in range(ns)]
                        for i in range(ns)])
        P = mp.eye(ns)
        for l in range(nt):
            ev = mp.diag([mp.mpf(expv[f_np[l, i]]) for i in range(ns)])
            P = (ev * eK) * P
        Gm = mp.inverse(mp.eye(ns) + P)
        gold = np.array([[float(Gm[i, j]) for j in range(ns)]
                         for i in range(ns)], np.float64)

    err = np.abs(np.asarray(tf32.to_f64(Gtf)) - gold).max()
    assert err < 1e-10, f"tf engine rebuild vs gold: {err:.3e}"

    # the production measurement path (scan-over-stacks, batched) must
    # land at the same tier (runs eagerly here: CPU jit would expose the
    # XLA:CPU multiword hazard and muddy the 1e-10 claim)
    from dqmc_tpu.engine.parity import measurement_greens_fn

    class _S:
        pass

    s = _S()
    s.fields = fields[None]
    G_scan = measurement_greens_fn(m64, cfg, tf32)(s)
    err_scan = np.abs(np.asarray(G_scan)[0, 0] - gold).max()
    assert err_scan < 1e-10, f"scan-path rebuild vs gold: {err_scan:.3e}"


def test_parity_rejects_f32_model():
    lat = square_lattice(4, 4)
    m32 = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0, beta=2.0,
                                  nt=8, dtype=jnp.float32)
    cfg = EngineConfig(nt=8, n_stab=2)
    fields = jnp.zeros((8, 16), jnp.int32)
    with pytest.raises(ValueError):
        parity_rebuild_greens(m32, cfg, fields)


def _f64_state(m64, cfg, fields):
    """A WalkerState seated on fixed fields via the f64 stabilized rebuild."""
    import dataclasses
    from dqmc_tpu.engine import init_state
    s = init_state(m64, cfg, jax.random.PRNGKey(0))
    stack, G, log_det = rebuild_stack_and_greens(m64, cfg, fields)
    return dataclasses.replace(s, fields=fields, G=G, stack=stack,
                               log_det_M=log_det)


def test_measurement_uneq_matches_f64_engine():
    """The multiword tau-resolved measurement rebuild must reproduce the
    f64 engine's unequal-time sweep (dqmc.cpp:458-514) at every tau on
    the same fixed fields — Gtt, Gt0 AND G0t (this pins the suffix-stack
    indexing, the tau ordering, and the triplet orientation all at
    once)."""
    from dqmc_tpu.engine.parity import measurement_uneq_fn
    from dqmc_tpu.engine.uneqtime import TauGreens, sweep_unequal_time

    lat = square_lattice(4, 4)
    nt, n_stab, beta = 40, 5, 8.0
    m64 = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=beta,
                                  nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    rng = np.random.default_rng(11)
    fields = jnp.asarray(rng.integers(0, 4, (nt, lat.n_sites)), jnp.int32)

    s64 = _f64_state(m64, cfg, fields)
    ys64, _ = sweep_unequal_time(m64, cfg, s64)

    class _S:
        pass

    s = _S()
    s.fields = fields[None]
    raw = lambda Gtt, Gt0, G0t, G00: TauGreens(Gtt, Gt0, G0t)
    ys, err = measurement_uneq_fn(m64, cfg, df32, raw,
                                  use_scan=False)(s)
    assert float(err[0]) < 1e-6
    for got, want, name in ((ys.Gtt, ys64.Gtt, "Gtt"),
                            (ys.Gt0, ys64.Gt0, "Gt0"),
                            (ys.G0t, ys64.G0t, "G0t")):
        d = np.abs(np.asarray(got)[0] - np.asarray(want)).max(axis=(1, 2, 3))
        assert d.max() < 1e-6, f"{name}: worst tau {d.argmax()}: {d.max():.3e}"


def test_tf_uneq_and_currxx_vs_gold():
    """Unequal-time north star at the engine level: tau-resolved Gt0/G0t
    from the tf32 measurement rebuild land under 1e-10 vs 60-digit gold
    at sampled taus, and the currxxTau observable (model.cpp:346-392,
    the superfluid-stiffness input) computed from the tier G's matches
    the gold-G observable below 1e-10 too."""
    from mpmath import mp
    from dqmc_tpu import hsfield
    from dqmc_tpu.ops import tf32
    from dqmc_tpu.engine.parity import measurement_uneq_fn
    from dqmc_tpu.engine.uneqtime import TauGreens

    lat = square_lattice(4, 4)
    nt, n_stab, beta = 40, 5, 8.0
    ns = lat.n_sites
    m64 = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=beta,
                                  nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    rng = np.random.default_rng(11)
    fields = jnp.asarray(rng.integers(0, 4, (nt, ns)), jnp.int32)

    class _S:
        pass

    s = _S()
    s.fields = fields[None]
    raw = lambda Gtt, Gt0, G0t, G00: TauGreens(Gtt, Gt0, G0t)
    ys, _ = measurement_uneq_fn(m64, cfg, tf32, raw,
                               use_scan=False)(s)

    g = float(np.asarray(m64.g, np.float64))
    expv = np.exp(g * np.asarray(hsfield.ETA, np.float64))
    expK = np.asarray(m64.expK, np.float64)
    f_np = np.asarray(fields)
    taus = [1, 7, 20, 33, 40]
    gold = {}
    with mp.workdps(60):
        eK = mp.matrix([[mp.mpf(expK[i, j]) for j in range(ns)]
                        for i in range(ns)])
        Bs = []
        for l in range(nt):
            ev = mp.diag([mp.mpf(expv[f_np[l, i]]) for i in range(ns)])
            Bs.append(ev * eK)
        for tau in taus:
            P1 = mp.eye(ns)
            for l in range(tau):
                P1 = Bs[l] * P1
            P2 = mp.eye(ns)
            for l in range(tau, nt):
                P2 = Bs[l] * P2
            Gt0_m = mp.inverse(mp.eye(ns) + P1 * P2) * P1
            G0t_m = -mp.inverse(mp.eye(ns) + P2 * P1) * P2
            gold[tau] = tuple(
                np.array([[float(M[i, j]) for j in range(ns)]
                          for i in range(ns)]) for M in (Gt0_m, G0t_m))

    for tau in taus:
        for got, want, name in ((ys.Gt0, gold[tau][0], "Gt0"),
                                (ys.G0t, gold[tau][1], "G0t")):
            err = np.abs(np.asarray(got)[0, tau, 0] - want).max()
            assert err < 1e-10, f"{name}(tau={tau}): {err:.3e}"

    # currxxTau from tier G's vs from gold G's (G00 = Gtt(0))
    from dqmc_tpu.measure import observables as obs
    from dqmc_tpu.measure.context import make_context
    ctx = make_context(lat, jnp.float64)
    G00 = np.asarray(ys.Gtt)[0, 0]

    def currxx(Gtt, Gt0, G0t):
        return np.asarray(obs.currxx_tau(
            jnp.asarray(Gtt)[None], jnp.asarray(Gt0)[None],
            jnp.asarray(G0t)[None], jnp.asarray(G00)[None], ctx))

    for tau in [7, 20]:
        tier = currxx(np.asarray(ys.Gtt)[0, tau, 0],
                      np.asarray(ys.Gt0)[0, tau, 0],
                      np.asarray(ys.G0t)[0, tau, 0])
        # same Gtt for both sides, gold Gt0/G0t on the oracle side: the
        # compared delta isolates exactly the unequal-time inputs this
        # test certifies (Gtt's own 1e-10 grade is pinned separately by
        # test_tf_parity_rebuild_beats_1e10_vs_gold).
        want = currxx(np.asarray(ys.Gtt)[0, tau, 0], gold[tau][0],
                      gold[tau][1])
        err = np.abs(tier - want).max()
        assert err < 1e-10, f"currxxTau(tau={tau}): {err:.3e}"


def test_tf_uneq_2x_stride_fine_dtau_vs_gold():
    """Wide-stride structural pin: explicit stride 10 at dtau = 0.05
    (stride*dtau = 0.5), tau-resolved Gt0/G0t under 1e-10 vs 60-digit
    gold at mid-stride taus.  NOTE this certifies the CPU path
    (Householder-seeded refinement); the 2x stride is NOT the shipped
    default — a CGS2-seeded triplet refinement diverged at this stride
    (see measurement_uneq_fn's stride note)."""
    from mpmath import mp
    from dqmc_tpu import hsfield
    from dqmc_tpu.ops import tf32
    from dqmc_tpu.engine.parity import measurement_uneq_fn
    from dqmc_tpu.engine.uneqtime import TauGreens

    lat = square_lattice(4, 4)
    nt, n_stab, beta = 80, 5, 4.0            # dtau = 0.05, as headline
    ns = lat.n_sites
    m64 = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=beta,
                                  nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    rng = np.random.default_rng(5)
    fields = jnp.asarray(rng.integers(0, 4, (nt, ns)), jnp.int32)

    class _S:
        pass

    s = _S()
    s.fields = fields[None]
    raw = lambda Gtt, Gt0, G0t, G00: TauGreens(Gtt, Gt0, G0t)
    ys, err = measurement_uneq_fn(m64, cfg, tf32, raw,
                                  use_scan=False, n_stab=10)(s)
    assert float(err.max()) < 1e-10, float(err.max())

    g = float(np.asarray(m64.g, np.float64))
    expv = np.exp(g * np.asarray(hsfield.ETA, np.float64))
    expK = np.asarray(m64.expK, np.float64)
    f_np = np.asarray(fields)
    taus = [3, 17, 45, 77]                   # all mid-stride
    with mp.workdps(60):
        eK = mp.matrix([[mp.mpf(expK[i, j]) for j in range(ns)]
                        for i in range(ns)])
        Bs = []
        for l in range(nt):
            ev = mp.diag([mp.mpf(expv[f_np[l, i]]) for i in range(ns)])
            Bs.append(ev * eK)
        for tau in taus:
            P1 = mp.eye(ns)
            for l in range(tau):
                P1 = Bs[l] * P1
            P2 = mp.eye(ns)
            for l in range(tau, nt):
                P2 = Bs[l] * P2
            Gt0_m = mp.inverse(mp.eye(ns) + P1 * P2) * P1
            G0t_m = -mp.inverse(mp.eye(ns) + P2 * P1) * P2
            for got, M, name in ((ys.Gt0, Gt0_m, "Gt0"),
                                 (ys.G0t, G0t_m, "G0t")):
                want = np.array([[float(M[i, j]) for j in range(ns)]
                                 for i in range(ns)])
                e = np.abs(np.asarray(got)[0, tau, 0] - want).max()
                assert e < 1e-10, f"{name}(tau={tau}): {e:.3e}"


def test_repulsive_measurement_greens_matches_f64_engine():
    """The measurement-tier rebuild for the 2-flavor repulsive model:
    both flavors (opposite couplings, models/repulsive_hubbard.expV_diag)
    must match the f64 engine's per-flavor stabilized rebuild at the
    df32 tier."""
    from dqmc_tpu.engine.parity import measurement_greens_fn
    from dqmc_tpu.models import RepulsiveHubbard

    lat = square_lattice(4, 4)
    nt, n_stab, beta = 20, 5, 4.0
    m64 = RepulsiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0, beta=beta,
                                 nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    rng = np.random.default_rng(5)
    fields = jnp.asarray(rng.integers(0, 4, (nt, lat.n_sites)), jnp.int32)

    _, G64, _ = rebuild_stack_and_greens(m64, cfg, fields)
    assert G64.shape == (2, lat.n_sites, lat.n_sites)

    class _S:
        pass

    s = _S()
    s.fields = fields[None]
    G = np.asarray(measurement_greens_fn(m64, cfg, df32)(s))[0]
    for flv in range(2):
        err = np.abs(G[flv] - np.asarray(G64)[flv]).max()
        assert err < 1e-7, (flv, err)
    # the two flavors genuinely differ (opposite couplings)
    assert np.abs(G[0] - G[1]).max() > 1e-3


def test_repulsive_measurement_uneq_matches_f64_engine():
    """2-flavor tau-resolved tier vs the f64 engine's unequal-time sweep
    on the repulsive model (both flavors, every tau)."""
    from dqmc_tpu.engine.parity import measurement_uneq_fn
    from dqmc_tpu.engine.uneqtime import TauGreens, sweep_unequal_time
    from dqmc_tpu.models import RepulsiveHubbard

    lat = square_lattice(4, 4)
    nt, n_stab, beta = 12, 3, 3.0
    m64 = RepulsiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0, beta=beta,
                                 nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    rng = np.random.default_rng(6)
    fields = jnp.asarray(rng.integers(0, 4, (nt, lat.n_sites)), jnp.int32)

    s64 = _f64_state(m64, cfg, fields)
    ys64, _ = sweep_unequal_time(m64, cfg, s64)

    class _S:
        pass

    s = _S()
    s.fields = fields[None]
    raw = lambda Gtt, Gt0, G0t, G00: TauGreens(Gtt, Gt0, G0t)
    ys, err = measurement_uneq_fn(m64, cfg, df32, raw,
                                  use_scan=False)(s)
    assert float(err[0]) < 1e-6
    for got, want, name in ((ys.Gtt, ys64.Gtt, "Gtt"),
                            (ys.Gt0, ys64.Gt0, "Gt0"),
                            (ys.G0t, ys64.G0t, "G0t")):
        assert np.asarray(got).shape[2] == 2          # flavor axis
        d = np.abs(np.asarray(got)[0] - np.asarray(want)).max()
        assert d < 1e-6, f"{name}: {d:.3e}"


def test_uneq_batched_matches_sequential():
    """The round-4 block-batched formulation of measurement_uneq_fn
    (one inv_triplet_dag over all boundaries + n_stab batched
    propagation steps) is arithmetically IDENTICAL per element to the
    round-3 sequential scan — pinned bit-exact on CPU eager (df32)."""
    import os
    from types import SimpleNamespace

    from dqmc_tpu.engine.parity import measurement_uneq_fn
    from dqmc_tpu.ops import df32

    lat = square_lattice(4, 4)
    nt, n_stab = 20, 5
    m64 = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=4.0,
                                  nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    fields = jax.random.randint(jax.random.PRNGKey(3),
                                (2, nt, lat.n_sites), 0, 4,
                                dtype=jnp.int32)
    states = SimpleNamespace(fields=fields)

    def mfn(Gtt, Gt0, G0t, G00):
        return {"a": jnp.mean(Gtt) + jnp.mean(G00),
                "b": jnp.mean(Gt0 * G0t)}

    res = {}
    old = os.environ.get("DQMC_UNEQ_BATCHED")
    try:
        for flag in ("0", "1"):
            os.environ["DQMC_UNEQ_BATCHED"] = flag
            fn = measurement_uneq_fn(m64, cfg, df32, mfn, n_stab=n_stab,
                                     use_scan=False, symmetric=True)
            res[flag] = fn(states)
    finally:
        if old is None:
            os.environ.pop("DQMC_UNEQ_BATCHED", None)
        else:
            os.environ["DQMC_UNEQ_BATCHED"] = old
    (ys0, e0), (ys1, e1) = res["0"], res["1"]
    for k in ys0:
        np.testing.assert_array_equal(np.asarray(ys0[k]),
                                      np.asarray(ys1[k]), err_msg=k)
    np.testing.assert_array_equal(np.asarray(e0), np.asarray(e1))
