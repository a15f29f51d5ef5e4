"""df32 LDR algebra vs f64: factorization quality, folds, dag inverse,
and the fixed-field chain rebuild at beta=8, carried entirely by f32
hardware operations.

Oracle note (round-4 finding): the chain tests compare against the f64
STABILIZED LDR chain (ops/linalg.py, itself mpmath-validated to < 1e-10
by tests/test_trajectory_golden.py) — NOT against a dense f64 product.
``solve(I + prod(B))`` computed densely in f64 is numerically void at
beta=8: ||prod(B)|| reaches ~1e21, so the dense oracle carries
eps64 * ||P|| ~ 1e5 absolute error in G (measured: max|G_dense - G_stab|
= 59 on this very chain).  An earlier round xfail'd the df chain tests
against that oracle, mistaking the oracle's garbage for a df defect.

Accuracy tier (measured, CPU eager, 16 folds at beta=8):
max|dG| ~ 1e-8 — the per-fold floor is eps_df * cond(equilibrated fold)
~ 1e-10..1e-9, accumulated over the stack.  Strict 1e-10 reference
parity remains the f64 mode's domain (tests/test_trajectory_golden.py);
df32 sits 2 orders below the reference's own 1e-6 stabilization-warning
threshold (dqmc.cpp:390).

The fold/chain calls here run EAGER on CPU deliberately: XLA:CPU's
backend codegen (opt level > 0) corrupts fused double-float chains —
jitting the identical fold graph degrades the chain from 1.1e-8 to
5.4e-4 (fixed by --xla_backend_optimization_level=0; per-primitive
eager execution is unaffected — see NOTES.md; chip_smoke.py checks the
jitted chain on the GPU)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dqmc_tpu.ops import df32, df_linalg, linalg  # noqa: E402
from dqmc_tpu.ops.df_qr import df_qr  # noqa: E402
from dqmc_tpu.ops.df32 import DF  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _df_from64(x):
    return df32.from_f64(jnp.asarray(x, jnp.float64))


def _to64(x: DF):
    return np.asarray(df32.to_f64(x))


def _d_full(F):
    """The full d-ladder in f64: mantissa * 2^e (exponent channel)."""
    return _to64(F.d) * np.exp2(np.asarray(F.e, np.float64))


def _b_chain(rng, n, nt, beta, U=4.0, mu=-0.1):
    """Realistic DQMC B-matrix chain (free kinetics + random HS diags)."""
    import scipy.linalg as sla
    K = np.zeros((n, n))
    L = int(np.sqrt(n))
    for x in range(L):
        for y in range(L):
            i = x * L + y
            for dx, dy in ((1, 0), (0, 1)):
                j = ((x + dx) % L) * L + (y + dy) % L
                K[i, j] = K[j, i] = -1.0
    np.fill_diagonal(K, -mu)
    dtau = beta / nt
    expK = sla.expm(-dtau * K)
    g = np.sqrt(dtau * U / 2)
    etas = rng.choice([-2.22474487, -0.74196378, 0.74196378, 2.22474487],
                      size=(nt, n))
    return [np.diag(np.exp(g * e)) @ expK for e in etas]


def _stab64_suffix(Bs, n_stab):
    """f64 stabilized transpose-suffix chain (the engine's dag fold)."""
    F2t = None
    nt = len(Bs)
    n = Bs[0].shape[0]
    for i_blk in range(-(-nt // n_stab) - 1, -1, -1):
        blk = Bs[i_blk * n_stab:(i_blk + 1) * n_stab]
        Bbar = np.eye(n)
        for B in blk:
            Bbar = B @ Bbar
        T = jnp.asarray(Bbar.T)
        F2t = (linalg.to_ldr(T) if F2t is None
               else linalg.mat_mul_ldr(T, F2t))
    return F2t


def _df_suffix(Bs, n_stab):
    F2t = None
    nt = len(Bs)
    n = Bs[0].shape[0]
    for i_blk in range(-(-nt // n_stab) - 1, -1, -1):
        blk = Bs[i_blk * n_stab:(i_blk + 1) * n_stab]
        Bbar = np.eye(n)
        for B in blk:
            Bbar = B @ Bbar
        T = _df_from64(Bbar.T)
        F2t = (df_linalg.to_ldr(T) if F2t is None
               else df_linalg.mat_mul_ldr(T, F2t))
    return F2t


def test_df_qr_quality(rng):
    """Orthogonality and columnwise residual at the df floor, including a
    graded matrix (the fold regime after column equilibration)."""
    n = 64
    A64 = rng.standard_normal((n, n))
    Q, R = df_qr(_df_from64(A64))
    Q64, R64 = _to64(Q), _to64(R)
    assert np.abs(Q64.T @ Q64 - np.eye(n)).max() < 2.0 ** -42
    col = np.abs(A64).max(axis=0)
    assert (np.abs(Q64 @ R64 - A64).max(axis=0) / col).max() < 2.0 ** -41
    # R exactly upper triangular
    assert np.all(np.tril(R64, -1) == 0)

    graded = A64 * np.exp(np.linspace(-4, 4, n))[None, :]
    Qg, Rg = df_qr(_df_from64(graded))
    assert np.abs(_to64(Qg).T @ _to64(Qg) - np.eye(n)).max() < 2.0 ** -42
    colg = np.abs(graded).max(axis=0)
    assert (np.abs(_to64(Qg) @ _to64(Rg) - graded).max(axis=0)
            / colg).max() < 2.0 ** -40


def test_to_ldr_reconstructs(rng):
    """Fold-regime input: well-conditioned core times a huge column
    ladder (column equilibration recovers the core)."""
    n = 64
    core = rng.standard_normal((n, n))
    u, sv, vt = np.linalg.svd(core)
    core = (u * np.linspace(1.0, 0.02, n)) @ vt          # cond 50
    A64 = core * np.exp(rng.uniform(-15, 15, (1, n)))
    F = df_linalg.to_ldr(_df_from64(A64))
    M = _to64(df_linalg.ldr_matrix(F))
    col = np.abs(A64).max(axis=0)
    assert (np.abs(M - A64).max(axis=0) / col).max() < 2.0 ** -40
    d = np.sort(_d_full(F))[::-1]
    assert d[0] / d[-1] > 1e8        # genuinely graded
    L = _to64(F.L)
    assert np.abs(L.T @ L - np.eye(n)).max() < 2.0 ** -42


def test_fold_chain_matches_f64(rng):
    """Fold 8 blocks at beta=8-grade scales: the df LDR product must track
    the f64 STABILIZED product columnwise (the dense product is not
    columnwise-representable at this grading — see module docstring)."""
    n, nt, beta, n_stab = 36, 40, 8.0, 5
    Bs = _b_chain(rng, n, nt, beta)
    Fdf = _df_suffix(Bs, n_stab)
    F64 = _stab64_suffix(Bs, n_stab)
    # compare factored representations: d-ladder relative + L span
    d_df = np.sort(_d_full(Fdf))[::-1]
    d_64 = np.sort(np.asarray(F64.d))[::-1]
    rel = np.abs(d_df - d_64) / d_64
    assert rel.max() < 1e-6, rel.max()
    L_df, L_64 = _to64(Fdf.L), np.asarray(F64.L)
    span = np.abs(L_df @ L_df.T - L_64 @ L_64.T).max()
    assert span < 1e-9, span


def test_fold_chain_beta16_stretch_grade(rng):
    """The stretch-scale regression (VERDICT r2 item 2): a beta=16 chain
    whose accumulated d-ladder spans ~e^{+-140} — NOT f32-representable
    (max ~e^88).  The exponent channel must carry it: the fold chain,
    the dag inverse, and the log-det all track the f64 stabilized chain,
    and the ladder provably exceeds linear-f32 range (so this test fails
    on any representation that materializes d in f32)."""
    n, nt, beta, n_stab = 36, 80, 16.0, 5
    Bs = _b_chain(rng, n, nt, beta)
    Fdf = _df_suffix(Bs, n_stab)
    F64 = _stab64_suffix(Bs, n_stab)
    log_d = np.log(_to64(Fdf.d)) + np.log(2.0) * np.asarray(
        Fdf.e, np.float64)
    assert log_d.max() > 95.0 and log_d.min() < -95.0, (
        log_d.min(), log_d.max())
    d_df = np.sort(_d_full(Fdf))[::-1]
    d_64 = np.sort(np.asarray(F64.d))[::-1]
    rel = np.abs(d_df - d_64) / d_64
    assert rel.max() < 1e-6, rel.max()

    G, log_det = df_linalg.inv_one_plus_ldr_dag(
        df_linalg.to_ldr(df32.df(jnp.eye(n, dtype=jnp.float32))), Fdf)
    G64, ld64 = linalg.inv_one_plus_ldr_dag(
        linalg.identity_ldr(n, jnp.float64), F64)
    err = np.abs(_to64(G) - np.asarray(G64)).max()
    assert err < 1e-7, err
    assert abs(float(log_det) - float(ld64)) / abs(float(ld64)) < 1e-6


def test_inv_one_plus_dag_matches_f64(rng):
    """G = [I + B(beta,0)]^{-1} via the df dag formulation vs the f64
    stabilized chain."""
    n, nt, beta, n_stab = 36, 40, 8.0, 5
    Bs = _b_chain(rng, n, nt, beta)
    F2t = _df_suffix(Bs, n_stab)
    F1 = df_linalg.to_ldr(df32.df(jnp.eye(n, dtype=jnp.float32)))
    G, log_det = df_linalg.inv_one_plus_ldr_dag(F1, F2t)

    F2t64 = _stab64_suffix(Bs, n_stab)
    G64, ld64 = linalg.inv_one_plus_ldr_dag(
        linalg.identity_ldr(n, jnp.float64), F2t64)
    err = np.abs(_to64(G) - np.asarray(G64)).max()
    assert err < 5e-8, err
    # log|det| sums ~n per-direction logs whose arguments carry the df
    # d-ladder tier (~1e-7 relative each): absolute tolerance scales with
    # n, not with the G tier.  2e-5 measured at n=36; PT exchange actions
    # are O(1e2-1e3), so this is ~1e-8 relative on the decision scale.
    assert abs(float(log_det) - float(ld64)) < 1e-4


def test_chain_rebuild_beta8(rng):
    """The df32 parity claim: G(0,0) from a full beta=8 stabilized rebuild
    on a FIXED field configuration matches the f64 stabilized engine
    chain to ~1e-8 — using only f32 hardware operations (vs the f32
    engine's ~1e-2 at this beta, and the reference's own 1e-6 warning
    threshold, dqmc.cpp:390)."""
    n, nt, beta, n_stab = 64, 80, 8.0, 5
    Bs = _b_chain(rng, n, nt, beta)
    F2t = _df_suffix(Bs, n_stab)
    F1 = df_linalg.to_ldr(df32.df(jnp.eye(n, dtype=jnp.float32)))
    G, _ = df_linalg.inv_one_plus_ldr_dag(F1, F2t)

    F2t64 = _stab64_suffix(Bs, n_stab)
    G64, _ = linalg.inv_one_plus_ldr_dag(
        linalg.identity_ldr(n, jnp.float64), F2t64)
    err = np.abs(_to64(G) - np.asarray(G64)).max()
    assert err < 1e-7, err


def _stab64_prefix(Bs, n_stab):
    """f64 stabilized prefix chain B(tau,0) in normal form."""
    F1 = None
    n = Bs[0].shape[0]
    for i_blk in range(-(-len(Bs) // n_stab)):
        blk = Bs[i_blk * n_stab:(i_blk + 1) * n_stab]
        Bbar = np.eye(n)
        for B in blk:
            Bbar = B @ Bbar
        M = jnp.asarray(Bbar)
        F1 = (linalg.to_ldr(M) if F1 is None
              else linalg.mat_mul_ldr(M, F1))
    return F1


def _df_prefix(Bs, n_stab):
    F1 = None
    n = Bs[0].shape[0]
    for i_blk in range(-(-len(Bs) // n_stab)):
        blk = Bs[i_blk * n_stab:(i_blk + 1) * n_stab]
        Bbar = np.eye(n)
        for B in blk:
            Bbar = B @ Bbar
        M = _df_from64(Bbar)
        F1 = (df_linalg.to_ldr(M) if F1 is None
              else df_linalg.mat_mul_ldr(M, F1))
    return F1


def test_inv_triplet_dag_matches_f64(rng):
    """The df measurement triplet (Gtt, Gt0, G0t) at mid-beta from the
    shared-factorization inv_triplet_dag vs the f64 stabilized triplet
    (stablelinalg.cpp:160-190 semantics).  This is the unequal-time
    parity path: greenTau/doublonTau/currxxTau consume exactly these."""
    n, nt, beta, n_stab = 36, 40, 8.0, 5
    Bs = _b_chain(rng, n, nt, beta)
    tau = nt // 2
    F1 = _df_prefix(Bs[:tau], n_stab)
    F2t = _df_suffix(Bs[tau:], n_stab)
    Gtt, Gt0, G0t, ld = df_linalg.inv_triplet_dag(F1, F2t)

    F1_64 = _stab64_prefix(Bs[:tau], n_stab)
    F2t_64 = _stab64_suffix(Bs[tau:], n_stab)
    Gtt64, Gt064, G0t64, ld64 = linalg.inv_triplet_dag(F1_64, F2t_64)

    for got, want, name in ((Gtt, Gtt64, "Gtt"), (Gt0, Gt064, "Gt0"),
                            (G0t, G0t64, "G0t")):
        err = np.abs(_to64(got) - np.asarray(want)).max()
        assert err < 5e-8, f"{name}: {err:.3e}"
    # mid-chain log|det|: BOTH factors carry full e^{+-20} d-ladders whose
    # log-sums accumulate the df ladder tier (4.2e-3 absolute measured on
    # an O(330) action = 1.3e-5 relative).  The measurement path never
    # consumes the triplet's log_det; it is asserted here only as a
    # same-quantity sanity bound.
    assert abs(float(ld) - float(ld64)) < 2e-2


def test_split_scales_dead_column():
    """A structurally dead column (d=0, e=0 — the rank-deficient
    convention maintained by to_ldr/mat_mul_ldr) must go to the SMALL
    branch: ds=0, inv_dl=1, log_m=0, e_big=0 (matching the reference's
    D_small placement, stablelinalg.cpp inv_I_plus_ldr).  Regression for
    the round-3 split (big = e>=0) that sent it big and NaN-poisoned
    the middle matrix via 1/0 and log(0)."""
    d = df32.df(jnp.asarray([2.5e4, 1.0, 0.0], jnp.float32))
    # normalize to the mantissa-in-[1,2) + exponent invariant
    m, e = jnp.frexp(d.hi)
    d = DF(jnp.where(d.hi > 0, 2 * m, 0.0), jnp.zeros_like(d.hi))
    e = jnp.where(m > 0, e - 1, 0).astype(jnp.int32)
    inv_dl, ds, log_m, e_big = df_linalg._split_scales(d, e)
    assert np.all(np.isfinite(_to64(inv_dl)))
    assert np.all(np.isfinite(_to64(ds)))
    assert np.all(np.isfinite(np.asarray(log_m)))
    np.testing.assert_allclose(_to64(inv_dl)[..., 2], 1.0)
    np.testing.assert_allclose(_to64(ds)[..., 2], 0.0)
    assert float(log_m[..., 2]) == 0.0 and int(e_big[..., 2]) == 0
    # live columns unchanged by the guard
    np.testing.assert_allclose(_to64(inv_dl)[..., 0], 1 / 2.5e4, rtol=1e-7)
    np.testing.assert_allclose(_to64(ds)[..., 1], 1.0)


def test_solve_refined_well_conditioned_converges(rng):
    """Healthy regime: the safeguarded IR is the old IR (monotone
    residuals pick the last iterate) — df-grade solve error."""
    n = 48
    A = rng.standard_normal((n, n))
    u, s, vt = np.linalg.svd(A)
    M64 = u @ np.diag(np.logspace(0, 4, n)) @ vt       # cond 1e4
    Y64 = rng.standard_normal((n, n))
    X, logabs = df_linalg._solve_refined(_df_from64(M64), _df_from64(Y64))
    X_exact = np.linalg.solve(M64, Y64)
    assert np.abs(_to64(X) - X_exact).max() < 1e-9
    # logdet carries the f32-Q first-order bias correction; its floor
    # scales with cond (~1e-4 at cond 1e4) — sanity-bound only
    assert abs(float(logabs) - np.linalg.slogdet(M64)[1]) < 1e-3


def test_solve_refined_safeguard_bounds_divergence(rng):
    """eps32*cond > 1 regime (cond 1e9): plain IR amplifies the seed
    error by (eps32*cond)^k — orders beyond the seed.  The safeguard
    returns the best-residual iterate, so the solve error stays at seed
    grade (~cond*eps32 relative) instead of exploding."""
    n = 48
    A = rng.standard_normal((n, n))
    u, s, vt = np.linalg.svd(A)
    M64 = u @ np.diag(np.logspace(0, 9, n)) @ vt       # cond 1e9
    Y64 = rng.standard_normal((n, n))
    X, _ = df_linalg._solve_refined(_df_from64(M64), _df_from64(Y64))
    X_exact = np.linalg.solve(M64, Y64)
    rel = np.abs(_to64(X) - X_exact).max() / np.abs(X_exact).max()
    # seed grade here is ~cond*eps32 ~ 1e2 relative at worst; plain IR
    # measured 1e5+ on this construction.  Bound well below divergence.
    assert rel < 1e3, f"safeguard failed to bound divergence: rel={rel:.3e}"


def test_solve_refined_well_conditioned_converges(rng):
    """Healthy regime: the safeguarded IR is the old IR (monotone
    residuals pick the last iterate) — df-grade solve error."""
    n = 48
    A = rng.standard_normal((n, n))
    u, s, vt = np.linalg.svd(A)
    M64 = u @ np.diag(np.logspace(0, 4, n)) @ vt       # cond 1e4
    Y64 = rng.standard_normal((n, n))
    X, logabs = df_linalg._solve_refined(_df_from64(M64), _df_from64(Y64))
    X_exact = np.linalg.solve(M64, Y64)
    assert np.abs(_to64(X) - X_exact).max() < 1e-9
    # logdet carries the f32-Q first-order bias correction; its floor
    # scales with cond (~1e-4 at cond 1e4) — sanity-bound only
    assert abs(float(logabs) - np.linalg.slogdet(M64)[1]) < 1e-3


def test_solve_refined_safeguard_bounds_divergence(rng):
    """eps32*cond > 1 regime (cond 1e9): plain IR amplifies the seed
    error by (eps32*cond)^k — orders beyond the seed.  The safeguard
    returns the best-residual iterate, so the solve error stays at seed
    grade (~cond*eps32 relative) instead of exploding."""
    n = 48
    A = rng.standard_normal((n, n))
    u, s, vt = np.linalg.svd(A)
    M64 = u @ np.diag(np.logspace(0, 9, n)) @ vt       # cond 1e9
    Y64 = rng.standard_normal((n, n))
    X, _ = df_linalg._solve_refined(_df_from64(M64), _df_from64(Y64))
    X_exact = np.linalg.solve(M64, Y64)
    rel = np.abs(_to64(X) - X_exact).max() / np.abs(X_exact).max()
    # seed grade here is ~cond*eps32 ~ 1e2 relative at worst; plain IR
    # measured 1e5+ on this construction.  Bound well below divergence.
    assert rel < 1e3, f"safeguard failed to bound divergence: rel={rel:.3e}"


# (the ldr_mul_ldr tree-fold and its test were removed in round 4:
# doubly-graded LDR x LDR combines are only NORMWISE backward stable
# and lose the small-d relative accuracy — see NOTES.md "LDR x LDR
# tree folds are a dead end at multiword-f32")
