"""tf32 LDR algebra: the parity++ tier vs an mpmath GOLD oracle.

The chain tests here use a dense arbitrary-precision (mpmath, 60-digit)
(I + prod B)^{-1} as the oracle — NOT the f64 stabilized chain.  Round-2
finding that motivated this module: at beta=8 the f64 stabilized chain
itself carries ~6.7e-10 error vs gold (measured at n=64, nt=80 — the
workload tests/test_df_linalg.py uses as its "oracle"), so a sub-1e-10
tier can only be validated against true arbitrary precision.  Measured
on that chain:

    f64 stabilized chain   6.7e-10   (the reference's own numerics grade)
    df32 chain             9.2e-9
    tf32 chain             8.5e-12   <- this tier: BELOW f64

tf32's ~2^-68 arithmetic beats f64's 2^-53 wherever the fold algebra is
the limiter, which is exactly the north-star parity regime
(BASELINE.md: max|dG| < 1e-10 on a fixed field configuration).

CPU caveat: like all multiword code here, chains run EAGER on CPU
(XLA:CPU backend codegen corrupts fused EFT chains at opt level > 0 —
ops/df_linalg.py module doc).  Sizes are kept small for eager speed;
the beta=8 d-ladder (the hard part) is size-independent.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mpmath  # noqa: E402
from mpmath import mp  # noqa: E402

from dqmc_tpu.ops import df32, tf32, df_linalg, linalg  # noqa: E402

from test_df_linalg import _b_chain  # noqa: E402

jax.config.update("jax_enable_x64", True)


def _gold_greens(Bs):
    """Dense (I + prod B)^{-1} at 60 significant digits."""
    n = Bs[0].shape[0]
    with mp.workdps(60):
        P = mp.eye(n)
        for B in Bs:
            Bm = mp.matrix([[mp.mpf(float(B[i, j])) for j in range(n)]
                            for i in range(n)])
            P = Bm * P
        Gm = mp.inverse(mp.eye(n) + P)
        return np.array([[float(Gm[i, j]) for j in range(n)]
                         for i in range(n)], np.float64)


def _tf_chain_greens(Bs, n_stab):
    """tf32 transpose-suffix chain + tf32 dag inverse."""
    n = Bs[0].shape[0]
    nt = len(Bs)
    F = None
    for i_blk in range(-(-nt // n_stab) - 1, -1, -1):
        blk = Bs[i_blk * n_stab:(i_blk + 1) * n_stab]
        Bbar = np.eye(n)
        for B in blk:
            Bbar = B @ Bbar
        T = tf32.from_f64(jnp.asarray(Bbar.T))
        F = (df_linalg.to_ldr(T, nm=tf32) if F is None
             else df_linalg.mat_mul_ldr(T, F, nm=tf32))
    F1 = df_linalg.to_ldr(tf32.df(jnp.eye(n, dtype=jnp.float32)), nm=tf32)
    G, log_det = df_linalg.inv_one_plus_ldr_dag(F1, F, nm=tf32)
    return np.asarray(tf32.to_f64(G)), float(log_det)


def test_tf_qr_quality():
    """Orthogonality and columnwise residual at the tf floor on a graded
    matrix (the fold regime after column equilibration)."""
    rng = np.random.default_rng(5)
    n = 64
    A64 = rng.standard_normal((n, n)) * np.exp(
        np.linspace(-4, 4, n))[None, :]
    from dqmc_tpu.ops.df_qr import df_qr
    Q, R = df_qr(tf32.from_f64(jnp.asarray(A64)), nm=tf32)
    Q64 = np.asarray(tf32.to_f64(Q))
    # f64 floors this check at ~2^-50; tf's own floor is ~2^-65
    assert np.abs(Q64.T @ Q64 - np.eye(n)).max() < 2.0 ** -48
    R64 = np.asarray(tf32.to_f64(R))
    col = np.abs(A64).max(axis=0)
    assert (np.abs(Q64 @ R64 - A64).max(axis=0) / col).max() < 2.0 ** -48
    assert np.all(np.tril(R64, -1) == 0)


def test_tf_to_ldr_roundtrip():
    """L d R reassembles a graded matrix columnwise at the f64-oracle
    floor, and d is positive, descending-sorted input order."""
    rng = np.random.default_rng(6)
    n = 48
    A64 = rng.standard_normal((n, n)) * np.exp(
        np.linspace(-8, 8, n))[None, :]
    F = df_linalg.to_ldr(tf32.from_f64(jnp.asarray(A64)), nm=tf32)
    M = np.asarray(tf32.to_f64(df_linalg.ldr_matrix(F, nm=tf32)))
    col = np.abs(A64).max(axis=0)
    assert (np.abs(M - A64).max(axis=0) / col).max() < 2.0 ** -46
    assert np.all(np.asarray(F.d.hi) > 0)


def test_tf_chain_beats_1e10_vs_gold():
    """North-star pin: the beta=8 tf32 chain lands under 1e-10 vs the
    60-digit gold Green's function — BELOW the f64 stabilized chain's
    own error on the same chain (asserted too, as documentation that
    only an arbitrary-precision oracle can grade this tier)."""
    rng = np.random.default_rng(3)
    n_stab = 5
    Bs = _b_chain(rng, 16, 80, 8.0)
    G_gold = _gold_greens(Bs)

    G_tf, _ = _tf_chain_greens(Bs, n_stab)
    err_tf = np.abs(G_tf - G_gold).max()
    assert err_tf < 1e-10, f"tf chain err vs gold: {err_tf:.3e}"

    # the f64 stabilized chain on the same workload (its error is the
    # grade the reference binary itself would produce)
    from test_df_linalg import _stab64_suffix
    F64 = _stab64_suffix(Bs, n_stab)
    G64, _ = linalg.inv_one_plus_ldr_dag(
        linalg.identity_ldr(16, jnp.float64), F64)
    err_64 = np.abs(np.asarray(G64) - G_gold).max()
    assert err_tf < max(err_64, 1e-12) * 3, (
        f"tf ({err_tf:.3e}) should not be worse than ~f64 ({err_64:.3e})")


def test_tf_log_det_vs_gold():
    """log|det(I + B(beta,0))| from the tf dag inverse vs gold."""
    rng = np.random.default_rng(4)
    n, nt = 16, 40
    Bs = _b_chain(rng, n, nt, 4.0)
    with mp.workdps(60):
        P = mp.eye(n)
        for B in Bs:
            Bm = mp.matrix([[mp.mpf(float(B[i, j])) for j in range(n)]
                            for i in range(n)])
            P = Bm * P
        ld_gold = float(mp.log(abs(mp.det(mp.eye(n) + P))))
    _, ld = _tf_chain_greens(Bs, 5)
    # the multiword tr(E)/2 correction for det(Q) != 1 (ops/df_linalg
    # _solve_refined) brings the log det to ~1e-8 relative; before it the
    # f32 CGS2 Q's first-order orthogonality bias capped it at ~1e-5
    assert abs(ld - ld_gold) / abs(ld_gold) < 1e-7


def test_tf_triplet_beats_1e10_vs_gold():
    """Unequal-time north-star pin: the tf32 measurement triplet at
    mid-beta lands under 1e-10 vs 60-digit gold for ALL THREE Green's
    functions — the tier greenTau/doublonTau/currxxTau consume
    (stablelinalg.cpp:160-190, model.cpp:290-392)."""
    rng = np.random.default_rng(3)
    n, nt, beta, n_stab = 16, 80, 8.0, 5
    Bs = _b_chain(rng, n, nt, beta)
    tau = nt // 2

    def _prod_mp(blocks):
        P = mp.eye(n)
        for B in blocks:
            Bm = mp.matrix([[mp.mpf(float(B[i, j])) for j in range(n)]
                            for i in range(n)])
            P = Bm * P
        return P

    with mp.workdps(60):
        P1 = _prod_mp(Bs[:tau])          # B(tau, 0)
        P2 = _prod_mp(Bs[tau:])          # B(beta, tau)
        Gtt_m = mp.inverse(mp.eye(n) + P1 * P2)
        Gt0_m = Gtt_m * P1               # (P1^{-1} + P2)^{-1}
        G0t_m = -mp.inverse(mp.eye(n) + P2 * P1) * P2
        gold = [np.array([[float(M[i, j]) for j in range(n)]
                          for i in range(n)]) for M in (Gtt_m, Gt0_m, G0t_m)]

    def _tf_fold(blocks, transpose_suffix):
        F = None
        idx = range(-(-len(blocks) // n_stab))
        order = reversed(idx) if transpose_suffix else idx
        for i_blk in order:
            blk = blocks[i_blk * n_stab:(i_blk + 1) * n_stab]
            Bbar = np.eye(n)
            for B in blk:
                Bbar = B @ Bbar
            M = tf32.from_f64(jnp.asarray(Bbar.T if transpose_suffix
                                          else Bbar))
            F = (df_linalg.to_ldr(M, nm=tf32) if F is None
                 else df_linalg.mat_mul_ldr(M, F, nm=tf32))
        return F

    F1 = _tf_fold(Bs[:tau], False)
    F2t = _tf_fold(Bs[tau:], True)
    Gtt, Gt0, G0t, _ = df_linalg.inv_triplet_dag(F1, F2t, nm=tf32)
    for got, want, name in ((Gtt, gold[0], "Gtt"), (Gt0, gold[1], "Gt0"),
                            (G0t, gold[2], "G0t")):
        err = np.abs(np.asarray(tf32.to_f64(got)) - want).max()
        assert err < 1e-10, f"{name}: {err:.3e}"
