"""Stabilized LDR algebra in df32 (double-float32) precision.

The parity-grade numerical core: the same presorted-QR LDR scheme as
ops/linalg.py (reference: stablelinalg.cpp:35-190) carried at ~2^-46
precision from f32 hardware operations.  The factorization is the genuine df
CGS2 of ops/df_qr.py (see there for why f32-QR-plus-refinement cannot
work on graded folds); everything around it is df32 matmuls (exact
int8-plane products) and df elementwise algebra.

Solves against the equilibrated middle matrices M use the FAST f32
factorization plus df iterative refinement: M's condition is bounded
(~4e4 at beta=8, measured), so each IR step gains a factor
~eps32 * cond(M) and three steps land at the df factor floor.  (The
round-2 "iterative refinement is useless" finding applied to
f32-REPRESENTED inputs; df inputs are exactly what IR needs.)

Accuracy tier (measured on the beta=8 fixed-field chain rebuild,
tests/test_df_linalg.py): max|dG| ~ 1e-8 vs the f64 stabilized chain —
per-fold floor eps_df * cond(equilibrated fold input) accumulated over
the stack.  That is ~6 orders below the f32 engine at the same beta and
2 below the reference's own 1e-6 stabilization warning (dqmc.cpp:390);
strict 1e-10 reference parity remains the f64 mode's domain
(tests/test_trajectory_golden.py).

Compilation caveat: on XLA:CPU, whole-graph compilation at backend
optimization level > 0 corrupts fused df chains (1.1e-8 -> 5.4e-4 on
the chain rebuild, measured; LLVM-level contraction across the
error-free transformations).  CPU callers should run these functions eagerly (see
engine/parity._maybe_jit) or set --xla_backend_optimization_level=0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu.ops import df32
from dqmc_tpu.ops.df32 import DF
from dqmc_tpu.ops.df_qr import df_qr
from dqmc_tpu.ops.linalg import unpermute_columns


class LDRdf(NamedTuple):
    """M = L * diag(d * 2^e) * R at multiword (df32 or tf32) precision.

    The scale ladder is stored exponent-split: ``d`` is a multiword
    MANTISSA with hi in [1, 2) (exactly 0 for structurally dead
    columns) and ``e`` an int32 power-of-two exponent per column.  The
    split exists because the accumulated d-ladder is NOT f32-
    representable at production scale: a beta=16 chain spans e^{+-148}
    (measured, tools/stretch range probe) against f32's e^{+-88}.  The
    reference stores d in f64 (range e^{+-709}, stablelinalg.cpp:35-55);
    the exponent channel is the multiword equivalent with effectively
    unbounded range — folds compose scales symbolically
    (``mat_mul_ldr``) so no dense intermediate ever carries the ladder,
    and mantissa renormalization is EXACT (power-of-two component
    scaling, no rounding).
    """
    L: DF
    d: DF
    R: DF
    e: jax.Array

    @property
    def n(self):
        return self.L.hi.shape[-1]


def _renorm_d(d: DF, e: jax.Array, nm=df32):
    """Normalize the mantissa hi into [1, 2), folding the shift into e.

    Scaling every multiword component by one integer power of two is
    exact, so the represented value is preserved bit-for-bit (the lo
    words' subnormal underflow floor sits ~2^-126 below the [1,2)
    mantissa — unreachable).  Zero mantissas pass through unshifted."""
    _, ex = jnp.frexp(d.hi)                 # d.hi = m * 2^ex, m in [.5, 1)
    sh = jnp.where(d.hi > 0, ex - 1, 0).astype(jnp.int32)
    d2 = nm.cmap(lambda c: jnp.ldexp(c, -sh), d)
    return d2, e + sh


def transpose(x):
    return type(x)(*(jnp.swapaxes(c, -1, -2) for c in x))


def _diag(x):
    return type(x)(*(jnp.diagonal(c, axis1=-2, axis2=-1) for c in x))


def _bcast_row(v, shape):
    return type(v)(*(jnp.broadcast_to(c[..., None, :], shape) for c in v))


def _bcast_col(v, shape):
    return type(v)(*(jnp.broadcast_to(c[..., :, None], shape) for c in v))


def to_ldr(M: DF, nm=df32) -> LDRdf:
    """Column-presorted multiword QR factorization into L * diag(d) * R.

    Mirrors ops/linalg.to_ldr (stablelinalg.cpp:35-55 semantics): columns
    sorted by max-abs scale (descending) before the QR, d = |diag R| with
    the column scales folded back, R row-rescaled to unit-modulus
    diagonal, permutation folded into R.
    """
    s = jnp.max(jnp.abs(M.hi), axis=-2)
    perm = jnp.argsort(-s, stable=True)
    Mp = nm.cmap(
        lambda c: jnp.take_along_axis(c, perm[..., None, :], axis=-1), M)
    sp = jnp.take_along_axis(s, perm, axis=-1)
    sp_safe = jnp.where(sp == 0, jnp.ones_like(sp), sp)
    inv_sp = nm.div(nm.df(jnp.ones_like(sp)), nm.df(sp_safe))
    Mn = nm.mul(Mp, _bcast_row(inv_sp, Mp.hi.shape))
    Q, Rn = df_qr(Mn, nm=nm)
    dn = _diag(Rn)
    sign = jnp.where(dn.hi < 0, jnp.float32(-1), jnp.float32(1))
    dabs = nm.cmap(lambda c: c * sign, dn)
    dabs_safe = nm.where(dabs.hi == 0, nm.df(jnp.ones_like(dabs.hi)),
                         dabs)
    d = nm.mul(dabs_safe, nm.df(sp_safe))
    d = nm.where((sp == 0) | (dabs.hi == 0),
                 nm.df(jnp.zeros_like(sp)), d)
    # R: rows rescaled by sign/|diag|, then un-equilibrated (sp_j / sp_i;
    # <= 1 on the upper triangle in sorted order, and the lower triangle
    # is exactly zero).  The lower-triangle ratio sp_j / sp_i can OVERFLOW
    # f32 (the accumulated d-ladder spread exceeds e^88 deep in a beta=8
    # chain), and 0 * inf = NaN would land exactly on R's structural
    # zeros — zero the ratio there explicitly (the f32 path clamps the
    # same way in the log domain, ops/linalg.py to_ldr).
    inv_d = nm.div(nm.df(sign), dabs_safe)
    R = nm.mul(Rn, _bcast_col(inv_d, Rn.hi.shape))
    n = Rn.hi.shape[-1]
    upper = (jnp.arange(n)[:, None] <= jnp.arange(n)[None, :])
    ratio = nm.mul(_bcast_row(nm.df(sp_safe), R.hi.shape),
                   _bcast_col(inv_sp, R.hi.shape))
    ratio = nm.where(upper, ratio, nm.df(jnp.zeros_like(ratio.hi)))
    R = nm.mul(R, ratio)
    R = nm.cmap(lambda c: unpermute_columns(c, perm), R)
    L = nm.cmap(lambda c: c * sign[..., None, :], Q)
    d, e = _renorm_d(d, jnp.zeros(d.hi.shape, jnp.int32), nm=nm)
    return LDRdf(L, d, R, e)


def ldr_matrix(F: LDRdf, nm=df32) -> DF:
    """Dense L * diag(d 2^e) * R (tests / oracles ONLY: the dense form
    overflows f32 whenever the ladder does — that's the point of the
    exponent channel).

    Associated as L @ (diag(d) R): the Ozaki matmul scales its lhs per
    ROW and its rhs per COLUMN, so the d-grading must ride the rhs rows
    (captured by the rhs column scales) — (L d) @ R would push the
    small-d columns below the lhs row-scale plane window and lose
    columnwise accuracy (measured 0.17 relative on an e^+-15 ladder vs
    2^-46 this way)."""
    Rd = nm.mul(F.R, _bcast_col(F.d, F.R.hi.shape))
    Rd = nm.cmap(lambda c: jnp.ldexp(c, F.e[..., :, None]), Rd)
    return nm.matmul(F.L, Rd)


def mat_mul_ldr(B: DF, F: LDRdf, nm=df32) -> LDRdf:
    """LDR of (B @ F_matrix): the forward fold (stablelinalg.cpp:69-79).

    Never materializes diag(d 2^e): with L orthonormal and B one
    stabilization block, BL = B @ L is O(|B|); the true column scales
    factor as (colmax|BL| * d) * 2^e and ride symbolically.  The QR
    input is the colmax-equilibrated BL — identical (to df rounding) to
    equilibrating the dense product B L diag(d 2^e) by ITS colmax, since
    the per-column scale divides out — so the factorization quality is
    unchanged while the ladder range becomes unbounded."""
    BL = nm.matmul(B, F.L)
    c = jnp.max(jnp.abs(BL.hi), axis=-2)
    dead_in = (c == 0) | (F.d.hi == 0)
    cs = jnp.where(dead_in, jnp.ones_like(c), c)
    # full column scale (mantissa m, exponent e): m 2^e = cs * d 2^F.e
    m = nm.mul(nm.df(cs), F.d)
    m, e = _renorm_d(m, F.e, nm=nm)
    m = nm.where(dead_in, nm.df(jnp.ones_like(c)), m)
    e = jnp.where(dead_in, jnp.zeros_like(e), e)
    # descending-scale presort; the f32 key only needs to ORDER columns
    # (near-ties order arbitrarily, as with the dense colmax key)
    t = e.astype(jnp.float32) + jnp.log2(m.hi)
    t = jnp.where(dead_in, -jnp.inf, t)
    perm = jnp.argsort(-t, stable=True)
    row_take = lambda v: jnp.take_along_axis(v, perm, axis=-1)  # noqa: E731
    col_take = lambda v: jnp.take_along_axis(                   # noqa: E731
        v, perm[..., None, :], axis=-1)
    inv_c = nm.div(nm.df(jnp.ones_like(cs)), nm.df(cs))
    Mn = nm.mul(BL, _bcast_row(inv_c, BL.hi.shape))
    Mn = nm.cmap(col_take, Mn)
    mp = nm.cmap(row_take, m)
    ep = row_take(e)
    deadp = row_take(dead_in)
    Q, Rn = df_qr(Mn, nm=nm)
    dn = _diag(Rn)
    sign = jnp.where(dn.hi < 0, jnp.float32(-1), jnp.float32(1))
    dabs = nm.cmap(lambda cc: cc * sign, dn)
    dead = deadp | (dabs.hi == 0)
    dabs_safe = nm.where(dabs.hi == 0, nm.df(jnp.ones_like(dabs.hi)), dabs)
    d_new = nm.mul(dabs_safe, mp)
    d_new, e_new = _renorm_d(d_new, ep, nm=nm)
    d_new = nm.where(dead, nm.df(jnp.zeros_like(d_new.hi)), d_new)
    e_new = jnp.where(dead, jnp.zeros_like(e_new), e_new)
    # R: rows rescaled by sign/|dn|, then un-equilibrated by
    # ratio_{ij} = scale_j / scale_i = (m_j / m_i) 2^{e_j - e_i} — the
    # mantissa part is a bounded multiword division, the exponent part
    # an EXACT component ldexp (underflow to 0 deep below the diagonal
    # is harmless: those entries are ~e^{-ladder} in exact arithmetic)
    inv_dn = nm.div(nm.df(sign), dabs_safe)
    R1 = nm.mul(Rn, _bcast_col(inv_dn, Rn.hi.shape))
    n = Rn.hi.shape[-1]
    upper = (jnp.arange(n)[:, None] <= jnp.arange(n)[None, :])
    mr = nm.div(_bcast_row(mp, R1.hi.shape), _bcast_col(mp, R1.hi.shape))
    de = ep[..., None, :] - ep[..., :, None]
    ratio = nm.cmap(lambda cc: jnp.ldexp(cc, de), mr)
    ratio = nm.where(upper, ratio, nm.df(jnp.zeros_like(ratio.hi)))
    R1 = nm.mul(R1, ratio)
    R1 = nm.cmap(lambda cc: unpermute_columns(cc, perm), R1)
    L = nm.cmap(lambda cc: cc * sign[..., None, :], Q)
    R = nm.matmul(R1, F.R)
    return LDRdf(L, d_new, R, e_new)


_LN2 = 0.6931471805599453


def _split_scales(d: DF, e: jax.Array, nm=df32):
    """Range-safe D_large/D_small split (stablelinalg.cpp:100).

    Returns ``(inv_dl, ds, log_m, e_big)``:

    - ``inv_dl`` = 1/max(d 2^e, 1) as a LINEAR multiword.  Entries below
      ~2^-126 underflow to exact 0 — harmless: they enter the middle
      matrix additively against O(1) rows, so anything below ~2^-60 is
      invisible at multiword grade (in the reference's f64 they are
      ~e^-150 — equally invisible).
    - ``ds`` = min(d 2^e, 1) linear, same underflow argument.
    - ``log_m`` (log of the mantissa where the scale is > 1, else 0) and
      ``e_big`` (the exponent where > 1, else 0): log(D_large) summed
      exactly as sum(log_m) + ln2 * sum(e_big) for the log-det.

    With the mantissa invariant hi in [1, 2), d 2^e >= 1 iff e >= 0,
    so the split predicate is exact integer arithmetic.

    A structurally DEAD column (d = 0, e = 0 — the convention to_ldr /
    mat_mul_ldr maintain for rank-deficient inputs) must NOT take the
    big branch: 1/d would be inf/nan and log(0) = -inf would poison the
    log-det.  It goes small with ds = 0, inv_dl = 1, log_m = 0 — the
    same place the reference's split sends it (stablelinalg.cpp
    inv_I_plus_ldr: d >= 1 fails for d = 0, so it lands in D_small)."""
    big = (e >= 0) & (d.hi > 0)
    one = nm.df(jnp.ones_like(d.hi))
    # clamp the ldexp argument so the not-taken branch never makes infs
    ds = nm.where(big, one,
                  nm.cmap(lambda c: jnp.ldexp(c, jnp.minimum(e, 0)), d))
    d_safe = nm.where(big, d, one)          # keep 1/d finite off-branch
    inv_m = nm.div(one, d_safe)
    inv_dl = nm.where(
        big, nm.cmap(lambda c: jnp.ldexp(c, -jnp.maximum(e, 0)), inv_m),
        one)
    log_m = jnp.where(big, jnp.log(jnp.where(big, nm.to_f64(d), 1.0)),
                      0.0)
    e_big = jnp.where(big, e, 0)
    return inv_dl, ds, log_m, e_big


def _solve_refined(Mdf: DF, Y: DF, n_ir: int | None = None, nm=df32,
                   Yt: DF | None = None):
    """X = M^{-1} Y and log|det M| via f32 QR + multiword iterative
    refinement.

    Each step contracts the error by ~eps32 * cond(M) (~5e-3 at beta=8
    where cond(M) ~ 4e4).  df32 default n_ir=3: with n_ir=2 the solve dominated the whole
    chain's error budget (3.6e-7 vs the folds' 1.1e-8 — measured by
    re-solving the same df factors exactly), with 3 it converges to the
    df factor floor.  tf32 default n_ir=8: the ~5e-3 contraction needs
    ~8 steps to reach the ~2^-68 tf floor; the residual is computed in
    tf so the floor is genuine.

    ``Yt`` (optional): a second right-hand side solved against M^T with
    the SAME f32 factors (M^T x = y -> x = Q R^{-T} y, refined against
    the multiword M^T) — the role-swapped solve of the unequal-time
    triplet (inv_triplet_dag below / ops/linalg.inv_triplet_dag).
    Returns (X, logabs, Xt) when given, (X, logabs) otherwise.

    SAFEGUARD: IR converges only while eps32 * cond(M) < 1.  Beyond
    that (measured with near-random, unthermalized field
    configurations) each step AMPLIFIES the error and
    3-8 steps turn a ~cond*eps seed error into 1e+5..1e+8 garbage.  The
    loop therefore tracks max|Y - M X| per system and returns the
    iterate with the smallest residual — bit-identical to plain IR
    whenever IR is monotone (the healthy regime), bounded at seed grade
    when it is not, so the tier's self-check stays honest instead of
    exploding.  Costs one extra multiword residual per solve."""
    if n_ir is None:
        if nm is df32:
            n_ir = 3
        else:
            # 8 reaches the tf 2^-68 floor; the <1e-10 contract holds
            # from ~5 (gold pins pass at 5), the floor count keeps margin
            n_ir = 8
    Q, R = jnp.linalg.qr(Mdf.hi)
    QT32 = jnp.swapaxes(Q, -1, -2)

    def f32_solve(rhs32):
        return jax.lax.linalg.triangular_solve(
            R, jnp.matmul(QT32, rhs32), left_side=True, lower=False)

    def refine(M, Ynm, solve):
        """Best-residual-iterate IR (see SAFEGUARD note)."""
        X = nm.df(solve(Ynm.hi))
        best_X, best_n = X, None
        for k in range(n_ir + 1):
            r = nm.sub(Ynm, nm.matmul(M, X))
            rn = jnp.max(jnp.abs(r.hi), axis=(-2, -1), keepdims=True)
            if best_n is None:
                best_X, best_n = X, rn
            else:
                better = rn < best_n
                best_X = nm.cmap(
                    lambda c, b: jnp.where(better, c, b), X, best_X)
                best_n = jnp.minimum(rn, best_n)
            if k < n_ir:
                X = nm.add(X, nm.df(solve(r.hi)))
        return best_X

    X = refine(Mdf, Y, f32_solve)

    Xt = None
    if Yt is not None:
        # M^T x = y with the same factors: M = Q R => M^T = R^T Q^T,
        # x = Q R^{-T} y; IR residuals against the multiword M^T
        RT = jnp.swapaxes(R, -1, -2)

        def f32_solve_t(rhs32):
            return jnp.matmul(Q, jax.lax.linalg.triangular_solve(
                RT, rhs32, left_side=True, lower=True))

        Xt = refine(transpose(Mdf), Yt, f32_solve_t)

    # log|det M| = log|det R'| - log|det Q| with R' = Q^T M refined in
    # multiword (one matmul; the f32 diag(R) alone carries only ~2^-23).
    # det Q is NOT 1 at f32-CGS2 grade: Q^T Q = I + E with E ~ 1e-5, and
    # log|det Q| = 0.5 log det(I+E) = 0.5 tr(E) + O(||E||^2) — a FIRST-
    # order bias (~1e-4 absolute on a 256-site chain, measured) that the
    # old "second order" assumption silently kept.  E is computed in
    # multiword (an f32 Q^T Q would bury E under its own rounding).
    Qnm = nm.df(Q)
    Rref = nm.matmul(nm.df(QT32), Mdf)
    diag = _diag(Rref)
    E_diag = _diag(nm.matmul(nm.df(QT32), Qnm))
    log_q = 0.5 * jnp.sum(nm.to_f64(E_diag) - 1.0, axis=-1)
    logabs = (jnp.sum(jnp.log(jnp.abs(nm.to_f64(diag))), axis=-1) - log_q)
    if Yt is not None:
        return X, logabs, Xt
    return X, logabs


def _middle_matrix(F1: LDRdf, F2t: LDRdf, nm=df32):
    """The equilibrated middle matrix shared by every dag inverse
    (stablelinalg.cpp:94-190 splitting, transpose-suffix orientation):

        M = D1l^{-1} (L1^T L2) D2l^{-1} + D1s (R1 R2^T) D2s

    Returns (M, splits, log-det pieces) so callers assemble their own
    G; every piece is range-safe (see _split_scales)."""
    inv_d1l, d1s, lm1, le1 = _split_scales(F1.d, F1.e, nm=nm)
    inv_d2l, d2s, lm2, le2 = _split_scales(F2t.d, F2t.e, nm=nm)
    L1T = transpose(F1.L)
    shape = L1T.hi.shape
    termA = nm.matmul(L1T, F2t.L)
    termA = nm.mul(termA, _bcast_col(inv_d1l, shape))
    termA = nm.mul(termA, _bcast_row(inv_d2l, shape))
    termB = nm.matmul(F1.R, transpose(F2t.R))
    termB = nm.mul(termB, _bcast_col(d1s, shape))
    termB = nm.mul(termB, _bcast_row(d2s, shape))
    M = nm.add(termA, termB)
    log_dl = (jnp.sum(lm1, axis=-1) + jnp.sum(lm2, axis=-1)
              + _LN2 * (jnp.sum(le1, axis=-1)
                        + jnp.sum(le2, axis=-1)).astype(lm1.dtype))
    return M, L1T, (d1s, inv_d1l), (d2s, inv_d2l), log_dl


def inv_one_plus_ldr_dag(F1: LDRdf, F2t: LDRdf, nm=df32):
    """G = [I + F1_matrix @ F2t_matrix^T]^{-1} and log|det|, multiword.

    The dag (transpose-suffix) formulation of ops/linalg.py: F2t holds
    the LDR of B(beta,tau)^T, the middle matrix is equilibrated, and
    G = (L2 / d2l) M^{-1} (L1^T / d1l) (cf. stablelinalg.cpp:94-126).
    """
    M, L1T, (_, inv_d1l), (_, inv_d2l), log_dl = _middle_matrix(
        F1, F2t, nm=nm)
    shape = L1T.hi.shape
    Y = nm.mul(L1T, _bcast_col(inv_d1l, shape))
    X, logabs = _solve_refined(M, Y, nm=nm)
    W2 = nm.mul(F2t.L, _bcast_row(inv_d2l, shape))
    G = nm.matmul(W2, X)
    return G, log_dl + logabs


def inv_triplet_dag(F1: LDRdf, F2t: LDRdf, nm=df32):
    """All three unequal-time Green's functions at multiword grade.

    The measurement-tier twin of ops/linalg.inv_triplet_dag
    (stablelinalg.cpp:160-190, dqmc.cpp:264-280): with B1 = F1 (normal
    form, B(tau,0)) and B2 = F2t_matrix^T (transpose form, B(beta,tau)),

        Gtt = [I + B1 B2]^{-1}         G = (L2/d2l) M^{-1} (L1^T/d1l)
        Gt0 = [B1^{-1} + B2]^{-1}      G = (L2/d2l) M^{-1} (D1s R1)
        G0t = -[B2^{-1} + B1]^{-1}     via M^T (role swap transposes M)

    One f32 factorization of the shared middle matrix M serves all
    three: Gtt/Gt0 refine two stacked right-hand sides against M, G0t
    refines against M^T with the same Q/R factors (_solve_refined's Yt
    path).  Returns (Gtt, Gt0, G0t, log_det) as nm tuples / f64 scalar.
    """
    M, L1T, (d1s, inv_d1l), (d2s, inv_d2l), log_dl = _middle_matrix(
        F1, F2t, nm=nm)
    shape = L1T.hi.shape
    n = F1.n
    Ytt = nm.mul(L1T, _bcast_col(inv_d1l, shape))
    Yt0 = nm.mul(F1.R, _bcast_col(d1s, shape))
    Y = nm.cmap(lambda a, b: jnp.concatenate([a, b], axis=-1), Ytt, Yt0)
    Y0t = nm.mul(F2t.R, _bcast_col(d2s, shape))
    X, logabs, Xt = _solve_refined(M, Y, nm=nm, Yt=Y0t)

    W2 = nm.mul(F2t.L, _bcast_row(inv_d2l, shape))
    Gtt = nm.matmul(W2, nm.cmap(lambda c: c[..., :, :n], X))
    Gt0 = nm.matmul(W2, nm.cmap(lambda c: c[..., :, n:], X))
    W1 = nm.mul(F1.L, _bcast_row(inv_d1l, shape))
    G0t = transpose(nm.neg(nm.matmul(W1, Xt)))
    return Gtt, Gt0, G0t, log_dl + logabs
