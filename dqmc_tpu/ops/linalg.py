"""Numerically stable LDR (UDT) matrix algebra for DQMC propagator products.

This is the JAX equivalent of the reference's ``stablelinalg``
(source/stablelinalg.cpp:1-191), which holds the entire numerical stability
of the method.  A propagator product over many imaginary-time slices has
singular values spanning ~exp(+-beta*W); representing it as ``F = L @
diag(d) @ R`` with orthogonal L, non-negative scales d, and a
well-conditioned R keeps every intermediate matrix O(1)-conditioned.

Design notes (a re-design, not a translation):

- The reference uses LAPACK's greedy column-pivoted QR (``geqp3`` via
  ``arma::qr(...,"vector")``, stablelinalg.cpp:40-41).  Greedy pivoting is
  inherently sequential and maps badly onto batched hardware.  We pre-sort
  columns by norm (one ``argsort``) and run XLA's blocked Householder QR.
  For the matrices that arise here — each re-QR input is
  ``diag(d_sorted) @ (well-conditioned) @ diag(d2)`` with d already sorted
  descending — a single pre-sort captures the pivot order almost exactly,
  and the d-scale separation it produces is validated against f64 brute
  force in tests/test_linalg.py down to <1e-10.
- All ops are pure functions on an ``LDR`` NamedTuple (a pytree), so they
  vmap over walker/flavor axes and batch the QRs/GEMMs.
- The three stabilized inverses mirror the reference's D_large/D_small
  splitting (stablelinalg.cpp:94-190) exactly:
      d = d_small * d_large,  d_large = max(d, 1),  d_small = min(d, 1)
  so every solve sees only O(1) entries.
- ``inv_one_plus_ldr_mul_ldr`` also returns log|det(I + F1 F2)|, which the
  reference only computes in ``inv_I_plus_ldr`` (stablelinalg.cpp:118-120);
  having it at every stabilization keeps the replica-exchange action fresh
  for free.

Identity padding: ``identity_ldr`` provides an exact identity factorization
used by the sweep engine to make the first/last stack slots uniform — the
reference's special cases (dqmc.cpp:141-146, 152-160, 196-214, 253-262,
265-274) all collapse into the generic formulas when multiplied against an
identity LDR.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class LDR(NamedTuple):
    """F = L @ diag(d) @ R.

    L: (..., n, n) orthogonal; d: (..., n) non-negative scales;
    R: (..., n, n) well-conditioned (unit-modulus diagonal up to a column
    permutation).
    """

    L: jax.Array
    d: jax.Array
    R: jax.Array

    @property
    def n(self) -> int:
        return self.L.shape[-1]


def identity_ldr(n: int, dtype=jnp.float64) -> LDR:
    eye = jnp.eye(n, dtype=dtype)
    return LDR(eye, jnp.ones((n,), dtype=dtype), eye)


def ldr_matrix(F: LDR) -> jax.Array:
    """Dense reconstruction L @ diag(d) @ R (for tests/diagnostics)."""
    return F.L @ (F.d[..., :, None] * F.R)


def _log_clamp(dtype) -> float:
    # d is stored as exp(log_d); the clamp keeps it representable with ample
    # headroom for the next block product (|B_block| up to ~e^25) and for
    # squaring-free downstream arithmetic.  Scales beyond the clamp
    # contribute < eps to every stabilized inverse (D_large only enters
    # inverted, D_small only as a damping factor), so G is unaffected; only
    # log|det| saturates, and only for modes with |log d| beyond the clamp
    # (beta*W ~ 60 in f32, ~600 in f64).
    return 60.0 if dtype == jnp.float32 else 600.0


def _qr(A: jax.Array):
    """Householder QR (cuSOLVER geqrf on the GPU, LAPACK on the CPU).

    Gram-based orthogonalization (CholeskyQR2) was measured unsafe here:
    fold inputs carry cond ~1e6 even after column equilibration at beta=8,
    and a gram-based factorization cannot resolve singular values below
    sqrt(eps_f32) * sigma_max (NaNs / O(1) G errors; NOTES.md)."""
    return jnp.linalg.qr(A)


def unpermute_columns(X: jax.Array, perm: jax.Array) -> jax.Array:
    """Undo a column permutation: column j of X moves to perm[j] (i.e.
    X[..., argsort(perm)]), as a scatter rather than a second argsort —
    XLA:GPU's permutation-sort simplifier rejects an argsort of a
    permutation under x64 (s32 vs s64 accumulator in the hlo verifier).
    perm: (..., n) with leading dims matching X's, or (n,)."""
    idx = jnp.broadcast_to(perm[..., None, :], X.shape)
    return jnp.put_along_axis(X, idx, X, axis=-1, inplace=False)


def to_ldr(M: jax.Array) -> LDR:
    """Factor M -> L * diag(d) * R via column-presorted QR.

    Same semantics as the reference's pivoted-QR ``to_LDR``
    (stablelinalg.cpp:35-55): d >= 0, R row-rescaled to a unit-modulus
    diagonal, column permutation folded back so L*d*R == M.

    Overflow-proof orientation for low precision: columns are pre-normalized
    by their max-abs scale s_j (computed without squaring), so the QR runs
    on an O(1) matrix regardless of the propagator's dynamic range; the true
    scales are re-attached in the log domain:

        d_j   = |Rn_jj| * s_j                    (as exp of clamped logs)
        R_ij  = (Rn_ij / |Rn_ii|) * exp(log s_j - log s_i)

    In the sorted upper triangle s_j <= s_i, so the scale ratio never
    exceeds ~1 and R stays well-conditioned.
    """
    dtype = M.dtype
    s = jnp.max(jnp.abs(M), axis=-2)
    # descending stable sort of column scales ≈ geqp3's pivot order here
    perm = jnp.argsort(-s, stable=True)
    Mp = jnp.take(M, perm, axis=-1)
    sp = jnp.take(s, perm, axis=-1)
    sp_safe = jnp.where(sp == 0, jnp.ones_like(sp), sp)
    Q, Rn = _qr(Mp / sp_safe[..., None, :])
    diag = jnp.abs(jnp.diagonal(Rn, axis1=-2, axis2=-1))
    diag_safe = jnp.where(diag == 0, jnp.ones_like(diag), diag)
    clamp = _log_clamp(dtype)
    log_sp = jnp.log(sp_safe)
    log_d = jnp.clip(jnp.log(diag_safe) + log_sp, -clamp, clamp)
    d = jnp.where((sp == 0) | (diag == 0), jnp.zeros_like(sp),
                  jnp.exp(log_d))
    # sorted order makes every needed (upper-triangle) exponent <= 0; the
    # lower triangle of Rn is zero, so clip to avoid inf * 0 there
    ratio = jnp.exp(jnp.minimum(
        log_sp[..., None, :] - log_sp[..., :, None], 0.0))
    Ru = (Rn / diag_safe[..., :, None]) * ratio
    R_final = unpermute_columns(Ru, perm)
    return LDR(Q, d, R_final)


def ldr_mul_mat(F: LDR, M: jax.Array) -> LDR:
    """F' = F @ M (stablelinalg.cpp:57-67)."""
    Mp = F.d[..., :, None] * (F.R @ M)
    q = to_ldr(Mp)
    return LDR(F.L @ q.L, q.d, q.R)


def mat_mul_ldr(M: jax.Array, F: LDR) -> LDR:
    """F' = M @ F (stablelinalg.cpp:69-79)."""
    Mp = (M @ F.L) * F.d[..., None, :]
    q = to_ldr(Mp)
    return LDR(q.L, q.d, q.R @ F.R)


def ldr_mul_ldr(F1: LDR, F2: LDR) -> LDR:
    """F' = F1 @ F2 (stablelinalg.cpp:81-92)."""
    Mp = (F1.d[..., :, None] * (F1.R @ F2.L)) * F2.d[..., None, :]
    q = to_ldr(Mp)
    return LDR(F1.L @ q.L, q.d, q.R @ F2.R)


def _split_scales(d: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """d -> (d_large, d_small) with d_large = max(d,1), d_small = min(d,1)."""
    one = jnp.ones_like(d)
    return jnp.maximum(d, one), jnp.minimum(d, one)


# ----------------------------------------------------------------------
# Reference-orientation stabilized inverses — TEST ORACLES, not engine code
# ----------------------------------------------------------------------
# These mirror the reference's row-graded formulas one-to-one
# (stablelinalg.cpp:94-190) and exist to (a) document the translation and
# (b) cross-check the production "dag" forms below in tests/test_linalg.py.
# The engine exclusively uses the transpose-suffix forms (inv_*_dag),
# whose inputs stay column-graded and f32-safe.


def inv_one_plus_ldr(F: LDR) -> Tuple[jax.Array, jax.Array]:
    """G = [I + F]^-1 and log|det(I + F)| (stablelinalg.cpp:94-126).

    Factorization: I + L d R = (R^-1 Dl^-1 + L Ds) Dl R = M Dl R, so
    G = R^-1 Dl^-1 M^-1 = X M^-1 with X = solve(R, diag(1/Dl)); and
    log|det(I+F)| = sum log Dl + log|det M| (|det R| = |det L| = 1).
    """
    d_large, d_small = _split_scales(F.d)
    n = F.n
    X = jnp.linalg.solve(F.R, jnp.eye(n, dtype=F.R.dtype)) / d_large[..., None, :]
    M = X + F.L * d_small[..., None, :]
    sign, logabs = jnp.linalg.slogdet(M)
    del sign
    log_det = jnp.sum(jnp.log(d_large), axis=-1) + logabs
    # G = X @ M^-1  computed as  solve(M^T, X^T)^T
    G = jnp.linalg.solve(jnp.swapaxes(M, -1, -2), jnp.swapaxes(X, -1, -2))
    return jnp.swapaxes(G, -1, -2), log_det


def inv_one_plus_ldr_mul_ldr(F1: LDR, F2: LDR) -> Tuple[jax.Array, jax.Array]:
    """G = [I + F1 @ F2]^-1 and log|det(I + F1 F2)| (stablelinalg.cpp:128-158).

    Factorization (orthogonal L1, so L1^-1 = L1^T):
      I + F1 F2 = L1 D1l [ D1l^-1 L1^T R2^-1 D2l^-1 + D1s R1 L2 D2s ] D2l R2
                = L1 D1l M D2l R2
      G = R2^-1 D2l^-1 M^-1 D1l^-1 L1^T = X M^-1 Y
      log|det| = sum log D1l + sum log D2l + log|det M|.

    With F2 = identity_ldr this is numerically well-posed and equals
    inv_one_plus_ldr(F1) mathematically — the sweep engine exploits this to
    avoid per-slice special cases.
    """
    d1l, d1s = _split_scales(F1.d)
    d2l, d2s = _split_scales(F2.d)
    n = F1.n
    L1T = jnp.swapaxes(F1.L, -1, -2)
    X = jnp.linalg.solve(F2.R, jnp.eye(n, dtype=F2.R.dtype)) / d2l[..., None, :]
    termA = (L1T @ X) / d1l[..., :, None]
    termB = d1s[..., :, None] * (F1.R @ (F2.L * d2s[..., None, :]))
    M = termA + termB
    Y = L1T / d1l[..., :, None]
    sign, logabs = jnp.linalg.slogdet(M)
    del sign
    log_det = (jnp.sum(jnp.log(d1l), axis=-1)
               + jnp.sum(jnp.log(d2l), axis=-1) + logabs)
    G = X @ jnp.linalg.solve(M, Y)
    return G, log_det


def _qr_solve_logdet(A: jax.Array, B: jax.Array):
    """(A^{-1} B, log|det A|) for the well-conditioned M systems.

    f64: via QR + TriangularSolve (LU-free, the parity-grade path).
    f32: LU (jnp.linalg.solve / slogdet).  M has O(1) ENTRIES by
    construction (the D_large/D_small split) but NOT O(1) condition —
    gram/Cholesky-based solvers (normal equations, even with iterative
    refinement) and gram-based log-dets were measured to lose the chain
    (G errors O(1), log|det| off by ~30); a genuinely stable
    factorization is load-bearing here, exactly like the reference's
    arma::solve (stablelinalg.cpp:112).
    """
    if A.dtype == jnp.float64:
        Q, R = jnp.linalg.qr(A)
        X = jax.lax.linalg.triangular_solve(
            R, jnp.swapaxes(Q, -1, -2) @ B, left_side=True, lower=False)
        logabs = jnp.sum(
            jnp.log(jnp.abs(jnp.diagonal(R, axis1=-2, axis2=-1))), axis=-1)
        return X, logabs
    X = jnp.linalg.solve(A, B)
    sign, logabs = jnp.linalg.slogdet(A)
    del sign
    return X, logabs


# ----------------------------------------------------------------------
# transpose-suffix ("dag") stabilized inverses
# ----------------------------------------------------------------------
#
# The reference's formulas (above) feed row-graded matrices diag(d) @ X into
# QR and solve against R factors — fine in f64, catastrophic in f32 once the
# d-range exceeds the mantissa (see tests/test_linalg.py::test_f32_accuracy).
# The engine therefore stores suffix propagator products
# B(beta,tau) as LDRs of their TRANSPOSE:
#
#     F2t = (L2, d2, R2)  represents  B2 = F2t_matrix^T = R2^T d2 L2^T.
#
# Then every product in both sweep directions is mat_mul_ldr — a
# column-graded QR, which column-norm presorting handles at columnwise
# relative accuracy — and the stabilized inverses combine
#     L1^T @ L2      (orthogonal x orthogonal: perfectly conditioned)
#     R1 @ R2^T      (well-conditioned x well-conditioned)
# scaled by D_large^{-1} <= 1 and D_small <= 1, so the M matrix has O(1)
# entries and its LU solve is f32-safe.  No solve against an R factor
# remains anywhere.

def inv_one_plus_ldr_dag(F1: LDR, F2t: LDR) -> Tuple[jax.Array, jax.Array]:
    """G = [I + B1 B2]^{-1} and log|det|, with B1 = F1 (normal form) and
    B2 given by its transpose factorization F2t (B2 = R2^T d2 L2^T).

    Derivation:
      I + B1 B2 = L1 D1l [ D1l^{-1} (L1^T L2) D2l^{-1}
                           + D1s (R1 R2^T) D2s ] D2l L2^T
      G = L2 D2l^{-1} M^{-1} D1l^{-1} L1^T
      log|det(I + B1 B2)| = sum log D1l + sum log D2l + log|det M|.

    With F2t = identity this reduces exactly to [I + B1]^{-1}.
    """
    d1l, d1s = _split_scales(F1.d)
    d2l, d2s = _split_scales(F2t.d)
    L1T = jnp.swapaxes(F1.L, -1, -2)
    R2T = jnp.swapaxes(F2t.R, -1, -2)
    M = ((L1T @ F2t.L) / d1l[..., :, None] / d2l[..., None, :]
         + (d1s[..., :, None] * (F1.R @ R2T)) * d2s[..., None, :])
    Y = L1T / d1l[..., :, None]
    X, logabs = _qr_solve_logdet(M, Y)
    log_det = (jnp.sum(jnp.log(d1l), axis=-1)
               + jnp.sum(jnp.log(d2l), axis=-1) + logabs)
    G = (F2t.L / d2l[..., None, :]) @ X
    return G, log_det


def inv_invldr_plus_ldr_dag(F1: LDR, F2t: LDR) -> jax.Array:
    """G = [B1^{-1} + B2]^{-1} with B2 = F2t_matrix^T (same M as above):

      B1^{-1} + B2 = R1^{-1} D1s^{-1} M D2l L2^T
      G = L2 D2l^{-1} M^{-1} D1s R1.

    Unequal-time usage: Gt0 = inv_invldr_plus_ldr_dag(Bt0, Bbt_t) and, by
    the transpose identity [X^{-1}+Y]^{-1} = ([X^{-T}+Y^T]^{-1})^T,
    G0t = -inv_invldr_plus_ldr_dag(Bbt_t, Bt0)^T — the argument roles swap
    because each LDR is simultaneously the normal form of one operand and
    the transpose form of the other.
    """
    d1l, d1s = _split_scales(F1.d)
    d2l, d2s = _split_scales(F2t.d)
    L1T = jnp.swapaxes(F1.L, -1, -2)
    R2T = jnp.swapaxes(F2t.R, -1, -2)
    M = ((L1T @ F2t.L) / d1l[..., :, None] / d2l[..., None, :]
         + (d1s[..., :, None] * (F1.R @ R2T)) * d2s[..., None, :])
    Y = d1s[..., :, None] * F1.R
    X, _ = _qr_solve_logdet(M, Y)
    return (F2t.L / d2l[..., None, :]) @ X


def inv_triplet_dag(F1: LDR, F2t: LDR):
    """All three unequal-time Green's functions from ONE factorization.

    With B1 = F1 (normal form, B(tau,0)) and B2 = F2t_matrix^T (transpose
    form, B(beta,tau)), the DQMC measurement triplet is

        Gtt = [I + B1 B2]^{-1}          (dqmc.cpp:264-280, stablelinalg 94-126)
        Gt0 = [B1^{-1} + B2]^{-1}       (stablelinalg.cpp:160-190)
        G0t = -[B2^{-1} + B1]^{-1}

    All three share the SAME stabilized middle matrix: inv_one_plus_ldr_dag
    and inv_invldr_plus_ldr_dag(F1, F2t) build an identical

        M = D1l^{-1} (L1^T L2) D2l^{-1} + D1s (R1 R2^T) D2s

    and the role-swapped call for G0t builds exactly M^T (swap the two
    factors and every term transposes).  So one QR of M serves all three:
    Gtt/Gt0 solve against M with two right-hand sides, G0t solves against
    M^T via the same factors (M^T = R^T Q^T => X = Q R^{-T} Y).  This
    replaces three factorizations per unequal-time stabilization with one
    — the single hottest saving in the measurement sweep (the reference
    recomputes each separately, dqmc.cpp:264-280).

    Returns (Gtt, Gt0, G0t, log_det) with log_det = log|det(I + B1 B2)|.
    """
    d1l, d1s = _split_scales(F1.d)
    d2l, d2s = _split_scales(F2t.d)
    L1T = jnp.swapaxes(F1.L, -1, -2)
    R2T = jnp.swapaxes(F2t.R, -1, -2)
    M = ((L1T @ F2t.L) / d1l[..., :, None] / d2l[..., None, :]
         + (d1s[..., :, None] * (F1.R @ R2T)) * d2s[..., None, :])
    n = F1.n

    Ytt = L1T / d1l[..., :, None]
    Yt0 = d1s[..., :, None] * F1.R
    Y = jnp.concatenate([Ytt, Yt0], axis=-1)            # two RHS, one solve
    Y0t = d2s[..., :, None] * F2t.R                     # RHS for M^T

    Q, R = jnp.linalg.qr(M)
    QT = jnp.swapaxes(Q, -1, -2)
    X = jax.lax.linalg.triangular_solve(R, QT @ Y, left_side=True,
                                        lower=False)
    # M^T x = y  =>  x = Q R^{-T} y (lower-triangular solve with R^T)
    Xt = Q @ jax.lax.linalg.triangular_solve(
        jnp.swapaxes(R, -1, -2), Y0t, left_side=True, lower=True)
    logabs = jnp.sum(
        jnp.log(jnp.abs(jnp.diagonal(R, axis1=-2, axis2=-1))), axis=-1)
    log_det = (jnp.sum(jnp.log(d1l), axis=-1)
               + jnp.sum(jnp.log(d2l), axis=-1) + logabs)

    W2 = F2t.L / d2l[..., None, :]
    Gtt = W2 @ X[..., :, :n]
    Gt0 = W2 @ X[..., :, n:]
    G0t = -jnp.swapaxes((F1.L / d1l[..., None, :]) @ Xt, -1, -2)
    return Gtt, Gt0, G0t, log_det


def inv_invldr_plus_ldr(F1: LDR, F2: LDR) -> jax.Array:
    """G = [F1^-1 + F2]^-1 (stablelinalg.cpp:160-190).

    Used for the unequal-time Green's functions
    Gt0 = [B(tau,0)^-1 + B(beta,tau)]^-1 and G0t = -[B(beta,tau)^-1 + B(tau,0)]^-1.

    Factorization:
      F1^-1 + F2 = R1^-1 D1s^-1 [ D1l^-1 L1^T R2^-1 D2l^-1 + D1s R1 L2 D2s ] D2l R2
      G = R2^-1 D2l^-1 M^-1 D1s R1 = X M^-1 (D1s R1).
    """
    d1l, d1s = _split_scales(F1.d)
    d2l, d2s = _split_scales(F2.d)
    n = F1.n
    L1T = jnp.swapaxes(F1.L, -1, -2)
    X = jnp.linalg.solve(F2.R, jnp.eye(n, dtype=F2.R.dtype)) / d2l[..., None, :]
    termA = (L1T @ X) / d1l[..., :, None]
    termB = d1s[..., :, None] * (F1.R @ (F2.L * d2s[..., None, :]))
    M = termA + termB
    Y = d1s[..., :, None] * F1.R
    return X @ jnp.linalg.solve(M, Y)
