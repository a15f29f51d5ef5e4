"""Multiword CGS2 QR: parity-grade factorization from f32 hardware ops.

The factorization of the LDR stabilization chain (ops/df_linalg.py),
generic over the multiword numerics module ``nm`` — ops/df32.py
(~2^-46, the sampling parity tier) or ops/tf32.py (~2^-68, the
measurement parity++ tier).

A real multiword orthogonalization loop is required — not a refinement
of the f32 factorization: for graded DQMC folds the f32 Q basis
misaligns from the true triangular basis by O(eps32 * cond) rotations
in the small-d directions; every matmul-level repair either loses the
alignment (Newton orthogonalization), explodes under un-equilibration
(keeping the non-triangular R), caps the backward error at f32 grade
(masking), or diverges (first-order rotations) — all four measured, see
NOTES.md.  Classical Gram-Schmidt with reorthogonalization carried in
multiword arithmetic resolves the grading down to the arithmetic's
floor directly.

Structure: 32-column panels, two batched panel-external projection
passes (multiword matmuls via the int8 digit-plane scheme), and a ``lax.fori_loop``
over the columns inside a panel (two-pass CGS), so the trace/compile
cost is O(1) in the in-panel column count instead of O(n) — a fully
unrolled per-column loop at n=256 produced ~100k-primitive graphs that
took XLA minutes to compile.

Everything runs on A^T (rows = columns of A), per-column access is a
sublane dynamic slice, and R is accumulated transposed, exactly like
the Pallas kernel's layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dqmc_tpu.ops import df32

_BLOCK = 32


def _t(x):
    return type(x)(*(jnp.swapaxes(c, -1, -2) for c in x))


def _rows(x, a, b):
    return type(x)(*(c[..., a:b, :] for c in x))


def _set_rows(x, a, b, v):
    return type(x)(*(c.at[..., a:b, :].set(u) for c, u in zip(x, v)))


def _dyn_row(x, t, size=1):
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, t, size, axis=-2)
    return type(x)(*(sl(c) for c in x))


def _dyn_set_row(x, t, v):
    st = lambda a, u: jax.lax.dynamic_update_slice_in_dim(a, u, t, axis=-2)
    return type(x)(*(st(c, u) for c, u in zip(x, v)))


def df_qr(A, nm=df32):
    """(Q, R) with A = Q R to ~nm's floor columnwise, Q nm-orthonormal,
    R upper triangular.

    A: (..., n, n) multiword tuple of nm's type; any leading batch dims.
    n not a multiple of the 32-column panel runs as one full-width panel
    (validation sizes; the engine's lattices are padded upstream).
    """
    n = A.hi.shape[-1]
    block = _BLOCK if n % _BLOCK == 0 else n
    QT = _t(A)                                      # rows = columns of A
    batch = A.hi.shape[:-2]
    rt = nm.zeros(batch + (n, n))
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, block), 1)

    for ip in range(n // block):
        p = ip * block
        # --- panel-external orthogonalization (twice, CGS2) ---
        for _ in range(2 if p else 0):
            P = _rows(QT, p, p + block)
            Qdone = _rows(QT, 0, p)
            C = nm.matmul(P, _t(Qdone))             # (block, p)
            P = nm.sub(P, nm.matmul(C, Qdone))
            QT = _set_rows(QT, p, p + block, P)
            rt = nm.cmap(
                lambda r, c: r.at[..., p:p + block, 0:p].add(c), rt, C)

        # --- in-panel two-pass CGS, fori_loop over columns ---
        # Carry: a zero-initialized ``Qfin`` buffer that receives each
        # finished q, and the panel-local R^T rows.  Projections run
        # against Qfin only — its rows beyond the current column are
        # exactly zero, so they contribute exactly 0 in the digit-plane
        # matmul AND keep its per-row/column scales at the finished-q
        # magnitude.  (Projecting against the raw panel with a lane mask
        # is algebraically identical but numerically ~50x worse: the raw
        # unfinished columns dominate the Ozaki per-column scales, and
        # every q-row contribution is quantized relative to those larger
        # scales — measured on the graded QR test.)
        def col_step(t, carry):
            Qfin, rg = carry                        # (.., block, n) x2
            y = _dyn_row(P0, t)                     # (.., 1, n) raw column
            row = nm.zeros(batch + (1, block))
            for _ in range(2):
                c = nm.matmul(y, _t(Qfin))          # (.., 1, block)
                y = nm.sub(y, nm.matmul(c, Qfin))
                row = nm.add(row, c)
            nrm2 = nm.matmul(y, _t(y))              # (.., 1, 1)
            nrm = nm.sqrt(nm.cmap(lambda a: a[..., 0, 0], nrm2))
            safe = nm.where(nrm.hi == 0,
                            nm.df(jnp.ones_like(nrm.hi)), nrm)
            inv = nm.div(nm.df(jnp.ones_like(nrm.hi)), safe)
            q = nm.mul(y, nm.cmap(lambda a: a[..., None, None], inv))
            Qfin = _dyn_set_row(Qfin, t, q)
            diag = (col_ids == t)
            row = nm.where(
                jnp.broadcast_to(diag, row.hi.shape),
                nm.cmap(lambda a: jnp.broadcast_to(a[..., None, None],
                                                   row.hi.shape), nrm),
                row)
            rg = _dyn_set_row(rg, t, row)
            return Qfin, rg

        P0 = _rows(QT, p, p + block)
        z = nm.zeros(batch + (block, n))
        rg0 = nm.zeros(batch + (block, block))
        Qfin, rg = jax.lax.fori_loop(0, block, col_step, (z, rg0))
        QT = _set_rows(QT, p, p + block, Qfin)
        rt = nm.cmap(
            lambda r, g: r.at[..., p:p + block, p:p + block].set(g),
            rt, rg)
    return _t(QT), _t(rt)
