"""Triple-float32 ("tf32x3") arithmetic: ~72-bit-significand numerics
from triples of f32 values.

Why a third component exists at all: the df32 pair tier bottoms out at
~1e-8 on the beta=8 stabilization chain — measured round-2, a pure
representation round-trip (f64 -> f32 pair -> f64) of the chain's LDR
factors already injects up to 6e-10 into the final Green's function
(the chain amplifies factor-level eps by ~1e4-2e5), so NO pair-of-f32
scheme can reach the 1e-10 parity target (BASELINE.md) regardless of
how accurate its arithmetic is.  A triple carries eps ~2^-70: even
after the chain's amplification the rebuilt G lands below 1e-12.

Same design as ops/df32.py (see there for the rationale):

- elementwise: error-free-transformation chains (two_sum / Dekker
  two_prod on f32, no FMA), "sloppy" triple-word algorithms in the
  sense of Fabiano-Muller-Picot: components may overlap by a few bits,
  costing a few of the 72 bits — validated ~<= 2^-63 worst-case
  elementwise against mpmath in tests/test_tf32.py, far below the
  chain's ~2^-51 requirement;
- matmul: the identical integer Ozaki digit-plane scheme with 10 planes
  (70 plane bits): per-row/column power-of-two scales, exact
  int8 x int8 -> int32 digit products, weight-graded triple-word
  recombination.  55 int8 passes per matmul vs df32's 28.

Used by the parity++ measurement-rebuild tier (engine/parity.py with
nm=tf32): df32 keeps the sampling hot path, tf32 rebuilds the measured
Green's functions at <1e-10 (north-star row, BASELINE.md).

Representation: TF(hi, mi, lo); value = hi + mi + lo exactly.  All
functions shape-polymorphic and jit/vmap-safe (no data-dependent
control flow).  API mirrors ops/df32.py so numeric-generic code
(ops/df_linalg.py, ops/df_qr.py) takes either module as its ``nm``
parameter; the constructor keeps df32's ``df`` name for that reason.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu import platform
from dqmc_tpu.ops.df32 import two_sum, quick_two_sum, two_prod


class TF(NamedTuple):
    """f32 triple: value = hi + mi + lo exactly (components may overlap
    by a few bits — "sloppy" normalization, bounds in the module doc)."""
    hi: jax.Array
    mi: jax.Array
    lo: jax.Array

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape


def cmap(f, *xs) -> TF:
    """Apply a structural (value-preserving) array op to each component."""
    return TF(*(f(*parts) for parts in zip(*xs)))


def df(hi, mi=None, lo=None) -> TF:
    """Constructor from plain f32 (named ``df`` for df32 API parity)."""
    hi = jnp.asarray(hi, jnp.float32)
    z = jnp.zeros_like(hi)
    return TF(hi,
              z if mi is None else jnp.asarray(mi, jnp.float32),
              z if lo is None else jnp.asarray(lo, jnp.float32))


def zeros(shape, dtype=jnp.float32) -> TF:
    z = jnp.zeros(shape, dtype)
    return TF(z, z, z)


def from_f64(x) -> TF:
    """Exact f64 -> tf32 conversion (53 significand bits <= 72)."""
    x = jnp.asarray(x)
    hi = x.astype(jnp.float32)
    r = x - hi.astype(x.dtype)
    mi = r.astype(jnp.float32)
    lo = (r - mi.astype(x.dtype)).astype(jnp.float32)
    return TF(hi, mi, lo)


def from_df(x) -> TF:
    return TF(x.hi, x.lo, jnp.zeros_like(x.hi))


def to_df(x: TF):
    from dqmc_tpu.ops.df32 import DF, add as df_add
    return df_add(DF(x.hi, x.mi), DF(x.lo, jnp.zeros_like(x.lo)))


def to_f64(x: TF):
    return (x.hi.astype(jnp.float64) + x.mi.astype(jnp.float64)
            + x.lo.astype(jnp.float64))


def _renorm(t0, t1, t2, *rest):
    """Triple from a decreasing-magnitude term list (value-preserving up
    to the dropped ~2^-72-relative tail)."""
    for r in rest:
        t2 = t2 + r
    s, e1 = two_sum(t0, t1)
    e1, e2 = two_sum(e1, t2)
    # full two_sum (not quick_) in the normalization chain: under
    # cancellation in t0 + t1 the folded error e1 can EXCEED s, and
    # quick_two_sum's ordering precondition would silently cost ~2^-25
    # relative instead of ~2^-70
    s, c = two_sum(s, e1)
    return TF(s, *two_sum(c, e2))


def add(x: TF, y: TF) -> TF:
    s0, e0 = two_sum(x.hi, y.hi)
    s1, e1 = two_sum(x.mi, y.mi)
    t1, f1 = two_sum(e0, s1)
    t2 = (e1 + f1) + (x.lo + y.lo)
    return _renorm(s0, t1, t2)


def neg(x: TF) -> TF:
    return TF(-x.hi, -x.mi, -x.lo)


def sub(x: TF, y: TF) -> TF:
    return add(x, neg(y))


def add_f32(x: TF, c) -> TF:
    s0, e0 = two_sum(x.hi, c)
    t1, f1 = two_sum(e0, x.mi)
    return _renorm(s0, t1, f1 + x.lo)


def mul(x: TF, y: TF) -> TF:
    p0, e0 = two_prod(x.hi, y.hi)
    p1, e1 = two_prod(x.hi, y.mi)
    p2, e2 = two_prod(x.mi, y.hi)
    p3 = (x.mi * y.mi + (e1 + e2)) + (x.hi * y.lo + x.lo * y.hi)
    t1, f1 = two_sum(p1, p2)
    t1, f2 = two_sum(e0, t1)
    return _renorm(p0, t1, p3 + f1 + f2)


def mul_f32(x: TF, c) -> TF:
    p0, e0 = two_prod(x.hi, c)
    p1, e1 = two_prod(x.mi, c)
    t1, f1 = two_sum(e0, p1)
    return _renorm(p0, t1, (e1 + f1) + x.lo * c)


def mul_pow2(x: TF, c) -> TF:
    """Multiply by a power of two (exact)."""
    return TF(x.hi * c, x.mi * c, x.lo * c)


def div(x: TF, y: TF) -> TF:
    """Long division: three f32 quotient digits + one correction."""
    q0 = x.hi / y.hi
    r = sub(x, mul_f32(y, q0))
    q1 = r.hi / y.hi
    r = sub(r, mul_f32(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_f32(y, q2))
    q3 = r.hi / y.hi
    return _renorm(q0, q1, q2, q3)


def sqrt(x: TF) -> TF:
    """sqrt via two triple-word Newton corrections of the f32 root."""
    q0 = jnp.sqrt(x.hi)
    safe = jnp.where(q0 == 0, jnp.float32(1), q0)
    p, e = two_prod(q0, q0)
    r = sub(x, TF(p, e, jnp.zeros_like(p)))
    q1 = r.hi / (2.0 * safe)
    # second step against the (q0, q1) approximation
    y = _renorm(q0, q1, jnp.zeros_like(q0))
    r = sub(x, mul(y, y))
    q2 = r.hi / (2.0 * safe)
    out = _renorm(q0, q1, q2)
    zero = q0 == 0
    return cmap(lambda a: jnp.where(zero, jnp.float32(0), a), out)


def abs_(x: TF) -> TF:
    neg_mask = x.hi < 0
    return cmap(lambda a: jnp.where(neg_mask, -a, a), x)


def lt(x: TF, y: TF):
    return ((x.hi < y.hi)
            | ((x.hi == y.hi) & (x.mi < y.mi))
            | ((x.hi == y.hi) & (x.mi == y.mi) & (x.lo < y.lo)))


def where(mask, x: TF, y: TF) -> TF:
    return cmap(lambda a, b: jnp.where(mask, a, b), x, y)


# ----------------------------------------------------------------------
# tf32 matmul: integer Ozaki digit-plane scheme (df32's, with 10 planes)
# ----------------------------------------------------------------------

N_PLANES = 10
_PLANE_BITS = 7


def _digit_planes(v: TF, axis: int, n_planes: int):
    """(planes int8 [n_planes, ...], scale f32 broadcastable) for v.

    Identical to df32._digit_planes but the residual cancellation runs
    in triple-word arithmetic so all 70 plane bits are genuine."""
    mag = jnp.max(jnp.abs(v.hi), axis=axis, keepdims=True)
    mag = jnp.where(mag == 0, jnp.float32(1), mag)
    _, e = jnp.frexp(mag)
    s = jnp.ldexp(jnp.float32(1.0), e + 1).astype(jnp.float32)
    r = cmap(lambda a: a / s, v)                     # exact (power of two)
    planes = []
    for i in range(n_planes):
        w = np.float32(2.0 ** (_PLANE_BITS * (i + 1)))
        q = jnp.rint(r.hi * w)
        planes.append(q.astype(jnp.int8))
        r = sub(r, TF(q / w, jnp.zeros_like(q), jnp.zeros_like(q)))
    return jnp.stack(planes), s


def matmul(a: TF, b: TF, n_planes: int = N_PLANES) -> TF:
    """tf32 (..., m, k) @ (..., k, n) -> (..., m, n) with ~2^-68 relative
    error w.r.t. exact row/column magnitudes (10 planes; k <= 2^18).

    Accelerators route through an inner jit (one trace per signature —
    the parity rebuild builds hundreds of these); CPU stays inline to
    dodge the XLA:CPU LLVM reassociation bug (ops/df_linalg.py doc)."""
    if platform.jit_multiword():
        return _matmul_jit(a, b, n_planes)
    return _matmul_impl(a, b, n_planes)


def _matmul_impl(a: TF, b: TF, n_planes: int = N_PLANES) -> TF:
    ap, sa = _digit_planes(a, axis=-1, n_planes=n_planes)   # per row
    bp, sb = _digit_planes(b, axis=-2, n_planes=n_planes)   # per column
    nbatch = a.hi.ndim - 2
    batch_axes = tuple(range(nbatch))
    dn = (((nbatch + 1,), (nbatch,)), (batch_axes, batch_axes))

    def idot(x, y):
        return jax.lax.dot_general(x, y, dn,
                                   preferred_element_type=jnp.int32)

    groups = [None] * n_planes
    for i in range(n_planes):
        for j in range(n_planes - i):
            p = idot(ap[i], bp[j])
            w = i + j
            groups[w] = p if groups[w] is None else groups[w] + p

    scale = sa * sb
    acc = None
    for w in range(n_planes - 1, -1, -1):
        term = groups[w].astype(jnp.float32) * np.float32(
            2.0 ** (-_PLANE_BITS * (w + 2)))
        z = jnp.zeros_like(term)
        acc = TF(term, z, z) if acc is None else add(acc, TF(term, z, z))
    return mul_pow2(acc, scale)


_matmul_jit = jax.jit(_matmul_impl, static_argnames="n_planes")
