"""Double-float32 ("df32") arithmetic: ~49-bit-significand numerics from
pairs of f32 values.

Why: near-f64 precision (2^-49 vs 2^-52) from f32 and int8 operations
only.  The tier was built for hardware without f64 units; the GPU has
native f64, so whether it stays is decided per benchmark cell against the
f64 engine (ROADMAP C3).

- elementwise: error-free transformations (Knuth two_sum, Dekker/
  Veltkamp two_prod without FMA) at ~6-15 f32 ops per df op, all
  fusable by XLA.  They are exact only if the compiler neither contracts
  a*b+c into an FMA nor reassociates — chip_smoke.py checks the jitted
  chain against f64 on the card;
- matmul: integer Ozaki scheme — operands are split into 7-bit signed
  digit planes with per-row/column power-of-two scales, digit products
  run as int8 x int8 -> int32 dots whose accumulation is EXACT
  (f32-accumulated schemes are capped at ~2^-24 by accumulator rounding
  no matter how the products are split), and the weight-graded partial
  sums recombine in df32.  28 int8 passes per matmul.

Used by the parity-grade engine mode; validated against numpy longdouble
in tests/test_df32.py.

Representation: DF(hi, lo) with hi = f32 nearest value, |lo| <= ulp(hi)/2
(a non-overlapping normalized pair).  All functions are shape-polymorphic
and jit/vmap-safe (no data-dependent control flow).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu import platform


class DF(NamedTuple):
    """Non-overlapping f32 pair: value = hi + lo exactly."""
    hi: jax.Array
    lo: jax.Array

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape


def cmap(f, *xs) -> DF:
    """Apply a structural (value-preserving) array op to each component.

    Part of the numerics-module protocol shared with ops/tf32.py: code
    generic over the component count (ops/df_linalg.py, ops/df_qr.py)
    uses cmap for transposes/slices/broadcasts instead of constructing
    DF(...) from named fields."""
    return DF(*(f(*parts) for parts in zip(*xs)))


def zeros(shape, dtype=jnp.float32) -> DF:
    z = jnp.zeros(shape, dtype)
    return DF(z, z)


# ----------------------------------------------------------------------
# error-free transformations (all plain f32 ops; no FMA)
# ----------------------------------------------------------------------

def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a+b) (Knuth, 6 ops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """two_sum under the precondition |a| >= |b| (3 ops)."""
    s = a + b
    e = b - (s - a)
    return s, e


_SPLITTER = np.float32(4097.0)        # 2^12 + 1 for f32's 24-bit mantissa


def veltkamp_split(a):
    """a == hi + lo with hi, lo carrying <= 12 significant bits each."""
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a*b) (Dekker, ~17 ops)."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ----------------------------------------------------------------------
# df32 arithmetic
# ----------------------------------------------------------------------

def df(hi, lo=None) -> DF:
    hi = jnp.asarray(hi, jnp.float32)
    return DF(hi, jnp.zeros_like(hi) if lo is None else
              jnp.asarray(lo, jnp.float32))


def from_f64(x) -> DF:
    """Exact f64 -> df32 conversion (up to df32's 49-bit significand)."""
    x = jnp.asarray(x)
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return DF(hi, lo)


def to_f64(x: DF):
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


def add(x: DF, y: DF) -> DF:
    """Accurate df + df (Dekker add2, ~20 ops; error O(2^-98))."""
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return DF(*quick_two_sum(s, e))


def add_f32(x: DF, c) -> DF:
    s, e = two_sum(x.hi, c)
    e = e + x.lo
    return DF(*quick_two_sum(s, e))


def neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def mul(x: DF, y: DF) -> DF:
    """df * df (~25 ops)."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DF(*quick_two_sum(p, e))


def mul_f32(x: DF, c) -> DF:
    """df * plain-f32 (~20 ops)."""
    p, e = two_prod(x.hi, c)
    e = e + x.lo * c
    return DF(*quick_two_sum(p, e))


def mul_pow2(x: DF, c) -> DF:
    """df * power-of-two (exact, 2 ops)."""
    return DF(x.hi * c, x.lo * c)


def div(x: DF, y: DF) -> DF:
    """df / df via one Newton-corrected long division (~60 ops)."""
    q1 = x.hi / y.hi
    r = sub(x, mul_f32(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_f32(y, q2))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    return add_f32(DF(s, e), q3)


def sqrt(x: DF) -> DF:
    """sqrt(df) via one Newton step off the f32 root (~50 ops)."""
    q1 = jnp.sqrt(x.hi)
    # r = x - q1^2, in df
    p, e = two_prod(q1, q1)
    r = sub(x, DF(p, e))
    safe = jnp.where(q1 == 0, jnp.float32(1), q1)
    q2 = r.hi / (2.0 * safe)
    out = DF(*quick_two_sum(q1, q2))
    return DF(jnp.where(q1 == 0, jnp.float32(0), out.hi),
              jnp.where(q1 == 0, jnp.float32(0), out.lo))


def abs_(x: DF) -> DF:
    neg_mask = x.hi < 0
    return DF(jnp.where(neg_mask, -x.hi, x.hi),
              jnp.where(neg_mask, -x.lo, x.lo))


def lt(x: DF, y: DF):
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo < y.lo))


def where(mask, x: DF, y: DF) -> DF:
    return DF(jnp.where(mask, x.hi, y.hi), jnp.where(mask, x.lo, y.lo))


# ----------------------------------------------------------------------
# df32 matmul: integer Ozaki digit-plane scheme
# ----------------------------------------------------------------------
#
# Each operand row (lhs) / column (rhs) is scaled by a power of two into
# [-0.5, 0.5), then split into N_PLANES signed 7-bit digit planes:
#   v / s == sum_i  q_i * 2^(-7(i+1)),   q_i integer in [-64, 64]
# (the extraction runs in exact df arithmetic; residuals cancel exactly
# because every subtracted term is a representable multiple of a power of
# two below the remaining residual's magnitude).
#
# Digit products q^a_i * q^b_j are <= 2^12, so a k-term int32 accumulation
# is exact for k <= 2^18 — far beyond any lattice here.  Partial products
# with equal weight w = i+j are summed in int32 (exact), converted to f32
# (exact below 2^24), rescaled by the outer product of the row/column
# scales (powers of two — exact), and df-accumulated high weight first.
#
# Terms kept: w <= N_PLANES - 1 (relative error ~2^(-7*N_PLANES) = 2^-49
# for the default 7 planes).  28 int8 matmuls replace the 6 bf16 passes
# of one f32-HIGHEST matmul.

N_PLANES = 7
_PLANE_BITS = 7


def _digit_planes(v: DF, axis: int, n_planes: int):
    """(planes int8 [n_planes, ...], scale f32 broadcastable) for v."""
    mag = jnp.max(jnp.abs(v.hi), axis=axis, keepdims=True)
    mag = jnp.where(mag == 0, jnp.float32(1), mag)
    # EXACT power-of-two scale with v/s in (-0.5, 0.5): via frexp/ldexp —
    # jnp.exp2(ceil(log2(x))) is a polynomial approximation in f32 and
    # returns near-powers like 32767.98, silently breaking the exact
    # divisions the digit extraction depends on (measured 2^-26 extraction
    # error on e^±25-graded columns)
    _, e = jnp.frexp(mag)                            # mag = m * 2^e, m in [0.5, 1)
    s = jnp.ldexp(jnp.float32(1.0), e + 1).astype(jnp.float32)
    r = DF(v.hi / s, v.lo / s)                       # exact
    planes = []
    for i in range(n_planes):
        w = np.float32(2.0 ** (_PLANE_BITS * (i + 1)))
        q = jnp.rint(r.hi * w)
        planes.append(q.astype(jnp.int8))
        r = sub(r, DF(q / w, jnp.zeros_like(q)))     # exact cancellation
    return jnp.stack(planes), s


def matmul(a: DF, b: DF, n_planes: int = N_PLANES) -> DF:
    """df32 (..., m, k) @ (..., k, n) -> (..., m, n) with ~2^-49 relative
    error w.r.t. exact row/column magnitudes.

    Batched over leading dims.  k <= 2^18 for exact int32 accumulation.

    On accelerators this routes through an inner ``jax.jit``: the ~100-op
    digit-plane graph then traces ONCE per operand signature instead of
    being re-traced at every call site (the df engine builds thousands of
    these; inner-jit jaxpr reuse cuts its multi-minute trace time ~2x).
    On CPU it stays inline — an inner jit would form its own fused XLA:CPU
    unit and hit the LLVM reassociation bug outside the tests' opt-0 flag
    (module docstring of ops/df_linalg.py).
    """
    if platform.jit_multiword():
        return _matmul_jit(a, b, n_planes)
    return _matmul_impl(a, b, n_planes)


def _matmul_impl(a: DF, b: DF, n_planes: int = N_PLANES) -> DF:
    ap, sa = _digit_planes(a, axis=-1, n_planes=n_planes)   # scales per row
    bp, sb = _digit_planes(b, axis=-2, n_planes=n_planes)   # per column
    nbatch = a.hi.ndim - 2
    batch_axes = tuple(range(nbatch))
    dn = (((nbatch + 1,), (nbatch,)), (batch_axes, batch_axes))

    def idot(x, y):
        return jax.lax.dot_general(x, y, dn,
                                   preferred_element_type=jnp.int32)

    # exact int32 partial sums grouped by weight w = i + j
    groups = [None] * n_planes
    for i in range(n_planes):
        for j in range(n_planes - i):
            p = idot(ap[i], bp[j])
            w = i + j
            groups[w] = p if groups[w] is None else groups[w] + p

    scale = sa * sb                                   # outer, power of two
    # low weights last so the df accumulator sees decreasing corrections
    acc = None
    for w in range(n_planes - 1, -1, -1):
        term = groups[w].astype(jnp.float32) * np.float32(
            2.0 ** (-_PLANE_BITS * (w + 2)))
        acc = (DF(term, jnp.zeros_like(term)) if acc is None
               else add(acc, DF(term, jnp.zeros_like(term))))
    return DF(acc.hi * scale, acc.lo * scale)


_matmul_jit = jax.jit(_matmul_impl, static_argnames="n_planes")


def matmul_f64_oracle(a: DF, b: DF):
    """f64 reference product of the same pair operands (for tests)."""
    return jnp.matmul(to_f64(a), to_f64(b))
