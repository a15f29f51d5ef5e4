"""tf32 (triple-float32) arithmetic vs an mpmath oracle.

tf32 carries ~72 significand bits — beyond longdouble's 64 — so the
oracle is 60-digit mpmath evaluated on the EXACT component sums.
Target: elementwise ops <= ~2^-62 relative (sloppy triple-word bounds),
matmul <= ~2^-65 relative of the row/column magnitude product.  The
chain requirement this tier exists for is only ~2^-51 (ops/tf32.py doc).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mpmath  # noqa: E402

from dqmc_tpu.ops import df32, tf32  # noqa: E402

mp = mpmath.mp
mp.dps = 60

EPS_TF = 2.0 ** -62


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _rand_tf(rng, shape, scale_pow=0.0):
    """Random tf values with full ~72-bit significands."""
    hi = (rng.standard_normal(shape) * 2.0 ** scale_pow).astype(np.float32)
    mi = (rng.standard_normal(shape)
          * np.spacing(np.abs(hi)) * 0.4).astype(np.float32)
    lo = (rng.standard_normal(shape)
          * np.spacing(np.abs(mi)) * 0.4).astype(np.float32)
    return tf32.TF(jnp.asarray(hi), jnp.asarray(mi), jnp.asarray(lo))


def _mpf(x: tf32.TF):
    h = np.asarray(x.hi, np.float64).ravel()
    m = np.asarray(x.mi, np.float64).ravel()
    l = np.asarray(x.lo, np.float64).ravel()
    return [mp.mpf(a) + mp.mpf(b) + mp.mpf(c) for a, b, c in zip(h, m, l)]


def _rel_err(got: tf32.TF, want_mp):
    g = _mpf(got)
    errs = []
    for gv, wv in zip(g, want_mp):
        denom = max(abs(wv), mp.mpf("1e-30"))
        errs.append(abs(gv - wv) / denom)
    return float(max(errs))


def test_from_to_f64_roundtrip(rng):
    jax.config.update("jax_enable_x64", True)
    x = jnp.asarray(rng.standard_normal(100) * 1e3, jnp.float64)
    t = tf32.from_f64(x)
    # exact: f64's 53 bits fit in three f32 components
    np.testing.assert_array_equal(np.asarray(tf32.to_f64(t)), np.asarray(x))


def test_df_roundtrip(rng):
    d = df32.DF(jnp.asarray(rng.standard_normal(64), jnp.float32),
                jnp.asarray(rng.standard_normal(64) * 1e-8, jnp.float32))
    t = tf32.from_df(d)
    back = tf32.to_df(t)
    ld = np.longdouble
    v0 = np.asarray(d.hi, ld) + np.asarray(d.lo, ld)
    v1 = np.asarray(back.hi, ld) + np.asarray(back.lo, ld)
    assert np.abs(v1 - v0).max() <= 2.0 ** -46 * np.abs(v0).max()


@pytest.mark.parametrize("op,mpop,bound", [
    ("add", lambda a, b: a + b, EPS_TF),
    ("sub", lambda a, b: a - b, EPS_TF),
    ("mul", lambda a, b: a * b, EPS_TF),
    ("div", lambda a, b: a / b, EPS_TF),
])
def test_elementwise_accuracy(rng, op, mpop, bound):
    x = _rand_tf(rng, (256,))
    y = _rand_tf(rng, (256,))
    if op == "div":
        y = tf32.TF(jnp.where(jnp.abs(y.hi) < 0.1, y.hi + 1.0, y.hi),
                    y.mi, y.lo)
    got = getattr(tf32, op)(x, y)
    want = [mpop(a, b) for a, b in zip(_mpf(x), _mpf(y))]
    assert _rel_err(got, want) < bound


def test_add_cancellation(rng):
    """x + (-x + tiny) keeps the tiny part to tf grade (the _renorm
    two_sum-not-quick_two_sum case)."""
    x = _rand_tf(rng, (128,))
    tiny = tf32.mul_pow2(_rand_tf(rng, (128,)), np.float32(2.0 ** -20))
    y = tf32.add(tf32.neg(x), tiny)
    got = tf32.add(x, y)
    want = _mpf(tiny)
    # relative to the SURVIVING value
    assert _rel_err(got, want) < 2.0 ** -40


def test_sqrt(rng):
    x = _rand_tf(rng, (256,))
    x = tf32.mul(x, x)  # positive
    got = tf32.sqrt(x)
    want = [mp.sqrt(v) for v in _mpf(x)]
    assert _rel_err(got, want) < EPS_TF
    z = tf32.sqrt(tf32.zeros((4,)))
    assert np.all(np.asarray(z.hi) == 0)


def test_mul_f32_and_pow2(rng):
    x = _rand_tf(rng, (128,))
    c = jnp.asarray(rng.standard_normal(128), jnp.float32)
    got = tf32.mul_f32(x, c)
    want = [a * mp.mpf(float(b)) for a, b in zip(_mpf(x), np.asarray(c))]
    assert _rel_err(got, want) < EPS_TF
    got2 = tf32.mul_pow2(x, np.float32(0.25))
    want2 = [a * mp.mpf("0.25") for a in _mpf(x)]
    assert _rel_err(got2, want2) == 0.0


def test_where_abs_lt(rng):
    x = _rand_tf(rng, (64,))
    y = _rand_tf(rng, (64,))
    m = np.asarray(x.hi) > 0
    w = tf32.where(jnp.asarray(m), x, y)
    assert np.array_equal(np.asarray(w.hi), np.where(m, x.hi, y.hi))
    a = tf32.abs_(x)
    assert np.all(np.asarray(a.hi) >= 0)
    assert bool(np.all(np.asarray(tf32.lt(x, tf32.add_f32(x, 1.0)))))


def test_matmul_accuracy(rng):
    n = 96
    a = _rand_tf(rng, (n, n))
    b = _rand_tf(rng, (n, n))
    got = tf32.matmul(a, b)
    # mpmath oracle on a few sampled entries (full n^2 would be slow)
    A = [_mpf(tf32.TF(a.hi[i], a.mi[i], a.lo[i])) for i in range(n)]
    Bc = [_mpf(tf32.TF(b.hi[:, j], b.mi[:, j], b.lo[:, j]))
          for j in range(n)]
    idx = [(0, 0), (1, 5), (n - 1, n - 1), (3, n - 2), (n // 2, 1)]
    gh = np.asarray(got.hi, np.float64)
    gm = np.asarray(got.mi, np.float64)
    gl = np.asarray(got.lo, np.float64)
    for i, j in idx:
        want = mp.fsum([x * y for x, y in zip(A[i], Bc[j])])
        g = mp.mpf(gh[i, j]) + mp.mpf(gm[i, j]) + mp.mpf(gl[i, j])
        assert abs(g - want) < 2.0 ** -64 * n  # vs O(1) row/col scales


def test_matmul_graded_columns(rng):
    """Columns graded over e^±12 (the fold regime): per-column relative
    accuracy must hold, not just accuracy vs the largest column."""
    n = 64
    a = _rand_tf(rng, (n, n))
    g = np.exp(np.linspace(-12, 12, n))
    b = tf32.cmap(lambda c: c * jnp.asarray(g, jnp.float32)[None, :],
                  _rand_tf(rng, (n, n)))
    got = tf32.matmul(a, b)
    want = np.asarray(tf32.to_f64(a)) @ np.asarray(tf32.to_f64(b))
    err = np.abs(np.asarray(tf32.to_f64(got)) - want).max(axis=0)
    colmag = np.abs(want).max(axis=0)
    # f64 oracle floors this comparison at ~2^-50 n-ish
    assert (err / colmag).max() < 2.0 ** -48


def test_matmul_batched(rng):
    a = _rand_tf(rng, (3, 32, 32))
    b = _rand_tf(rng, (3, 32, 32))
    got = tf32.matmul(a, b)
    assert got.hi.shape == (3, 32, 32)
    want = np.einsum("bij,bjk->bik", np.asarray(tf32.to_f64(a)),
                     np.asarray(tf32.to_f64(b)))
    assert np.abs(np.asarray(tf32.to_f64(got)) - want).max() < 2.0 ** -45


def test_jit_consistency(rng):
    """tf ops produce identical triples under jit.

    On CPU the known XLA:CPU reassociation hazard applies to FUSED df
    chains; a single op is small enough to stay intact — this is a
    smoke check that the EFT ops survive jit at all."""
    x = _rand_tf(rng, (64,))
    y = _rand_tf(rng, (64,))
    eager = tf32.mul(x, y)
    jitted = jax.jit(tf32.mul)(x, y)
    np.testing.assert_allclose(np.asarray(tf32.to_f64(eager)),
                               np.asarray(tf32.to_f64(jitted)),
                               rtol=2.0 ** -44)
