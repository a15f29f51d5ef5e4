"""Low-precision (f32) regression tests for the transpose-suffix LDR chain.

The GPU default samples in f32; the engine's f32 viability rests on (a) every QR
input being column-graded, (b) overflow-proof log-domain d handling in
to_ldr, and (c) LU-free well-scaled stabilized inverses.  These tests pin
the achieved accuracy so regressions in the orientation/scaling logic show
up immediately.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dqmc_tpu.engine import EngineConfig, init_state, sweep_pair
from dqmc_tpu.engine.sweep import rebuild_stack_and_greens
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard


def _g_pair(beta, nt, n_stab, seed=0, L=8):
    lat = square_lattice(L, L)
    rng = np.random.default_rng(seed)
    fields = jnp.asarray(rng.integers(0, 4, (nt, lat.n_sites)),
                         dtype=jnp.int32)
    out = {}
    for dt in (jnp.float64, jnp.float32):
        m = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=beta,
                                    nt=nt, dtype=dt)
        cfg = EngineConfig(nt=nt, n_stab=n_stab)
        _, g, ld = rebuild_stack_and_greens(m, cfg, fields)
        out[dt] = (np.asarray(g[0], np.float64), float(ld[0]))
    return out


@pytest.mark.parametrize("beta,nt,n_stab,tol", [
    (4.0, 40, 5, 5e-3),
    (8.0, 80, 5, 5e-2),
    (8.0, 80, 2, 1e-2),
])
def test_f32_rebuild_accuracy(beta, nt, n_stab, tol):
    out = _g_pair(beta, nt, n_stab)
    g64, _ = out[jnp.float64]
    g32, _ = out[jnp.float32]
    assert np.isfinite(g32).all()
    assert np.abs(g32 - g64).max() < tol


def test_f32_no_overflow_extreme_beta():
    """At beta=24 (d-range ~ e^{108}, far beyond f32) the chain must stay
    finite — the log-domain clamp guarantees no inf/NaN even where accuracy
    is no longer meaningful."""
    out = _g_pair(24.0, 240, 5)
    g32, ld32 = out[jnp.float32]
    assert np.isfinite(g32).all()
    assert np.isfinite(ld32)


def test_f32_sweep_self_check():
    """Full f32 Monte-Carlo sweeps at beta=8 keep the naive-vs-stabilized
    deviation bounded (the run-time health signal)."""
    lat = square_lattice(8, 8)
    m = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=8.0, nt=80,
                                dtype=jnp.float32)
    cfg = EngineConfig(nt=80, n_stab=2)
    state = init_state(m, cfg, jax.random.PRNGKey(0))
    for _ in range(3):
        state = sweep_pair(m, cfg, state)
    assert np.isfinite(np.asarray(state.G)).all()
    assert float(state.err_max) < 0.2
    assert 0.05 < float(state.acc_sum) / 6.0 < 0.95
