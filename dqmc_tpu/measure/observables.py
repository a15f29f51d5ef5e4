"""Observable kernels: Wick-contracted functions of the Green's functions.

Capability mirror of the reference's ``Observables`` namespace
(source/model.cpp:165-392), re-expressed as vectorized array contractions
instead of element loops.  Conventions:

- Equal-time observables take ``G00`` of shape (nfl, ns, ns); the up/down
  species are ``G00[0]`` / ``G00[-1]`` — identical for the spin-symmetric
  attractive model (nfl=1), and ready for a 2-flavor repulsive model.
- Unequal-time observables are *per-tau* kernels
  ``fn(Gtt, Gt0, G0t, G00, ctx) -> (ns, ns)``; the engine maps them over
  the tau scan (engine/uneqtime.py) so the full (nt+1, ns, ns) cubes never
  materialize unless explicitly requested.

Where the reference's arithmetic deviates from the textbook Wick
expression, we reproduce the reference (bit-compatible output contract)
and note the deviation.
"""

from __future__ import annotations

import jax.numpy as jnp

from dqmc_tpu.measure.context import MeasurementContext


def _updn(G):
    return G[0], G[-1]


# ----------------------------------------------------------------------
# scalar observables (model.cpp:167-256)
# ----------------------------------------------------------------------

def density(G00, ctx: MeasurementContext):
    """<n> = (1/N) sum_i <n_iu + n_id>, <n_is> = 1 - G_s(i,i)."""
    Gup, Gdn = _updn(G00)
    ns = ctx.n_sites
    return (2.0 * ns - jnp.trace(Gup) - jnp.trace(Gdn)) / ns


def double_occupancy(G00, ctx: MeasurementContext):
    """<D> = (1/N) sum_i <n_iu n_id> = (1/N) sum_i (1-Gu_ii)(1-Gd_ii)."""
    Gup, Gdn = _updn(G00)
    return jnp.mean((1.0 - jnp.diag(Gup)) * (1.0 - jnp.diag(Gdn)))


def swave_pairing(G00, ctx: MeasurementContext):
    """q=0 s-wave pair structure factor (model.cpp:223-256):
    (1/N) sum_ij (delta_ji - Gu(j,i)) (delta_ji - Gd(j,i))."""
    Gup, Gdn = _updn(G00)
    eye = jnp.eye(ctx.n_sites, dtype=G00.dtype)
    return jnp.sum((eye - Gup) * (eye - Gdn)) / ctx.n_sites


# ----------------------------------------------------------------------
# equal-time site-pair observables (model.cpp:258-288)
# ----------------------------------------------------------------------

def density_corr(G00, ctx: MeasurementContext):
    """Connected density-density correlation matrix (model.cpp:258-288).

    ninj_conn(i,j) = n_i n_j + exch(i,j) - n_avg^2 with
    exch(i,j) = sum_s (1 - G_s(j,i)) G_s(i,j).  NOTE: the reference uses
    (1 - G(j,i)) rather than (delta_ji - G(j,i)) in the exchange term
    (model.cpp:281); reproduced verbatim for output parity.
    """
    Gup, Gdn = _updn(G00)
    n_i = (1.0 - jnp.diag(Gup)) + (1.0 - jnp.diag(Gdn))
    n_avg = jnp.mean(n_i)
    exch = (1.0 - Gup.T) * Gup + (1.0 - Gdn.T) * Gdn
    return n_i[:, None] * n_i[None, :] + exch - n_avg ** 2


def spin_zz_corr(G00, ctx: MeasurementContext):
    """<S^z_i S^z_j> with S^z = (n_up - n_dn)/2 (beyond-reference; the
    natural magnetic probe for the 2-flavor repulsive model).

    Wick (per spin species s): <n_is n_js> = n_i n_j + X_s(i,j) with
    X_s(i,j) = (delta_ij - G_s(j,i)) G_s(i,j); cross-species terms
    factorize, so
        <Sz_i Sz_j> = 1/4 [ m_i m_j + X_up(i,j) + X_dn(i,j) ],
    m_i = <n_iu> - <n_id>.  The textbook delta_ij (NOT the reference's
    1-G quirk, cf. density_corr) — this observable has no reference
    counterpart to stay bit-compatible with.
    """
    Gup, Gdn = _updn(G00)
    eye = jnp.eye(ctx.n_sites, dtype=G00.dtype)
    m = jnp.diag(Gdn) - jnp.diag(Gup)        # <n_u> - <n_d> = Gd_ii - Gu_ii
    X = (eye - Gup.T) * Gup + (eye - Gdn.T) * Gdn
    return 0.25 * (m[:, None] * m[None, :] + X)


def spin_xx_corr(G00, ctx: MeasurementContext):
    """<S^x_i S^x_j> = 1/4 [<S+_i S-_j> + <S-_i S+_j>] (beyond-reference).

    <S+_i S-_j> = <c+_iu c_ju><c_id c+_jd> = (delta_ij - Gu(j,i)) Gd(i,j)
    and the spin-flipped mirror.  For a spin-symmetric G this equals
    spin_zz_corr exactly (SU(2)); pinned in tests/test_measure.py.
    """
    Gup, Gdn = _updn(G00)
    eye = jnp.eye(ctx.n_sites, dtype=G00.dtype)
    return 0.25 * ((eye - Gup.T) * Gdn + (eye - Gdn.T) * Gup)


# ----------------------------------------------------------------------
# unequal-time per-tau observables (model.cpp:290-392)
# ----------------------------------------------------------------------

def green_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """G_u(tau,0) + G_d(tau,0) (model.cpp:290-314)."""
    return Gt0[0] + Gt0[-1]


def doublon_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """Pair propagator Gt0_u(i,j) * Gt0_d(i,j) (model.cpp:316-344)."""
    return Gt0[0] * Gt0[-1]


def spinzz_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """Time-displaced spin correlation <S^z_i(tau) S^z_j(0)> — the input
    to the dynamic spin structure factor / magnetic susceptibility
    (beyond-reference; registered with [simulation] measure_spin).

    Wick with independent flavors: <n_is(tau) n_js(0)> = n_is(tau) n_js(0)
    - G0t_s(j,i) Gt0_s(i,j) (cross contraction, same pattern as the
    currxx terms, model.cpp:346-392); cross-flavor terms factorize, so
        <Sz_i(tau) Sz_j> = 1/4 [ m_i(tau) m_j(0)
                                 - sum_s G0t_s(j,i) Gt0_s(i,j) ],
    m_i(tau) = Gtt_dn(i,i) - Gtt_up(i,i).  At tau = 0 (Gtt = G00 = G,
    Gt0 = G, G0t = G - I) this reduces exactly to spin_zz_corr (pinned in
    tests/test_measure.py).
    """
    m_tau = jnp.diagonal(Gtt[-1]) - jnp.diagonal(Gtt[0])   # (ns,)
    m_0 = jnp.diagonal(G00[-1]) - jnp.diagonal(G00[0])
    X = G0t[0].T * Gt0[0] + G0t[-1].T * Gt0[-1]
    return 0.25 * (m_tau[:, None] * m_0[None, :] - X)


def spinxx_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """Time-displaced transverse spin correlation <S^x_i(tau) S^x_j(0)>
    = 1/4 [<S+_i(tau) S-_j> + <S-_i(tau) S+_j>] (beyond-reference;
    [simulation] measure_spin).

    Cross-flavor Wick: <c+_iu(tau) c_ju> <c_id(tau) c+_jd>
    = (-G0t_u(j,i)) Gt0_d(i,j), so
        spinxx(tau; i,j) = -1/4 [ G0t_u(j,i) Gt0_d(i,j)
                                  + G0t_d(j,i) Gt0_u(i,j) ].
    At tau = 0 this reduces exactly to spin_xx_corr (pinned in tests).
    """
    return -0.25 * (G0t[0].T * Gt0[-1] + G0t[-1].T * Gt0[0])


def density_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """Time-displaced connected density correlation
    <n_i(tau) n_j(0)> - navg(tau) navg(0) — the input to the dynamic
    charge structure factor (beyond-reference; [simulation]
    measure_charge).

    Same Wick pattern as spinzz_tau with the cross contraction entering
    per flavor: <n_is(tau) n_js(0)> = n_is(tau) n_js(0)
    - G0t_s(j,i) Gt0_s(i,j); cross-flavor terms factorize.  Uses the
    textbook cross contraction (NOT the reference's equal-time 1-G quirk,
    cf. density_corr — this observable has no reference counterpart), so
    its tau = 0 limit equals the textbook form of densityCorr.
    """
    n_tau = ((1.0 - jnp.diagonal(Gtt[0]))
             + (1.0 - jnp.diagonal(Gtt[-1])))            # (ns,)
    n_0 = (1.0 - jnp.diagonal(G00[0])) + (1.0 - jnp.diagonal(G00[-1]))
    X = G0t[0].T * Gt0[0] + G0t[-1].T * Gt0[-1]
    return (n_tau[:, None] * n_0[None, :] - X
            - jnp.mean(n_tau) * jnp.mean(n_0))


def currxx_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """x-current correlator <j_x(i,tau) j_x(j,0)> (model.cpp:346-392),
    input to the superfluid stiffness.

    All eight element-gather patterns of the reference's quadruple loop are
    expressed through the +x neighbor map as a one-hot permutation matmul
    P[i, j] = delta(j == nbr(i)): row gathers G[nbr] = P @ G, column
    gathers G[:, nbr] = G @ P^T, diagonal picks as masked row sums; only
    two real transposes per spin remain (G0t^T and (P G0t)^T, each reused
    twice).
    """
    nbr = ctx.nbr_x
    ns = ctx.n_sites
    dt = Gtt.dtype
    if dt == jnp.float64:
        # f64 path: P is a PERMUTATION, so every P-product is an exact
        # row/column gather — memory ops instead of f64 matmuls.  The f32
        # engine path below keeps the matmul forms.
        idx = jnp.arange(ns)

        def one_spin(Gtt_s, Gt0_s, G0t_s, G00_s):
            PGt0 = Gt0_s[nbr, :]
            PG0t_T = G0t_s[nbr, :].T
            G0t_T = G0t_s.T
            dc1_i = Gtt_s[nbr, idx]                  # Gtt(ix, i)
            dc2_i = Gtt_s[idx, nbr]                  # Gtt(i, ix)
            dc1_j = G00_s[nbr, idx]                  # G00(jx, j)
            dc2_j = G00_s[idx, nbr]                  # G00(j, jx)
            c1 = PG0t_T * PGt0                       # G0t(jx,i) Gt0(ix,j)
            c2 = G0t_T * PGt0[:, nbr]                # G0t(j,i)  Gt0(ix,jx)
            c3 = PG0t_T[nbr, :] * Gt0_s              # G0t(jx,ix) Gt0(i,j)
            c4 = G0t_T[nbr, :] * Gt0_s[:, nbr]       # G0t(j,ix) Gt0(i,jx)
            return dc1_i, dc2_i, dc1_j, dc2_j, c1, c2, c3, c4
    else:
        P = (jnp.arange(ns)[None, :] == nbr[:, None]).astype(dt)
        PT = P.T
        eye = jnp.eye(ns, dtype=dt)

        def one_spin(Gtt_s, Gt0_s, G0t_s, G00_s):
            PGt0 = P @ Gt0_s
            PG0t_T = (P @ G0t_s).T
            G0t_T = G0t_s.T
            dc1_i = jnp.sum((P @ Gtt_s) * eye, axis=1)   # Gtt(ix, i)
            dc2_i = jnp.sum(Gtt_s * P, axis=1)           # Gtt(i, ix)
            dc1_j = jnp.sum((P @ G00_s) * eye, axis=1)   # G00(jx, j)
            dc2_j = jnp.sum(G00_s * P, axis=1)           # G00(j, jx)
            c1 = PG0t_T * PGt0                           # G0t(jx,i) Gt0(ix,j)
            c2 = G0t_T * (PGt0 @ PT)                     # G0t(j,i)  Gt0(ix,jx)
            c3 = (P @ PG0t_T) * Gt0_s                    # G0t(jx,ix) Gt0(i,j)
            c4 = (P @ G0t_T) * (Gt0_s @ PT)              # G0t(j,ix) Gt0(i,jx)
            return dc1_i, dc2_i, dc1_j, dc2_j, c1, c2, c3, c4

    up = one_spin(Gtt[0], Gt0[0], G0t[0], G00[0])
    dn = one_spin(Gtt[-1], Gt0[-1], G0t[-1], G00[-1])
    dc1_i, dc2_i, dc1_j, dc2_j, c1, c2, c3, c4 = (
        u + d for u, d in zip(up, dn))

    term1 = dc1_i[:, None] * dc1_j[None, :] - c1
    term2 = dc1_i[:, None] * dc2_j[None, :] - c2
    term3 = dc2_i[:, None] * dc1_j[None, :] - c3
    term4 = dc2_i[:, None] * dc2_j[None, :] - c4
    return -(term1 - term2 - term3 + term4)


# registries used by the driver (main.cpp:116-122)
SCALAR_OBSERVABLES = {
    "density": density,
    "doubleOcc": double_occupancy,
    "swave": swave_pairing,
}

EQUAL_TIME_OBSERVABLES = {
    "densityCorr": density_corr,
}

# opt-in magnetic set ([simulation] measure_spin = true): beyond-reference,
# so not in the default registry — default runs keep reference-identical
# output files
SPIN_OBSERVABLES = {
    "spinZZCorr": spin_zz_corr,
    "spinXXCorr": spin_xx_corr,
}

# tau-resolved half of the opt-in magnetic set (registered only when
# unequal-time measurement is on, like every unequal-time observable)
SPIN_UNEQUAL_TIME_OBSERVABLES = {
    "spinzzTau": spinzz_tau,
    "spinxxTau": spinxx_tau,
}

# opt-in dynamic charge set ([simulation] measure_charge = true)
CHARGE_UNEQUAL_TIME_OBSERVABLES = {
    "densityTau": density_tau,
}

UNEQUAL_TIME_OBSERVABLES = {
    "greenTau": green_tau,
    "doublonTau": doublon_tau,
    "currxxTau": currxx_tau,
}
