"""Attractive Hubbard model on a periodic lattice.

    H = -t sum_<ij> c_i^dag c_j - mu sum_i n_i
        - U sum_i (n_{iu} - 1/2)(n_{id} - 1/2)

Convention note: the reference README states the interaction as
-U n_u n_d, but the GHQ decoupling it (and we) implement —
exp(dtau U/2 (n-1)^2) with weights gamma and nodes eta (field.h:36-43,
model.cpp:27-28,62-72) — corresponds to the particle-hole-symmetric form
above: half filling sits at mu = 0 (the example config uses mu = -0.1 as
"near half filling", main.cpp/examples).  Validated against exact
diagonalization in tests/test_ed.py.

Capability mirror of the reference ``AttractiveHubbard`` (source/model.cpp:
3-159, include/model.h:11-58).  After the 4-state GHQ Hubbard–Stratonovich
transform, each imaginary-time propagator factorizes as

    B_l = diag(exp(g * eta(s_l))) @ expm(-dtau * K)

with coupling g = sqrt(dtau*|U|/2) (model.cpp:27).  The attractive model is
spin-symmetric: both spin species see the same B, so only one flavor is
stored (``n_flavor = 1``) and its determinant ratio enters squared
(``det_power = 2``, model.cpp:90-97).

The model object is a frozen dataclass pytree: array leaves (expK and
friends, g, eta/gamma tables, beta) vmap over a replica axis for parallel
tempering — each replica's beta yields different dtau, hence different expK
and g — while the static shape metadata (n_sites, nt, flavor structure)
stays compile-time constant.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

from dqmc_tpu import hsfield
from dqmc_tpu.config import Parameters
from dqmc_tpu.lattice import Lattice

def _static():
    return dataclasses.field(metadata=dict(static=True))


def build_kinetic_matrix(lat: Lattice, t: float, mu: float,
                         bonds=None) -> np.ndarray:
    """Hopping + chemical-potential matrix K (model.cpp:39-60), generalized
    to any bond set.

    K[i,i] = -mu; K[i,j] = K[j,i] = -amp for every bond: site
    (cell, orb_a) -> (cell+delta, orb_b) with PBC.  Bond entries are
    (delta, orb_a, orb_b) with amplitude ``t``, or (delta, orb_a, orb_b,
    amp) with an explicit amplitude (e.g. next-nearest-neighbour t').
    Default bonds are the square lattice's +x/+y (the reference's
    hardcoded case); pass `dqmc_tpu.lattice.nn_bonds(geometry)` for
    triangular/honeycomb.  Assignment (not accumulation) semantics match
    the reference, which writes K(i,j) = -t — relevant only for L=2 where
    +x and -x bonds coincide.
    """
    if bonds is None:
        bonds = [((1, 0), 0, 0), ((0, 1), 0, 0)]
    ns = lat.n_sites
    K = np.zeros((ns, ns))
    np.fill_diagonal(K, -mu)
    for bond in bonds:
        delta, orb_a, orb_b = bond[:3]
        amp = bond[3] if len(bond) > 3 else t
        for cell in range(lat.n_cells):
            i = lat.cell_to_site(cell, orb_a)
            j = lat.site_neighbor(i, delta, orb_b)
            K[i, j] = -amp
            K[j, i] = -amp
    return K


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AttractiveHubbard:
    # --- static structure ---
    n_sites: int = _static()
    nt: int = _static()
    n_flavor: int = _static()    # stored flavors (spin-symmetric: 1)
    det_power: int = _static()   # determinant-ratio multiplicity per stored flavor

    # --- array leaves (batchable over a replica axis) ---
    expK: jax.Array              # (ns, ns) expm(-dtau K)
    invexpK: jax.Array           # (ns, ns) expm(+dtau K)
    expK_half: jax.Array         # (ns, ns) expm(-dtau K / 2)
    invexpK_half: jax.Array      # (ns, ns) expm(+dtau K / 2)
    g: jax.Array                 # () HS coupling sqrt(dtau |U| / 2)
    alpha: jax.Array             # () bosonic sign (-1 for attractive U>0)
    eta: jax.Array               # (4,) GHQ node values
    gamma: jax.Array             # (4,) GHQ weights
    beta: jax.Array              # () inverse temperature (bookkeeping / PT)

    # checkerboard kinetics (models/kinetic.py); None in dense mode
    checkerboard: bool = dataclasses.field(default=False,
                                           metadata=dict(static=True))
    cb_perm: jax.Array | None = None    # (4, ns) bond-partner permutations
    cb_mask: jax.Array | None = None    # (4, ns) group membership
    cb_ch: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    cb_sh: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    cb_emu: float = dataclasses.field(default=1.0, metadata=dict(static=True))

    # ------------------------------------------------------------------

    @classmethod
    def build(cls, lat: Lattice, *, U: float, t: float, mu: float,
              beta: float, nt: int, dtype=jnp.float64,
              checkerboard: bool = False,
              bonds=None) -> "AttractiveHubbard":
        dtau = beta / nt
        K = build_kinetic_matrix(lat, t, mu, bonds=bonds)
        # one-time dense expm in host f64 (model.cpp:31-35)
        expK = scipy.linalg.expm(-dtau * K)
        invexpK = scipy.linalg.expm(dtau * K)
        expKh = scipy.linalg.expm(-0.5 * dtau * K)
        invexpKh = scipy.linalg.expm(0.5 * dtau * K)
        g = np.sqrt(0.5 * abs(U) * dtau)
        cb = {}
        if checkerboard:
            if bonds is not None and sorted(bonds) != sorted(
                    [((1, 0), 0, 0), ((0, 1), 0, 0)]):
                raise ValueError("checkerboard kinetics supports the square "
                                 "lattice only; use dense expK for other "
                                 "geometries")
            from dqmc_tpu.models.kinetic import build_checkerboard
            perms, masks, ch, sh = build_checkerboard(lat, t, dtau)
            cb = dict(checkerboard=True,
                      cb_perm=jnp.asarray(perms),
                      cb_mask=jnp.asarray(masks, dtype),
                      cb_ch=ch, cb_sh=sh, cb_emu=float(np.exp(dtau * mu)))
        return cls(
            n_sites=lat.n_sites, nt=int(nt), n_flavor=1, det_power=2,
            expK=jnp.asarray(expK, dtype),
            invexpK=jnp.asarray(invexpK, dtype),
            expK_half=jnp.asarray(expKh, dtype),
            invexpK_half=jnp.asarray(invexpKh, dtype),
            g=jnp.asarray(g, dtype),
            alpha=jnp.asarray(-1.0, dtype),
            eta=jnp.asarray(hsfield.ETA, dtype),
            gamma=jnp.asarray(hsfield.GAMMA, dtype),
            beta=jnp.asarray(beta, dtype),
            **cb,
        )

    @classmethod
    def from_params(cls, params: Parameters, lat: Lattice, *,
                    beta: float | None = None, dtype=jnp.float64):
        from dqmc_tpu.lattice import bonds_with_tp
        geometry = params.get_str("Lattice", "geometry", "square")
        bonds = bonds_with_tp(geometry,
                              params.get_float("hubbard", "tp", 0.0))
        return cls.build(
            lat,
            U=params.get_float("hubbard", "U"),
            t=params.get_float("hubbard", "t"),
            mu=params.get_float("hubbard", "mu"),
            beta=params.get_float("simulation", "beta") if beta is None else beta,
            nt=params.get_int("simulation", "nt"),
            dtype=dtype,
            checkerboard=params.get_bool("hubbard", "checkerboard", False),
            bonds=bonds,
        )

    @property
    def dtype(self):
        return self.expK.dtype

    # ------------------------------------------------------------------
    # propagator pieces
    # ------------------------------------------------------------------

    def expV_diag(self, fields_l: jax.Array) -> jax.Array:
        """diag of exp(+V): (nfl, ns) = exp(g * eta(s)) (model.cpp:62-72).

        Spin-symmetric: one stored flavor.  The 4-entry eta table lookup
        runs as a where-select chain (hsfield.select4) instead of a
        gather.
        """
        from dqmc_tpu.hsfield import select4
        return jnp.exp(self.g * select4(self.eta, fields_l))[None, :]

    def B_mats(self, fields_l: jax.Array):
        """B_l = diag(expV) @ expK and its inverse, shape (nfl, ns, ns)."""
        expV = self.expV_diag(fields_l)
        B = expV[..., :, None] * self.expK
        invB = self.invexpK * (1.0 / expV)[..., None, :]
        return B, invB

    def B_of(self, fields_l: jax.Array) -> jax.Array:
        expV = self.expV_diag(fields_l)
        return expV[..., :, None] * self.expK

    # ------------------------------------------------------------------
    # local-update math (model.cpp:90-122)
    # ------------------------------------------------------------------

    def update_factors(self, old: jax.Array, new: jax.Array):
        """(gammaR, bosonR, delta) for a proposed single-site flip.

        gammaR = gamma(new)/gamma(old); bosonR = exp(alpha*g*d_eta);
        delta  = exp(g*d_eta) - 1 (per stored flavor, (nfl,)) such that
        B' = (I + delta * e_i e_i^T) B.
        """
        d_eta = self.eta[new] - self.eta[old]
        gammaR = self.gamma[new] / self.gamma[old]
        bosonR = jnp.exp(self.alpha * self.g * d_eta)
        delta = jnp.expm1(self.g * d_eta)
        return gammaR, bosonR, delta[None]

    def det_ratio(self, G_ii: jax.Array, delta: jax.Array) -> jax.Array:
        """Fermionic determinant ratio, all flavors combined
        (model.cpp:90-97): prod_flv [1 + (1 - G_ii) delta]^det_power."""
        r_flv = 1.0 + (1.0 - G_ii) * delta
        return jnp.prod(r_flv) ** self.det_power

    # ------------------------------------------------------------------
    # global action for replica exchange (model.cpp:140-159)
    # ------------------------------------------------------------------

    def global_action(self, fields: jax.Array, log_det_M: jax.Array) -> jax.Array:
        """S = -det_power * sum_flv log|det M_flv| - sum_i (alpha*g*eta_i + log gamma_i).

        The bosonic sum runs over only 4 distinct per-site values, so it
        is computed as exact integer state-counts times per-state
        constants: the nt*ns-term gather-sum collapses to a 4-term dot
        whose only rounding is eps * |S_boson| (load-bearing for f32
        chains, where the long-sum version carried O(1e-2) absolute
        error into parallel-tempering decisions).
        """
        s_ferm = -self.det_power * jnp.sum(log_det_M)
        dtype = self.eta.dtype
        counts = jnp.stack(
            [jnp.count_nonzero(fields == v) for v in range(4)]).astype(dtype)
        log_boson = self.alpha * self.g * jnp.sum(counts * self.eta)
        log_gamma = jnp.sum(counts * jnp.log(self.gamma))
        return s_ferm - log_boson - log_gamma
