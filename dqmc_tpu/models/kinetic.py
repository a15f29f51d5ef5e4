"""Kinetic-propagator application: dense expm or checkerboard decomposition.

The engine never needs the matrix exp(-dtau K) itself — only the four
products  B@X,  X@B,  B^{-1}@X,  X@B^{-1}  with  B = diag(expV) expK.
This module provides those as functions generic over the model, dispatching
on the model's static ``checkerboard`` flag:

- dense: one GEMM with the precomputed exp(-dtau K) (O(ns^3));
- checkerboard: exp(-dtau K_hop) ~= prod_g exp(-dtau K_g) over 4 bond
  groups of the square lattice (x-even, x-odd, y-even, y-odd), each an
  exact disjoint 2-site rotation [[cosh, sinh], [sinh, cosh]](dtau t)
  applied as a masked row gather-mix — O(ns^2) per application.  The
  chemical-potential part exp(dtau mu) commutes exactly (proportional to
  the identity for a single orbital).  The reference lists this as an
  open TODO (README.md:40).

The checkerboard operator *defines* the simulated B (its inverse is the
exact reverse-order product, so stabilization is unaffected); relative to
the dense model it differs by an additional O(dtau^2) Trotter term, the
standard trade for O(ns^2) kinetics.  Where the dense GEMMs and the
masked gather-mix cross over on the GPU is not measured yet.  Keep
checkerboard for memory-bound regimes
(no dense expK storage) and as the reference-TODO parity feature
(README.md:40); default to dense for throughput.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from dqmc_tpu.lattice import Lattice


def build_checkerboard(lat: Lattice, t: float, dtau: float):
    """(perms (4, ns) int32, masks (4, ns) f64, ch, sh, emu-less) tables.

    Group g's permutation maps each site to its bond partner (itself when
    the site is not in the group).  Requires even L1/L2 (disjoint bonds).
    """
    if lat.L1 % 2 or lat.L2 % 2 or lat.n_orb != 1:
        raise ValueError("checkerboard kinetics requires even L1, L2 and a "
                         "single orbital")
    ns = lat.n_sites
    perms = []
    masks = []
    for axis, parity in (((1, 0), 0), ((1, 0), 1), ((0, 1), 0), ((0, 1), 1)):
        p = np.arange(ns, dtype=np.int32)
        m = np.zeros(ns)
        nm = lat.neighbor_map(axis, orb=0)
        for i in range(ns):
            ux, uy = lat.site_to_unitcellpos(i)
            coord = ux if axis == (1, 0) else uy
            if coord % 2 == parity:
                j = nm[i]
                p[i], p[j] = j, i
                m[i] = m[j] = 1.0
        perms.append(p)
        masks.append(m)
    ch = math.cosh(dtau * t)
    sh = math.sinh(dtau * t)
    return np.stack(perms), np.stack(masks), ch, sh


def _apply_groups(X, perms, masks, ch, sh, *, reverse: bool):
    """Apply prod_g G_g (or its transpose = reversed order; each G_g is
    symmetric) to the rows of X (..., ns, n)."""
    order = range(perms.shape[0] - 1, -1, -1) if reverse \
        else range(perms.shape[0])
    for g in order:
        p = perms[g]
        m = masks[g][:, None].astype(X.dtype)
        Xp = jnp.take(X, p, axis=-2)
        X = X + m * ((ch - 1.0) * X + sh * Xp)
    return X


def _kin_left(model, X, *, inv: bool):
    """exp(-+dtau K) @ X."""
    if not getattr(model, "checkerboard", False):
        return (model.invexpK if inv else model.expK) @ X
    ch, sh = model.cb_ch, model.cb_sh
    emu = model.cb_emu
    if inv:
        # reverse order, sinh -> -sinh, 1/emu
        return _apply_groups(X, model.cb_perm, model.cb_mask, ch, -sh,
                             reverse=True) / emu
    return emu * _apply_groups(X, model.cb_perm, model.cb_mask, ch, sh,
                               reverse=False)


def _kin_right(model, X, *, inv: bool):
    """X @ exp(-+dtau K).  Each group factor is symmetric, so right
    application = transpose-apply with reversed group order."""
    if not getattr(model, "checkerboard", False):
        return X @ (model.invexpK if inv else model.expK)
    XT = jnp.swapaxes(X, -1, -2)
    YT = _kin_left(model, XT, inv=inv)
    return jnp.swapaxes(YT, -1, -2)


# ----------------------------------------------------------------------
# the four B-products the engine consumes (B = diag(expV) expK)
# ----------------------------------------------------------------------

def apply_B_left(model, fields_l, X):
    """B @ X"""
    expV = model.expV_diag(fields_l)
    return expV[..., :, None] * _kin_left(model, X, inv=False)


def apply_B_right(model, fields_l, X):
    """X @ B"""
    expV = model.expV_diag(fields_l)
    return _kin_right(model, X * expV[..., None, :], inv=False)


def apply_invB_left(model, fields_l, X):
    """B^{-1} @ X = expK^{-1} (diag(expV)^{-1} X)"""
    expV = model.expV_diag(fields_l)
    return _kin_left(model, X / expV[..., :, None], inv=True)


def apply_invB_right(model, fields_l, X):
    """X @ B^{-1} = (X expK^{-1}) diag(expV)^{-1}"""
    expV = model.expV_diag(fields_l)
    return _kin_right(model, X, inv=True) / expV[..., None, :]
