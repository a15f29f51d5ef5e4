"""Site-pair -> displacement -> momentum transforms.

Batched re-design of the reference's transform namespace
(measurementh5.h:12-117):

- ``site_to_r``: the O(ns^2) scalar accumulation loop becomes one batched
  gather + mean over cells, using the precomputed lattice translation table.
  Output layout matches the reference exactly: (L1, L2, (a*n_orb+b)*S + s)
  with displacement index offsets dx + L/2 - 1 for even L
  (measurementh5.h:57-61).
- ``r_to_k``: the explicit O(L^4) DFT quadruple loop becomes a single dense
  complex contraction with the precomputed phase tensor — one matmul.
  The reference's k flat-index convention (measurementh5.h:98-99) is only
  self-consistent for L1 == L2; we use the row-major (kidx // L2, kidx % L2)
  mapping, identical for square lattices and correct for rectangular ones.

Both transforms are linear, so they commute with bin averaging; the
measurement manager applies them per measurement inside jit and accumulates
the reduced (L1, L2, S) arrays — O(L^2) memory per observable instead of
the reference's O(ns^2) site-pair accumulators (measurementh5.h:140-141).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dqmc_tpu.measure.context import MeasurementContext


def site_to_r_batched(chis, ctx: MeasurementContext):
    """chis (..., ns, ns) -> (..., L1, L2, n_orb^2) displacement arrays,
    averaged over cells, via ONE dense one-hot matmul.

    The site-pair axes flatten row-major into the contracted axis with no
    transposes, so the whole reduction is a single
    (..., ns^2) x (ns^2, L1*L2*no^2) dot, in the input's own dtype (f64
    is native on both the CPU and the GPU).  It replaces the separable
    shift-tensor einsums for the per-tau unequal-time measurements.  Stack
    observables on a leading axis so the one-hot matrix builds/
    streams once per tau batch.  The dense one-hot is expanded IN-GRAPH
    from ctx.pair_cols (one compare per entry — trivial next to the dot
    it feeds); a baked dense constant inflated the lowered HLO 54x.
    Requires ctx.pair_cols (built for lattices where the dense operand
    fits; see context._pair_cols_vector).
    """
    ns = ctx.n_sites
    nd = ctx.L1 * ctx.L2 * ctx.n_orb * ctx.n_orb
    lead = chis.shape[:-2]
    X = chis.reshape(lead + (ns * ns,))
    D = (ctx.pair_cols[:, None]
         == jnp.arange(nd, dtype=jnp.int32)[None, :]).astype(chis.dtype)
    out = jnp.einsum("...k,kd->...d", X, D,
                     precision=jax.lax.Precision.HIGHEST) / ctx.n_cells
    return out.reshape(lead + (ctx.L1, ctx.L2, ctx.n_orb * ctx.n_orb))


def site_to_r_all(vals, ctx: MeasurementContext):
    """dict name -> site-pair array, reduced to displacement space.

    Plain (ns, ns) entries share ONE pair-matmul reduction (the one-hot
    operand builds/streams once); everything else goes through the
    general site_to_r.  The shared helper behind both the equal-time and
    the per-tau unequal-time measurement emits."""
    ns = ctx.n_sites
    out = {}
    batch = [n for n, v in vals.items()
             if ctx.pair_cols is not None and v.shape == (ns, ns)]
    if len(batch) > 1:
        red = site_to_r_batched(jnp.stack([vals[n] for n in batch]), ctx)
        for i, n in enumerate(batch):
            out[n] = red[i]
    for name, v in vals.items():
        if name not in out:
            out[name] = site_to_r(v, ctx)
    return out


def site_to_r(chi, ctx: MeasurementContext):
    """chi (ns, ns) or (ns, ns, S) site-pair array -> (L1, L2, n_orb^2 * S)
    displacement array, averaged over cells (1/n_cells, measurementh5.h:61).

    Two equivalent formulations (brute-force-pinned in
    tests/test_transforms.py):

    - pair-matmul (default when ctx.pair_cols exists): one dense one-hot
      contraction over flattened site pairs — see site_to_r_batched.
    - separable einsums: the cell translation is separable (cell =
      uy*L1 + ux translates per-axis), so the reduction runs as TWO dense
      einsums against one-hot cyclic-shift tensors.  Used when the pair
      matrix would be too large.
    """
    nc, no = ctx.n_cells, ctx.n_orb
    L1, L2 = ctx.L1, ctx.L2
    squeeze = chi.ndim == 2
    if squeeze:
        chi = chi[..., None]
    S = chi.shape[-1]
    dt = chi.dtype
    if ctx.pair_cols is not None:
        out = site_to_r_batched(jnp.moveaxis(chi, -1, 0), ctx)  # (S,L1,L2,ab)
        # reference flat layout: (a*n_orb + b)*S + s  (measurementh5.h:61)
        return jnp.moveaxis(out, 0, -1).reshape(L1, L2, no * no * S)
    # cell index = uy * L1 + ux  =>  (y, x) cell-major axes
    chi7 = chi.reshape(L2, L1, no, L2, L1, no, S)
    # out[dx, dy, a, b, s] =
    #   (1/nc) sum_{x,y} chi[(y,x),a,((y+dy)%L2,(x+dx)%L1),b,s]
    t1 = jnp.einsum("yxaYXbs,xdX->yaYdbs", chi7, ctx.shift1.astype(dt),
                    precision=jax.lax.Precision.HIGHEST)
    out = jnp.einsum("yaYdbs,yeY->deabs", t1, ctx.shift2.astype(dt),
                     precision=jax.lax.Precision.HIGHEST) / nc
    # reference flat layout: (a*n_orb + b)*S + s  (measurementh5.h:61)
    return out.reshape(L1, L2, no * no * S)


def r_to_k(chi_r, ctx: MeasurementContext):
    """(L1, L2, S) real displacement data -> (L1, L2, S) complex k-space via
    the dense DFT: chi_k[k] = sum_r chi_r[r] exp(-i k . r).

    Computed as two real contractions (phases stored as a re/im pair so the
    context needs no complex device arrays)."""
    chi_r = chi_r.astype(ctx.phases_re.dtype)
    re = jnp.tensordot(ctx.phases_re, chi_r, axes=((2, 3), (0, 1)))
    im = jnp.tensordot(ctx.phases_im, chi_r, axes=((2, 3), (0, 1)))
    return jax.lax.complex(re, im)
