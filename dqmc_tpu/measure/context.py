"""Device-side lattice tables for measurement kernels.

The Lattice object is host-side numpy; observables and transforms run
inside jit.  ``MeasurementContext`` packages the index tables and DFT
phases they need as a pytree of device constants.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu.lattice import Lattice


def _static():
    return dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeasurementContext:
    # static dims
    L1: int = _static()
    L2: int = _static()
    n_orb: int = _static()
    n_cells: int = _static()
    n_sites: int = _static()

    # tables (DFT phases stored as a real (re, im) pair: the k-space
    # transform runs host-side in the manager, and real tables keep every
    # device array real)
    disp_table: jax.Array      # (L1, L2, n_cells) int32 — lattice translations
    phases_re: jax.Array       # (L1, L2, L1, L2) — Re exp(-i k . r)
    phases_im: jax.Array       # (L1, L2, L1, L2) — Im exp(-i k . r)
    nbr_x: jax.Array           # (n_sites,) int32 — +x neighbor map (currxx)
    # one-hot cyclic-shift tensors for the separable site->r contraction:
    # shift1[x, dxi, x'] = 1 iff x' = (x + dxi - off1) mod L1, and the L2
    # analogue — the displacement reduction runs as two einsums instead of
    # a gather (see transforms.site_to_r)
    shift1: jax.Array          # (L1, L1, L1)
    shift2: jax.Array          # (L2, L2, L2)
    # column indices of the one-hot site-PAIR reduction matrix for the
    # single-matmul site->r path (transforms.site_to_r_batched):
    # P[i*ns + j, c] = 1 iff c == pair_cols[i*ns + j], where column
    # (dx*L2+dy)*no^2 + a*no+b encodes the displacement (dx, dy) from i's
    # cell to j's cell and the orbital pair (a, b).  One (.., ns^2) x
    # (ns^2, nd) dot replaces the separable einsums, whose XLA lowering
    # (convolution + layout copies) dominated measured unequal-time sweeps.
    # Only the index VECTOR is stored; the dense one-hot is rebuilt
    # in-graph per use (a trivial compare vs the dot it feeds) — a baked
    # dense constant inflated the lowered HLO 54x (68 MB at L=16), which
    # the compiler must hash every cold compile.  None when the dense operand would exceed ~96 MB (large
    # lattices fall back to the einsum path).
    pair_cols: jax.Array | None = None     # (ns^2,) int32 or None

    @property
    def phases(self):
        return np.asarray(self.phases_re) + 1j * np.asarray(self.phases_im)


def _shift_onehot(L: int, off: int, dtype) -> np.ndarray:
    S = np.zeros((L, L, L))
    for x in range(L):
        for d in range(L):
            S[x, d, (x + d - off) % L] = 1.0
    return S


_PAIR_REDUCE_BYTES_CAP = 96 * 2**20


def _pair_cols_vector(lat: Lattice, itemsize: int = 4) -> np.ndarray | None:
    """Column indices of the one-hot site-pair -> displacement matrix.

    Entry i*ns + j is (dx*L2 + dy)*no^2 + a*no + b where (dx, dy) is the
    (offset-indexed) displacement from i's cell to j's cell and (a, b)
    their orbitals — the same index conventions as
    Lattice.displacement_table / the reference's chi_site_to_chi_r
    (measurementh5.h:20-66).  ``itemsize`` is the measurement dtype's
    width: the dense one-hot materializes in that dtype, so the cap must
    account for it (an f64 context halves the covered lattice sizes)."""
    ns, no, nc = lat.n_sites, lat.n_orb, lat.n_cells
    nd = lat.L1 * lat.L2 * no * no
    if ns * ns * nd * itemsize > _PAIR_REDUCE_BYTES_CAP:
        return None
    T = lat.displacement_table()                      # (L1, L2, nc)
    cols_vec = np.zeros(ns * ns, np.int32)
    cells = np.arange(nc)
    d_flat = (np.arange(lat.L1)[:, None] * lat.L2
              + np.arange(lat.L2)[None, :])           # (L1, L2)
    for a in range(no):
        for b in range(no):
            rows = ((cells[None, None, :] * no + a) * ns
                    + T * no + b)                     # (L1, L2, nc)
            cols = (d_flat * no * no + a * no + b)[..., None]
            cols_vec[rows.ravel()] = \
                np.broadcast_to(cols, rows.shape).ravel()
    return cols_vec


def make_context(lat: Lattice, dtype=jnp.float64) -> MeasurementContext:
    from dqmc_tpu.lattice import _half_offset
    phases = lat.kspace_phases()
    pair = _pair_cols_vector(lat, jnp.dtype(dtype).itemsize)
    return MeasurementContext(
        L1=lat.L1, L2=lat.L2, n_orb=lat.n_orb, n_cells=lat.n_cells,
        n_sites=lat.n_sites,
        disp_table=jnp.asarray(lat.displacement_table()),
        phases_re=jnp.asarray(phases.real, dtype),
        phases_im=jnp.asarray(phases.imag, dtype),
        nbr_x=jnp.asarray(lat.neighbor_map((1, 0), orb=0)),
        shift1=jnp.asarray(_shift_onehot(lat.L1, _half_offset(lat.L1), dtype),
                           dtype),
        shift2=jnp.asarray(_shift_onehot(lat.L2, _half_offset(lat.L2), dtype),
                           dtype),
        pair_cols=None if pair is None else jnp.asarray(pair),
    )
