"""Simulation state pytrees and static engine configuration.

The reference keeps mutable state spread across the DQMC object, the model,
and main() locals (dqmc.h:21-71).  Here the entire Markov-chain state is one
explicit pytree, so a walker axis is just ``vmap``, a replica axis is a mesh
axis, and checkpointing is serializing one tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu.ops.linalg import LDR


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static sweep-engine configuration (hashable; a jit static arg).

    Mirrors the reference's stabilization bookkeeping (dqmc.cpp:8-18):
    nt time slices in n_stack blocks of n_stab (the last block may be
    shorter when nt % n_stab != 0).
    """

    nt: int
    n_stab: int
    # Delayed-update rank: 0 = plain rank-1 Sherman-Morrison per site;
    # k > 0 = accumulate up to k rank-1 terms in (ns, k) buffers and apply
    # them as ONE rank-k GEMM per block of k sites (exact same sequential
    # Markov chain, identical accept/reject stream — only the linear
    # algebra is reorganized into GEMMs; see sweep.local_update_slice).
    delay_rank: int = 0
    # Submatrix-update rank: like delay_rank, the exact same sequential
    # Markov chain, but decisions run on the k x k submatrix G[I, I] of
    # the block's candidate sites through a bordered Woodbury inverse —
    # O(k^2) sequential work per site instead of the delayed scheme's
    # O(k ns) effective-row formation (sweep.local_update_slice_submatrix;
    # the BASELINE stretch configuration's update scheme for L >= 32).
    # Takes precedence over delay_rank.
    submatrix_rank: int = 0
    # Run each slice's Metropolis site loop as one Pallas (Triton) program
    # per walker (ops/kernels.py): the same Markov chain as the delayed
    # scheme given the same stream, with the batch sharing its visit
    # order.  GPU only (it raises elsewhere); single-flavor models; its
    # flush rank comes from delay_rank (default 32).
    use_pallas: bool = False

    def __post_init__(self):
        if self.nt <= 0 or self.n_stab <= 0:
            raise ValueError("nt and n_stab must be positive")
        if self.delay_rank < 0:
            raise ValueError("delay_rank must be >= 0")
        if self.submatrix_rank < 0:
            raise ValueError("submatrix_rank must be >= 0")
        if self.use_pallas and self.submatrix_rank > 0:
            raise ValueError("the submatrix scheme has no Pallas kernel; "
                             "use site_update = submatrix (XLA) or pallas "
                             "(delayed kernel)")

    @classmethod
    def for_site_update(cls, site_update: str, *, nt: int, n_stab: int,
                        rank: int = 32) -> "EngineConfig":
        """The config of a named site-update scheme ([simulation]
        site_update): 'pallas' (the Triton kernel), 'delayed' and
        'submatrix' (block rank ``rank``), or 'scan' (rank-1)."""
        if site_update not in ("pallas", "delayed", "submatrix", "scan"):
            raise ValueError(f"[simulation] site_update must be auto, "
                             f"pallas, delayed, submatrix or scan, got "
                             f"{site_update!r}")
        return cls(nt=nt, n_stab=n_stab,
                   use_pallas=site_update == "pallas",
                   delay_rank=rank if site_update in ("pallas", "delayed")
                   else 0,
                   submatrix_rank=rank if site_update == "submatrix" else 0)

    @property
    def n_stack(self) -> int:
        return math.ceil(self.nt / self.n_stab)

    @property
    def n_slots(self) -> int:
        # physical stacks at slots 1..n_stack; slots 0 and n_stack+1 hold
        # identity LDRs so first/last-stack stabilizations need no special
        # cases (cf. dqmc.cpp:141-146,152-160,196-214).
        return self.n_stack + 2

    def loc_l_end(self, i_stack: int) -> int:
        if i_stack == self.n_stack - 1 and self.nt % self.n_stab != 0:
            return self.nt % self.n_stab - 1
        return self.n_stab - 1

    def slice_schedule(self, forward: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(l, i_stack, do_stab) per scan step.

        Forward sweeps stabilize at each stack's last local slice
        (dqmc.cpp:369); backward sweeps at the first (dqmc.cpp:429).
        """
        ls = np.arange(self.nt, dtype=np.int32)
        i_stack = ls // self.n_stab
        loc_l = ls % self.n_stab
        ends = np.array([self.loc_l_end(i) for i in i_stack], dtype=np.int32)
        if forward:
            do_stab = loc_l == ends
        else:
            ls = ls[::-1].copy()
            i_stack = i_stack[::-1].copy()
            do_stab = (loc_l == 0)[::-1].copy()
        return ls, i_stack, do_stab


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WalkerState:
    """Complete per-walker Markov-chain state.

    - fields: (nt, ns) int32 HS configuration
    - G: (nfl, ns, ns) current equal-time Green's function.  Unlike the
      reference (which stores all nt+1 Gtt slices, stackngf.h:15-29), the
      equal-time sweep carries only the current slice; full tau-resolved
      Green's functions exist only transiently inside the unequal-time
      measurement scan.
    - stack: LDR pytree with leading (nfl, n_slots) axes; slots 0 and
      n_slots-1 are identity padding.
    - log_det_M: (nfl,) log|det(I + B(beta,0))|, refreshed at every
      stabilization.
    - key: jax.random key for this walker's chain.
    - sign: current Metropolis sign of the configuration weight (+1 always
      for the sign-free attractive model; flips on accepted negative-ratio
      moves for multi-flavor models — measurements should be reweighted by
      <O s>/<s>).
    - acc_sum / err_*: running acceptance and stabilization-precision
      statistics (cf. dqmc.cpp:317-329, main.cpp:183).
    """

    fields: jax.Array
    G: jax.Array
    stack: LDR
    log_det_M: jax.Array
    key: jax.Array
    acc_sum: jax.Array
    sign: jax.Array
    err_max: jax.Array
    err_sum: jax.Array
    err_count: jax.Array
