"""The DQMC sweep engine: propagation, local updates, stabilization.

JAX re-design of the reference engine (source/dqmc.cpp:337-456,
source/update.cpp:5-32).  One Monte-Carlo sweep is a single jitted
``lax.scan`` over imaginary-time slices; each scan step

  1. wraps the equal-time Green's function through the slice propagator
     (two ns x ns GEMMs),
  2. runs the sequential Metropolis site loop (model.cpp:124-138) by the
     scheme EngineConfig selects (``site_update``): a rank-1
     Sherman–Morrison ``lax.scan``, delayed rank-k or submatrix updates,
     or the Triton site kernel (ops/kernels.py),
  3. accumulates the running B-product for the current stabilization block,
  4. at block boundaries, restabilizes: folds the block product into the
     LDR stack and recomputes G from the stable factorization, tracking the
     naive-vs-stable deviation exactly like the reference's check_error
     (dqmc.cpp:317-329).

Two departures from the reference worth naming:

- **Identity-padded stack.**  Stack slot arrays carry identity LDR factors
  at both ends, which makes every stabilization, initialization, and
  unequal-time formula a single generic expression — the reference's
  boundary special cases (dqmc.cpp:141-146, 152-161, 196-215, 253-280) all
  vanish.  ``[I + F·Id]⁻¹ == [I + F]⁻¹`` holds exactly in the stabilized
  formulas (see ops/linalg.py).
- **Transpose-suffix chain.**  Prefix products B(tau,0) live in the stack
  in normal LDR form; suffix products B(beta,tau) live as LDRs of their
  TRANSPOSE.  Every stack extension in both sweep directions is then
  mat_mul_ldr — a column-graded QR — and the stabilized inverses never
  solve against an R factor (ops/linalg.py "dag" forms).  This is what
  makes the engine run in f32 at large beta, where the reference's
  row-graded orientation loses all precision (tests/test_linalg.py::
  test_f32_accuracy_dag_chain).
- **Streaming block product.**  The reference caches all nt B matrices and
  re-multiplies each block at stabilization time (dqmc.cpp:88-105).  We
  instead accumulate the block product one GEMM per slice inside the scan
  (same total FLOPs, no O(nt·ns²) cache, better pipelining) and recompute
  B from the field configuration wherever needed — the diag-scale of expK
  is free compared to the GEMMs.

Everything is vmappable over a leading walker axis and over model-replica
axes (parallel tempering).  The stabilization schedule is host-side static
data, so sweeps scan over stabilization BLOCKS with the n_stab slice steps
inlined and the restabilization placed unconditionally at the block end —
a per-slice ``lax.cond`` would copy its whole carry (including the LDR
stack) every slice.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu import hsfield
from dqmc_tpu.engine.state import EngineConfig, WalkerState
from dqmc_tpu.models.kinetic import (
    apply_B_left,
    apply_B_right,
    apply_invB_left,
    apply_invB_right,
)
from dqmc_tpu.ops.linalg import (
    LDR,
    inv_invldr_plus_ldr_dag,
    inv_one_plus_ldr_dag,
    mat_mul_ldr,
    to_ldr,
)

# flavor-batched LDR ops (leading (nfl,) axis)
_to_ldr_f = jax.vmap(to_ldr)
_mat_mul_ldr_f = jax.vmap(mat_mul_ldr)
_inv_pair_f = jax.vmap(inv_one_plus_ldr_dag)
_inv_invldr_f = jax.vmap(inv_invldr_plus_ldr_dag)


# ----------------------------------------------------------------------
# stack-slot helpers (stack leaves have leading (nfl, n_slots) axes)
# ----------------------------------------------------------------------

def slot_get(stack: LDR, i) -> LDR:
    take = lambda x: jax.lax.dynamic_index_in_dim(x, i, axis=1, keepdims=False)
    return LDR(take(stack.L), take(stack.d), take(stack.R))


def slot_set(stack: LDR, i, F: LDR) -> LDR:
    put = lambda x, v: jax.lax.dynamic_update_index_in_dim(x, v, i, axis=1)
    return LDR(put(stack.L, F.L), put(stack.d, F.d), put(stack.R, F.R))


def identity_stack(nfl: int, n_slots: int, ns: int, dtype) -> LDR:
    eye = jnp.eye(ns, dtype=dtype)
    L = jnp.tile(eye, (nfl, n_slots, 1, 1))
    d = jnp.ones((nfl, n_slots, ns), dtype=dtype)
    return LDR(L, d, L)


def identity_slot(nfl: int, ns: int, dtype) -> LDR:
    """One identity LDR factor with a leading (nfl,) axis — the seed of the
    prefix/suffix chains (= stack slots 0 / n_slots-1)."""
    eye = jnp.tile(jnp.eye(ns, dtype=dtype), (nfl, 1, 1))
    return LDR(eye, jnp.ones((nfl, ns), dtype=dtype), eye)


def stack_from_slots(slots, id_slot, tail=None, *, reverse: bool = False,
                     axis: int = 1):
    """Assemble the identity-padded stack from per-block LDR factors stacked
    on a LEADING scan axis (in block-processing order).

    Sweeps and rebuilds no longer carry the O(n_slots * ns^2) stack through
    their block scans: each block reads the opposite half-chain from the
    (non-carried) input stack, carries only the single previous factor of
    its own chain, and emits the new factor as a scan output.  XLA was
    copying several stack-sized buffers per block iteration for the carried
    dynamic-update-slice pattern (~190 ms/pair of pure copies on the df32
    engine at the headline workload, traced); the assembled concatenate
    below costs one stack-sized copy per sweep.

    Works on any LDR-like pytree (LDR, df_linalg.LDRdf) — id_slot must be
    one identity factor with the same leaves as a slot (it becomes the
    padding at both ends).

    tail: the extra slot of the short last block when nt % n_stab != 0.
    reverse: True for backward sweeps / rebuilds, whose blocks are processed
    n_stack-1..0 (write order slot n_stack..1).
    axis: position of the slot axis in the assembled stack (1 for (nfl, ...)
    leaves, 2 for walker-batched (W, nfl, ...) leaves).
    """
    def one(x, idv, t=None):
        if t is not None:
            # the ragged tail block runs last on forward sweeps, first on
            # backward ones; splice it into processing order before the flip
            x = (jnp.concatenate([t[None], x], axis=0) if reverse
                 else jnp.concatenate([x, t[None]], axis=0))
        if reverse:
            x = jnp.flip(x, 0)
        x = jnp.moveaxis(x, 0, axis)
        pad = jnp.expand_dims(idv, axis)
        return jnp.concatenate([pad, x, pad], axis=axis)

    if tail is None:
        return jax.tree_util.tree_map(one, slots, id_slot)
    return jax.tree_util.tree_map(one, slots, id_slot, tail)


# ----------------------------------------------------------------------
# local Metropolis updates over one time slice (update.cpp:5-32)
# ----------------------------------------------------------------------

def draw_slice_randoms(key: jax.Array, ns: int, dtype):
    """The per-slice random stream: (visit order, proposal draws, uniforms).

    Shared by every site-update implementation (scan, delayed, submatrix,
    the Pallas kernel) so
    they all realize the *identical* Markov chain from the same key.
    """
    kperm, kprop, kacc = jax.random.split(key, 3)
    order = jax.random.permutation(kperm, ns)
    props = jax.random.randint(kprop, (ns,), 0, 3)
    us = jax.random.uniform(kacc, (ns,), dtype=dtype)
    return order, props, us


def local_update_slice(model, key: jax.Array, G: jax.Array,
                       fields_l: jax.Array):
    """Sequential Metropolis sweep over all sites of one time slice.

    Sites are visited in a fresh random permutation (update.cpp:10-14);
    each site proposes one of the 3 other field states; acceptance applies
    the rank-1 Sherman–Morrison Green's-function update *before* writing
    the new field value (update.cpp:27-28).  All randomness is drawn
    up-front (the accept/reject path never re-seeds), so the inner scan is
    deterministic data flow.

    Returns (G, fields_l, acceptance_fraction).
    """
    order, props, us = draw_slice_randoms(key, model.n_sites, G.dtype)
    return local_update_core(model, G, fields_l, order, props, us)


def local_update_core(model, G: jax.Array, fields_l: jax.Array,
                      order: jax.Array, props: jax.Array, us: jax.Array):
    """The sequential site loop with an explicit random stream (used by all
    implementations' equivalence tests)."""
    ns = model.n_sites
    dtype = G.dtype
    proposal_table = jnp.asarray(hsfield.PROPOSAL)

    def step(carry, xs):
        G, fields_l, acc, sgn = carry
        i, r, u = xs
        old = fields_l[i]
        new = proposal_table[old, r]
        gammaR, bosonR, delta = model.update_factors(old, new)
        G_ii = G[:, i, i]                       # (nfl,)
        r_flv = 1.0 + (1.0 - G_ii) * delta      # (nfl,)
        R = gammaR * bosonR * jnp.prod(r_flv) ** model.det_power
        accept = u < jnp.minimum(1.0, jnp.abs(R))
        # Metropolis on |R|; an accepted negative-ratio move flips the
        # configuration's sign (sign-problem bookkeeping for multi-flavor
        # models; identically +1 for the attractive model)
        sgn = jnp.where(accept & (R < 0), -sgn, sgn)
        # G'_{jk} = G_{jk} + prefac * G_{ji} (G_{ik} - delta_{ik})
        prefac = jnp.where(accept, delta / r_flv, jnp.zeros_like(delta))
        e_i = jax.nn.one_hot(i, ns, dtype=dtype)
        u_vec = G[:, :, i]                      # (nfl, ns)
        v_vec = G[:, i, :] - e_i[None, :]       # (nfl, ns)
        G = G + prefac[:, None, None] * (u_vec[:, :, None] * v_vec[:, None, :])
        fields_l = fields_l.at[i].set(jnp.where(accept, new, old))
        return (G, fields_l, acc + accept.astype(dtype), sgn), None

    init = (G, fields_l, jnp.zeros((), dtype), jnp.ones((), dtype))
    (G, fields_l, acc, sgn), _ = jax.lax.scan(step, init, (order, props, us))
    return G, fields_l, acc / ns, sgn


def local_update_slice_delayed(model, key: jax.Array, G: jax.Array,
                               fields_l: jax.Array, k_max: int):
    """Delayed rank-k variant of `local_update_slice` — the exact same
    Markov chain (identical random stream and accept/reject decisions), with
    the linear algebra reorganized into GEMMs.

    Instead of applying each accepted rank-1 Sherman-Morrison update to the
    full (ns, ns) Green's function, accepted updates accumulate into
    U (ns, k) / V (k, ns) buffers; each site reads its effective row/column

        g_row = G[i, :] + U[i, :] @ V,    g_col = G[:, i] + U @ V[:, i]

    at O(ns k) cost, and every k sites the block flushes as ONE rank-k GEMM
    G += U @ V.  Total FLOPs match the rank-1 scheme, but the sequential
    dependency chain only carries O(ns k) work per step and the O(ns^2 k)
    work lands in dense matmuls (delayed-update scheme of the QMC
    literature, cf. PAPERS.md).
    """
    ns, nfl = model.n_sites, model.n_flavor
    dtype = G.dtype
    n_blocks = -(-ns // k_max)
    pad = n_blocks * k_max - ns

    # identical random stream to the rank-1 path: draw (ns,) then pad
    order, props, us = draw_slice_randoms(key, ns, dtype)
    valid = jnp.ones((ns,), dtype=bool)
    if pad:
        order = jnp.concatenate([order, jnp.zeros((pad,), order.dtype)])
        props = jnp.concatenate([props, jnp.zeros((pad,), props.dtype)])
        us = jnp.concatenate([us, jnp.ones((pad,), dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), dtype=bool)])
    proposal_table = jnp.asarray(hsfield.PROPOSAL)
    slots = jnp.tile(jnp.arange(k_max), (n_blocks, 1))

    def block(carry, xs):
        G, fields_l, acc, sgn = carry
        o_b, r_b, u_b, valid_b, slot_b = xs
        U0 = jnp.zeros((nfl, ns, k_max), dtype)
        V0 = jnp.zeros((nfl, k_max, ns), dtype)

        def site(c, x):
            U, V, fields_l, acc, sgn = c
            slot, i, r, u, ok = x
            old = fields_l[i]
            new = proposal_table[old, r]
            gammaR, bosonR, delta = model.update_factors(old, new)
            # effective row/column of G under the pending low-rank terms
            g_row = G[:, i, :] + jnp.einsum("fk,fkn->fn", U[:, i, :], V)
            g_col = G[:, :, i] + jnp.einsum("fnk,fk->fn", U, V[:, :, i])
            G_ii = g_row[:, i]
            r_flv = 1.0 + (1.0 - G_ii) * delta
            R = gammaR * bosonR * jnp.prod(r_flv) ** model.det_power
            accept = ok & (u < jnp.minimum(1.0, jnp.abs(R)))
            sgn = jnp.where(accept & (R < 0), -sgn, sgn)
            prefac = jnp.where(accept, delta / r_flv, jnp.zeros_like(delta))
            e_i = jax.nn.one_hot(i, ns, dtype=dtype)
            u_new = prefac[:, None] * g_col          # (nfl, ns)
            v_new = g_row - e_i[None, :]             # (nfl, ns)
            U = jax.lax.dynamic_update_index_in_dim(U, u_new, slot, axis=2)
            V = jax.lax.dynamic_update_index_in_dim(V, v_new, slot, axis=1)
            fields_l = fields_l.at[i].set(jnp.where(accept, new, old))
            return (U, V, fields_l, acc + accept.astype(dtype), sgn), None

        (U, V, fields_l, acc, sgn), _ = jax.lax.scan(
            site, (U0, V0, fields_l, acc, sgn),
            (slot_b, o_b, r_b, u_b, valid_b))
        G = G + U @ V                                # rank-k flush (GEMM)
        return (G, fields_l, acc, sgn), None

    xs = tuple(a.reshape(n_blocks, k_max) for a in (order, props, us, valid))
    xs = xs + (slots,)
    (G, fields_l, acc, sgn), _ = jax.lax.scan(
        block, (G, fields_l, jnp.zeros((), dtype), jnp.ones((), dtype)), xs)
    return G, fields_l, acc / ns, sgn


def local_update_slice_submatrix(model, key: jax.Array, G: jax.Array,
                                 fields_l: jax.Array, k_max: int):
    """Submatrix-update variant of `local_update_slice` — the same Markov
    chain (identical random stream; accept/reject identical up to floating
    rounding of the ratio), with the sequential dependency chain reduced
    from O(k ns) to O(k^2) work per site.

    The delayed scheme (above) forms each candidate's *effective* G
    row/column against the pending (k, ns) buffers — O(ns k) VPU work per
    site, which dominates at large lattices.  The submatrix scheme [Nukala
    et al., PRB 81 195119; "delayed/submatrix updates" of the QMC
    literature, PAPERS.md] observes that within a block of k candidate
    sites I = (i_1..i_k) — known in advance, the visit order is
    state-independent — every quantity the decisions need lives in the
    k x k submatrix G[I, I] of the *block-base* G plus a small maintained
    inverse.  With P the accepted subset, deltas D_P, and

        M = D_P^{-1} + (I - G)[P, P]              (m x m, m <= k)

    the composite update after the block closes is the exact Woodbury form
    of m compounded rank-1 Sherman-Morrison steps (model.cpp:124-138):

        G' = G + G[:, P] M^{-1} (G[P, :] - I[P, :])

    and the next candidate t's flavor ratio is the bordering Schur
    complement of M — all O(m^2) arithmetic on k x k data:

        r_flv = 1 + delta (1 - G[t,t]) - delta * G[t,P] M^{-1} G[P,t].

    W = M^{-1} is maintained by bordered inversion in a fixed (k, k)
    buffer masked to accepted slots (rejected candidates never touch W, so
    the flush GEMM's rank is the number of *acceptances*, not visits).
    Per slice: ns * O(k^2) sequential work + two (k, ns) gathers and
    three GEMMs per block — vs the delayed scheme's ns * O(k ns).
    """
    ns, nfl = model.n_sites, model.n_flavor
    dtype = G.dtype
    n_blocks = -(-ns // k_max)
    pad = n_blocks * k_max - ns

    # identical random stream to the rank-1 path: draw (ns,) then pad
    order, props, us = draw_slice_randoms(key, ns, dtype)
    valid = jnp.ones((ns,), dtype=bool)
    if pad:
        order = jnp.concatenate([order, jnp.zeros((pad,), order.dtype)])
        props = jnp.concatenate([props, jnp.zeros((pad,), props.dtype)])
        us = jnp.concatenate([us, jnp.ones((pad,), dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), dtype=bool)])
    proposal_table = jnp.asarray(hsfield.PROPOSAL)
    slots = jnp.tile(jnp.arange(k_max), (n_blocks, 1))

    def block(carry, xs):
        G, fields_l, acc, sgn = carry
        o_b, r_b, u_b, valid_b, slot_b = xs
        # block-base k x k submatrix: all decisions read only this
        GII = jnp.take(jnp.take(G, o_b, axis=1), o_b, axis=2)  # (nfl, k, k)
        W0 = jnp.zeros((nfl, k_max, k_max), dtype)
        mask0 = jnp.zeros((k_max,), dtype)

        def site(c, x):
            W, mask, fields_l, acc, sgn = c
            slot, i, r, u, ok = x
            old = fields_l[i]
            new = proposal_table[old, r]
            gammaR, bosonR, delta = model.update_factors(old, new)
            # Schur complement of the bordered M through W = M^{-1}
            b = -GII[:, slot, :] * mask                   # (nfl, k) = -G[t,P]
            cc = -GII[:, :, slot] * mask                  # (nfl, k) = -G[P,t]
            Wc = jnp.einsum("fpq,fq->fp", W, cc)
            bW = jnp.einsum("fp,fpq->fq", b, W)
            bWc = jnp.sum(b * Wc, axis=1)                 # (nfl,)
            G_tt = GII[:, slot, slot]
            r_flv = 1.0 + delta * (1.0 - G_tt) - delta * bWc
            R = gammaR * bosonR * jnp.prod(r_flv) ** model.det_power
            accept = ok & (u < jnp.minimum(1.0, jnp.abs(R)))
            sgn = jnp.where(accept & (R < 0), -sgn, sgn)
            # bordered-inverse growth of W at slot t (only when accepted)
            inv_s = jnp.where(accept, delta / r_flv,
                              jnp.zeros_like(delta))      # (nfl,)
            W = W + inv_s[:, None, None] * Wc[:, :, None] * bW[:, None, :]
            row_t = jnp.where(accept, -inv_s[:, None] * bW,
                              jnp.take(W, slot, axis=1))
            W = jax.lax.dynamic_update_index_in_dim(W, row_t, slot, axis=1)
            col_t = jnp.where(accept, -inv_s[:, None] * Wc,
                              jnp.take(W, slot, axis=2))
            col_t = col_t.at[:, slot].set(jnp.where(accept, inv_s,
                                                    col_t[:, slot]))
            W = jax.lax.dynamic_update_index_in_dim(W, col_t, slot, axis=2)
            mask = mask.at[slot].set(jnp.where(accept, 1.0, mask[slot]))
            fields_l = fields_l.at[i].set(jnp.where(accept, new, old))
            return (W, mask, fields_l, acc + accept.astype(dtype), sgn), None

        (W, mask, fields_l, acc, sgn), _ = jax.lax.scan(
            site, (W0, mask0, fields_l, acc, sgn),
            (slot_b, o_b, r_b, u_b, valid_b))
        # composite flush: G += G[:,I] W (G[I,:] - I[I,:]); W is zero on
        # rejected slots, so only accepted candidates contribute
        Grows = jnp.take(G, o_b, axis=1)                  # (nfl, k, ns)
        Gcols = jnp.take(G, o_b, axis=2)                  # (nfl, ns, k)
        V = Grows - jax.nn.one_hot(o_b, ns, dtype=dtype)[None]
        G = G + Gcols @ (W @ V)
        return (G, fields_l, acc, sgn), None

    xs = tuple(a.reshape(n_blocks, k_max) for a in (order, props, us, valid))
    xs = xs + (slots,)
    (G, fields_l, acc, sgn), _ = jax.lax.scan(
        block, (G, fields_l, jnp.zeros((), dtype), jnp.ones((), dtype)), xs)
    return G, fields_l, acc / ns, sgn


def site_update(model, cfg: EngineConfig, key: jax.Array, G: jax.Array,
                fields_l: jax.Array):
    """One slice's site update by the scheme cfg selects; returns
    (G, fields_l, acceptance_fraction, sign_factor)."""
    if cfg.use_pallas:
        if model.n_flavor != 1 or model.det_power != 2:
            raise NotImplementedError(
                "the Pallas site kernel serves single-flavor det_power=2 "
                "models; use site_update = delayed or scan")
        from dqmc_tpu.ops.kernels import site_update_fn
        G, fields_l, acc = site_update_fn(cfg.delay_rank or 32)(
            model, key, G, fields_l)
        return G, fields_l, acc, jnp.ones((), G.dtype)   # sign-free model
    if cfg.submatrix_rank > 0:
        return local_update_slice_submatrix(model, key, G, fields_l,
                                            cfg.submatrix_rank)
    if cfg.delay_rank > 0:
        return local_update_slice_delayed(model, key, G, fields_l,
                                          cfg.delay_rank)
    return local_update_slice(model, key, G, fields_l)


# ----------------------------------------------------------------------
# stack (re)initialization (dqmc.cpp:43-72)
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def rebuild_stack_and_greens(model, cfg: EngineConfig, fields: jax.Array):
    """Build the full right-to-left LDR stack from a field configuration and
    the equal-time G(0,0) = [I + B(beta,0)]^{-1} with its log-determinant.

    Structured as a backward no-update scan (cf. dqmc.cpp:46-56): accumulate
    each block's dense B-product, then extend the suffix chain in its
    TRANSPOSE representation,
        slot[i+1] = LDR of (Bbar_i^T @ slot[i+2]_matrix)
    so that slot[i+1]_matrix = B(beta, tau_i)^T — every QR input is
    column-graded (see ops/linalg.py "dag" docs for why this is the f32-safe
    orientation).
    """
    nfl, ns = model.n_flavor, model.n_sites
    dtype = model.dtype
    eyeB = jnp.tile(jnp.eye(ns, dtype=dtype), (nfl, 1, 1))

    # block-structured (see sweep): slices of one stack inlined, fold at the
    # block end unconditionally.  The scan carries only the previous suffix
    # factor and emits each block's new LDR (see stack_from_slots).
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab

    def run_block(T_prev, n_slices, l0):
        Bbar = eyeB
        for k in range(n_slices):
            l = l0 + n_slices - 1 - k
            Bbar = apply_B_right(model, jnp.take(fields, l, axis=0), Bbar)
        return _mat_mul_ldr_f(jnp.swapaxes(Bbar, -1, -2), T_prev)

    def scan_step(t, i):
        T_new = run_block(t, n_stab, i * n_stab)
        return T_new, T_new

    T0 = identity_slot(nfl, ns, dtype)
    tail = run_block(T0, rem, n_full * n_stab) if rem else None
    T, slots = jax.lax.scan(scan_step, tail if rem else T0,
                            jnp.arange(n_full - 1, -1, -1, dtype=jnp.int32))
    stack = stack_from_slots(slots, identity_slot(nfl, ns, dtype), tail,
                              reverse=True)
    G, log_det_M = _inv_pair_f(identity_slot(nfl, ns, dtype), T)
    return stack, G, log_det_M


def init_state(model, cfg: EngineConfig, key: jax.Array) -> WalkerState:
    """Fresh walker: random HS field (field.h:52-57), stack + G from it."""
    kf, kchain = jax.random.split(key)
    fields = hsfield.init_fields(kf, cfg.nt, model.n_sites)
    stack, G, log_det_M = rebuild_stack_and_greens(model, cfg, fields)
    z = jnp.zeros((), model.dtype)
    return WalkerState(
        fields=fields, G=G, stack=stack, log_det_M=log_det_M, key=kchain,
        acc_sum=z, sign=jnp.ones((), model.dtype), err_max=z, err_sum=z,
        err_count=z,
    )


# ----------------------------------------------------------------------
# the sweep (dqmc.cpp:337-456)
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "forward", "update"))
def sweep(model, cfg: EngineConfig, state: WalkerState, *,
          forward: bool = True, update: bool = True) -> WalkerState:
    """One full Monte-Carlo sweep over all time slices.

    forward=True : 0 -> beta, propagate then update, stabilize at block
                   ends (dqmc.cpp:337-396).
    forward=False: beta -> 0, update then propagate, stabilize at block
                   starts (dqmc.cpp:398-456).
    update=False : propagation/stabilization only (diagnostics).
    """
    nfl, ns = model.n_flavor, model.n_sites
    dtype = model.dtype
    eyeB = jnp.tile(jnp.eye(ns, dtype=dtype), (nfl, 1, 1))

    def stabilize(G, F_prev, Bbar, i_stack):
        # The block scan carries only the previous factor of the chain it
        # BUILDS (F_prev); the opposite half-chain is read per block from
        # the non-carried input stack — the sweep never writes slots it
        # reads, so reading state.stack is exact (see stack_from_slots).
        if forward:
            # prefix chain (normal form): slot[i+1] = Bbar * slot[i];
            # G(tau,tau) = [I + B(tau,0) B(beta,tau)]^{-1} with the suffix
            # read from slot[i+2] in TRANSPOSE form (left by the previous
            # backward pass / init).
            F_new = _mat_mul_ldr_f(Bbar, F_prev)
            G_new, log_det = _inv_pair_f(
                F_new, slot_get(state.stack, i_stack + 2))
        else:
            # suffix chain (transpose form): slot[i+1]_matrix =
            # Bbar^T @ slot[i+2]_matrix = B(beta,tau)^T; prefix read from
            # slot[i] in normal form (left by the previous forward pass).
            F_new = _mat_mul_ldr_f(jnp.swapaxes(Bbar, -1, -2), F_prev)
            G_new, log_det = _inv_pair_f(slot_get(state.stack, i_stack),
                                         F_new)
        err = jnp.max(jnp.abs(G - G_new))
        return G_new, F_new, log_det, err

    def slice_step(carry, l):
        (fields, G, Bbar, key, acc, sign) = carry
        fields_l = jnp.take(fields, l, axis=0)

        if forward:
            # G(l+1) = B_l G(l) B_l^{-1}
            G = apply_invB_right(model, fields_l,
                                 apply_B_left(model, fields_l, G))

        if update:
            key, k_slice = jax.random.split(key)
            G, fields_l, acc_l, sgn_l = site_update(model, cfg, k_slice, G,
                                                    fields_l)
            sign = sign * sgn_l
            acc = acc + acc_l / cfg.nt
            fields = fields.at[l].set(fields_l)

        if forward:
            # post-update B enters the block product
            Bbar = apply_B_left(model, fields_l, Bbar)
        else:
            # G(l) = B_l^{-1} G(l+1) B_l
            G = apply_B_right(model, fields_l,
                              apply_invB_left(model, fields_l, G))
            Bbar = apply_B_right(model, fields_l, Bbar)

        return (fields, G, Bbar, key, acc, sign)

    # Block-structured scan: the stabilization schedule is STATIC (each
    # stack's boundary slice, dqmc.cpp:369/429), so the sweep scans over
    # stacks with the n_stab slice steps inlined and the restabilization
    # placed unconditionally at the block end.  The per-slice lax.cond it
    # replaces forced a full copy of the cond carry — including the whole
    # LDR stack — every slice (cf. engine/uneqtime.py, same restructure).
    # Slice processing order and key-split order are IDENTICAL to the flat
    # schedule, so the Markov chains are bit-equal.
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab

    def run_block(carry, i_stack, n_slices, l0):
        (fields, G, F_prev, log_det_M, key, acc, sign, emax, esum,
         ecnt) = carry
        c6 = (fields, G, eyeB, key, acc, sign)
        for k in range(n_slices):
            l = l0 + (k if forward else n_slices - 1 - k)
            c6 = slice_step(c6, l)
        fields, G, Bbar, key, acc, sign = c6
        G, F_new, log_det_M, err = stabilize(G, F_prev, Bbar, i_stack)
        emax = jnp.maximum(emax, err)
        esum = esum + err
        ecnt = ecnt + jnp.ones((), dtype)
        return (fields, G, F_new, log_det_M, key, acc, sign, emax, esum,
                ecnt)

    def block_step(carry, i_stack):
        carry = run_block(carry, i_stack, n_stab, i_stack * n_stab)
        return carry, carry[2]

    def tail_block(carry):
        return run_block(carry, jnp.int32(n_full), rem, n_full * n_stab)

    carry = (state.fields, state.G, identity_slot(nfl, ns, dtype),
             state.log_det_M, state.key, state.acc_sum, state.sign,
             state.err_max, state.err_sum, state.err_count)
    i_stacks = jnp.arange(n_full, dtype=jnp.int32)
    tail = None
    if forward:
        carry, slots = jax.lax.scan(block_step, carry, i_stacks)
        if rem:
            carry = tail_block(carry)
            tail = carry[2]
    else:
        if rem:
            carry = tail_block(carry)
            tail = carry[2]
        carry, slots = jax.lax.scan(block_step, carry, i_stacks[::-1])
    stack = stack_from_slots(slots, identity_slot(nfl, ns, dtype), tail,
                              reverse=not forward)
    (fields, G, _, log_det_M, key, acc, sign, emax, esum, ecnt) = carry
    return dataclasses.replace(
        state, fields=fields, G=G, stack=stack, log_det_M=log_det_M, key=key,
        acc_sum=acc, sign=sign, err_max=emax, err_sum=esum, err_count=ecnt)


def sweep_pair(model, cfg: EngineConfig, state: WalkerState) -> WalkerState:
    """The reference's per-iteration unit: forward then backward sweep
    (main.cpp:131-132, 156-157)."""
    state = sweep(model, cfg, state, forward=True)
    return sweep(model, cfg, state, forward=False)


def reset_error_stats(state: WalkerState) -> WalkerState:
    """Zero the stabilization-precision accumulators (err_max/err_sum/count).

    The first sweeps from a random field produce large naive-vs-stable
    deviations that say nothing about steady-state stabilization health; the
    driver resets after thermalization so the reported max/mean error
    reflects the measured phase only (cf. dqmc.cpp:317-329 — the reference
    never resets and its lifetime max conflates the two)."""
    z = jnp.zeros_like(state.err_max)
    return dataclasses.replace(state, err_max=z, err_sum=z,
                               err_count=jnp.zeros_like(state.err_count))


# ----------------------------------------------------------------------
# symmetric-Trotter half-warp (dqmc.cpp:288-315)
# ----------------------------------------------------------------------

def half_warp(model, G: jax.Array) -> jax.Array:
    """G~ = expm(+dtau K/2) G expm(-dtau K/2): the similarity transform that
    makes measurements symmetric-Trotter accurate."""
    return model.invexpK_half @ G @ model.expK_half
