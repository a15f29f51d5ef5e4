"""Hybrid df32 parity sweep engine: f32 updates, df32 stabilization.

The parity-grade production mode (NOTES.md roadmap).  Design: the
Metropolis site loop and the slice-to-slice wraps stay on the fast f32
path (the same site updates as engine/sweep.py, f32 GEMMs), while
everything whose error ACCUMULATES across the sweep — the propagator block products, the LDR stack folds,
and the stabilized inverses — is carried in df32 (double-float32,
ops/df32 + ops/df_linalg, ~2^-46 from pure f32 operations).

Why this split is sound: between two stabilizations the f32 G drifts by
at most ~1e-6 (a few hundred rank-1 updates + 2*n_stab GEMM wraps of
rounding), which only perturbs ACCEPTANCE ratios — a bias of the same
order as the reference tolerates in f64 (its own naive-vs-stable warning
fires at 1e-6, dqmc.cpp:390).  At every stabilization G is REPLACED by
the df rebuild, so the drift never compounds; the Green's function used
for measurements carries df accuracy (~1e-8 at beta=8 vs the f64 chain,
tests/test_df_linalg.py) for the exact field configuration being
measured.  The f64 mode remains for strict 1e-10 work.

Mirrors the sweep structure of engine/sweep.py (dqmc.cpp:337-456); see
there for the identity-padded stack and transpose-suffix conventions.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu import hsfield
from dqmc_tpu.engine.state import EngineConfig
from dqmc_tpu.engine.sweep import draw_slice_randoms, site_update
from dqmc_tpu.models.kinetic import (
    apply_B_left,
    apply_B_right,
    apply_invB_left,
    apply_invB_right,
)
from dqmc_tpu.ops import df32, df_linalg
from dqmc_tpu.ops.df32 import DF
from dqmc_tpu.ops.df_linalg import LDRdf

# flavor-batched df LDR ops (leading (nfl,) axis)
_to_ldr_df = jax.vmap(df_linalg.to_ldr)
_mat_mul_ldr_df = jax.vmap(df_linalg.mat_mul_ldr)
_inv_pair_df = jax.vmap(df_linalg.inv_one_plus_ldr_dag)


# ----------------------------------------------------------------------
# df model data: the exact propagator pieces at df precision
# ----------------------------------------------------------------------

class DFModelAux(NamedTuple):
    """df32 twins of the propagator constants.

    expK: (ns, ns) df pair of expm(-dtau K), split from the f64 build
    (scipy expm carries full f64 precision; model.cpp:31-35).
    expv: (nfl, 4) df pair table exp(g * eta(s)) per stored flavor.
    act: (4,) df pair of per-state bosonic action constants
    -(alpha*g*eta_v + log gamma_v), so the bosonic part of the global
    action is the exact state-count dot sum_v N_v * act_v
    (model.cpp:140-159 semantics; used by parallel tempering).
    """
    expK: DF
    expv: DF
    act: DF


def _aux_from_np(expK64: np.ndarray, g64: float, alpha: float = -1.0,
                 n_flavor: int = 1) -> DFModelAux:
    eta = np.asarray(hsfield.ETA, np.float64)
    gamma = np.asarray(hsfield.GAMMA, np.float64)
    if n_flavor == 1:
        tbl = np.exp(g64 * eta)[None, :]                # (1, 4)
    else:
        # 2-flavor repulsive spin channel: opposite couplings
        # (models/repulsive_hubbard.py:99-105)
        tbl = np.stack([np.exp(g64 * eta), np.exp(-g64 * eta)])
    th = np.float32(tbl)
    tl = np.float32(tbl - np.float64(th))
    kh = np.float32(expK64)
    kl = np.float32(expK64 - np.float64(kh))
    act = -(alpha * g64 * eta + np.log(gamma))          # (4,) f64
    ah = np.float32(act)
    al = np.float32(act - np.float64(ah))
    return DFModelAux(expK=DF(jnp.asarray(kh), jnp.asarray(kl)),
                      expv=DF(jnp.asarray(th), jnp.asarray(tl)),
                      act=DF(jnp.asarray(ah), jnp.asarray(al)))


def df_aux_build(lat, *, U: float, t: float, mu: float, beta: float,
                 nt: int, bonds=None, n_flavor: int = 1) -> DFModelAux:
    """Build the df32 propagator constants host-side in full f64.

    Independent of ``jax_enable_x64`` (an f64-built *model* only exists
    in x64 sessions): recomputes expm(-dtau K) with scipy exactly like
    AttractiveHubbard.build (model.cpp:31-35) and splits it into df pairs
    before anything touches the device.  n_flavor=2 builds the repulsive
    spin-channel twin (opposite couplings, alpha = 0)."""
    import scipy.linalg
    from dqmc_tpu.models.attractive_hubbard import build_kinetic_matrix
    dtau = beta / nt
    K = build_kinetic_matrix(lat, t, mu, bonds=bonds)
    expK64 = scipy.linalg.expm(-dtau * K)
    g64 = float(np.sqrt(0.5 * abs(U) * dtau))
    alpha = -1.0 if n_flavor == 1 else 0.0
    return _aux_from_np(expK64, g64, alpha=alpha, n_flavor=n_flavor)


def df_aux_from(model64) -> DFModelAux:
    """df32 propagator constants from an f64-built model twin (x64 only)."""
    if model64.expK.dtype != jnp.float64:
        raise ValueError("df_aux_from needs the f64-built model twin "
                         "(build with dtype=jnp.float64; requires "
                         "jax_enable_x64 — use df_aux_build otherwise)")
    if model64.n_flavor != 1:
        raise NotImplementedError("df sweep engine: single-flavor models "
                                  "only (the flagship attractive Hubbard)")
    return _aux_from_np(np.asarray(model64.expK, np.float64),
                        float(np.asarray(model64.g, np.float64)))


def cast_model_f32(model64):
    """The f32 working twin of an f64-built model (same build, f32 leaves).

    Equivalent to AttractiveHubbard.build(..., dtype=jnp.float32): the
    f32 engine path (wraps, kernels, update factors) runs on this."""
    def cast(x):
        if isinstance(x, jax.Array) and x.dtype == jnp.float64:
            return x.astype(jnp.float32)
        return x
    leaves, treedef = jax.tree_util.tree_flatten(model64)
    return jax.tree_util.tree_unflatten(treedef, [cast(l) for l in leaves])


def _slice_B_df(aux: DFModelAux, fields_l: jax.Array) -> DF:
    """(nfl, ns, ns) df B_l = diag(expv[s_l]) @ expK.

    Full df multiply (a bare hi*hi product would cap B at 2^-24
    relative); select-chain over the 4 field states, not a gather."""
    nfl = aux.expv.hi.shape[0]
    ns = fields_l.shape[-1]
    evh = jnp.zeros((nfl, ns), jnp.float32)
    evl = jnp.zeros((nfl, ns), jnp.float32)
    for v in range(4):
        m = (fields_l == v)[None, :]
        evh = jnp.where(m, aux.expv.hi[:, v:v + 1], evh)
        evl = jnp.where(m, aux.expv.lo[:, v:v + 1], evl)
    ev = DF(evh[..., :, None], evl[..., :, None])        # (nfl, ns, 1)
    return df32.mul(DF(aux.expK.hi[None], aux.expK.lo[None]), ev)


# ----------------------------------------------------------------------
# df stack (identity-padded, transpose-suffix — see engine/sweep.py)
# ----------------------------------------------------------------------

def slot_get_df(stack: LDRdf, i) -> LDRdf:
    return jax.tree.map(
        lambda x: jax.lax.dynamic_index_in_dim(x, i, axis=1, keepdims=False),
        stack)


def slot_set_df(stack: LDRdf, i, F: LDRdf) -> LDRdf:
    return jax.tree.map(
        lambda x, v: jax.lax.dynamic_update_index_in_dim(x, v, i, axis=1),
        stack, F)


def _stack_inplace() -> bool:
    """Round-4 stretch-memory experiment (DQMC_STACK_INPLACE=1): build
    the sweep's new stack by writing each block's factor into a carried
    preallocated buffer (write-only carry + dynamic_update_index — the
    pattern XLA keeps in place) instead of emitting scan slots and
    assembling with a concatenate.  Removes one stack-sized buffer from
    the sweep's peak (the df stack is ~1.1 GB/walker at the 32x32
    stretch, and the slots+assembled+input triple is the W>=2 OOM).
    Read at TRACE time."""
    import os
    return os.environ.get("DQMC_STACK_INPLACE", "") in ("1", "on", "true")


def identity_stack_df(nfl: int, n_slots: int, ns: int) -> LDRdf:
    eye = jnp.tile(jnp.eye(ns, dtype=jnp.float32), (nfl, n_slots, 1, 1))
    z_m = jnp.zeros_like(eye)
    ones = jnp.ones((nfl, n_slots, ns), jnp.float32)
    z_v = jnp.zeros_like(ones)
    return LDRdf(DF(eye, z_m), DF(ones, z_v), DF(eye, z_m),
                 jnp.zeros((nfl, n_slots, ns), jnp.int32))


def identity_slot_df(nfl: int, ns: int) -> LDRdf:
    """One identity df LDR factor (the prefix/suffix chain seed)."""
    eye = jnp.tile(jnp.eye(ns, dtype=jnp.float32), (nfl, 1, 1))
    ones = jnp.ones((nfl, ns), jnp.float32)
    return LDRdf(DF(eye, jnp.zeros_like(eye)), DF(ones, jnp.zeros_like(ones)),
                 DF(eye, jnp.zeros_like(eye)), jnp.zeros((nfl, ns), jnp.int32))


def _eye_df(nfl: int, ns: int) -> DF:
    eye = jnp.tile(jnp.eye(ns, dtype=jnp.float32), (nfl, 1, 1))
    return DF(eye, jnp.zeros_like(eye))


def _transpose_df(x: DF) -> DF:
    return DF(jnp.swapaxes(x.hi, -1, -2), jnp.swapaxes(x.lo, -1, -2))


# ----------------------------------------------------------------------
# state
# ----------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DFWalkerState:
    """Markov-chain state of the hybrid parity engine.

    G is the f32 WORKING Green's function (what the site loop reads);
    G_df is its df32 twin, refreshed at every stabilization — parity-grade
    for the current fields, and what measurements should consume.
    """
    fields: jax.Array
    G: jax.Array
    G_df: DF
    stack: LDRdf
    log_det_M: jax.Array
    key: jax.Array
    acc_sum: jax.Array
    sign: jax.Array
    err_max: jax.Array
    err_sum: jax.Array
    err_count: jax.Array


# ----------------------------------------------------------------------
# stack rebuild (dqmc.cpp:43-72 in df)
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def rebuild_stack_df(aux: DFModelAux, cfg: EngineConfig, fields: jax.Array):
    """Full right-to-left df stack + G_df(0,0) + log_det from the fields."""
    nfl = aux.expv.hi.shape[0]
    ns = aux.expK.hi.shape[-1]
    eyeB = _eye_df(nfl, ns)

    # block-structured (see engine/sweep.py): the scan carries only the
    # previous suffix factor and emits each block's new df LDR
    # (sweep.stack_from_slots — no stack-sized carry copies)
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab

    def run_block(T_prev, n_slices, l0):
        Bbar = eyeB
        for k in range(n_slices):
            l = l0 + n_slices - 1 - k
            B = _slice_B_df(aux, jnp.take(fields, l, axis=0))
            Bbar = df32.matmul(Bbar, B)      # right-to-left: Bbar @ B_l
        return _mat_mul_ldr_df(_transpose_df(Bbar), T_prev)

    T0 = identity_slot_df(nfl, ns)
    tail = run_block(T0, rem, n_full * n_stab) if rem else None

    if _stack_inplace():
        n_blocks = n_full + (1 if rem else 0)
        stack0 = identity_stack_df(nfl, n_blocks + 2, ns)
        if rem:
            stack0 = slot_set_df(stack0, n_full + 1, tail)

        def scan_step_ip(carry, i):
            t, stack = carry
            T_new = run_block(t, n_stab, i * n_stab)
            return (T_new, slot_set_df(stack, i + 1, T_new)), None

        (T, stack), _ = jax.lax.scan(
            scan_step_ip, (tail if rem else T0, stack0),
            jnp.arange(n_full - 1, -1, -1, dtype=jnp.int32))
    else:
        def scan_step(t, i):
            T_new = run_block(t, n_stab, i * n_stab)
            return T_new, T_new

        from dqmc_tpu.engine.sweep import stack_from_slots
        T, slots = jax.lax.scan(
            scan_step, tail if rem else T0,
            jnp.arange(n_full - 1, -1, -1, dtype=jnp.int32))
        stack = stack_from_slots(slots, identity_slot_df(nfl, ns), tail,
                                 reverse=True)
    G_df, log_det = _inv_pair_df(identity_slot_df(nfl, ns), T)
    return stack, G_df, log_det


def init_state_df(model32, aux: DFModelAux, cfg: EngineConfig,
                  key: jax.Array) -> DFWalkerState:
    """Fresh walker: random HS field, df stack + G from it."""
    kf, kchain = jax.random.split(key)
    fields = hsfield.init_fields(kf, cfg.nt, model32.n_sites)
    stack, G_df, log_det = rebuild_stack_df(aux, cfg, fields)
    z = jnp.zeros((), jnp.float32)
    return DFWalkerState(
        fields=fields, G=G_df.hi, G_df=G_df, stack=stack,
        log_det_M=log_det, key=kchain, acc_sum=z,
        sign=jnp.ones((), jnp.float32), err_max=z, err_sum=z, err_count=z,
    )


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "forward", "update"))
def df_sweep(model32, aux: DFModelAux, cfg: EngineConfig,
             state: DFWalkerState, *, forward: bool = True,
             update: bool = True) -> DFWalkerState:
    """One Monte-Carlo sweep: f32 wraps + site updates, df stabilization.

    Structure identical to engine.sweep.sweep (dqmc.cpp:337-456); the
    df block product rides the scan carry alongside the f32 state, and
    stabilizations replace G with the df rebuild."""
    nfl, ns = model32.n_flavor, model32.n_sites
    eyeB = _eye_df(nfl, ns)

    def stabilize(F_prev, Bbar, i_stack):
        # chain factor carried; the opposite half-chain is read from the
        # NON-CARRIED input stack (see engine/sweep.py stack_from_slots)
        if forward:
            F_new = _mat_mul_ldr_df(Bbar, F_prev)
            G_df, log_det = _inv_pair_df(
                F_new, slot_get_df(state.stack, i_stack + 2))
        else:
            F_new = _mat_mul_ldr_df(_transpose_df(Bbar), F_prev)
            G_df, log_det = _inv_pair_df(slot_get_df(state.stack, i_stack),
                                         F_new)
        return G_df, F_new, log_det

    def slice_step(carry, l):
        (fields, G, Bbar, key, acc, sign) = carry
        fields_l = jnp.take(fields, l, axis=0)

        if forward:
            G = apply_invB_right(model32, fields_l,
                                 apply_B_left(model32, fields_l, G))

        if update:
            key, k_slice = jax.random.split(key)
            G, fields_l, acc_l, sgn_l = site_update(model32, cfg, k_slice,
                                                    G, fields_l)
            sign = sign * sgn_l
            acc = acc + acc_l / cfg.nt
            fields = fields.at[l].set(fields_l)

        B_df = _slice_B_df(aux, fields_l)
        if forward:
            Bbar = df32.matmul(B_df, Bbar)
        else:
            G = apply_B_right(model32, fields_l,
                              apply_invB_left(model32, fields_l, G))
            Bbar = df32.matmul(Bbar, B_df)

        return (fields, G, Bbar, key, acc, sign)

    # block-structured scan (see engine/sweep.py): the per-slice lax.cond
    # it replaces copied the full cond carry — including the df stack's
    # six (nfl, n_slots, ns, ns) leaves — every slice
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab

    def run_block(carry, i_stack, n_slices, l0):
        (fields, G, G_df, F_prev, log_det_M, key, acc, sign, emax, esum,
         ecnt) = carry
        c6 = (fields, G, eyeB, key, acc, sign)
        for k in range(n_slices):
            l = l0 + (k if forward else n_slices - 1 - k)
            c6 = slice_step(c6, l)
        fields, G, Bbar, key, acc, sign = c6
        G_df, F_new, log_det_M = stabilize(F_prev, Bbar, i_stack)
        err = jnp.max(jnp.abs(G - G_df.hi))
        emax = jnp.maximum(emax, err)
        esum = esum + err
        ecnt = ecnt + jnp.ones((), jnp.float32)
        return (fields, G_df.hi, G_df, F_new, log_det_M, key, acc, sign,
                emax, esum, ecnt)

    def tail_block(carry):
        return run_block(carry, jnp.int32(n_full), rem, n_full * n_stab)

    carry = (state.fields, state.G, state.G_df, identity_slot_df(nfl, ns),
             state.log_det_M, state.key, state.acc_sum, state.sign,
             state.err_max, state.err_sum, state.err_count)
    i_stacks = jnp.arange(n_full, dtype=jnp.int32)
    tail = None
    if _stack_inplace():
        n_blocks = n_full + (1 if rem else 0)
        stack0 = identity_stack_df(nfl, n_blocks + 2, ns)

        def block_step_ip(cs, i_stack):
            carry, stack = cs
            carry = run_block(carry, i_stack, n_stab, i_stack * n_stab)
            return (carry, slot_set_df(stack, i_stack + 1, carry[3])), None

        if forward:
            (carry, stack), _ = jax.lax.scan(block_step_ip,
                                             (carry, stack0), i_stacks)
            if rem:
                carry = tail_block(carry)
                stack = slot_set_df(stack, n_full + 1, carry[3])
        else:
            if rem:
                carry = tail_block(carry)
                stack0 = slot_set_df(stack0, n_full + 1, carry[3])
            (carry, stack), _ = jax.lax.scan(block_step_ip,
                                             (carry, stack0),
                                             i_stacks[::-1])
    else:
        def block_step(carry, i_stack):
            carry = run_block(carry, i_stack, n_stab, i_stack * n_stab)
            return carry, carry[3]

        from dqmc_tpu.engine.sweep import stack_from_slots
        if forward:
            carry, slots = jax.lax.scan(block_step, carry, i_stacks)
            if rem:
                carry = tail_block(carry)
                tail = carry[3]
        else:
            if rem:
                carry = tail_block(carry)
                tail = carry[3]
            carry, slots = jax.lax.scan(block_step, carry, i_stacks[::-1])
        stack = stack_from_slots(slots, identity_slot_df(nfl, ns), tail,
                                 reverse=not forward)
    (fields, G, G_df, _, log_det_M, key, acc, sign, emax, esum,
     ecnt) = carry
    return dataclasses.replace(
        state, fields=fields, G=G, G_df=G_df, stack=stack,
        log_det_M=log_det_M, key=key, acc_sum=acc, sign=sign, err_max=emax,
        err_sum=esum, err_count=ecnt)


def df_sweep_pair(model32, aux: DFModelAux, cfg: EngineConfig,
                  state: DFWalkerState) -> DFWalkerState:
    """Forward + backward sweep (main.cpp:156-157)."""
    state = df_sweep(model32, aux, cfg, state, forward=True)
    return df_sweep(model32, aux, cfg, state, forward=False)


def f32_view(state: DFWalkerState):
    """The f32 ``WalkerState`` twin of a df walker (hi-rounded stack).

    Used to run the f32 unequal-time sweep on a df chain: each
    tau-resolved triplet reconstruction starts from df-accurate
    (f32-representation-limited) factors, so the tau data carries f32
    reconstruction noise but none of the f32 chain's accumulated drift.
    """
    from dqmc_tpu.engine.state import WalkerState
    from dqmc_tpu.ops.linalg import LDR
    # linearize the exponent-split ladder with the f32 path's own log
    # clamp (ops/linalg._log_clamp): beyond e^+-60 the f32 view is
    # saturated either way, and the clamp keeps it inf-free
    dm = state.stack.d.hi
    log_d = jnp.log(jnp.where(dm == 0, 1.0, dm)) \
        + jnp.float32(0.6931471805599453) * state.stack.e.astype(jnp.float32)
    d32 = jnp.where(dm == 0, 0.0, jnp.exp(jnp.clip(log_d, -60.0, 60.0)))
    return WalkerState(
        fields=state.fields, G=state.G,
        stack=LDR(state.stack.L.hi, d32, state.stack.R.hi),
        log_det_M=state.log_det_M, key=state.key, acc_sum=state.acc_sum,
        sign=state.sign, err_max=state.err_max, err_sum=state.err_sum,
        err_count=state.err_count)


def df_global_action(aux: DFModelAux, fields: jax.Array,
                     log_det_M: jax.Array, det_power: int = 2) -> jax.Array:
    """S({s}) at df accuracy for replica exchange (model.cpp:140-159).

    The fermionic part uses the df chain's log-det (itself df-grade);
    the bosonic part is the exact integer state-count dot with the f64
    per-state constants carried as df pairs in ``aux.act`` — total
    absolute error ~eps32 * |S|, versus the O(1..10) bias of an f32
    chain's log-det that forces the f32 PT path onto f64 rebuilds.
    """
    counts = jnp.stack([jnp.count_nonzero(fields == v)
                        for v in range(4)]).astype(jnp.float32)
    prod = df32.mul(aux.act, df32.df(counts))
    tot = DF(jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))
    for v in range(4):
        tot = df32.add(tot, DF(prod.hi[v], prod.lo[v]))
    s_ferm = -det_power * jnp.sum(log_det_M)
    return s_ferm + tot.hi + tot.lo
