"""Unequal-time Green's-function sweep (dqmc.cpp:458-514, 223-280).

With the HS fields frozen (this sweep runs after the equal-time update
sweeps, main.cpp:156-158), propagate the triplet

    Gtt(tau) = G(tau,tau),   Gt0(tau) = G(tau,0),   G0t(tau) = G(0,tau)

forward through all slices, restabilizing every block from the LDR pair
(B(tau,0), B(beta,tau)):

    Gtt = [I + Bt0 Bbt]^-1,  Gt0 = [Bt0^-1 + Bbt]^-1,  G0t = -[Bbt^-1 + Bt0]^-1

Because the stack slots are identity-padded (see engine/sweep.py), the
tau = beta endpoint needs no special case: with Bbt = Id the three formulas
reduce exactly to the reference's l == nt-1 branch (dqmc.cpp:265-274).

The scan emits per-tau measurement inputs.  By default it stacks the full
(nt+1)-slice Green's functions (matching the reference's GF struct,
stackngf.h:15-29); callers that cannot afford O(nt * ns^2) memory can pass
a ``measure_fn`` that is applied per-tau inside the scan so only the
reduced observables are materialized.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from dqmc_tpu.engine.state import EngineConfig, WalkerState
from dqmc_tpu.engine.sweep import (
    _mat_mul_ldr_f,
    identity_stack,
    slot_get,
)
from dqmc_tpu.models.kinetic import apply_B_left, apply_invB_right
from dqmc_tpu.ops.linalg import LDR, inv_triplet_dag

_inv_triplet_f = jax.vmap(inv_triplet_dag)


class TauGreens(NamedTuple):
    """Per-tau Green's functions, leading (nt+1,) tau axis then (nfl, ns, ns)."""

    Gtt: jax.Array
    Gt0: jax.Array
    G0t: jax.Array


@partial(jax.jit, static_argnames=("cfg", "measure_fn", "warp"))
def sweep_unequal_time(model, cfg: EngineConfig, state: WalkerState,
                       measure_fn: Optional[Callable] = None,
                       warp: bool = False):
    """Returns (ys, err_max) where ys is ``TauGreens`` stacked over
    tau = 0..nt when measure_fn is None, else the stacked per-tau results of
    ``measure_fn(Gtt, Gt0, G0t)`` (tau axis leading, tau = 0..nt).

    Must be called right after a backward sweep: the stack then holds
    suffix products B(beta, tau) and state.G is G(0,0).

    warp=True applies the symmetric-Trotter half-warp to every Green's
    function seen by the measurement — the reference warps Gtt AND Gt0/G0t
    per tau when unequal-time measurement is on (dqmc.cpp:300-312); the
    propagation/stabilization itself always runs on the unwarped functions.
    """
    nfl, ns = model.n_flavor, model.n_sites
    dtype = model.dtype
    eye = jnp.eye(ns, dtype=dtype)
    eyeB = jnp.tile(eye, (nfl, 1, 1))

    G00 = state.G
    # tau = 0 seeding (dqmc.cpp:235-239): Gt0(0) = G(0,0), G0t(0) = G - I
    Gtt0, Gt00, G0t0 = G00, G00, G00 - eye

    if measure_fn is None:
        emit = lambda a, b, c, g00: TauGreens(a, b, c)
    else:
        emit = measure_fn

    if warp:
        from dqmc_tpu.engine.sweep import half_warp
        raw_emit = emit

        def emit(a, b, c, g00):
            return raw_emit(half_warp(model, a), half_warp(model, b),
                            half_warp(model, c), half_warp(model, g00))

    # Block-structured scan: the stabilization schedule is STATIC (stab at
    # each stack's last slice, dqmc.cpp:369), so the sweep scans over
    # stacks with the n_stab propagation slices unrolled inline and the
    # restabilization placed at the block end — no per-slice lax.cond.
    # The cond formulation (still used by the chunked iterator, whose tau
    # boundaries don't align with stacks) costs ~6 full-GF carry copies
    # per slice.
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab
    emit3 = lambda a, b, c: emit(a, b, c, G00)

    prop = _uneq_prop(model, state)
    stab = _uneq_stab(state, eyeB)

    def block(carry, i_stack, n_slices):
        l0 = i_stack * n_stab
        cs = []
        err = jnp.zeros((), dtype)
        for k in range(n_slices):
            carry = prop(carry, l0 + k)
            if k == n_slices - 1:
                carry, err = stab(carry, i_stack)
            cs.append((carry[0], carry[1], carry[2]))
        # ONE measurement emit per block, vmapped over the stacked slice
        # axis: the per-tau reductions become (n_slices)-batched matmuls
        # (better matmul shapes) and the scan body carries a single emit's HLO
        # instead of n_stab unrolled copies (cold compile time)
        triplets = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *cs)
        ys = jax.vmap(emit3)(*triplets)
        return carry, ys, err

    def scan_body(c, i_stack):
        carry, emax = c
        carry, ys, err = block(carry, i_stack, n_stab)
        return (carry, jnp.maximum(emax, err)), ys

    Bt0_init = slot_get(identity_stack(nfl, 1, ns, dtype), 0)
    carry0 = (Gtt0, Gt00, G0t0, Bt0_init, eyeB)
    (carry, err_max), ys = jax.lax.scan(
        scan_body, (carry0, jnp.zeros((), dtype)),
        jnp.arange(n_full, dtype=jnp.int32))
    ys = jax.tree_util.tree_map(
        lambda a: a.reshape((n_full * n_stab,) + a.shape[2:]), ys)
    if rem:
        carry, ys_t, err_t = block(carry, jnp.int32(n_full), rem)
        err_max = jnp.maximum(err_max, err_t)
        ys = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a, b], axis=0), ys, ys_t)

    y0 = emit(Gtt0, Gt00, G0t0, G00)
    ys = jax.tree_util.tree_map(
        lambda first, rest: jnp.concatenate([first[None], rest], axis=0),
        y0, ys)
    return ys, err_max


def iter_unequal_time(model, cfg: EngineConfig, state: WalkerState,
                      tau_chunk: int = 16, warp: bool = False):
    """Stream the tau-resolved Green's functions in bounded device memory.

    The full ``TauGreens`` stack is O(3 * nt * nfl * ns^2) — ~4 GB per
    walker at L=32, beta=16 — so large lattices cannot materialize it on
    device.  This generator runs the exact same propagation/stabilization
    chain as ``sweep_unequal_time`` in jitted scan segments of ``tau_chunk``
    slices, yielding ``(tau_start, TauGreens_chunk)`` with the chunk pulled
    to host numpy before the next segment runs.  Chunks concatenate to the
    unchunked result exactly (the scan carry crosses chunk boundaries
    unchanged); tau = 0 is included in the first chunk, so chunk c covers
    tau = [c == 0 ? 0 : c*tau_chunk + 1 .. min((c+1)*tau_chunk, nt)].

    Same contract as sweep_unequal_time: call right after a backward sweep.
    """
    import numpy as np

    nfl, ns = model.n_flavor, model.n_sites
    dtype = model.dtype
    eye = jnp.eye(ns, dtype=dtype)
    eyeB = jnp.tile(eye, (nfl, 1, 1))
    G00 = state.G
    Gtt0, Gt00, G0t0 = G00, G00, G00 - eye

    carry = (Gtt0, Gt00, G0t0,
             slot_get(identity_stack(nfl, 1, ns, dtype), 0), eyeB,
             jnp.zeros((), dtype))
    emit0 = _tau_emit(model, warp)
    first = jax.tree_util.tree_map(lambda x: np.asarray(x)[None],
                                   emit0(Gtt0, Gt00, G0t0))
    for start in range(0, cfg.nt, tau_chunk):
        n = min(tau_chunk, cfg.nt - start)
        carry, ys = _uneq_segment(model, cfg, state, carry, start, n=n,
                                  warp=warp)
        ys = jax.tree_util.tree_map(np.asarray, ys)
        if start == 0:
            ys = jax.tree_util.tree_map(
                lambda f, r: np.concatenate([f, r], axis=0), first, ys)
        yield start, ys


def _tau_emit(model, warp: bool):
    if not warp:
        return TauGreens
    from dqmc_tpu.engine.sweep import half_warp
    return lambda a, b, c: TauGreens(*(half_warp(model, x)
                                       for x in (a, b, c)))


@partial(jax.jit, static_argnames=("cfg", "n", "warp"))
def _uneq_segment(model, cfg, state, carry, start, *, n, warp):
    nfl, ns = model.n_flavor, model.n_sites
    eyeB = jnp.tile(jnp.eye(ns, dtype=model.dtype), (nfl, 1, 1))
    ls, i_stacks, do_stabs = cfg.slice_schedule(forward=True)
    xs = jax.tree_util.tree_map(
        lambda a: jax.lax.dynamic_slice_in_dim(jnp.asarray(a), start, n,
                                               axis=0),
        (ls, i_stacks, do_stabs))
    step = _uneq_step(model, cfg, state, _tau_emit(model, warp), eyeB)
    return jax.lax.scan(step, carry, xs)


def _uneq_prop(model, state):
    """One propagation slice on the (Gtt, Gt0, G0t, Bt0, Bbar) carry."""

    def prop(carry, l):
        Gtt, Gt0, G0t, Bt0, Bbar = carry
        fields_l = jnp.take(state.fields, l, axis=0)
        # batch the slice's five B-applications into two stacked GEMMs
        # (dqmc.cpp:223-246 does them one by one): B @ [Gtt, Gt0, Bbar]
        # left, then [B Gtt, G0t] @ B^{-1} right — same math, 2 matmul
        # dispatches per slice instead of 5 and expV built twice not five
        # times
        BL = apply_B_left(model, fields_l, jnp.stack([Gtt, Gt0, Bbar]))
        BR = apply_invB_right(model, fields_l, jnp.stack([BL[0], G0t]))
        return (BR[0], BL[1], BR[1], Bt0, BL[2])

    return prop


def _uneq_stab(state, eyeB):
    """Block-end restabilization of the triplet from (B(tau,0), B(beta,tau));
    returns the new carry and the check_error-style max deviation."""

    def stab(carry, i_stack):
        Gtt, Gt0, G0t, Bt0, Bbar = carry
        Bt0 = _mat_mul_ldr_f(Bbar, Bt0)
        Bbt = slot_get(state.stack, i_stack + 2)
        Gtt_n, Gt0_n, G0t_n, _ = _inv_triplet_f(Bt0, Bbt)
        err = jnp.maximum(
            jnp.max(jnp.abs(Gtt - Gtt_n)),
            jnp.maximum(jnp.max(jnp.abs(Gt0 - Gt0_n)),
                        jnp.max(jnp.abs(G0t - G0t_n))))
        return (Gtt_n, Gt0_n, G0t_n, Bt0, eyeB), err

    return stab


def _uneq_step(model, cfg, state, emit, eyeB):
    """The per-slice lax.cond scan body — used by the chunked iterator,
    whose tau-chunk boundaries do not align with stabilization blocks.
    (sweep_unequal_time itself uses the block-structured scan above, which
    avoids the cond's per-slice carry copies.)"""
    dtype = model.dtype
    prop = _uneq_prop(model, state)
    stab = _uneq_stab(state, eyeB)

    def step(carry, x):
        *c5, emax = carry
        l, i_stack, do_stab = x
        c5 = prop(tuple(c5), l)

        c5, err = jax.lax.cond(
            do_stab, lambda a: stab(a, i_stack),
            lambda a: (a, jnp.zeros((), dtype)), c5)
        emax = jnp.maximum(emax, err)
        return c5 + (emax,), emit(c5[0], c5[1], c5[2])

    return step
