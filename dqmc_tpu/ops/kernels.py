"""Hopper site-update kernel: one time slice's Metropolis loop per launch.

Each time slice makes ns sequential single-site decisions.  Under XLA every
decision is a loop iteration of several small GPU kernels, so the loop is
bound by launch latency rather than arithmetic.  This module runs the whole
slice as ONE Pallas program per walker, compiled through Triton:

- the walker's Green's function stays in device memory (16 walkers x
  256 KiB at ns=256 sit in the 50 MB L2); each site loads row i and
  column i of G;
- accepted rank-1 updates accumulate in delayed-update buffers
  U^T, V (k x ns_pad), carried through the site loop as register values
  (effective row/column of G at O(k ns) per site, as in
  engine.sweep.local_update_slice_delayed);
- every k sites the buffers flush as G += U V, in row tiles with a
  full-precision tiled dot.

Lattices are padded to a power-of-two lane width (Triton blocks) with zero
rows/columns that no decision touches.  The random stream (visit order
shared by the batch, per-walker proposals and uniforms) is drawn outside
with jax.random and passed in, so given the same stream the kernel
realizes the exact chain of engine.sweep.local_update_core.

Single stored flavor (spin-symmetric attractive model, det_power = 2)
only; the coupling scalars (g, alpha) are per walker, so a
replica-by-walker tempering batch runs as one launch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from dqmc_tpu import hsfield, platform

# Largest lattice the kernel serves: the two (k, ns_pad) buffers live in
# registers, 2 * 32 * 256 floats over _NUM_WARPS * 32 threads.
MAX_SITES = 256
_NUM_WARPS = 8
_ROW_TILE = 32


def padded_sites(ns: int) -> int:
    """Lane width of the kernel's blocks: the next power of two, at least
    16 (the smallest operand a Triton dot takes)."""
    return max(16, 1 << (ns - 1).bit_length())


def flush_rank(k_delay: int, ns_pad: int) -> int:
    """Delayed-update rank the kernel runs: a power of two in [16, 32]
    (dot operands need >= 16 rows), and no wider than the lattice."""
    k = 16 if k_delay <= 16 else 32
    return min(k, ns_pad)


def _lut(table, s, dtype):
    out = jnp.asarray(float(table[0]), dtype)
    for v in range(1, 4):
        out = jnp.where(s == v, jnp.asarray(float(table[v]), dtype), out)
    return out


def _site_kernel(ns, k, interpret, ga_ref, order_ref, props_ref, us_ref,
                 fields_in_ref, g_in_ref, g_ref, fields_ref, acc_ref,
                 ut_ref):
    """Program w: walker w's full slice.

    ga (W, 2) = per-walker [g, alpha]; order (nb*k,) shared visit order;
    props/us (W, nb*k) per-walker streams; fields (W, np); G (W, np, np)
    updated in place (g_in aliases g); acc (W,); ut (W, k, np) is the
    staging buffer the flush reads U^T tiles from.
    """
    del g_in_ref  # aliased with g_ref
    w = pl.program_id(0)
    n_pad = g_ref.shape[-1]
    n_blocks = order_ref.shape[0] // k
    dtype = g_ref.dtype
    tile = min(_ROW_TILE, n_pad)
    g_hs = ga_ref[w, 0]
    alpha = ga_ref[w, 1]
    lanes = jax.lax.iota(jnp.int32, n_pad)
    slots = jax.lax.iota(jnp.int32, k)
    zero = jnp.asarray(0.0, dtype)
    one = jnp.asarray(1.0, dtype)

    def barrier():
        # stores to G / ut by some threads must be visible to the loads
        # of others; the interpreter runs sequentially and needs none
        if not interpret:
            pltriton.debug_barrier()

    def block(b, carry):
        fields, acc = carry

        def site(t, c):
            ut, v, fields, acc = c
            idx = b * k + t
            i = order_ref[idx]
            r = props_ref[w, idx]
            u = us_ref[w, idx]
            onehot = lanes == i
            old = jnp.sum(jnp.where(onehot, fields, 0), dtype=jnp.int32)
            new = r + (r >= old).astype(jnp.int32)   # hsfield.PROPOSAL
            d_eta = (_lut(hsfield.ETA, new, dtype)
                     - _lut(hsfield.ETA, old, dtype))
            gamma_r = (_lut(hsfield.GAMMA, new, dtype)
                       / _lut(hsfield.GAMMA, old, dtype))
            boson_r = jnp.exp(alpha * g_hs * d_eta)
            delta = jnp.expm1(g_hs * d_eta)
            # effective row/column of G under the pending rank-t update
            sel = onehot[None, :]
            ucoef = jnp.sum(jnp.where(sel, ut, zero), axis=1)   # U[i, :]
            vcoef = jnp.sum(jnp.where(sel, v, zero), axis=1)    # V[:, i]
            row = g_ref[w, i, :] + jnp.sum(ucoef[:, None] * v, axis=0)
            col = g_ref[w, :, i] + jnp.sum(vcoef[:, None] * ut, axis=0)
            g_ii = jnp.sum(jnp.where(onehot, row, zero))
            r_flv = one + (one - g_ii) * delta
            ratio = gamma_r * boson_r * r_flv * r_flv
            accept = (idx < ns) & (u < jnp.minimum(one, jnp.abs(ratio)))
            prefac = jnp.where(accept, delta / r_flv, zero)
            hit = (slots == t)[:, None]
            ut = jnp.where(hit, (prefac * col)[None, :], ut)
            v = jnp.where(hit, (row - onehot.astype(dtype))[None, :], v)
            fields = jnp.where(onehot & accept, new, fields)
            return ut, v, fields, acc + accept.astype(dtype)

        buf = jnp.zeros((k, n_pad), dtype)
        ut, v, fields, acc = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(k), site, (buf, buf, fields, acc))

        # flush G += U V = ut^T v, one row tile at a time
        ut_ref[w, :, :] = ut
        barrier()

        def flush(j, carry):
            rows = pl.ds(pl.multiple_of(j * tile, tile), tile)
            g_ref[w, rows, :] += jax.lax.dot_general(
                ut_ref[w, :, rows], v, (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=dtype)
            return carry

        jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_pad // tile), flush,
                          jnp.int32(0))
        barrier()
        return fields, acc

    fields, acc = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(n_blocks), block,
        (fields_in_ref[w, :], jnp.asarray(0.0, dtype)))
    fields_ref[w, :] = fields
    acc_ref[w] = acc / ns


@functools.partial(jax.jit, static_argnames=("k_delay", "interpret"))
def site_update_batched(g_vec: jax.Array, alpha_vec: jax.Array,
                        keys: jax.Array, G: jax.Array, fields: jax.Array, *,
                        k_delay: int = 32, interpret: bool = False):
    """One slice's site update for a flat batch of walkers.

    g_vec/alpha_vec: (W,) per-walker coupling scalars; keys: (W, ...);
    G: (W, 1, ns, ns); fields: (W, ns).  The visit order is shared across
    the batch (drawn from keys[0]; state-independent, so each chain is
    still exactly Metropolis); proposals and uniforms are per walker.
    Returns (G, fields, acc (W,)).

    interpret=True runs the kernel in the Pallas interpreter (tests); the
    compiled kernel needs a GPU and raises elsewhere.
    """
    from dqmc_tpu.engine.sweep import draw_slice_randoms

    W, nfl, ns, _ = G.shape
    if nfl != 1:
        raise ValueError("the site kernel serves one stored flavor")
    if ns > MAX_SITES:
        raise ValueError(f"the site kernel serves ns <= {MAX_SITES}, "
                         f"got {ns}")
    if not interpret:
        platform.require_gpu("the Triton site-update kernel")
    dtype = G.dtype
    n_pad = padded_sites(ns)
    k = flush_rank(k_delay, n_pad)
    n_stream = -(-ns // k) * k

    order, _, _ = draw_slice_randoms(keys[0], ns, dtype)
    _, props, us = jax.vmap(lambda kk: draw_slice_randoms(kk, ns, dtype))(
        keys)
    tail = n_stream - ns
    order = jnp.pad(order.astype(jnp.int32), (0, tail))
    props = jnp.pad(props.astype(jnp.int32), ((0, 0), (0, tail)))
    us = jnp.pad(us, ((0, 0), (0, tail)), constant_values=1.0)
    pad = n_pad - ns
    G_p = jnp.pad(G.reshape(W, ns, ns), ((0, 0), (0, pad), (0, pad)))
    f_p = jnp.pad(fields.astype(jnp.int32), ((0, 0), (0, pad)))
    ga = jnp.stack([g_vec.astype(dtype), alpha_vec.astype(dtype)], axis=1)

    G_new, f_new, acc, _ = pl.pallas_call(
        functools.partial(_site_kernel, ns, k, interpret),
        out_shape=(
            jax.ShapeDtypeStruct((W, n_pad, n_pad), dtype),
            jax.ShapeDtypeStruct((W, n_pad), jnp.int32),
            jax.ShapeDtypeStruct((W,), dtype),
            jax.ShapeDtypeStruct((W, k, n_pad), dtype),
        ),
        grid=(W,),
        input_output_aliases={5: 0},
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="dqmc_site_update",
    )(ga, order, props, us, f_p, G_p)

    return (G_new[:, None, :ns, :ns], f_new[:, :ns].astype(fields.dtype),
            acc)


def metropolis_slice_update_batched(model, keys: jax.Array, G: jax.Array,
                                    fields: jax.Array, *, k_delay: int = 32,
                                    interpret: bool = False):
    """site_update_batched for one (unbatched) model: its coupling scalars
    broadcast over the walker axis."""
    W = G.shape[0]
    g_vec = jnp.broadcast_to(model.g, (W,))
    alpha_vec = jnp.broadcast_to(model.alpha, (W,))
    return site_update_batched(g_vec, alpha_vec, keys, G, fields,
                               k_delay=k_delay, interpret=interpret)


# ----------------------------------------------------------------------
# vmap-aware entry point
# ----------------------------------------------------------------------
#
# site_update_fn(...)(model, key, G, fields_l) is a per-walker site update;
# the first vmap over it dispatches to the flat batched kernel with
# per-walker coupling scalars, and every further vmap (replica axes,
# nested walker axes) flattens into the same batch, so a tempering
# ladder's replicas x walkers run as ONE launch.


def _ensure(x, batched, B):
    return x if batched else jnp.broadcast_to(x[None], (B,) + jnp.shape(x))


@functools.lru_cache(maxsize=None)
def site_update_fn(k_delay: int = 32, interpret: bool = False):
    """The per-walker, vmap-flattening site update (see above)."""

    @jax.custom_batching.custom_vmap
    def flat(g, alpha, keys, G, fields):
        return site_update_batched(g, alpha, keys, G, fields,
                                   k_delay=k_delay, interpret=interpret)

    @flat.def_vmap
    def _flat_vmap(axis_size, in_batched, g, alpha, keys, G, fields):
        B = axis_size
        g, alpha, keys, G, fields = (
            _ensure(x, b, B) for x, b in zip((g, alpha, keys, G, fields),
                                             in_batched))
        W = G.shape[1]
        Gn, fn, an = flat(g.reshape(B * W), alpha.reshape(B * W),
                          keys.reshape((B * W,) + keys.shape[2:]),
                          G.reshape((B * W,) + G.shape[2:]),
                          fields.reshape((B * W,) + fields.shape[2:]))
        out = (Gn.reshape(G.shape), fn.reshape(fields.shape),
               an.reshape(B, W))
        return out, (True, True, True)

    @jax.custom_batching.custom_vmap
    def per_walker(model, key, G, fields_l):
        G1, f1, a1 = flat(model.g.reshape(1), model.alpha.reshape(1),
                          key[None], G[None], fields_l[None])
        return G1[0], f1[0], a1[0]

    @per_walker.def_vmap
    def _per_walker_vmap(axis_size, in_batched, model, key, G, fields_l):
        W = axis_size
        mb = in_batched[0]
        # only the coupling scalars of the model enter the site update
        g = model.g if mb.g else jnp.broadcast_to(model.g, (W,))
        alpha = model.alpha if mb.alpha else jnp.broadcast_to(model.alpha,
                                                              (W,))
        out = flat(g, alpha, _ensure(key, in_batched[1], W),
                   _ensure(G, in_batched[2], W),
                   _ensure(fields_l, in_batched[3], W))
        return out, (True, True, True)

    return per_walker
