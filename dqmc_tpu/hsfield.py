"""Discrete 4-state Gauss–Hermite-quadrature Hubbard–Stratonovich field.

Capability mirror of the reference ``GHQField`` (include/field.h:13-84): the
four field states s in {0,1,2,3} carry quadrature weights gamma(s) and node
values eta(s); a proposal picks one of the other three states uniformly.

Design: the field configuration is a plain ``int32`` array of
shape ``(nt, n_sites)`` inside the walker-state pytree (batchable with a
leading walker axis); gamma/eta are tiny constant lookup tables, and
proposals are drawn with explicit ``jax.random`` key threading (the
reference's RNG-stream discipline is accidental — it advances a *copy* of
the generator, field.h:26,76 — which we deliberately do not reproduce).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

_S6 = math.sqrt(6.0)

# gamma/eta tables for states 0..3 (field.h:36-43)
GAMMA = np.array(
    [1.0 - _S6 / 3.0, 1.0 + _S6 / 3.0, 1.0 + _S6 / 3.0, 1.0 - _S6 / 3.0]
)
ETA = np.array(
    [
        -math.sqrt(2.0 * (3.0 + _S6)),
        -math.sqrt(2.0 * (3.0 - _S6)),
        math.sqrt(2.0 * (3.0 - _S6)),
        math.sqrt(2.0 * (3.0 + _S6)),
    ]
)

# PROPOSAL[old, r] = new state, r uniform in {0,1,2} (field.h:45-48)
PROPOSAL = np.array(
    [[1, 2, 3],
     [0, 2, 3],
     [0, 1, 3],
     [0, 1, 2]],
    dtype=np.int32,
)

N_STATES = 4


def init_fields(key: jax.Array, nt: int, n_sites: int) -> jax.Array:
    """Random initial configuration, uniform over the 4 states (field.h:52-57)."""
    return jax.random.randint(key, (nt, n_sites), 0, N_STATES, dtype=jnp.int32)


def propose_new_fields(key: jax.Array, old: jax.Array) -> jax.Array:
    """Propose one of the other 3 states, uniformly, elementwise.

    `old` may have any shape; one independent proposal per element.
    """
    r = jax.random.randint(key, old.shape, 0, 3, dtype=jnp.int32)
    table = jnp.asarray(PROPOSAL)
    return table[old, r]


def select4(table: jax.Array, idx: jax.Array) -> jax.Array:
    """table[idx] for a 4-entry table as a where-select chain.

    Four elementwise selects fuse into the surrounding elementwise work,
    where an indexed lookup would be a gather."""
    out = jnp.full(idx.shape, table[0], table.dtype)
    for k in range(1, 4):
        out = jnp.where(idx == k, table[k], out)
    return out


def log_gamma_eta_sums(fields: jax.Array, g: jax.Array, alpha: float):
    """(sum_i alpha*g*eta(s_i), sum_i log gamma(s_i)) over all field entries.

    The bosonic and quadrature-weight pieces of the global action
    (model.cpp:147-157).
    """
    eta = jnp.asarray(ETA, dtype=g.dtype)
    gamma = jnp.asarray(GAMMA, dtype=g.dtype)
    log_boson = alpha * g * jnp.sum(eta[fields])
    log_gamma = jnp.sum(jnp.log(gamma[fields]))
    return log_boson, log_gamma
