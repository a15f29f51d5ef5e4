"""Walker/replica batching across devices.

The reference's only throughput parallelism is embarrassingly-parallel
Markov chains, one per MPI rank (SURVEY.md section 2: seed ``time+rank``,
per-rank output files, zero inter-rank communication).  The JAX
equivalent is layered:

- within a device: a leading walker axis handled by ``vmap`` (batched
  ns x ns GEMMs keep the device far busier than one chain can);
- across devices: the same walker axis sharded over a
  ``jax.sharding.Mesh``.  Independent chains need no collectives, so XLA
  partitions the jitted sweep with zero communication; parallel
  tempering's partner exchange is the only op that turns into a
  collective (see tempering.py).

Because the sweep engine is a pure function of pytrees, "multi-device" is
nothing but placing the walker axis on a mesh: no code in the engine
changes.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "walkers") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_walkers(tree, mesh: Mesh, axis: str = "walkers"):
    """Place the leading (walker/replica) axis of every leaf on the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(tree, sharding)


def stack_models(models: Sequence) -> object:
    """Stack per-replica model pytrees along a new leading axis (static
    metadata must agree; array leaves like expK/g/beta may differ per
    replica — that is how one beta per replica is expressed)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *models)
