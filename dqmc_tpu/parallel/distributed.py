"""Multi-host / multi-device initialization helpers.

The reference scales across nodes with ``mpirun -np N`` and raw MPI
(SURVEY.md section 5: MPI_Init/Sendrecv/Reduce over MPI_COMM_WORLD).  The
JAX equivalents:

- within a host: all GPUs appear as ``jax.devices()`` of one process;
  walkers/replicas shard over a 1-D Mesh axis and the only collective
  (the replica-exchange permutation) rides NVLink, which joins every card
  to every other, so the mesh follows the algorithm alone.
- across hosts: ``jax.distributed.initialize()`` forms the global runtime,
  after which the same Mesh code is unchanged.

Per-walker output files keep the reference's "pool offline" contract: each
process writes walkers [rank_offset, rank_offset + local_walkers) so the
analysis tool aggregates ``data_*.h5`` from any number of hosts exactly as
it aggregates the reference's MPI ranks.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize the multi-host JAX runtime (no-op for single-process).

    Pass coordinator_address (host:port), num_processes and process_id
    explicitly ([distributed] section of parameters.in).
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)


def global_walker_mesh(axis: str = "walkers") -> Mesh:
    """1-D mesh over every device of every host."""
    return Mesh(np.array(jax.devices()), (axis,))


def local_rank_offset(walkers_per_device: int) -> int:
    """First output-file index owned by this process, mirroring the
    reference's per-rank file naming (measurementh5.h:294)."""
    local = jax.local_device_count() * walkers_per_device
    return jax.process_index() * local
