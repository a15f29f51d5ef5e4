"""dqmc_tpu — a Determinant Quantum Monte Carlo framework in JAX.

A ground-up JAX/XLA/Pallas re-design of auxiliary-field DQMC for Hubbard
models (capability reference: kfkq/DQMC, a C++17/MKL/MPI simulator).  The
compute path is functional JAX: imaginary-time sweeps are jitted
``lax.scan``s, Monte-Carlo walkers are a ``vmap`` axis, devices are a
``jax.sharding.Mesh`` axis, and parallel tempering rides collectives
(``ppermute``) instead of MPI point-to-point.  It runs on NVIDIA GPUs and,
for tests, on the CPU (dqmc_tpu.platform decides what runs where).

Package layout
--------------
- :mod:`dqmc_tpu.config`      — ``parameters.in`` INI parser (reference: include/utility.h:50-276)
- :mod:`dqmc_tpu.lattice`     — Bravais lattice geometry (reference: include/lattice.h)
- :mod:`dqmc_tpu.hsfield`     — Gauss–Hermite-quadrature HS field (reference: include/field.h)
- :mod:`dqmc_tpu.ops`         — numerically stable LDR linear algebra (reference: source/stablelinalg.cpp)
- :mod:`dqmc_tpu.models`      — Hamiltonians (reference: source/model.cpp)
- :mod:`dqmc_tpu.engine`      — sweep engine: propagation + stabilization (reference: source/dqmc.cpp)
- :mod:`dqmc_tpu.measure`     — observables, r/k transforms, binned accumulation (reference: include/measurementh5.h)
- :mod:`dqmc_tpu.io`          — HDF5 output compatible with the reference's analysis pipeline
- :mod:`dqmc_tpu.parallel`    — walker batching, device meshes, replica exchange (reference: source/update.cpp:34-117)
- :mod:`dqmc_tpu.analysis`    — jackknife post-processing (reference: scripts/analysis.py)
"""

__version__ = "0.1.0"

from dqmc_tpu.config import Parameters

__all__ = ["Parameters", "__version__"]
