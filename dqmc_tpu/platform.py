"""Which implementation runs where.

Every choice that depends on the machine is made here, from what JAX
reports (its default backend) and what the caller passes (dtype, model,
lattice size, sharding).  The program knows two machines: the CPU, where
the tests run, and an NVIDIA GPU, its accelerator.  Any other backend is
an error, not a default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SUPPORTED = ("cpu", "gpu")


def backend() -> str:
    name = jax.default_backend()
    if name not in SUPPORTED:
        raise RuntimeError(f"unsupported JAX backend {name!r}; dqmc_tpu runs "
                           f"on {' or '.join(SUPPORTED)}")
    return name


def on_gpu() -> bool:
    return backend() == "gpu"


def require_gpu(what: str) -> None:
    """Refuse to run a GPU-only path anywhere else.  A compiled GPU kernel
    never falls back to the Pallas interpreter: tests ask for that
    explicitly."""
    if not on_gpu():
        raise RuntimeError(f"{what} needs a GPU; the JAX backend is "
                           f"{jax.default_backend()!r}")


def default_dtype():
    """Sampling dtype when [simulation] dtype is not given.

    The GPU has native f64 units; f32 there is a speed choice whose cost in
    accuracy is pinned by tests/test_precision.py, not a necessity.  The
    CPU runs the f64 parity-grade engine."""
    return jnp.float32 if on_gpu() else jnp.float64


def site_update(model, dtype, *, sharded: bool = False) -> str:
    """Default site-update path for a model at a dtype.

    "pallas": the Triton site kernel (ops/kernels.py) — GPU, f32, one
    stored flavor with det_power 2, ns up to kernels.MAX_SITES, walkers on
    one device (the kernel takes the whole local batch in one launch; a
    sharded walker axis would need shard_map around it).
    "delayed": XLA rank-k delayed updates — every other GPU case.
    "scan": the rank-1 reference loop — the CPU.
    """
    from dqmc_tpu.ops.kernels import MAX_SITES

    if not on_gpu():
        return "scan"
    if (jnp.dtype(dtype) == jnp.float32 and model.n_flavor == 1
            and model.det_power == 2 and model.n_sites <= MAX_SITES
            and not sharded):
        return "pallas"
    return "delayed"


def jit_multiword() -> bool:
    """Whether multiword (df32/tf32) graphs may be compiled whole.

    XLA:CPU's LLVM codegen at optimization level > 0 contracts and
    reassociates across the error-free transformations (1.1e-8 -> 5.4e-4
    on the beta=8 rebuild), so on the CPU they run eagerly.  On the GPU
    they compile; chip_smoke.py checks the jitted chain against the eager
    one and against f64 on the card."""
    return backend() != "cpu"
