"""Measured 1-core CPU f64 denominator for the STRETCH workload.

The round-3 verdict (What's missing #2) called out that the stretch row's
"~115x" was a cost-model estimate (0.166 / 128 from the nt*ns^3 scaling
of the pinned headline denominator), not a measured number.  This runs
the same engine the pinned headline denominator used — 1 walker, f64,
one single-threaded XLA:CPU core (the stand-in for the reference's
sequential-MKL rank, BASELINE.md) — at the stretch shape
(32x32, beta=16, nt=320, n_stab=5) and prints the measured rate.

A sweep-pair at this shape is ~770 s of single-core f64 GEMMs, so the
protocol is 1 compile + 2 timed pairs (~30 min); the compute is
deterministic, so pair-to-pair spread is the only noise and is reported.

Usage:  JAX_PLATFORMS=cpu python tools/stretch_baseline.py [--pairs 2]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--L", type=int, default=32)
    p.add_argument("--beta", type=float, default=16.0)
    p.add_argument("--nt", type=int, default=320)
    p.add_argument("--n-stab", type=int, default=5)
    args = p.parse_args()

    from dqmc_tpu.engine import EngineConfig, init_state, sweep_pair
    from dqmc_tpu.lattice import square_lattice
    from dqmc_tpu.models import AttractiveHubbard

    lat = square_lattice(args.L, args.L)
    model = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0,
                                    beta=args.beta, nt=args.nt,
                                    dtype=jnp.float64)
    cfg = EngineConfig(nt=args.nt, n_stab=args.n_stab)
    t0 = time.perf_counter()
    state = init_state(model, cfg, jax.random.PRNGKey(0))
    jax.block_until_ready(state.G)
    print(f"init: {time.perf_counter() - t0:.1f}s", flush=True)

    step = jax.jit(lambda s: sweep_pair(model, cfg, s))
    t0 = time.perf_counter()
    compiled = step.lower(state).compile()
    print(f"compile: {time.perf_counter() - t0:.1f}s", flush=True)

    rates = []
    for i in range(args.pairs):
        t0 = time.perf_counter()
        state = compiled(state)
        jax.block_until_ready(state.G)
        dt = time.perf_counter() - t0
        rates.append(1.0 / dt)
        print(f"pair {i}: {dt:.1f}s -> {1.0 / dt:.5f} pairs/s", flush=True)
    med = sorted(rates)[len(rates) // 2]
    print(json.dumps({
        "metric": (f"stretch CPU f64 baseline ({args.L}x{args.L} "
                   f"beta={args.beta} nt={args.nt}, 1 walker, 1 core)"),
        "cpu_sweeps_per_sec": med,
        "spread": (max(rates) - min(rates)) / 2,
        "pairs": args.pairs,
    }))


if __name__ == "__main__":
    main()
