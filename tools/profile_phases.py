"""Per-phase device-time breakdown of one DQMC sweep-pair.

Captures a jax.profiler trace of the configured workload on the current
backend, aggregates per-op device durations into engine phases, and prints
a table (plus one JSON line for dashboards).  Device time per phase comes
from the trace, not from host clocks around asynchronous dispatch.

Usage:  python tools/profile_phases.py [--L 16] [--beta 8] [--nt 160]
            [--n-stab 5] [--walkers 16]
            [--site-update auto|pallas|delayed|scan] [--dtype float32]
"""

import argparse
import collections
import glob
import gzip
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = [
    # (phase, substring patterns matched against XLA op names)
    ("site-update kernel", ("dqmc_site_update",)),
    ("QR/LU library calls", ("custom-call", "geqrf", "getrf", "trsm",
                             "cusolver", "cublas")),
    ("copies", ("copy",)),
    ("fusions (propagation, streams, misc)", ("fusion", "bitcast")),
]


def classify(name: str) -> str:
    for phase, pats in PHASES:
        if any(p in name for p in pats):
            return phase
    return "other"


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--beta", type=float, default=8.0)
    p.add_argument("--nt", type=int, default=160)
    p.add_argument("--n-stab", type=int, default=5)
    p.add_argument("--walkers", type=int, default=16)
    p.add_argument("--site-update",
                   choices=("auto", "pallas", "delayed", "scan"),
                   default="auto")
    p.add_argument("--dtype", choices=("float32", "float64", "df32"),
                   default="float32")
    p.add_argument("--top", type=int, default=0,
                   help="also print the N most expensive individual ops")
    p.add_argument("--uneq", action="store_true",
                   help="profile the unequal-time measurement sweep (with "
                        "the fused site->r measurement reduction) instead "
                        "of the equal-time sweep-pair")
    args = p.parse_args()

    import jax
    jax.config.update("jax_default_matmul_precision", "highest")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    from dqmc_tpu import compile_cache
    compile_cache.enable()
    import jax.numpy as jnp
    from dqmc_tpu import platform
    from dqmc_tpu.engine import EngineConfig, init_state, sweep_pair
    from dqmc_tpu.lattice import square_lattice
    from dqmc_tpu.models import AttractiveHubbard

    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    lat = square_lattice(args.L, args.L)
    model = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0,
                                    beta=args.beta, nt=args.nt, dtype=dtype)
    impl = (platform.site_update(model, dtype)
            if args.site_update == "auto" else args.site_update)
    cfg = EngineConfig.for_site_update(impl, nt=args.nt, n_stab=args.n_stab)
    keys = jax.random.split(jax.random.PRNGKey(0), args.walkers)
    if args.dtype == "df32":
        from dqmc_tpu.engine.df_sweep import (df_aux_build, df_sweep_pair,
                                              init_state_df)
        aux = df_aux_build(lat, U=4.0, t=1.0, mu=0.0, beta=args.beta,
                           nt=args.nt)
        states = jax.jit(jax.vmap(
            lambda k: init_state_df(model, aux, cfg, k)))(keys)
        step = jax.jit(jax.vmap(lambda s: df_sweep_pair(model, aux, cfg, s)))
    else:
        states = jax.jit(jax.vmap(lambda k: init_state(model, cfg, k)))(keys)
        step = jax.jit(jax.vmap(lambda s: sweep_pair(model, cfg, s)))
    states = step(states)
    jax.block_until_ready(states.G)

    if args.uneq:
        # profile the measured path instead: the unequal-time triplet sweep
        # with the fused per-tau site->r measurement reduction, exactly as
        # run.py's measurement loop invokes it (run.py:434-455)
        from dqmc_tpu.engine.uneqtime import sweep_unequal_time
        from dqmc_tpu.measure.manager import MeasurementManager
        manager = MeasurementManager(lat, n_walkers=args.walkers,
                                     measure_unequal=True, dtype=dtype,
                                     out_dir=tempfile.mkdtemp(
                                         prefix="dqmc_prof_out_"))
        manager.add_defaults()
        uneq_fn = manager.uneq_measure_fn
        step = jax.jit(jax.vmap(
            lambda s: sweep_unequal_time(model, cfg, s,
                                         measure_fn=uneq_fn)))
        ys, err = step(states)
        jax.block_until_ready(err)

    trace_dir = tempfile.mkdtemp(prefix="dqmc_prof_")
    jax.profiler.start_trace(trace_dir, create_perfetto_trace=True)
    if args.uneq:
        ys, err = step(states)
        jax.block_until_ready(err)
    else:
        states = step(states)
        jax.block_until_ready(states.G)
    jax.profiler.stop_trace()

    agg = collections.Counter()
    ops = collections.Counter()
    names = set()
    for fn in glob.glob(trace_dir + "/**/*.trace.json.gz", recursive=True):
        with gzip.open(fn, "rt") as fh:
            data = json.load(fh)
        pids = {ev["pid"]: ev["args"].get("name")
                for ev in data["traceEvents"]
                if ev.get("ph") == "M" and ev.get("name") == "process_name"}
        names.update(nm for nm in pids.values() if nm)
        dev = {pid for pid, nm in pids.items()
               if nm and ("GPU" in nm or "/device" in nm)}
        for ev in data["traceEvents"]:
            if ev.get("ph") != "X" or "dur" not in ev \
                    or ev.get("pid") not in dev:
                continue
            name = ev.get("name", "")
            # skip the enclosing program/while wrappers (double counting)
            if name.startswith(("jit_", "while", "cond", "body",
                                "condition")):
                continue
            ph = classify(name)
            agg[ph] += ev["dur"]
            ops[(ph, name.split("(")[0][:48])] += ev["dur"]
    shutil.rmtree(trace_dir, ignore_errors=True)
    if not agg:
        print(f"no device events; trace processes: {sorted(names)}",
              file=sys.stderr)

    total = sum(agg.values()) or 1
    eng = impl
    print(f"\nsweep-pair phase breakdown ({args.L}x{args.L} beta={args.beta} "
          f"nt={args.nt} n_stab={args.n_stab} W={args.walkers} "
          f"{args.dtype}, engine={eng}, backend={jax.default_backend()})")
    print(f"{'phase':42s} {'ms':>9s} {'share':>7s}")
    for phase, dur in agg.most_common():
        print(f"{phase:42s} {dur / 1e3:9.2f} {dur / total:7.1%}")
    print(f"{'TOTAL device time':42s} {total / 1e3:9.2f}")
    if args.top:
        print(f"\ntop {args.top} ops:")
        for (ph, name), dur in ops.most_common(args.top):
            print(f"  {dur / 1e3:8.2f} ms  [{ph:>8.8s}] {name}")
    print(json.dumps({"phases": {k: round(v / 1e3, 3)
                                 for k, v in agg.items()},
                      "total_ms": round(total / 1e3, 3),
                      "engine": eng}))


if __name__ == "__main__":
    main()
