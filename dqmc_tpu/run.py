"""Simulation driver: the JAX equivalent of the reference's main()
(source/main.cpp:14-214).

Reads ``parameters.in`` from the working directory, runs thermalization and
measurement sweeps, and writes binned HDF5 output under ``results/``.

Where the reference parallelizes with one MPI rank per Markov chain, this
driver batches walkers with ``vmap`` on one device (section [walkers]);
scaling across devices and parallel tempering live in ``dqmc_tpu.parallel``.

Config schema (superset of the reference's, SURVEY.md section 5):
  [Lattice]            L1, L2, geometry (square|triangular|honeycomb, default square)
  [hubbard]            U, t, mu, model (attractive|repulsive, default
                       attractive), tp (next-nearest hopping, default 0),
                       checkerboard (default false)
  [simulation]         beta, nt, n_therms, n_sweeps, n_bins, n_stab,
                       symmetric (default false),
                       measure_spin (default false: spin-z/x correlation
                       matrices + spinzzTau when unequal-time is on),
                       measure_charge (default false: densityTau),
                       isMeasureUnequalTime, seed (default 42),
                       dtype (float32|float64|df32; default float64 on the
                       CPU, float32 on the GPU — a speed choice against the
                       card's native f64 units, see platform.default_dtype.
                       df32 = the hybrid double-float32 parity engine:
                       ~1e-8 fixed-field Green's-function accuracy from
                       f32 operations),
                       site_update (auto|pallas|delayed|scan|submatrix;
                       auto = platform.site_update), delay_rank,
                       measure_precision (engine|tf32|df32, default engine:
                       tf32 rebuilds every MEASURED Green's function —
                       equal-time G and, when isMeasureUnequalTime is on,
                       the full tau-resolved Gtt/Gt0/G0t triplet — from
                       the fields in triple-float32: <1e-10 vs exact,
                       below the f64 grade the reference itself measures
                       at, independent of the sampling dtype; 1- and
                       2-flavor models),
                       measure_n_stab / measure_uneq_n_stab (override the
                       rebuild fold strides; defaults documented in
                       engine/parity.py)
  [io]                 sink (h5|spool, default h5)
  [walkers]            n_walkers (default 1),
                       n_devices (0 = all visible devices, 1 = no sharding)
  [ParallelTempering]  enabled (default false), sweep_steps, betas
  [distributed]        coordinator_address, num_processes, process_id
                       (multi-host; all optional — single host needs none)
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu import platform
from dqmc_tpu.config import Parameters
from dqmc_tpu.engine import (EngineConfig, init_state, reset_error_stats,
                             sweep_pair, half_warp)
from dqmc_tpu.engine.uneqtime import sweep_unequal_time
from dqmc_tpu.lattice import make_lattice
from dqmc_tpu.measure import MeasurementManager
from dqmc_tpu.models import AttractiveHubbard


def _resolve_dtype(params: Parameters):
    """(dtype, df_mode) from [simulation] dtype.

    df32: the hybrid double-float32 parity engine (engine/df_sweep.py) —
    f32 wraps/site updates, df32 stack + stabilized inverses.
    Fixed-field Green's-function accuracy ~1e-8 at beta=8 from pure f32
    operations."""
    name = params.get_str("simulation", "dtype", "")
    if name in ("df32", "df"):
        return jnp.float32, True
    if name in ("float32", "f32"):
        return jnp.float32, False
    if name in ("float64", "f64"):
        # without the x64 flag the arrays silently truncate to f32 and the
        # run is NOT f64
        jax.config.update("jax_enable_x64", True)
        return jnp.float64, False
    dt = platform.default_dtype()
    if dt == jnp.float64:
        # the CPU default IS f64 — it needs the same x64 switch, or every
        # defaulted CPU run silently truncates to f32 (caught as a ~1e-2
        # steady-state self-check error on a run that claimed f64)
        jax.config.update("jax_enable_x64", True)
    return dt, False


def _parse_n_stab(params: Parameters):
    """(start_value, auto_flag) for [simulation] n_stab.

    `n_stab = auto` turns on driver-level adaptation (see run_simulation):
    the stabilization interval is tuned during thermalization to the
    loosest value whose steady-state naive-vs-stabilized error stays below
    the warn threshold — the automated version of the reference's "Reduce
    n_stab or increase nt" advice (dqmc.cpp:390-393)."""
    raw = params.get_str("simulation", "n_stab").strip().lower()
    if raw == "auto":
        return params.get_int("simulation", "n_stab_start", 5), True
    return params.get_int("simulation", "n_stab"), False


def make_engine_config(params: Parameters, model,
                       n_stab: Optional[int] = None, *,
                       sharded: bool = False) -> EngineConfig:
    """EngineConfig from the [simulation] section.

    site_update: 'auto' (default: platform.site_update picks from the
    backend, dtype, model and sharding), 'pallas' (the Triton site kernel,
    GPU only), 'delayed' or 'submatrix' (both take their block rank from
    delay_rank), or 'scan'.
    """
    nt = params.get_int("simulation", "nt")
    if n_stab is None:
        n_stab = _parse_n_stab(params)[0]
    engine = params.get_str("simulation", "engine", "auto")
    if engine not in ("auto", "slice"):
        raise ValueError(f"[simulation] engine = {engine} was removed: the "
                         f"slice engine is the only engine")
    impl = params.get_str("simulation", "site_update", "auto")
    if impl == "auto":
        impl = platform.site_update(model, model.dtype, sharded=sharded)
    if impl == "pallas":
        platform.require_gpu("site_update = pallas")
    return EngineConfig.for_site_update(
        impl, nt=nt, n_stab=n_stab,
        rank=params.get_int("simulation", "delay_rank", 32))


def site_update_name(cfg: EngineConfig) -> str:
    if cfg.use_pallas:
        return f"pallas (Triton kernel, rank {cfg.delay_rank})"
    if cfg.submatrix_rank:
        return f"submatrix (rank {cfg.submatrix_rank})"
    if cfg.delay_rank:
        return f"delayed (rank {cfg.delay_rank})"
    return "scan"


@dataclasses.dataclass
class RunSummary:
    n_walkers: int
    n_bins: int
    n_sweeps: int
    therm_seconds: float
    measure_seconds: float
    sweeps_per_sec: float          # full sweep-pairs/sec aggregated over walkers
    acc_rate: float
    max_precision_error: float     # steady-state (measurement phase only)
    mean_precision_error: float
    therm_max_precision_error: float = float("nan")
    exchange_rate: Optional[float] = None
    n_stab: int = 0                # final (possibly auto-adapted) value
    # wall time and sweep count of the FIRST measured segment (carries
    # the jit compile); sweeps_per_sec_steady excludes both
    first_segment_seconds: float = float("nan")
    sweeps_per_sec_steady: float = float("nan")
    # measurement-tier self-check (max over bins of the tier's
    # propagated-vs-stabilized error), separate from
    # max_precision_error (which, for an f32 chain, is dominated by the
    # SAMPLING engine's envelope): set when measure_precision != engine
    # and the tau-resolved tier runs; None otherwise
    tier_err_max: Optional[float] = None


def _maybe_init_distributed(params: Parameters) -> None:
    """Form the multi-host runtime when [distributed] asks for it.

    Replaces the reference's `mpirun -np N` + MPI_Init (main.cpp:20-28):
    after initialization every host's devices appear in jax.devices() and the
    walker mesh spans them transparently.  No-op in single-host runs."""
    from dqmc_tpu.parallel.distributed import initialize_distributed
    coord = params.get_str("distributed", "coordinator_address", "")
    nproc = params.get_int("distributed", "num_processes", 0)
    pid = params.get_int("distributed", "process_id", 0)
    initialize_distributed(coord or None, nproc or None,
                           pid if nproc else None)


def walker_devices(params: Parameters, n_batch: int) -> int:
    """Devices the leading walker/replica axis is sharded over: [walkers]
    n_devices (0 = all visible), 1 when that does not divide n_batch."""
    n_devices = params.get_int("walkers", "n_devices", 0)
    n_avail = len(jax.devices())
    ndev = n_avail if n_devices == 0 else min(n_devices, n_avail)
    if ndev > 1 and n_batch % ndev != 0:
        print(f"WARNING: {n_batch} walkers not divisible by {ndev} "
              f"devices; running unsharded on one device.", file=sys.stderr)
        return 1
    return max(ndev, 1)


def _shard_over_devices(states, n_walkers: int, ndev: int, all_devices: bool,
                        log):
    """Shard the leading walker axis over the device mesh (data parallelism
    over independent Markov chains — the reference's mpirun execution model,
    README.md:29-32).  Returns (states, rank_offset_for_output_files)."""
    from dqmc_tpu.parallel.distributed import (global_walker_mesh,
                                               local_rank_offset)
    from dqmc_tpu.parallel.walkers import make_mesh, shard_walkers
    if ndev <= 1:
        return states, 0
    mesh = global_walker_mesh() if all_devices else make_mesh(ndev)
    states = shard_walkers(states, mesh)
    offset = (local_rank_offset(n_walkers // ndev)
              if jax.process_count() > 1 else 0)
    log(f"Sharded {n_walkers} walkers over {ndev} devices "
        f"({jax.process_count()} process(es))")
    return states, offset


def _rank0_log(verbose: bool):
    """Rank-0-only logging, the utility::io::print_info analogue
    (utility.h:278-288): in multi-host runs only process 0 narrates."""
    if not verbose:
        return lambda *a, **k: None

    def log(*a, **k):
        if jax.process_index() == 0:
            print(*a, **k)
    return log


def global_stats(states) -> dict:
    """Cross-process aggregate run statistics (the MPI_Reduce analogue,
    main.cpp:186-187): jitted reductions over the (possibly multi-host
    sharded) walker axis with fully-replicated outputs, so every process
    can read them."""
    @jax.jit
    def reduce(s):
        return dict(
            acc_sum_mean=jnp.mean(s.acc_sum),
            err_max=jnp.max(s.err_max),
            err_sum=jnp.sum(s.err_sum),
            err_count=jnp.sum(s.err_count),
        )
    return {k: float(v) for k, v in reduce(states).items()}


def run_simulation(params: Parameters, *, out_dir: str = "results",
                   verbose: bool = True) -> RunSummary:
    # multi-host runtime must form before any backend query
    _maybe_init_distributed(params)
    log = _rank0_log(verbose)

    # persistent XLA cache for every entry point (tools import
    # run_simulation directly and would otherwise pay the multi-minute
    # cold compiles the CLI main() avoids); enable() is idempotent
    from dqmc_tpu import compile_cache
    compile_cache.enable()

    # On the GPU, f32 matmuls default to TF32 (~3 decimal digits) — fatal
    # for DQMC stabilization.  Full-precision accumulation is the only sane
    # default; override via [simulation] matmul_precision for experiments.
    jax.config.update("jax_default_matmul_precision",
                      params.get_str("simulation", "matmul_precision",
                                     "highest"))

    pt_enabled = params.get_bool("ParallelTempering", "enabled", False)
    if pt_enabled:
        from dqmc_tpu.parallel.tempering import run_parallel_tempering
        return run_parallel_tempering(params, out_dir=out_dir, verbose=verbose)

    dtype, df_mode = _resolve_dtype(params)
    measure_prec = params.get_str("simulation", "measure_precision",
                                  "engine")
    if measure_prec not in ("engine", "tf32", "df32"):
        raise ValueError(f"[simulation] measure_precision must be engine, "
                         f"tf32 or df32, got {measure_prec!r}")
    if measure_prec != "engine":
        # the f64 model twin and the f64 measurement G need real f64
        # arrays; the sampling engine keeps its own (f32/df32) dtypes
        jax.config.update("jax_enable_x64", True)
    n_sweeps = params.get_int("simulation", "n_sweeps")
    n_therms = params.get_int("simulation", "n_therms")
    n_bins = params.get_int("simulation", "n_bins")
    nt = params.get_int("simulation", "nt")
    n_stab, n_stab_auto = _parse_n_stab(params)
    symmetric = params.get_bool("simulation", "symmetric", False)
    uneq = params.get_bool("simulation", "isMeasureUnequalTime", False)
    seed = params.get_int("simulation", "seed", 42)
    n_walkers = params.get_int("walkers", "n_walkers", 1)

    lat = make_lattice(params.get_str("Lattice", "geometry", "square"),
                       params.get_int("Lattice", "L1"),
                       params.get_int("Lattice", "L2"))
    lat.save_info(os.path.join(out_dir, "info"))

    from dqmc_tpu.models import MODEL_REGISTRY
    model_name = params.get_str("hubbard", "model", "attractive")
    model_cls = MODEL_REGISTRY[model_name]
    model = model_cls.from_params(params, lat, dtype=dtype)
    df_aux = None
    if df_mode:
        from dqmc_tpu.engine.df_sweep import df_aux_build
        from dqmc_tpu.lattice import bonds_with_tp
        df_aux = df_aux_build(
            lat,
            U=params.get_float("hubbard", "U"),
            t=params.get_float("hubbard", "t"),
            mu=params.get_float("hubbard", "mu"),
            beta=float(model.beta), nt=nt,
            bonds=bonds_with_tp(
                params.get_str("Lattice", "geometry", "square"),
                params.get_float("hubbard", "tp", 0.0)),
            n_flavor=model.n_flavor)
    # adaptive n_stab + resume: the stack shape depends on n_stab, so the
    # adapted value must be known before states are built
    ckpt_every = params.get_int("simulation", "checkpoint_every", 0)
    ckpt_path = params.get_str("simulation", "checkpoint_path",
                               os.path.join(out_dir, "checkpoint.npz"))
    if n_stab_auto and ckpt_every > 0 and os.path.exists(ckpt_path):
        from dqmc_tpu.io.checkpoint import peek_meta
        n_stab = int(peek_meta(ckpt_path).get("n_stab", n_stab))
    ndev = walker_devices(params, n_walkers)
    cfg = make_engine_config(params, model, n_stab=n_stab,
                             sharded=ndev > 1)
    log(f"Standard DQMC run: {lat.L1}x{lat.L2} lattice, beta={float(model.beta)}, "
        f"nt={nt}, {n_walkers} walkers, "
        f"dtype={'df32' if df_mode else dtype.__name__}, "
        f"backend={jax.default_backend()}")

    keys = jax.random.split(jax.random.PRNGKey(seed), n_walkers)
    if df_mode:
        from dqmc_tpu.engine.df_sweep import init_state_df
        states = jax.vmap(lambda k: init_state_df(model, df_aux, cfg, k))(keys)
    else:
        states = jax.vmap(lambda k: init_state(model, cfg, k))(keys)

    # --- checkpoint / resume (absent in the reference; SURVEY.md section 5)
    start_bin = 0
    start_therm = 0
    therm_done = False
    if ckpt_every > 0 and os.path.exists(ckpt_path):
        from dqmc_tpu.io.checkpoint import load_checkpoint
        states, meta = load_checkpoint(ckpt_path, states)
        start_bin = int(meta["bin"])
        therm_done = bool(meta.get("therm_done", True))
        start_therm = int(meta.get("therm_sweep", 0))
        log(f"Resumed from {ckpt_path} at bin {start_bin}"
            + (f" (thermalization sweep {start_therm})"
               if not therm_done else ""))

    # multi-device: shard the walker axis (zero-communication data
    # parallelism)
    states, rank_offset = _shard_over_devices(
        states, n_walkers, ndev,
        params.get_int("walkers", "n_devices", 0) == 0, log)

    manager = MeasurementManager(lat, n_walkers=n_walkers,
                                 measure_unequal=uneq, out_dir=out_dir,
                                 dtype=dtype, start_bin=start_bin,
                                 rank_offset=rank_offset,
                                 file_mode="a" if start_bin else "w",
                                 sink=params.get_str("io", "sink", "h5"))
    manager.add_defaults()
    if params.get_bool("simulation", "measure_spin", False):
        manager.add_spin()
    if params.get_bool("simulation", "measure_charge", False):
        manager.add_charge()

    # runtime observability: reference warns when the naive-vs-stabilized
    # deviation exceeds 1e-6 (dqmc.cpp:390-393).  The threshold applies to
    # the STEADY-STATE error (stats reset after thermalization); f32 default
    # reflects the documented single-precision stabilization bound.
    err_warn = params.get_float(
        "simulation", "err_warn_threshold",
        1e-6 if dtype == jnp.float64 else 1e-2)
    warned = False
    profile_dir = params.get_str("simulation", "profile_dir", "")

    log(f"Site update: {site_update_name(cfg)}")
    if df_mode:
        log("Engine: df32 hybrid (f32 kernels, double-float32 stabilization)")

    def build_step(c: EngineConfig):
        if df_mode:
            from dqmc_tpu.engine.df_sweep import df_sweep_pair
            return jax.jit(jax.vmap(
                lambda s: df_sweep_pair(model, df_aux, c, s)))
        return jax.jit(jax.vmap(lambda s: sweep_pair(model, c, s)))

    step = build_step(cfg)
    warp = jax.jit(jax.vmap(lambda G: half_warp(model, G)))

    def checkpoint(therm_flag: bool, therm_sweep: int = 0):
        if ckpt_every <= 0:
            return
        from dqmc_tpu.io.checkpoint import save_checkpoint
        jax.block_until_ready(states.G)
        save_checkpoint(ckpt_path, states,
                        {"bin": manager.current_bin, "therm_done": therm_flag,
                         "therm_sweep": therm_sweep, "n_stab": cfg.n_stab,
                         "seed": seed, "n_walkers": n_walkers})

    # n_stab = auto: tune the stabilization interval during thermalization
    # to the loosest value whose steady-state chunk error stays below the
    # warn threshold (with /16 hysteresis against oscillation).  A change
    # rebuilds the LDR stack and G from the fields (the Markov chain —
    # fields, RNG keys, signs — is untouched) and re-jits the sweep.
    adapt_marks = ()
    if n_stab_auto and not therm_done and n_therms - start_therm >= 4:
        k = min(8, (n_therms - start_therm) // 2)
        adapt_marks = sorted({start_therm + (i + 1)
                              * (n_therms - start_therm) // k
                              for i in range(k - 1)})
    n_stab_cap = min(cfg.nt, 32)

    def make_reseat(cfg):
        """Rebuild stack + G from the fields under a new n_stab (the
        Markov chain — fields, RNG keys, signs — is untouched)."""
        if df_mode:
            from dqmc_tpu.engine.df_sweep import rebuild_stack_df

            @jax.jit
            @jax.vmap
            def reseat(s):
                stack, G_df, log_det = rebuild_stack_df(df_aux, cfg, s.fields)
                return dataclasses.replace(s, G=G_df.hi, G_df=G_df,
                                           stack=stack, log_det_M=log_det)
        else:
            from dqmc_tpu.engine.sweep import rebuild_stack_and_greens

            @jax.jit
            @jax.vmap
            def reseat(s):
                stack, G, log_det = rebuild_stack_and_greens(model, cfg,
                                                             s.fields)
                return dataclasses.replace(s, G=G, stack=stack,
                                           log_det_M=log_det)
        return reseat

    def adapt(states, cfg, step):
        stats = global_stats(states)
        err_mean = (stats["err_sum"] / stats["err_count"]
                    if stats["err_count"] else 0.0)
        new = cfg.n_stab
        if err_mean > err_warn and cfg.n_stab > 1:
            new = cfg.n_stab - 1
        elif err_mean < err_warn / 16 and cfg.n_stab < n_stab_cap:
            new = cfg.n_stab + 1
        states = jax.jit(jax.vmap(reset_error_stats))(states)
        if new == cfg.n_stab:
            return states, cfg, step
        cfg = dataclasses.replace(cfg, n_stab=new)
        log(f"n_stab auto: chunk err_mean {err_mean:.2e} "
            f"(warn {err_warn:.0e}) -> n_stab = {new}")
        return make_reseat(cfg)(states), cfg, build_step(cfg)

    # thermalization (main.cpp:129-137); checkpointed mid-phase every
    # ckpt_every * n_sweeps sweep-pairs so a preempted long thermalization
    # resumes where it stopped instead of from zero
    t0 = time.perf_counter()
    if not therm_done:
        ckpt_stride = ckpt_every * max(n_sweeps, 1)
        for it in range(start_therm, n_therms):
            states = step(states)
            if (it + 1) in adapt_marks:
                states, cfg, step = adapt(states, cfg, step)
            if ckpt_every > 0 and (it + 1) % ckpt_stride == 0 \
                    and (it + 1) < n_therms:
                checkpoint(False, therm_sweep=it + 1)
        jax.block_until_ready(states.G)
        checkpoint(True)
    dt_therm = time.perf_counter() - t0
    log(f"Thermalization done in {dt_therm:.2f} seconds"
        + (f" (auto n_stab = {cfg.n_stab})" if n_stab_auto else ""))

    uneq_fn = manager.uneq_measure_fn
    meas_stab = params.get_int("simulation", "measure_n_stab", 0)
    uneq_stab = params.get_int("simulation", "measure_uneq_n_stab", 0)

    def build_measured(cfg, step):
        """The whole measurement-phase program for one n_stab value:
        uneq step (engine-dtype or measurement-tier), optional multiword
        greens_fn, the fused measured iteration, and the jitted bin scan.
        Rebuilt when n_stab adapts mid-measurement (the stack shape and
        every stabilization schedule depend on it)."""
        greens_fn = None
        uneq_step = None
        uneq_emits_greens = False
        if measure_prec != "engine":
            from dqmc_tpu.engine.parity import (measurement_greens_fn,
                                                measurement_uneq_fn)
            from dqmc_tpu.ops import df32 as _nm_df32, tf32 as _nm_tf32
            nm_meas = _nm_tf32 if measure_prec == "tf32" else _nm_df32
            model64 = model_cls.from_params(params, lat, dtype=jnp.float64)
            if uneq and uneq_fn is not None:
                # tau-resolved tier: the triplet rebuilt from the fields
                # at the same multiword grade (stride defaults: see
                # engine.parity.measurement_uneq_fn).  Its G00 doubles
                # as the equal-time measurement G (emit_greens) — no
                # separate fold chain.
                uneq_step = measurement_uneq_fn(
                    model64, cfg, nm_meas, uneq_fn, symmetric=symmetric,
                    n_stab=uneq_stab if uneq_stab > 0 else None,
                    emit_greens=True)
                uneq_emits_greens = True
                log(f"Measurement tier: tau-resolved Gt0/G0t/Gtt + "
                    f"equal-time G rebuilt at {measure_prec}")
            else:
                greens_fn = measurement_greens_fn(
                    model64, cfg, nm_meas, symmetric=symmetric,
                    n_stab=meas_stab if meas_stab > 0 else None)
                log(f"Measurement tier: equal-time G rebuilt at "
                    f"{measure_prec} "
                    f"({'<1e-10' if measure_prec == 'tf32' else '~1e-8'} "
                    f"fixed-field accuracy)")
        elif uneq and uneq_fn is not None:
            if df_mode:
                # tau-resolved reconstruction runs the f32 uneq sweep on
                # the hi-rounded df stack (engine.df_sweep.f32_view)
                from dqmc_tpu.engine.df_sweep import f32_view as _f32_view
                uneq_step = jax.jit(jax.vmap(
                    lambda s: sweep_unequal_time(model, cfg, _f32_view(s),
                                                 measure_fn=uneq_fn,
                                                 warp=symmetric)))
            else:
                uneq_step = jax.jit(jax.vmap(
                    lambda s: sweep_unequal_time(model, cfg, s,
                                                 measure_fn=uneq_fn,
                                                 warp=symmetric)))

        iter_fn, zero_acc = manager.make_measured_iter(
            step, uneq_step if (uneq and uneq_fn is not None) else None,
            warp_fn=warp if (symmetric and greens_fn is None
                             and not uneq_emits_greens) else None,
            signed=model.det_power == 1, greens_fn=greens_fn,
            uneq_emits_greens=uneq_emits_greens)

        @jax.jit
        def bin_fn(states, acc):
            def body(c, _):
                return iter_fn(*c), None
            (states, acc), _ = jax.lax.scan(body, (states, acc), None,
                                            length=n_sweeps)
            return states, acc

        return bin_fn, zero_acc

    # split precision stats: the random-field transient is reported once,
    # then reset so the summary's max/mean reflect the measured phase
    therm_err_max = global_stats(states)["err_max"]
    if n_therms and not therm_done:
        log(f"Thermalization transient precision error = {therm_err_max:.4e}")
    states = jax.jit(jax.vmap(reset_error_stats))(states)

    # measurement sweeps (main.cpp:144-171), fused: one jitted program runs
    # a whole bin — n_sweeps iterations of (sweep pair -> unequal-time sweep
    # -> measurements -> accumulator adds) scanned on device — and the host
    # touches the accumulators once per bin instead of one readback and
    # ~10 small accumulator dispatches per sweep.
    err_uneq_max = 0.0
    t0 = time.perf_counter()
    bin_fn, zero_acc = build_measured(cfg, step)

    for ibin in range(start_bin, n_bins):
        if profile_dir and ibin == start_bin:
            jax.profiler.start_trace(profile_dir)
        acc = zero_acc(states)
        states, acc = bin_fn(states, acc)
        if profile_dir and ibin == start_bin:
            jax.block_until_ready(states.G)
            jax.profiler.stop_trace()
            log(f"Profiler trace written to {profile_dir}")
        bin_err_uneq = manager.ingest_bin(jax.device_get(acc), n_sweeps)
        err_uneq_max = max(err_uneq_max, bin_err_uneq)
        if not warned:
            cur_err = float(jnp.max(states.err_max))
            if cur_err > err_warn:
                print(f"WARNING: GF precision {cur_err:.3e} exceeds "
                      f"{err_warn:.1e}. Reduce n_stab or increase nt.",
                      file=sys.stderr)
                warned = True
        # n_stab = auto in the MEASUREMENT phase: tighten-only (the
        # reference's "Reduce n_stab" advice, dqmc.cpp:390-393, made
        # actionable mid-run).  The per-bin steady-state chunk error AND
        # the unequal-time sweep's own self-check feed back; a change
        # reseats the stack from the fields at the bin boundary (already
        # written — bins stay uncorrupted) and rebuilds the jitted
        # programs.  Never loosens: a loosen/tighten oscillation would
        # recompile every few bins for no physics benefit.
        if n_stab_auto and cfg.n_stab > 1 and ibin + 1 < n_bins:
            stats = global_stats(states)
            err_mean = (stats["err_sum"] / stats["err_count"]
                        if stats["err_count"] else 0.0)
            if max(err_mean, bin_err_uneq) > err_warn:
                cfg = dataclasses.replace(cfg, n_stab=cfg.n_stab - 1)
                log(f"n_stab auto (measurement): bin err {err_mean:.2e} / "
                    f"uneq {bin_err_uneq:.2e} exceeds warn "
                    f"{err_warn:.0e} -> n_stab = {cfg.n_stab}, stack "
                    f"reseated")
                states = make_reseat(cfg)(states)
                states = jax.jit(jax.vmap(reset_error_stats))(states)
                step = build_step(cfg)
                bin_fn, zero_acc = build_measured(cfg, step)
                warned = False
        if ckpt_every > 0 and manager.current_bin % ckpt_every == 0:
            checkpoint(True)
    total = (n_bins - start_bin) * n_sweeps
    jax.block_until_ready(states.G)
    dt_meas = time.perf_counter() - t0
    manager.close()

    # summary (main.cpp:180-208); a sweep here = the reference's
    # forward+backward pair, so acc normalization uses 2 sweeps per pair.
    # Stats aggregate over all walkers of all processes (the MPI_Reduce
    # of main.cpp:186-187).
    n_pairs = n_therms + total
    stats = global_stats(states)
    acc = stats["acc_sum_mean"] / (2.0 * n_pairs)
    err_max = max(stats["err_max"], err_uneq_max)
    err_mean = stats["err_sum"] / max(stats["err_count"], 1)
    sweeps_per_sec = total * n_walkers / dt_meas if dt_meas > 0 else float("inf")
    h, rem = divmod(int(dt_meas), 3600)
    m, s = divmod(rem, 60)
    log(f"DQMC measurement sweeps are finished in {h} hours {m} minutes {s} seconds.")
    log(f"Average acceptance rate = {acc:.4f}")
    log(f"Max, Mean Precision Error (steady-state) = {err_max:.4e}, {err_mean:.4e}")
    log(f"Throughput: {sweeps_per_sec:.3f} walker-sweep-pairs/sec")

    return RunSummary(
        n_walkers=n_walkers, n_bins=n_bins, n_sweeps=n_sweeps,
        therm_seconds=dt_therm, measure_seconds=dt_meas,
        sweeps_per_sec=sweeps_per_sec, acc_rate=acc,
        max_precision_error=err_max, mean_precision_error=err_mean,
        therm_max_precision_error=therm_err_max, n_stab=cfg.n_stab,
        tier_err_max=(err_uneq_max if measure_prec != "engine" and uneq
                      else None))


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="dqmc_tpu",
        description="Determinant QMC for Hubbard models in JAX. "
                    "Run inside a directory containing parameters.in.")
    p.add_argument("-f", "--file", default="parameters.in",
                   help="parameter file (default: parameters.in)")
    p.add_argument("-d", "--out-dir", default="results",
                   help="output directory (default: results)")
    args = p.parse_args(argv)
    from dqmc_tpu import compile_cache
    compile_cache.enable()
    params = Parameters(args.file)
    run_simulation(params, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
