"""Parallel tempering (replica exchange) over a replica axis.

Capability mirror of the reference's MPI replica exchange
(source/update.cpp:34-117, main.cpp:39-73,147-153), re-designed for the
device-mesh world:

- One replica per leading-axis slot, each with its own beta (hence its own
  expK/g model leaves — the model pytree is stacked, walkers.stack_models).
- The even/odd partner pairing alternates with the attempt counter
  (update.cpp:34-45).
- Field configurations travel to partners as one permutation of the
  (R, nt, ns) int array.  On a single device that's a gather; with the
  replica axis sharded over a mesh, XLA lowers the same permutation to a
  `collective-permute` — no hand-written point-to-point code.
- The reference's three MPI_Sendrecv round-trips plus an explicit accept
  message (update.cpp:64-105) collapse into: one field permutation, one
  scalar-action permutation, and a *shared-randomness* Metropolis coin —
  both partners draw the same uniform from a pair-indexed key, so the
  accept decision needs no communication at all.
- The reference rebuilds stacks twice on rejection (update.cpp:76-80,
  109-115); here the pre-exchange state is kept and selected back, so the
  O(nt ns^3 / n_stab) rebuild happens exactly once per attempt.

The joint Metropolis rule is identical: accept with
min(1, exp(-[S_r(s') + S_p(s'') - S_r(s) - S_p(s)])) on the pair.
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu.engine import (EngineConfig, init_state, reset_error_stats,
                             sweep_pair, half_warp)
from dqmc_tpu.engine.sweep import rebuild_stack_and_greens
from dqmc_tpu.engine.uneqtime import sweep_unequal_time
from dqmc_tpu.engine.state import WalkerState


def _cast_floats(tree, dtype):
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def partner_indices(n_replicas: int, attempt: int | jax.Array) -> jax.Array:
    """Alternating even/odd neighbor pairing (update.cpp:34-45).

    attempt parity 1 (first attempt, matching the reference's pre-increment)
    pairs (0,1),(2,3),...; parity 0 pairs (1,2),(3,4),...,(R-1,0).
    """
    idx = jnp.arange(n_replicas)
    is_even_attempt = (attempt % 2) == 0
    offset_even_rank = jnp.where(is_even_attempt, 1, -1)
    offset = jnp.where(idx % 2 == 0, offset_even_rank, -offset_even_rank)
    return (idx + offset) % n_replicas


@partial(jax.jit, static_argnames=("cfg", "f64_actions"))
def replica_exchange(models, cfg: EngineConfig, states: WalkerState,
                     attempt: jax.Array, key: jax.Array,
                     f64_actions: bool = False):
    """One replica-exchange attempt over the leading replica axis.

    Returns (states, accept): accept is the per-replica decision vector
    (each pair shares one decision).

    f64_actions=True computes both actions from float64 stack rebuilds even
    for an f32 chain (requires jax_enable_x64).  In f32 the log-determinant
    carries O(1..10) absolute error (a sum of hundreds of logs spanning
    beta*W), which biases the joint Metropolis rule; exchanges are
    infrequent, so the two f64 rebuilds per attempt are cheap insurance.
    The exchanged state itself is cast back to the chain dtype.

    Design note — why configurations travel rather than temperatures
    (SURVEY.md suggested the beta-swap as "cheaper"): the O(nt ns^3/n_stab)
    cross-action rebuild is required under EITHER convention (S_{beta_r} of
    the partner's fields has no incremental relation to anything cached),
    so the only difference is what crosses the device link — an O(nt ns) int
    field block here versus, for the beta-swap, re-sorting each O(ns^2)
    Green's function (plus stack) back to fixed-beta measurement streams
    before every measurement, because analysis pools per-beta files
    (analysis.py:46-48).  Swapping fields is the cheaper and simpler
    equivalent on a mesh.
    """
    R = states.fields.shape[0]
    partner = partner_indices(R, attempt)
    chain_dtype = states.G.dtype

    # --- swap field configurations (MPI_Sendrecv, update.cpp:64-66) ---
    fields_partner = jnp.take(states.fields, partner, axis=0)

    # --- own and cross actions (update.cpp:72-81) ---
    if f64_actions and chain_dtype != jnp.float64:
        models_hi = _cast_floats(models, jnp.float64)
        action = jax.vmap(lambda m, f, ld: m.global_action(f, ld))
        # the chain's own f32 log_det_M is not trustworthy: recompute both
        # own and cross log-dets at f64
        _, _, log_det_own = jax.vmap(
            lambda m, f: rebuild_stack_and_greens(m, cfg, f))(
                models_hi, states.fields)
        S_self = action(models_hi, states.fields, log_det_own)
        stack_hi, G_hi, log_det_hi = jax.vmap(
            lambda m, f: rebuild_stack_and_greens(m, cfg, f))(
                models_hi, fields_partner)
        S_cross = action(models_hi, fields_partner, log_det_hi)
        stack_x = _cast_floats(stack_hi, chain_dtype)
        G_x = G_hi.astype(chain_dtype)
        log_det_x = log_det_hi.astype(chain_dtype)
    else:
        action = jax.vmap(lambda m, f, ld: m.global_action(f, ld))
        S_self = action(models, states.fields, states.log_det_M)
        stack_x, G_x, log_det_x = jax.vmap(
            lambda m, f: rebuild_stack_and_greens(m, cfg, f))(models,
                                                              fields_partner)
        S_cross = action(models, fields_partner, log_det_x)

    # --- joint Metropolis decision with shared randomness (update.cpp:84-105)
    dS = (S_cross + jnp.take(S_cross, partner)
          - S_self - jnp.take(S_self, partner))
    pair_id = jnp.minimum(jnp.arange(R), partner)
    u_all = jax.random.uniform(key, (R,), dtype=S_self.dtype)
    u_pair = jnp.take(u_all, pair_id)  # both partners draw the same coin
    accept = u_pair < jnp.exp(-dS)

    # --- select exchanged vs original state per replica ---
    def sel(new, old):
        acc = accept.reshape((R,) + (1,) * (new.ndim - 1))
        return jnp.where(acc, new, old)

    states = dataclasses.replace(
        states,
        fields=sel(fields_partner, states.fields),
        G=sel(G_x, states.G),
        stack=jax.tree_util.tree_map(sel, stack_x, states.stack),
        log_det_M=sel(log_det_x, states.log_det_M),
        # the Metropolis sign belongs to the CONFIGURATION: it travels
        # with the fields on an accepted swap (stale signs would corrupt
        # every subsequent sign-weighted bin for sign-prone replicas)
        sign=sel(jnp.take(states.sign, partner, axis=0), states.sign),
    )
    return states, accept


@partial(jax.jit, static_argnames=("cfg",))
def replica_exchange_df(auxs, cfg: EngineConfig, states, attempt: jax.Array,
                        key: jax.Array, det_power: int = 2):
    """Replica exchange for df32 chains (parity-grade PT).

    Same pairing/shared-coin protocol as :func:`replica_exchange`, with
    both actions carried at df accuracy: the chain's own log-det is
    already df-grade, the cross log-det comes from one df stack rebuild
    per replica (``rebuild_stack_df``), and the bosonic part is the
    exact state-count dot (``df_global_action``).  No f64 emulation
    anywhere — this is what makes PT affordable in the hybrid parity
    mode (~20x cheaper rebuilds than the f64 path the f32 chain needs).

    ``auxs``: a replica-stacked ``DFModelAux`` (one beta per slot).
    ``states``: replica-stacked ``DFWalkerState``.
    """
    import dataclasses as _dc

    from dqmc_tpu.engine.df_sweep import df_global_action, rebuild_stack_df

    R = states.fields.shape[0]
    partner = partner_indices(R, attempt)
    fields_partner = jnp.take(states.fields, partner, axis=0)

    act = jax.vmap(lambda a, f, ld: df_global_action(a, f, ld, det_power))
    S_self = act(auxs, states.fields, states.log_det_M)
    stack_x, G_x_df, log_det_x = jax.vmap(
        lambda a, f: rebuild_stack_df(a, cfg, f))(auxs, fields_partner)
    S_cross = act(auxs, fields_partner, log_det_x)

    dS = (S_cross + jnp.take(S_cross, partner)
          - S_self - jnp.take(S_self, partner))
    pair_id = jnp.minimum(jnp.arange(R), partner)
    u_all = jax.random.uniform(key, (R,), dtype=S_self.dtype)
    u_pair = jnp.take(u_all, pair_id)
    accept = u_pair < jnp.exp(-dS)

    def sel(new, old):
        acc = accept.reshape((R,) + (1,) * (new.ndim - 1))
        return jnp.where(acc, new, old)

    states = _dc.replace(
        states,
        fields=sel(fields_partner, states.fields),
        G=sel(G_x_df.hi, states.G),
        G_df=jax.tree_util.tree_map(sel, G_x_df, states.G_df),
        stack=jax.tree_util.tree_map(sel, stack_x, states.stack),
        log_det_M=sel(log_det_x, states.log_det_M),
        # sign travels with the configuration (see replica_exchange)
        sign=sel(jnp.take(states.sign, partner, axis=0), states.sign),
    )
    return states, accept


# ----------------------------------------------------------------------
# PT simulation driver (main.cpp PT branch)
# ----------------------------------------------------------------------

def run_parallel_tempering(params, *, out_dir: str = "results",
                           verbose: bool = True):
    from dqmc_tpu.lattice import make_lattice
    from dqmc_tpu.measure import MeasurementManager
    from dqmc_tpu.parallel.walkers import stack_models
    from dqmc_tpu.run import (RunSummary, _rank0_log, _resolve_dtype,
                              global_stats, make_engine_config,
                              walker_devices)

    log = _rank0_log(verbose)
    dtype, df_mode = _resolve_dtype(params)

    # Measurement tier (VERDICT r4 item 2): the reference's PT ranks
    # measure through the same full-grade path as any rank
    # (update.cpp:47-117 + measurementh5.h) — measure_precision wires
    # the df32/tf32 tiers into the PT measured loop exactly as in the
    # standard driver, via the replica-stacked tier constructors
    # (engine/parity.measurement_*_fn_stacked: per-replica beta models).
    measure_prec = params.get_str("simulation", "measure_precision",
                                  "engine")
    if measure_prec not in ("engine", "tf32", "df32"):
        raise ValueError(f"[simulation] measure_precision must be engine, "
                         f"tf32 or df32, got {measure_prec!r}")
    if measure_prec != "engine":
        jax.config.update("jax_enable_x64", True)

    # f32 chains get f64 exchange actions by default (the f32 log-det bias
    # is documented in NOTES.md); x64 must be on for the cast to be real.
    # df32 chains carry their own df-grade actions (replica_exchange_df) —
    # no f64 emulation anywhere in the df PT path.
    f64_actions = params.get_bool("ParallelTempering", "f64_actions",
                                  dtype == jnp.float32 and not df_mode)
    if f64_actions and not df_mode:
        jax.config.update("jax_enable_x64", True)

    betas = params.get_float_list("ParallelTempering", "betas")
    exchange_step = params.get_int("ParallelTempering", "sweep_steps")
    R = len(betas)
    if R % 2 != 0:
        raise ValueError(
            f"number of betas ({R}) must be even for replica exchange")

    n_sweeps = params.get_int("simulation", "n_sweeps")
    n_therms = params.get_int("simulation", "n_therms")
    n_bins = params.get_int("simulation", "n_bins")
    nt = params.get_int("simulation", "nt")
    n_stab = params.get_int("simulation", "n_stab")
    symmetric = params.get_bool("simulation", "symmetric", False)
    uneq = params.get_bool("simulation", "isMeasureUnequalTime", False)
    seed = params.get_int("simulation", "seed", 42)

    lat = make_lattice(params.get_str("Lattice", "geometry", "square"),
                       params.get_int("Lattice", "L1"),
                       params.get_int("Lattice", "L2"))
    lat.save_info(os.path.join(out_dir, "info"))
    from dqmc_tpu.models import MODEL_REGISTRY
    model_cls = MODEL_REGISTRY[params.get_str("hubbard", "model",
                                              "attractive")]
    models = stack_models([
        model_cls.from_params(params, lat, beta=b, dtype=dtype)
        for b in betas])
    signed = models.det_power == 1    # sign-prone family: weight by sign
    ndev = walker_devices(params, R)
    cfg = make_engine_config(params, models, sharded=ndev > 1)
    auxs = None
    if df_mode:
        from dqmc_tpu.engine.df_sweep import df_aux_build
        from dqmc_tpu.lattice import bonds_with_tp
        bonds = bonds_with_tp(
            params.get_str("Lattice", "geometry", "square"),
            params.get_float("hubbard", "tp", 0.0))
        U = params.get_float("hubbard", "U")
        t = params.get_float("hubbard", "t")
        mu = params.get_float("hubbard", "mu")
        auxs = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs),
            *[df_aux_build(lat, U=U, t=t, mu=mu, beta=b, nt=nt, bonds=bonds,
                           n_flavor=models.n_flavor)
              for b in betas])
    log(f"Parallel Tempering enabled: {R} replicas, betas={betas}, "
        f"{lat.L1}x{lat.L2}, nt={nt}, "
        f"dtype={'df32' if df_mode else dtype.__name__}, "
        f"backend={jax.default_backend()}")

    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    if df_mode:
        from dqmc_tpu.engine.df_sweep import init_state_df
        states = jax.vmap(lambda m, a, k: init_state_df(m, a, cfg, k))(
            models, auxs, jax.random.split(k_init, R))
    else:
        states = jax.vmap(lambda m, k: init_state(m, cfg, k))(
            models, jax.random.split(k_init, R))

    # checkpoint / resume (same contract as the standard driver)
    ckpt_every = params.get_int("simulation", "checkpoint_every", 0)
    ckpt_path = params.get_str("simulation", "checkpoint_path",
                               os.path.join(out_dir, "checkpoint.npz"))
    start_bin = 0
    therm_done = False
    attempt = 0
    accepted = 0.0
    if ckpt_every > 0 and os.path.exists(ckpt_path):
        from dqmc_tpu.io.checkpoint import load_checkpoint
        states, meta = load_checkpoint(ckpt_path, states)
        start_bin = int(meta["bin"])
        therm_done = bool(meta.get("therm_done", True))
        attempt = int(meta.get("attempt", 0))
        accepted = float(meta.get("accepted", 0.0))
        log(f"Resumed PT run from {ckpt_path} at bin {start_bin}")

    # multi-device: one (or more) replicas per device; the exchange
    # permutation inside replica_exchange lowers to a collective-permute
    # when the replica axis is sharded (the reference's MPI_Sendrecv,
    # update.cpp:64-66)
    if ndev > 1:
        from dqmc_tpu.parallel.walkers import make_mesh, shard_walkers
        mesh = make_mesh(ndev, axis="replicas")
        states = shard_walkers(states, mesh, axis="replicas")
        models = shard_walkers(models, mesh, axis="replicas")
        log(f"Sharded {R} replicas over {ndev} devices")

    manager = MeasurementManager(lat, n_walkers=R, measure_unequal=uneq,
                                 out_dir=out_dir, dtype=dtype,
                                 start_bin=start_bin,
                                 file_mode="a" if start_bin else "w",
                                 sink=params.get_str("io", "sink", "h5"))
    manager.add_defaults()
    if params.get_bool("simulation", "measure_spin", False):
        manager.add_spin()
    if params.get_bool("simulation", "measure_charge", False):
        manager.add_charge()

    def save_ckpt():
        if ckpt_every <= 0:
            return
        from dqmc_tpu.io.checkpoint import save_checkpoint
        jax.block_until_ready(states.G)
        save_checkpoint(ckpt_path, states,
                        {"bin": manager.current_bin, "therm_done": True,
                         "attempt": attempt, "accepted": accepted,
                         "seed": seed})

    uneq_fn = manager.uneq_measure_fn
    # symmetric=true warps the tau-resolved Green's functions too
    # (dqmc.cpp:300-312)
    if df_mode:
        from dqmc_tpu.engine.df_sweep import df_sweep_pair, f32_view
        step = jax.jit(jax.vmap(
            lambda m, a, s: df_sweep_pair(m, a, cfg, s)))
        step = partial(step, models, auxs)
        uneq_step = jax.jit(jax.vmap(
            lambda m, s: sweep_unequal_time(m, cfg, f32_view(s),
                                            measure_fn=uneq_fn,
                                            warp=symmetric)))
    else:
        _step = jax.jit(jax.vmap(lambda m, s: sweep_pair(m, cfg, s)))
        step = partial(_step, models)
        uneq_step = jax.jit(jax.vmap(
            lambda m, s: sweep_unequal_time(m, cfg, s, measure_fn=uneq_fn,
                                            warp=symmetric)))
    warp = jax.jit(jax.vmap(lambda m, G: half_warp(m, G)))

    t0 = time.perf_counter()
    if not therm_done:
        for _ in range(n_therms):
            states = step(states)
        jax.block_until_ready(states.G)
        save_ckpt()
    dt_therm = time.perf_counter() - t0
    log(f"Thermalization done in {dt_therm:.2f} seconds")

    # report the random-field transient once, then track steady-state error
    therm_err_max = global_stats(states)["err_max"]
    if n_therms and not therm_done:
        log(f"Thermalization transient precision error = {therm_err_max:.4e}")
    states = jax.jit(jax.vmap(reset_error_stats))(states)

    # --- fused measured iterations between exchange attempts ---
    # The reference cadence (main.cpp:147-171): an exchange attempt
    # precedes sweep number k*sweep_steps; every sweep is measured; bins
    # close every n_sweeps.  Exchange attempts stay host-side (they are
    # infrequent and carry host RNG/stat bookkeeping); the sweeps BETWEEN
    # events run as ONE jitted scan of the fused measured iteration —
    # the same ~2x host-dispatch elimination run.py's bin loop got
    # (measure.manager.make_measured_iter).
    greens_fn = None
    tier_uneq_step = None
    uneq_emits_greens = False
    if measure_prec != "engine":
        from dqmc_tpu.engine.parity import (measurement_greens_fn_stacked,
                                            measurement_uneq_fn_stacked)
        from dqmc_tpu.ops import df32 as _nm_df32, tf32 as _nm_tf32
        nm_meas = _nm_tf32 if measure_prec == "tf32" else _nm_df32
        models64 = stack_models([
            model_cls.from_params(params, lat, beta=b, dtype=jnp.float64)
            for b in betas])
        meas_stab = params.get_int("simulation", "measure_n_stab", 0)
        uneq_stab = params.get_int("simulation", "measure_uneq_n_stab", 0)
        if uneq and uneq_fn is not None:
            tier_uneq_step = measurement_uneq_fn_stacked(
                models64, cfg, nm_meas, uneq_fn, symmetric=symmetric,
                n_stab=uneq_stab if uneq_stab > 0 else None,
                emit_greens=True)
            uneq_emits_greens = True
            log(f"PT measurement tier: tau-resolved Gt0/G0t/Gtt + "
                f"equal-time G rebuilt per replica at {measure_prec}")
        else:
            greens_fn = measurement_greens_fn_stacked(
                models64, cfg, nm_meas, symmetric=symmetric,
                n_stab=meas_stab if meas_stab > 0 else None)
            log(f"PT measurement tier: equal-time G rebuilt per replica "
                f"at {measure_prec}")

    engine_uneq = ((lambda s: uneq_step(models, s))
                   if (uneq and uneq_fn is not None
                       and tier_uneq_step is None) else None)
    iter_fn, zero_acc = manager.make_measured_iter(
        step, tier_uneq_step if tier_uneq_step is not None else engine_uneq,
        warp_fn=(lambda G: warp(models, G))
        if (symmetric and greens_fn is None
            and not uneq_emits_greens) else None,
        signed=signed, greens_fn=greens_fn,
        uneq_emits_greens=uneq_emits_greens)

    @partial(jax.jit, static_argnames=("n",))
    def seg_fn(states, acc, n):
        def body(c, _):
            return iter_fn(*c), None
        (states, acc), _ = jax.lax.scan(body, (states, acc), None, length=n)
        return states, acc

    def do_exchange():
        nonlocal states, attempt, accepted, key
        attempt += 1
        key, k_ex = jax.random.split(key)
        if df_mode:
            states, acc = replica_exchange_df(
                auxs, cfg, states, jnp.asarray(attempt), k_ex,
                det_power=models.det_power)
        else:
            states, acc = replica_exchange(models, cfg, states,
                                           jnp.asarray(attempt), k_ex,
                                           f64_actions=f64_actions)
        accepted += float(jnp.mean(acc))

    err_uneq_max = 0.0
    total = (n_bins - start_bin) * n_sweeps
    t0 = time.perf_counter()
    s_done = 0
    acc_bin = zero_acc(states)
    n_acc = 0
    # wall time + sweeps of the first measured segment (the jit
    # compile rides on it); the steady-state rate excludes both
    t_first, n_first = 0.0, 0
    while s_done < total:
        if (s_done + 1) % exchange_step == 0:
            do_exchange()
        r = (s_done + 1) % exchange_step
        n_ex = exchange_step if r == 0 else exchange_step - r
        n_bin = n_sweeps - (s_done % n_sweeps)
        n = min(n_ex, n_bin, total - s_done)
        if s_done == 0:
            tf0 = time.perf_counter()
            states, acc_bin = seg_fn(states, acc_bin, n)
            jax.block_until_ready(states.G)
            t_first, n_first = time.perf_counter() - tf0, n
        else:
            states, acc_bin = seg_fn(states, acc_bin, n)
        s_done += n
        n_acc += n
        if s_done % n_sweeps == 0:
            err_uneq_max = max(
                err_uneq_max,
                manager.ingest_bin(jax.device_get(acc_bin), n_acc))
            acc_bin = zero_acc(states)
            n_acc = 0
            if ckpt_every > 0 and manager.current_bin % ckpt_every == 0:
                save_ckpt()
    jax.block_until_ready(states.G)
    dt_meas = time.perf_counter() - t0
    manager.close()

    n_pairs = n_therms + total
    stats = global_stats(states)
    acc_rate = stats["acc_sum_mean"] / (2.0 * n_pairs)
    err_max = max(stats["err_max"], err_uneq_max)
    err_mean = stats["err_sum"] / max(stats["err_count"], 1)
    exchange_rate = accepted / attempt if attempt else 0.0
    sweeps_per_sec = total * R / dt_meas if dt_meas > 0 else float("inf")
    dt_steady = dt_meas - t_first
    n_steady = total - n_first
    steady = (n_steady * R / dt_steady if n_steady > 0 and dt_steady > 0
              else float("nan"))
    log(f"Average acceptance rate = {acc_rate:.4f}")
    log(f"Max, Mean Precision Error (steady-state) = {err_max:.4e}, {err_mean:.4e}")
    log(f"Parallel tempering exchange rate = {exchange_rate:.4f}")
    log(f"Measurement phase: {dt_meas:.2f} s for {total} sweeps x {R} "
        f"replicas = {sweeps_per_sec:.2f} replica-sweeps/s "
        f"({steady:.2f} steady, first segment {t_first:.1f} s excluded)")

    return RunSummary(
        n_walkers=R, n_bins=n_bins, n_sweeps=n_sweeps,
        therm_seconds=dt_therm, measure_seconds=dt_meas,
        sweeps_per_sec=sweeps_per_sec, acc_rate=acc_rate,
        max_precision_error=err_max, mean_precision_error=err_mean,
        therm_max_precision_error=therm_err_max,
        exchange_rate=exchange_rate,
        first_segment_seconds=t_first, sweeps_per_sec_steady=steady,
        tier_err_max=(err_uneq_max if measure_prec != "engine" and uneq
                      else None))
