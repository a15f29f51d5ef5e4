"""Smoke test of the DQMC main path on one GPU (or, with --four, four).

Run from the root of a checkout:

    python chip_smoke.py            # every one-card phase
    python chip_smoke.py --four     # only the four-card phase

One process drives the card(s).  Phases:

1. device: JAX's device, the card's name and power limit (nvidia-smi, in a
   child that stays off JAX), versions, h5py / make / g++ presence; the
   native host library is rebuilt from native/*.cpp.
2. compile: the headline sweep step (16x16, beta=8, U=4, nt=160, n_stab=5,
   16 walkers, f32) — compile seconds and compiled.memory_analysis().
3. correctness at real widths, each error printed beside its tolerance:
   f32 vs f64 chain on one fixed field; f64 vs the scipy pivoted-QR oracle
   (tests/golden.py); the Triton site kernel vs the XLA reference loop on
   one stream; the df32 rebuild vs f64, jitted and eager.
4. main path: `python -m dqmc_tpu` on examples/basic (shortened) and its
   analysis, then one measured headline bin with unequal-time measurements.
5. kernel A/B: the headline sweep pair with the Triton site kernel and with
   XLA's delayed and rank-1 loops, 3 timed windows each.

--four runs walkers sharded over 4 cards against the same seeds on one card
(f64, fields equal, G within 1e-10) and one tempering exchange across 4
cards against the single-device result.

Exits non-zero, without the final JSON, when a phase fails or JAX's default
device is not a GPU.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# headline workload (bench.py CONFIGS["headline"])
L, BETA, NT, NSTAB, U, MU, WALKERS = 16, 8.0, 160, 5, 4.0, 0.0, 16
# site-update arms of the kernel A/B: the Triton kernel and XLA's loops
AB_ARMS = ("pallas", "delayed", "scan")


def say(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    """'name, power.limit' of the card, from a child that never imports
    JAX (a JAX process would reserve the card's memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def headline_model(dtype, side=None, nt=None):
    from dqmc_tpu.lattice import square_lattice
    from dqmc_tpu.models import AttractiveHubbard
    side = side or L
    return AttractiveHubbard.build(square_lattice(side, side), U=U, t=1.0,
                                   mu=MU, beta=BETA, nt=nt or NT, dtype=dtype)


def fixed_fields(nt, ns, seed=7):
    import jax.numpy as jnp
    import numpy as np
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 4, (nt, ns)), jnp.int32)


def check(name, err, tol):
    ok = bool(err <= tol)
    say(f"  {name}: error {err:.3e}  tolerance {tol:.1e}  "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.1e}")


class Smoke:
    def __init__(self):
        import jax
        self.jax = jax
        self.card = ""

    # -- phase 1 ------------------------------------------------------------
    def device(self):
        jax = self.jax
        d = jax.devices()[0]
        say(f"  device_kind={d.device_kind} count={len(jax.devices())}")
        self.card = nvidia_smi()
        say(f"  nvidia-smi: {self.card}")
        import jaxlib
        say(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
            f"python {sys.version.split()[0]}")
        try:
            import h5py
            self.h5py = True
            say(f"  h5py {h5py.__version__}")
        except ImportError:
            self.h5py = False
            say("  h5py: not installed (examples run with [io] sink = spool)")
        for tool in ("make", "g++", "nvcc"):
            say(f"  {tool}: {shutil.which(tool) or 'not found'}")
        if shutil.which("make") and shutil.which("g++"):
            out = subprocess.run(["make", "-B", "-C",
                                  os.path.join(REPO, "native")],
                                 capture_output=True, text=True, timeout=300)
            say(f"  native rebuild: rc={out.returncode}")
            if out.returncode:
                raise RuntimeError(out.stderr[-2000:])
        from dqmc_tpu import native
        say(f"  native library loaded: {native.load() is not None}")

    # -- phase 2 ------------------------------------------------------------
    def headline_states(self, dtype, seed=0):
        import jax
        from dqmc_tpu.engine import init_state
        model = headline_model(dtype)
        cfg = self.engine_config(model, "auto")
        keys = jax.random.split(jax.random.PRNGKey(seed), WALKERS)
        states = jax.jit(jax.vmap(lambda k: init_state(model, cfg, k)))(keys)
        return model, cfg, jax.block_until_ready(states)

    @staticmethod
    def engine_config(model, site_update):
        from dqmc_tpu import platform
        from dqmc_tpu.engine import EngineConfig
        impl = (platform.site_update(model, model.dtype)
                if site_update == "auto" else site_update)
        return EngineConfig.for_site_update(impl, nt=NT, n_stab=NSTAB)

    def compile(self):
        import jax
        import jax.numpy as jnp
        from dqmc_tpu.engine import sweep_pair
        model, cfg, states = self.headline_states(jnp.float32)
        say(f"  site update: {'pallas' if cfg.use_pallas else cfg}")
        step = jax.jit(jax.vmap(lambda s: sweep_pair(model, cfg, s)))
        t0 = time.perf_counter()
        compiled = step.lower(states).compile()
        say(f"  headline sweep pair compile: "
            f"{time.perf_counter() - t0:.1f} s")
        ma = compiled.memory_analysis()
        for f in ("argument_size_in_bytes", "output_size_in_bytes",
                  "alias_size_in_bytes", "temp_size_in_bytes",
                  "generated_code_size_in_bytes"):
            say(f"  memory_analysis.{f} = {getattr(ma, f, 'n/a')}")
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(states))
        say(f"  first sweep pair: {time.perf_counter() - t0:.3f} s, "
            f"G finite: {bool(jnp.isfinite(out.G).all())}, "
            f"err_max {float(jnp.max(out.err_max)):.3e}")
        stats = jax.devices()[0].memory_stats() or {}
        say(f"  peak_bytes_in_use = {stats.get('peak_bytes_in_use')}")
        if not bool(jnp.isfinite(out.G).all()):
            raise AssertionError("non-finite G after one sweep pair")

    # -- phase 3 ------------------------------------------------------------
    def correctness(self):
        import jax
        import jax.numpy as jnp
        import numpy as np
        from dqmc_tpu.engine import EngineConfig
        from dqmc_tpu.engine.sweep import rebuild_stack_and_greens

        cfg = EngineConfig(nt=NT, n_stab=NSTAB)
        fields = fixed_fields(NT, L * L)
        with jax.default_matmul_precision("highest"):
            _, g32, _ = rebuild_stack_and_greens(
                headline_model(jnp.float32), cfg, fields)
            pinned = {}
            # tests/test_precision.py::test_f32_rebuild_accuracy shapes
            for n_stab, tol in ((5, 5e-2), (2, 1e-2)):
                c = EngineConfig(nt=80, n_stab=n_stab)
                f = fixed_fields(80, 64, seed=n_stab)
                pinned[n_stab] = (c, f, tol, rebuild_stack_and_greens(
                    headline_model(jnp.float32, side=8, nt=80), c, f)[1])
        jax.config.update("jax_enable_x64", True)
        try:
            for n_stab, (c, f, tol, g) in pinned.items():
                _, ref, _ = rebuild_stack_and_greens(
                    headline_model(jnp.float64, side=8, nt=80), c, f)
                check(f"f32 vs f64 chain, G(0,0), 8x8 beta=8 n_stab={n_stab}",
                      float(np.abs(np.asarray(g[0], np.float64)
                                   - np.asarray(ref[0])).max()), tol)
            m64 = headline_model(jnp.float64)
            _, g64, _ = rebuild_stack_and_greens(m64, cfg, fields)
            g64 = np.asarray(g64[0])
            # no absolute pin exists at 16x16: random fields give G
            # entries ~3e2, and the f32 chain's error scales with them
            # (CPU: 2.0 absolute, 7.4e-3 of max|G|); bound it relatively
            check("f32 vs f64 chain, G(0,0), 16x16 beta=8 n_stab=5, "
                  "relative to max|G|",
                  float(np.abs(np.asarray(g32[0], np.float64) - g64).max()
                        / np.abs(g64).max()), 1e-2)
            self.golden_check(m64, fields, g64)
            self.df32_check()
        finally:
            jax.config.update("jax_enable_x64", False)
        self.kernel_check()

    def golden_check(self, m64, fields, g64):
        """The f64 stabilized chain on the card against the scipy
        true-pivoted-QR oracle (tests/golden.py): the CPU test's own case
        at its tolerance, then the headline shape relative to max|G|."""
        import jax.numpy as jnp
        import numpy as np
        from dqmc_tpu.ops import identity_ldr, inv_one_plus_ldr, mat_mul_ldr
        sys.path.insert(0, os.path.join(REPO, "tests"))
        import golden
        import test_linalg

        # tests/test_linalg.py::test_vs_golden_pivoted_qr_interacting
        rng = np.random.default_rng(12345)
        n, beta, nt, n_stab = 16, 6.0, 60, 5
        Bs = test_linalg.b_matrices(rng, test_linalg.random_K(rng, n=n,
                                                              w=3.0),
                                    beta, nt)
        F, F_gold = identity_ldr(n), golden.to_ldr(np.eye(n))
        for start in range(0, nt, n_stab):
            Bprod = np.eye(n)
            for B in Bs[start:start + n_stab]:
                Bprod = B @ Bprod
            F = mat_mul_ldr(jnp.asarray(Bprod), F)
            F_gold = golden.mat_mul_ldr(Bprod, F_gold)
        G, _ = inv_one_plus_ldr(F)
        check("f64 stabilized G vs scipy pivoted-QR oracle, n=16 beta=6",
              float(np.abs(np.asarray(G) - golden.inv_one_plus_ldr(F_gold)[0])
                    .max()), 1e-10)

        expK = np.asarray(m64.expK)
        eta = np.asarray(m64.eta)
        g = float(m64.g)
        F = golden.to_ldr(np.eye(expK.shape[0]))
        f = np.asarray(fields)
        for start in range(0, NT, NSTAB):
            Bprod = np.eye(expK.shape[0])
            for l in range(start, min(start + NSTAB, NT)):
                Bprod = (np.exp(g * eta[f[l]])[:, None] * expK) @ Bprod
            F = golden.mat_mul_ldr(Bprod, F)
        g_gold, _ = golden.inv_one_plus_ldr(F)
        # the f64 chain's own error grows with beta and with G's entries
        # (6.9e-9 absolute, 2.6e-11 of max|G| on the CPU at this shape)
        check("f64 stabilized G vs scipy pivoted-QR oracle, 16x16 beta=8, "
              "relative to max|G|",
              float(np.abs(g64 - g_gold).max() / np.abs(g_gold).max()),
              1e-10)

    def df32_check(self):
        """Section 5 of the bring-up: the df32 tier's error-free
        transformations survive the GPU compiler.  The fixed-field beta=8
        chain of tests/test_df_linalg.py::test_chain_rebuild_beta8 (n=64,
        nt=80, n_stab=5; its bound 1e-7, pin ~1e-8) folded op by op
        (eager) and with every fold compiled whole (jitted), plus the
        engine's own jitted rebuild on a fixed field."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from dqmc_tpu.engine import EngineConfig
        from dqmc_tpu.engine.df_sweep import df_aux_build, rebuild_stack_df
        from dqmc_tpu.engine.sweep import rebuild_stack_and_greens
        from dqmc_tpu.lattice import square_lattice
        from dqmc_tpu.ops import df32, df_linalg, linalg
        sys.path.insert(0, os.path.join(REPO, "tests"))
        import test_df_linalg as tdf

        n, nt = 64, 80
        Bs = tdf._b_chain(np.random.default_rng(3), n, nt, BETA)
        F64 = tdf._stab64_suffix(Bs, NSTAB)
        G64, _ = linalg.inv_one_plus_ldr_dag(
            linalg.identity_ldr(n, jnp.float64), F64)
        G64 = np.asarray(G64)
        eager = (df_linalg.to_ldr, df_linalg.mat_mul_ldr,
                 df_linalg.inv_one_plus_ldr_dag)
        for mode, (to_ldr, mat_mul, inv) in (
                ("eager", eager), ("jitted", tuple(map(jax.jit, eager)))):
            t0 = time.perf_counter()
            F = None
            for i in range(-(-nt // NSTAB) - 1, -1, -1):
                Bbar = np.eye(n)
                for B in Bs[i * NSTAB:(i + 1) * NSTAB]:
                    Bbar = B @ Bbar
                T = tdf._df_from64(Bbar.T)
                F = to_ldr(T) if F is None else mat_mul(T, F)
            G, _ = inv(df_linalg.to_ldr(df32.df(jnp.eye(n, dtype=jnp.float32))),
                       F)
            err = float(np.abs(tdf._to64(G) - G64).max())
            say(f"  df32 chain {mode}: {time.perf_counter() - t0:.1f} s")
            check(f"df32 vs f64 G(0,0), n=64 beta=8 chain, {mode}", err,
                  1e-7)

        Ls = 8
        cfg = EngineConfig(nt=nt, n_stab=NSTAB)
        fields = fixed_fields(nt, Ls * Ls, seed=11)
        _, g64, _ = rebuild_stack_and_greens(
            headline_model(jnp.float64, side=Ls, nt=nt), cfg, fields)
        aux = df_aux_build(square_lattice(Ls, Ls), U=U, t=1.0, mu=MU,
                           beta=BETA, nt=nt)
        _, g_df, _ = rebuild_stack_df(aux, cfg, fields)
        check("df32 engine rebuild (jitted) vs f64, 8x8 beta=8", float(
            np.abs(np.asarray(df32.to_f64(g_df)) - np.asarray(g64)).max()),
            1e-7)

    def kernel_check(self):
        """The compiled Triton site kernel against the XLA reference loop
        (engine.sweep.local_update_core) on one random stream, one slice
        at ns=256 and precision highest: a well-scaled G (entries O(1),
        as tests/test_kernels.py's gpu check) at an absolute bound, then
        the physical headline G (entries ~1e2 from random fields) relative
        to max|G|, beside XLA's own delayed-vs-rank-1 spread."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from dqmc_tpu.engine.sweep import (draw_slice_randoms,
                                           local_update_core,
                                           local_update_slice_delayed)
        from dqmc_tpu.ops.kernels import metropolis_slice_update_batched

        model, _, states = self.headline_states(jnp.float32, seed=3)
        ns = L * L
        keys = jax.random.split(jax.random.PRNGKey(5), WALKERS)
        rng = np.random.default_rng(3)
        G_unit = jnp.asarray(rng.standard_normal((WALKERS, 1, ns, ns)) * 0.05
                             + 0.5 * np.eye(ns), jnp.float32)
        fl = states.fields[:, 0]
        order, _, _ = draw_slice_randoms(keys[0], ns, jnp.float32)

        def ref(k, g, f):
            _, props, us = draw_slice_randoms(k, ns, jnp.float32)
            return local_update_core(model, g, f, order, props, us)

        for name, G, relative in (("well-scaled G", G_unit, False),
                                  ("headline G", states.G, True)):
            with jax.default_matmul_precision("highest"):
                G2, f2, a2 = metropolis_slice_update_batched(model, keys, G,
                                                             fl)
                G1, f1, a1, _ = jax.jit(jax.vmap(ref))(keys, G, fl)
                Gd = jax.jit(lambda k, g, f: local_update_slice_delayed(
                    model, k, g, f, 32)[0])(keys[0], G[0], fl[0])
            same = bool((f1 == f2).all())
            scale = float(jnp.max(jnp.abs(G1))) if relative else 1.0
            say(f"  site kernel vs XLA loop, {name}, ns={ns}, {WALKERS} "
                f"walkers: accept masks equal: {same}, acceptance "
                f"{float(a2.mean()):.4f} vs {float(a1.mean()):.4f}; XLA "
                f"delayed vs rank-1 (walker 0): "
                f"{float(jnp.max(jnp.abs(Gd - G1[0]))) / scale:.3e}")
            if not same:
                raise AssertionError("site kernel accept mask differs")
            check(f"site kernel max|dG| after one slice, {name}"
                  + (", relative to max|G|" if relative else ""),
                  float(jnp.max(jnp.abs(G1 - G2))) / scale, 1e-4)

    # -- phase 4 ------------------------------------------------------------
    def main_path(self):
        import re
        from dqmc_tpu import analysis, run  # noqa: F401
        from dqmc_tpu.analysis import cli
        from dqmc_tpu.config import Parameters

        cwd = os.getcwd()
        with tempfile.TemporaryDirectory(prefix="dqmc_smoke_") as work:
            try:
                os.chdir(work)
                text = open(os.path.join(REPO, "examples", "basic",
                                         "parameters.in")).read()
                for key, val in (("n_therms", "50"), ("n_sweeps", "10"),
                                 ("n_bins", "4")):
                    text = re.sub(rf"(?m)^({key}\s*=\s*)\S+", rf"\g<1>{val}",
                                  text)
                if not self.h5py:
                    text += "\n[io]\nsink = spool\n"
                open("parameters.in", "w").write(text)
                t0 = time.perf_counter()
                run.main(["-f", "parameters.in", "-d", "results"])
                say(f"  examples/basic (4 bins x 10 sweeps, 50 therm): "
                    f"{time.perf_counter() - t0:.1f} s")
                if self.h5py:
                    cli.main(["-d", "results", "-p", "parameters.in"])
                    scal = open("scalarObservables.dat").read()
                    say("  analysis: scalarObservables.dat "
                        f"({len(scal.splitlines())} lines)")
                    if "density" not in scal:
                        raise AssertionError("analysis wrote no density")
                else:
                    from dqmc_tpu.io.spool import read_spool
                    bins = {b for _, b, _ in
                            read_spool("results/data_0.spool")}
                    say(f"  spool log bins: {sorted(bins)}")
                    if len(bins) != 4:
                        raise AssertionError("spool log lacks bins")

                hl = f"""
[Lattice]
L1 = {L}
L2 = {L}
[hubbard]
U = {U}
t = 1.0
mu = {MU}
[simulation]
beta = {BETA}
nt = {NT}
n_therms = 4
n_sweeps = 2
n_bins = 1
n_stab = {NSTAB}
isMeasureUnequalTime = true
dtype = float32
seed = 1
[walkers]
n_walkers = {WALKERS}
n_devices = 1
""" + ("" if self.h5py else "[io]\nsink = spool\n")
                t0 = time.perf_counter()
                s = run.run_simulation(Parameters.from_string(hl),
                                       out_dir="headline", verbose=False)
                say(f"  headline measured bin (4 therm + 2 measured sweep "
                    f"pairs, uneq on): {time.perf_counter() - t0:.1f} s "
                    f"incl. compile, acc {s.acc_rate:.4f}, steady err_max "
                    f"{s.max_precision_error:.3e}")
                stats = self.jax.devices()[0].memory_stats() or {}
                say(f"  peak_bytes_in_use = {stats.get('peak_bytes_in_use')}")
                if not (0.0 < s.acc_rate < 1.0
                        and s.max_precision_error < 1e4):
                    raise AssertionError("headline measured bin unhealthy")
            finally:
                os.chdir(cwd)

    # -- phase 5 ------------------------------------------------------------
    def kernel_ab(self):
        import math
        from functools import partial

        import jax
        import jax.numpy as jnp
        from dqmc_tpu.engine import sweep_pair

        rows = {}
        for arm in AB_ARMS:
            model, _, states = self.headline_states(jnp.float32)
            cfg = self.engine_config(model, arm)

            @partial(jax.jit, donate_argnums=(0,))
            def step(s):
                return jax.vmap(lambda w: sweep_pair(model, cfg, w))(s)

            t0 = time.perf_counter()
            states = jax.block_until_ready(step(states))
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            states = jax.block_until_ready(step(states))
            per_pair = time.perf_counter() - t0
            n = max(1, min(20, math.ceil(3.0 / per_pair)))
            rates = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(n):
                    states = step(states)
                jax.block_until_ready(states)
                rates.append(WALKERS * n / (time.perf_counter() - t0))
            med = statistics.median(rates)
            rows[arm] = med
            say(f"  {arm:8s}: {med:.3f} walker-sweep-pairs/s (median of 3 "
                f"windows x {n} pairs; spread {(max(rates) - min(rates)) / 2:.3f}"
                f"; compile+first {t_first:.1f} s) [{self.card}]")
        xla = max(v for k, v in rows.items() if k != "pallas")
        say(f"  kernel / best XLA: {rows.get('pallas', float('nan')) / xla:.3f}")

    # -- --four -------------------------------------------------------------
    def four(self):
        import jax
        import jax.numpy as jnp
        import numpy as np
        from dqmc_tpu.engine import EngineConfig, init_state, sweep_pair
        from dqmc_tpu.lattice import square_lattice
        from dqmc_tpu.models import AttractiveHubbard
        from dqmc_tpu.parallel import (make_mesh, replica_exchange,
                                       shard_walkers, stack_models)

        n_dev = len(jax.devices())
        if n_dev != 4:
            raise RuntimeError(f"--four needs 4 devices, found {n_dev}")
        jax.config.update("jax_enable_x64", True)
        model = headline_model(jnp.float64)
        cfg = self.engine_config(model, "auto")
        say(f"  walkers: f64 headline, {WALKERS} walkers, {cfg}")
        keys = jax.random.split(jax.random.PRNGKey(0), WALKERS)
        states = jax.jit(jax.vmap(lambda k: init_state(model, cfg, k)))(keys)
        step = jax.jit(jax.vmap(lambda s: sweep_pair(model, cfg, s)))
        one = states
        sharded = shard_walkers(states, make_mesh(4))
        say(f"  sharded over {len(sharded.G.sharding.device_set)} devices")
        t = {}
        for name in ("one", "four"):
            s = one if name == "one" else sharded
            t0 = time.perf_counter()
            for _ in range(2):
                s = step(s)
            jax.block_until_ready(s)
            t[name] = time.perf_counter() - t0
            if name == "one":
                one = s
            else:
                sharded = s
        fields_equal = bool(np.array_equal(np.asarray(one.fields),
                                           np.asarray(sharded.fields)))
        say(f"  2 sweep pairs: 1 card {t['one']:.1f} s, 4 cards "
            f"{t['four']:.1f} s (both incl. compile); fields equal: "
            f"{fields_equal}")
        if not fields_equal:
            raise AssertionError("sharded walkers diverged from one card")
        check("walkers 4 cards vs 1 card, max|dG|", float(
            np.abs(np.asarray(one.G) - np.asarray(sharded.G)).max()), 1e-10)

        # tests/test_tempering.py::test_exchange_sharded_matches_single_device
        betas = (4.0, 3.0, 2.0, 1.0)
        lat = square_lattice(4, 4)
        models = stack_models([AttractiveHubbard.build(
            lat, U=U, t=1.0, mu=-0.1, beta=b, nt=16) for b in betas])
        pcfg = EngineConfig(nt=16, n_stab=4)
        pstates = jax.vmap(lambda m, k: init_state(m, pcfg, k))(
            models, jax.random.split(jax.random.PRNGKey(1), len(betas)))
        s1, acc1 = replica_exchange(models, pcfg, pstates, jnp.asarray(2),
                                    jax.random.PRNGKey(9))
        mesh = make_mesh(4, axis="replica")
        s2, acc2 = replica_exchange(shard_walkers(models, mesh, "replica"),
                                    pcfg, shard_walkers(pstates, mesh,
                                                        "replica"),
                                    jnp.asarray(2), jax.random.PRNGKey(9))
        same = (np.array_equal(np.asarray(acc1), np.asarray(acc2))
                and np.array_equal(np.asarray(s1.fields),
                                   np.asarray(s2.fields)))
        say(f"  tempering exchange over 4 cards: accept "
            f"{np.asarray(acc2).tolist()}, equal to one device: {same}")
        if not same:
            raise AssertionError("sharded exchange differs")
        # decisions and fields must be identical; G only to f64 rounding:
        # one replica per card runs the rebuilt stack's cuBLAS/cuSOLVER
        # calls at batch 1, the single device at batch 4, and the library
        # picks other algorithms (2.95e-12 measured on four H100s)
        check("tempering exchange 4 cards vs 1, max|dG|", float(
            np.abs(np.asarray(s1.G) - np.asarray(s2.G)).max()), 1e-10)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phase")
    p.add_argument("--only", default="",
                   help="comma-separated one-card phases to run (default: "
                        "all): device, compile, correctness, main_path, "
                        "kernel_ab")
    args = p.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's default device is {dev.platform!r}, not a "
              f"GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dqmc_tpu import compile_cache
    say(f"compile cache: {compile_cache.enable()}")

    smoke = Smoke()
    phases = ["device"] + (["four"] if args.four else
                           (args.only.split(",") if args.only else
                            ["compile", "correctness", "main_path",
                             "kernel_ab"]))
    failed = []
    for name in dict.fromkeys(phases):
        say(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            getattr(smoke, name)()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            say(f"== phase {name}: FAILED")
            continue
        say(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    say(f"card: {smoke.card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
