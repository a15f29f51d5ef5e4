"""Measurement registry, binned accumulation, and HDF5 output.

Capability mirror of the reference ``MeasurementManager``
(measurementh5.h:119-363), rebuilt around the device/host split:

- All registered observables are fused into ONE jitted, walker-vmapped
  measurement function; per-sweep work is entirely on-device, including the
  site-pair -> displacement reduction (the transforms are linear, so
  transforming per measurement and accumulating reduced (L1, L2, S) arrays
  is exactly equivalent to the reference's accumulate-then-transform
  (measurementh5.h:201-226, 321-348) while shrinking the accumulator from
  O(ns^2) to O(L^2) per observable).
- Unequal-time observables are measured *inside* the tau scan of
  engine/uneqtime.py via ``self.uneq_measure_fn``; the full Green's-function
  cubes never hit HBM.
- ``accumulate()`` normalizes by the measurement count, DFTs displacement ->
  momentum space, writes one HDF5 bin per walker in the reference's exact
  group layout (io/h5out.py), and zeroes the accumulators
  (measurementh5.h:229-274).

Each walker plays the role of one reference MPI rank: walker w writes
``results/data_<offset + w>.h5``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dqmc_tpu.lattice import Lattice
from dqmc_tpu.io.h5out import BinFileWriter
from dqmc_tpu.measure.context import make_context
from dqmc_tpu.measure.transforms import site_to_r


class MeasurementManager:
    def __init__(self, lat: Lattice, *, n_walkers: int = 1,
                 measure_unequal: bool = False, out_dir: str = "results",
                 rank_offset: int = 0, dtype=jnp.float64,
                 start_bin: int = 0, file_mode: str = "w",
                 sink: str = "h5"):
        self.lat = lat
        self.ctx = make_context(lat, dtype)
        self.n_walkers = n_walkers
        self.measure_unequal = measure_unequal
        self.out_dir = out_dir
        self.rank_offset = rank_offset
        self.dtype = dtype

        self._scalar_fns: Dict[str, Callable] = {}
        self._eq_fns: Dict[str, Callable] = {}
        self._uneq_fns: Dict[str, Callable] = {}

        self._acc_scalar: Dict[str, jax.Array] = {}
        self._acc_eq: Dict[str, jax.Array] = {}
        self._acc_uneq: Dict[str, jax.Array] = {}
        self._eq_count = 0
        self._uneq_count = 0
        self.current_bin = start_bin       # resume continues bin numbering
        self._file_mode = file_mode        # "a" on resume
        # sink "h5": synchronous h5py writes (reference behavior);
        # sink "spool": async C++ background writer (io/spool.py), converted
        # to the same HDF5 layout at close().  A resumed run (append) writes
        # h5 directly; a spool whose native library is missing raises.
        self._sink = sink if file_mode == "w" else "h5"
        self._spools = None
        if self._sink == "spool":
            from dqmc_tpu.io.spool import Spool
            self._spools = {
                w: Spool(os.path.join(out_dir,
                                      f"data_{rank_offset + w}.spool"))
                for w in range(n_walkers)}

        self._measure_eq_jit = None
        self._uneq_measure_fn = None
        self._writers = None

    # ------------------------------------------------------------------
    # registry (measurementh5.h:167-187)
    # ------------------------------------------------------------------

    def add_scalar(self, name: str, fn: Callable) -> None:
        self._scalar_fns[name] = fn
        self._measure_eq_jit = None

    def add_equal_time(self, name: str, fn: Callable) -> None:
        self._eq_fns[name] = fn
        self._measure_eq_jit = None

    def add_unequal_time(self, name: str, fn: Callable) -> None:
        # silently dropped when unequal-time measurement is off
        # (measurementh5.h:182-184)
        if not self.measure_unequal:
            return
        self._uneq_fns[name] = fn
        self._uneq_measure_fn = None

    def add_defaults(self) -> None:
        """Register the reference driver's observable set (main.cpp:116-122)."""
        from dqmc_tpu.measure import observables as obs
        for name, fn in obs.SCALAR_OBSERVABLES.items():
            self.add_scalar(name, fn)
        for name, fn in obs.EQUAL_TIME_OBSERVABLES.items():
            self.add_equal_time(name, fn)
        for name, fn in obs.UNEQUAL_TIME_OBSERVABLES.items():
            self.add_unequal_time(name, fn)

    def add_spin(self) -> None:
        """Register the opt-in magnetic set ([simulation] measure_spin =
        true): spin-z and spin-x correlation matrices, plus the
        time-displaced <Sz(tau) Sz> when unequal-time measurement is on
        (beyond-reference)."""
        from dqmc_tpu.measure import observables as obs
        for name, fn in obs.SPIN_OBSERVABLES.items():
            self.add_equal_time(name, fn)
        for name, fn in obs.SPIN_UNEQUAL_TIME_OBSERVABLES.items():
            self.add_unequal_time(name, fn)

    def add_charge(self) -> None:
        """Register the opt-in dynamic charge set ([simulation]
        measure_charge = true): the time-displaced connected
        density-density correlator (beyond-reference)."""
        from dqmc_tpu.measure import observables as obs
        for name, fn in obs.CHARGE_UNEQUAL_TIME_OBSERVABLES.items():
            self.add_unequal_time(name, fn)

    # ------------------------------------------------------------------
    # fused measurement kernels
    # ------------------------------------------------------------------

    def _build_eq(self):
        ctx = self.ctx
        scalar_fns = dict(self._scalar_fns)
        eq_fns = dict(self._eq_fns)
        ns = ctx.n_sites

        def measure_one(G00, sign):
            # sign-weighted accumulation: for sign-free models sign == 1 and
            # the extra "sign" observable is dropped by measure_equal
            out = {("scalar", "sign"): sign}
            for name, fn in scalar_fns.items():
                out[("scalar", name)] = fn(G00, ctx) * sign
            vals = {name: fn(G00, ctx) for name, fn in eq_fns.items()}
            from dqmc_tpu.measure.transforms import site_to_r_all
            for name, red in site_to_r_all(vals, ctx).items():
                out[("eq", name)] = red * sign
            return out

        self._measure_eq_vmapped = jax.vmap(measure_one)
        self._measure_eq_jit = jax.jit(self._measure_eq_vmapped)

    @property
    def uneq_measure_fn(self) -> Optional[Callable]:
        """Per-tau emit function for engine.sweep_unequal_time (stable
        identity => jit cache hit across sweeps)."""
        if not self._uneq_fns:
            return None
        if self._uneq_measure_fn is None:
            ctx = self.ctx
            uneq_fns = dict(self._uneq_fns)

            def emit(Gtt, Gt0, G0t, G00):
                # all plain (ns, ns) observables share ONE pair-matmul
                # site->r reduction per tau (see transforms.site_to_r_all)
                from dqmc_tpu.measure.transforms import site_to_r_all
                vals = {name: fn(Gtt, Gt0, G0t, G00, ctx)
                        for name, fn in uneq_fns.items()}
                return site_to_r_all(vals, ctx)

            self._uneq_measure_fn = emit
        return self._uneq_measure_fn

    # ------------------------------------------------------------------
    # fully-fused measured iteration (sweep + uneq + measure + accumulate
    # as ONE jittable program instead of a host round-trip per observable
    # per sweep; see run.py's bin loop)
    # ------------------------------------------------------------------

    def make_measured_iter(self, sweep_fn, uneq_step=None, *, warp_fn=None,
                           signed: bool = False, greens_fn=None,
                           uneq_emits_greens: bool = False):
        """Build the pure measured-iteration function.

        ``greens_fn(states) -> (W, nfl, ns, ns)``, when given, replaces
        ``states.G`` as the equal-time measurement input — the
        measurement-precision tier (engine.parity.measurement_greens_fn
        rebuilds G from the fields at tf32 grade, <1e-10).  It must
        return the FINAL measurement-basis G (apply any symmetric-Trotter
        half-warp itself); ``warp_fn`` is ignored alongside it.

        ``uneq_emits_greens=True``: ``uneq_step`` returns
        ``(ys, err, G)`` (engine.parity.measurement_uneq_fn with
        emit_greens=True) and that G is the equal-time measurement
        input — the tier's suffix chain serves both roles, dropping the
        separate greens_fn fold chain from the fused iteration.

        Returns ``(iter_fn, zero_acc)``:

        - ``iter_fn(states, acc) -> (states, acc)`` runs one full measured
          iteration — the equal-time sweep pair (``sweep_fn``), the
          unequal-time sweep with fused per-tau reductions (``uneq_step``,
          returning ``(ys, err_max)``), the equal-time measurement, and the
          on-device accumulator adds (the reference's measure() call,
          measurementh5.h:189-227, fused with the sweeps of
          main.cpp:156-165).
        - ``zero_acc(states) -> acc`` builds the zeroed accumulator pytree
          (dict keyed ``(kind, name)`` with kinds scalar/eq/uneq plus
          ``("meta", "err_uneq_max")``).

        Everything is jit/scan-safe; run.py scans a whole bin of iterations
        inside one jitted program and pulls the accumulators to host once
        per bin (``ingest_bin``).
        """
        if self._measure_eq_jit is None:
            self._build_eq()
        eq_measure = self._measure_eq_vmapped

        def increments(states):
            out = {}
            G_uneq = None
            if uneq_step is not None and self._uneq_fns:
                if uneq_emits_greens:
                    ys, err_u, G_uneq = uneq_step(states)
                else:
                    ys, err_u = uneq_step(states)
                if signed:
                    s = states.sign.reshape((-1,) + (1,) * 4)
                    ys = {k: v * s for k, v in ys.items()}
                for name, v in ys.items():
                    out[("uneq", name)] = v
                out[("meta", "err_uneq_max")] = jnp.max(err_u)
            if G_uneq is not None:
                G = G_uneq
            elif greens_fn is not None:
                G = greens_fn(states)
            else:
                G = warp_fn(states.G) if warp_fn is not None else states.G
            signs = (states.sign if signed
                     else jnp.ones((G.shape[0],), G.dtype))
            for key, v in eq_measure(G, signs).items():
                if key == ("scalar", "sign") and not signed:
                    continue  # reference-identical output for sign-free runs
                out[key] = v
            return out

        def iter_fn(states, acc):
            states = sweep_fn(states)
            inc = increments(states)
            new_acc = {}
            for key, v in acc.items():
                if key == ("meta", "err_uneq_max"):
                    new_acc[key] = jnp.maximum(v, inc[key])
                else:
                    new_acc[key] = v + inc[key]
            return states, new_acc

        def zero_acc(states):
            shapes = jax.eval_shape(increments, states)
            return {k: jnp.zeros(s.shape, s.dtype)
                    for k, s in shapes.items()}

        return iter_fn, zero_acc

    def ingest_bin(self, acc, count: int) -> float:
        """Write one bin from a fused accumulator pytree (make_measured_iter)
        and reset.  ``count`` is the number of iterations accumulated.
        Returns the bin's max unequal-time stabilization error (0.0 when
        unequal-time measurement is off)."""
        err_u = 0.0
        for (kind, name), v in acc.items():
            if kind == "meta":
                err_u = float(v)
            elif kind == "scalar":
                self._acc_scalar[name] = v
            elif kind == "eq":
                self._acc_eq[name] = v
            else:
                self._acc_uneq[name] = v
        self._eq_count = count
        self._uneq_count = count
        self.accumulate()
        return err_u

    # ------------------------------------------------------------------
    # per-sweep measurement (measurementh5.h:189-227)
    # ------------------------------------------------------------------

    def measure_equal(self, G00_batch: jax.Array, signs=None) -> None:
        """G00_batch: (n_walkers, nfl, ns, ns) equal-time Green's functions.

        For models with a sign problem pass ``signs`` (n_walkers,): every
        observable accumulates sign-weighted (<O s>) and a "sign" scalar
        observable records <s> for reweighting at analysis time.
        """
        if self._measure_eq_jit is None:
            self._build_eq()
        signed = signs is not None
        if signs is None:
            signs = jnp.ones((G00_batch.shape[0],), G00_batch.dtype)
        out = self._measure_eq_jit(G00_batch, signs)
        for (kind, name), val in out.items():
            if name == "sign" and not signed:
                continue  # keep reference-identical output for sign-free runs
            acc = self._acc_scalar if kind == "scalar" else self._acc_eq
            acc[name] = acc[name] + val if name in acc else val
        self._eq_count += 1

    def measure_unequal_result(self, ys: Dict[str, jax.Array]) -> None:
        """ys: dict name -> (n_walkers, n_tau, L1, L2, n_orb^2), the stacked
        per-tau outputs of engine.sweep_unequal_time(measure_fn=...)."""
        for name, val in ys.items():
            self._acc_uneq[name] = (self._acc_uneq[name] + val
                                    if name in self._acc_uneq else val)
        self._uneq_count += 1

    # ------------------------------------------------------------------
    # bin boundary: normalize, transform to k, write, reset
    # (measurementh5.h:229-274, 277-362)
    # ------------------------------------------------------------------

    def _writer(self, w: int) -> BinFileWriter:
        if self._writers is None:
            self._writers = {}
        if w not in self._writers:
            path = os.path.join(self.out_dir,
                                f"data_{self.rank_offset + w}.h5")
            self._writers[w] = BinFileWriter(path, mode=self._file_mode)
        return self._writers[w]

    def accumulate(self) -> None:
        phases = np.asarray(self.ctx.phases)  # (L1, L2, L1, L2)

        def to_k(chi_r):
            return np.tensordot(phases, chi_r, axes=((2, 3), (0, 1)))

        scalars = {n: np.asarray(v) / max(self._eq_count, 1)
                   for n, v in self._acc_scalar.items()}
        eq_r = {n: np.asarray(v) / max(self._eq_count, 1)
                for n, v in self._acc_eq.items()}
        # (W, T, L1, L2, no^2) -> (W, L1, L2, no^2, T) -> flat (a*no+b)*T + t
        uneq_r = {}
        for n, v in self._acc_uneq.items():
            a = np.asarray(v) / max(self._uneq_count, 1)
            W, T, L1, L2, no2 = a.shape
            a = np.moveaxis(a, 1, -1).reshape(W, L1, L2, no2 * T)
            uneq_r[n] = a

        for w in range(self.n_walkers):
            if self._spools is not None:
                sp = self._spools[w]
                b = self.current_bin
                for n, v in scalars.items():
                    sp.write(f"scalar/{n}", b, np.asarray([v[w]]))
                for n, v in eq_r.items():
                    sp.write(f"equaltime/{n}", b, v[w])
                    sp.write(f"K/equaltime/{n}", b, to_k(v[w]))
                for n, v in uneq_r.items():
                    sp.write(f"unequaltime/{n}", b, v[w])
                    sp.write(f"K/unequaltime/{n}", b, to_k(v[w]))
            else:
                self._writer(w).write_bin(
                    self.current_bin,
                    {n: float(v[w]) for n, v in scalars.items()},
                    {n: v[w] for n, v in eq_r.items()},
                    {n: to_k(v[w]) for n, v in eq_r.items()},
                    {n: v[w] for n, v in uneq_r.items()},
                    {n: to_k(v[w]) for n, v in uneq_r.items()},
                )

        self._acc_scalar.clear()
        self._acc_eq.clear()
        self._acc_uneq.clear()
        self._eq_count = 0
        self._uneq_count = 0
        self.current_bin += 1

    def close(self) -> None:
        for w in (self._writers or {}).values():
            w.close()
        self._writers = None
        if self._spools is not None:
            from dqmc_tpu.io.spool import convert_spool_to_h5
            for w, sp in self._spools.items():
                sp.close()
                path = os.path.join(self.out_dir,
                                    f"data_{self.rank_offset + w}")
                if convert_spool_to_h5(path + ".spool",
                                       path + ".h5") is not None:
                    os.unlink(path + ".spool")
            self._spools = None
