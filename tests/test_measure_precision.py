"""The measurement-precision tier ([simulation] measure_precision):
equal-time observables measured from a multiword Green's-function
rebuild instead of the engine's working G.

Same seed -> identical sampled trajectory (the tier only changes what
the measurement sees), so the binned observables of a tf32-measured run
must agree with the engine-measured run to the engine G's own accuracy
— a tight cross-check of the whole plumbing (run.py greens_fn ->
manager.make_measured_iter -> h5 output).

CPU caveat: inside the jitted measured iteration the multiword graphs
are exposed to the XLA:CPU reassociation hazard (ops/df_linalg.py doc),
so CPU agreement is asserted at 1e-3; the tier's real (<1e-10) grade is
pinned eagerly in tests/test_parity.py / test_tf_linalg.py.
"""

import os

import h5py
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dqmc_tpu.config import Parameters  # noqa: E402
from dqmc_tpu.run import run_simulation  # noqa: E402

BASE = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = -0.1
[simulation]
beta = 2.0
nt = 8
n_therms = 6
n_sweeps = 3
n_bins = 2
n_stab = 2
symmetric = {symmetric}
isMeasureUnequalTime = false
seed = 17
dtype = float32
{extra}
[walkers]
n_walkers = 2
"""


def _run(tmp_path, name, symmetric, extra):
    d = tmp_path / name
    d.mkdir()
    params = Parameters.from_string(
        BASE.format(symmetric=symmetric, extra=extra))
    run_simulation(params, out_dir=str(d / "results"), verbose=False)
    out = {}
    with h5py.File(d / "results" / "data_0.h5") as f:
        for b in range(2):
            for k in f[f"/bin_{b}/scalar"]:
                out[(b, k)] = float(np.asarray(f[f"/bin_{b}/scalar/{k}"]))
    return out


@pytest.mark.parametrize("symmetric", [False, True])
def test_tf32_measure_matches_engine_trajectory(tmp_path, symmetric):
    eng = _run(tmp_path, f"eng{symmetric}", symmetric, "")
    tf = _run(tmp_path, f"tf{symmetric}", symmetric,
              "measure_precision = tf32")
    assert eng.keys() == tf.keys()
    for k in eng:
        # identical trajectory; difference = engine-G error (f32 ~1e-5
        # at beta=2) + the CPU-jit multiword hazard margin
        assert abs(eng[k] - tf[k]) < 1e-3, (k, eng[k], tf[k])


def test_measure_precision_rejects_bad_value(tmp_path):
    with pytest.raises(ValueError):
        params = Parameters.from_string(
            BASE.format(symmetric="false",
                        extra="measure_precision = nonsense"))
        run_simulation(params, out_dir=str(tmp_path / "r"), verbose=False)


@pytest.mark.slow
def test_uneq_tier_e2e_minimal(tmp_path):
    """Driver-level integration of the tau-resolved measurement tier
    (run.py -> measurement_uneq_fn -> make_measured_iter -> h5): the
    cheapest possible config (nt=2, n_stab=1, df32 tier) still costs
    ~5 min of XLA:CPU compile for the fused multiword bin program — the
    tier's numerical grade is pinned eagerly in tests/test_parity.py;
    this test proves the production wiring end-to-end."""
    cfgtext = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = -0.1
[simulation]
beta = 0.5
nt = 2
n_therms = 1
n_sweeps = 1
n_bins = 1
n_stab = 1
isMeasureUnequalTime = true
seed = 7
dtype = float32
measure_precision = df32
[walkers]
n_walkers = 1
"""
    d = tmp_path / "uneq_tier"
    d.mkdir()
    params = Parameters.from_string(cfgtext)
    run_simulation(params, out_dir=str(d / "results"), verbose=False)
    with h5py.File(d / "results" / "data_0.h5") as f:
        gt = np.asarray(f["/bin_0/unequaltime/greenTau"])
        assert gt.shape == (4, 4, 3)          # (L1, L2, no^2 * (nt+1))
        assert np.all(np.isfinite(gt))
        cx = np.asarray(f["/bin_0/unequaltime/currxxTau"])
        assert np.all(np.isfinite(cx))
        dens = float(np.asarray(f["/bin_0/scalar/density"]))
        assert 0.0 < dens < 2.0


def test_repulsive_df32_measure_matches_engine_trajectory(tmp_path):
    """2-flavor measurement tier through the driver: same seed -> same
    sampled trajectory, so df32-measured binned scalars must agree with
    engine-measured ones to the engine G's own accuracy (+ CPU-jit
    multiword hazard margin)."""
    base = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
model = repulsive
[simulation]
beta = 2.0
nt = 6
n_therms = 4
n_sweeps = 2
n_bins = 2
n_stab = 2
isMeasureUnequalTime = false
seed = 23
dtype = float32
{extra}
[walkers]
n_walkers = 2
"""

    def run(name, extra):
        d = tmp_path / name
        d.mkdir()
        params = Parameters.from_string(base.format(extra=extra))
        run_simulation(params, out_dir=str(d / "results"), verbose=False)
        out = {}
        with h5py.File(d / "results" / "data_0.h5") as f:
            for b in range(2):
                for k in f[f"/bin_{b}/scalar"]:
                    out[(b, k)] = float(
                        np.asarray(f[f"/bin_{b}/scalar/{k}"]))
        return out

    eng = run("eng", "")
    df = run("df", "measure_precision = df32")
    assert eng.keys() == df.keys()
    assert ("0", "sign") not in eng  # sanity: sign key is (b, name) tuple
    assert any(k[1] == "sign" for k in eng)   # sign-prone family records <s>
    for k in eng:
        assert abs(eng[k] - df[k]) < 1e-3, (k, eng[k], df[k])
