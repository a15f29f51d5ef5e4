"""Driver-level multi-device tests on the faked 8-device CPU mesh.

The reference's production mode is `mpirun -np N` data-parallel chains
(README.md:29-32, main.cpp:20-28): N identical independent simulations, one
output file per rank, statistics pooled offline.  The JAX equivalent
is the walker axis sharded over a jax.sharding.Mesh — these tests assert the
driver actually does that and that sharding changes NOTHING about the
output (bit-identical HDF5 bins sharded vs unsharded).
"""

import dataclasses
import os

import h5py
import jax
import numpy as np
import pytest

from dqmc_tpu.config import Parameters
from dqmc_tpu.run import run_simulation

PARAMS = """
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
n_therms = 3
n_sweeps = 2
n_bins = 2
n_stab = 4
isMeasureUnequalTime = true
seed = 7
dtype = float64
checkpoint_every = 1
[walkers]
n_walkers = 8
n_devices = %d
"""


def _h5_datasets(path):
    out = {}
    with h5py.File(path) as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj[...])
        f.visititems(visit)
    return out


@pytest.fixture(scope="module")
def sharded_and_unsharded(tmp_path_factory):
    dirs = {}
    for tag, ndev in (("unsharded", 1), ("sharded", 8)):
        d = tmp_path_factory.mktemp(tag)
        params = Parameters.from_string(PARAMS % ndev)
        summary = run_simulation(params, out_dir=str(d / "results"),
                                 verbose=False)
        dirs[tag] = (d, summary)
    return dirs


def test_walker_axis_is_actually_sharded():
    """The jitted sweep on a mesh-sharded state keeps the walker axis
    distributed (XLA partitions with zero collectives for independent
    chains)."""
    import jax.numpy as jnp
    from dqmc_tpu.engine import EngineConfig, init_state, sweep_pair
    from dqmc_tpu.lattice import square_lattice
    from dqmc_tpu.models import AttractiveHubbard
    from dqmc_tpu.parallel.walkers import make_mesh, shard_walkers

    lat = square_lattice(4, 4)
    model = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0, beta=2.0,
                                    nt=4, dtype=jnp.float64)
    cfg = EngineConfig(nt=4, n_stab=2)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    states = jax.vmap(lambda k: init_state(model, cfg, k))(keys)
    mesh = make_mesh(8)
    states = shard_walkers(states, mesh)
    assert len(states.G.sharding.device_set) == 8
    out = jax.jit(jax.vmap(lambda s: sweep_pair(model, cfg, s)))(states)
    assert len(out.G.sharding.device_set) == 8


def test_driver_sharded_output_identical(sharded_and_unsharded):
    """Sharding must not change the simulation.

    Two layers of identity:
    - the Markov chains themselves are IDENTICAL: the final integer HS field
      configurations (from the checkpoint) match bit-for-bit, i.e. every
      accept/reject decision of every walker was the same;
    - the measured bins match to reduction-order rounding (XLA legitimately
      compiles different-but-equivalent summation orders for different
      shardings, so float reductions are equal only to ~1 ulp accumulation).
    """
    d_un, s_un = sharded_and_unsharded["unsharded"]
    d_sh, s_sh = sharded_and_unsharded["sharded"]
    ck_un = np.load(d_un / "results" / "checkpoint.npz")
    ck_sh = np.load(d_sh / "results" / "checkpoint.npz")
    # the HS field configuration is the only signed-integer leaf
    int_leaves_un = [k for k in ck_un.files
                     if k.startswith("leaf_") and ck_un[k].dtype.kind == "i"]
    assert int_leaves_un, "no integer field leaf in checkpoint"
    for k in int_leaves_un:
        np.testing.assert_array_equal(ck_un[k], ck_sh[k])

    for w in range(8):
        a = _h5_datasets(d_un / "results" / f"data_{w}.h5")
        b = _h5_datasets(d_sh / "results" / f"data_{w}.h5")
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12,
                                       err_msg=f"walker {w}: {k}")
    np.testing.assert_allclose(s_un.acc_rate, s_sh.acc_rate, rtol=1e-12)


def test_summary_reports_steady_state_error(sharded_and_unsharded):
    _, summary = sharded_and_unsharded["unsharded"]
    # transient from the random field is tracked separately from the
    # steady-state (measurement phase) error
    assert np.isfinite(summary.therm_max_precision_error)
    assert summary.max_precision_error <= summary.therm_max_precision_error
    assert summary.max_precision_error < 1e-8  # f64 steady state


def test_distributed_helpers_single_process():
    from dqmc_tpu.parallel.distributed import (global_walker_mesh,
                                               initialize_distributed,
                                               local_rank_offset)
    initialize_distributed()  # no-op single process
    mesh = global_walker_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert local_rank_offset(4) == 0


def test_pt_driver_sharded_matches_unsharded(tmp_path):
    """PT driver: replica axis sharded over the mesh gives bit-identical
    bins (the exchange permutation lowers to collective-permute)."""
    pt_params = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 2.0
nt = 8
n_therms = 2
n_sweeps = 2
n_bins = 2
n_stab = 4
seed = 3
dtype = float64
[walkers]
n_devices = %d
[ParallelTempering]
enabled = true
sweep_steps = 2
betas = 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5
"""
    outs = {}
    for tag, ndev in (("un", 1), ("sh", 8)):
        d = tmp_path / tag
        d.mkdir()
        params = Parameters.from_string(pt_params % ndev)
        summary = run_simulation(params, out_dir=str(d / "results"),
                                 verbose=False)
        outs[tag] = (d, summary)
    for r in range(8):
        a = _h5_datasets(outs["un"][0] / "results" / f"data_{r}.h5")
        b = _h5_datasets(outs["sh"][0] / "results" / f"data_{r}.h5")
        assert a.keys() == b.keys()
        for k in a:
            # reduction-order rounding only (see the standard-driver test)
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12,
                                       err_msg=f"replica {r}: {k}")
    # identical exchange decisions => identical exchange rate
    assert outs["un"][1].exchange_rate == outs["sh"][1].exchange_rate
