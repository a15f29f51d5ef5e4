"""Offline jackknife analysis over binned HDF5 output.

Clean-room, behavior-compatible rewrite of the reference's analysis tool
(scripts/analysis.py): reads ``results/data_*.h5`` + ``results/info``,
jackknifes all bins, and writes

  - ``scalarObservables.dat``           (name, mean, error)
  - ``<obs>/statr.dat``                 real-space mean/error per (rx, ry, a, b[, tau])
  - ``<obs>/statr0.dat``                unequal-time tau slices at r = 0
  - ``<obs>/statk.dat``                 complex k-space mean/error

with identical column formats, so downstream tooling written against the
reference's outputs keeps working.  In parallel-tempering mode only
``data_0.h5`` (the target beta) is analyzed (analysis.py:46-48); standard
runs pool bins from every walker/rank file as one ensemble.

Usage: ``python -m dqmc_tpu.analysis [-d results]`` from the run directory.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List

import numpy as np

from dqmc_tpu.analysis.jackknife import (jackknife, jackknife_array,
                                         jackknife_ratio_array)


def is_pt_enabled(param_file: str = "parameters.in") -> bool:
    if not os.path.exists(param_file):
        return False
    from dqmc_tpu.config import Parameters
    try:
        return Parameters(param_file).get_bool("ParallelTempering", "enabled",
                                               False)
    except Exception:
        return False


def _data_files(results_dir: str, pt_enabled: bool) -> List[str]:
    if pt_enabled:
        files = [os.path.join(results_dir, "data_0.h5")]
    else:
        files = sorted(glob.glob(os.path.join(results_dir, "data_*.h5")))
    if not files or not os.path.exists(files[0]):
        raise FileNotFoundError(f"No data files found in {results_dir}")
    return files


def _sorted_bins(f, prefix: str) -> List[str]:
    keys = [k for k in f.keys() if k.startswith(prefix)
            and k[len(prefix):].isdigit()]
    return sorted(keys, key=lambda k: int(k[len(prefix):]))


def load_bins(results_dir: str, pt_enabled: bool):
    """Returns (scalars, eq_r, eq_k, uneq_r, uneq_k): dicts name -> list of
    per-bin arrays, pooled over all files."""
    import h5py

    scalars: Dict[str, list] = {}
    eq_r: Dict[str, list] = {}
    eq_k: Dict[str, list] = {}
    uneq_r: Dict[str, list] = {}
    uneq_k: Dict[str, list] = {}
    for path in _data_files(results_dir, pt_enabled):
        with h5py.File(path, "r") as f:
            for bin_name in _sorted_bins(f, "bin_"):
                g = f[bin_name]
                for name in g.get("scalar", {}):
                    ds = g["scalar"][name]
                    val = ds[()] if ds.shape == () else ds[0]
                    scalars.setdefault(name, []).append(val)
                for name in g.get("equaltime", {}):
                    eq_r.setdefault(name, []).append(np.array(g["equaltime"][name]))
                for name in g.get("unequaltime", {}):
                    uneq_r.setdefault(name, []).append(
                        np.array(g["unequaltime"][name]))
            for bin_name in _sorted_bins(f, "binK_"):
                g = f[bin_name]
                for name in g.get("equaltime", {}):
                    d = np.array(g["equaltime"][name])
                    eq_k.setdefault(name, []).append(d[..., 0] + 1j * d[..., 1])
                for name in g.get("unequaltime", {}):
                    d = np.array(g["unequaltime"][name])
                    uneq_k.setdefault(name, []).append(d[..., 0] + 1j * d[..., 1])
    return scalars, eq_r, eq_k, uneq_r, uneq_k


def load_lattice_info(results_dir: str) -> Dict:
    info = {}
    with open(os.path.join(results_dir, "info")) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                key, value = parts
                try:
                    value = int(value)
                except ValueError:
                    try:
                        value = float(value)
                    except ValueError:
                        pass
                info[key] = value
    return info


def _r_phys(x: int, y: int, info: Dict):
    L1, L2 = info["L1"], info["L2"]
    rx = (x - (L1 / 2 - 1)) * info["a1_x"] + (y - (L2 / 2 - 1)) * info["a2_x"]
    ry = (x - (L1 / 2 - 1)) * info["a1_y"] + (y - (L2 / 2 - 1)) * info["a2_y"]
    return rx, ry


def _k_phys(kx: int, ky: int, info: Dict):
    L1, L2 = info["L1"], info["L2"]
    det = info["a1_x"] * info["a2_y"] - info["a1_y"] * info["a2_x"]
    b1 = (2 * np.pi * info["a2_y"] / det / L1, -2 * np.pi * info["a2_x"] / det / L1)
    b2 = (-2 * np.pi * info["a1_y"] / det / L2, 2 * np.pi * info["a1_x"] / det / L2)
    qx = kx - L1 // 2 + 1
    qy = ky - L2 // 2 + 1
    return qx * b1[0] + qy * b2[0], qx * b1[1] + qy * b2[1]


def _ab_tau(flat_idx: int, n_orb: int, n_tau: int):
    tau = flat_idx % n_tau
    ab = flat_idx // n_tau
    return ab // n_orb, ab % n_orb, tau


def analyze(results_dir: str = "results", param_file: str = "parameters.in",
            out_dir: str = ".", verbose: bool = True,
            use_native: bool = False) -> Dict:
    log = print if verbose else (lambda *a: None)
    pt = is_pt_enabled(param_file)
    info = load_lattice_info(results_dir)
    n_orb = info.get("n_orb", 1)
    scalars, eq_r, eq_k, uneq_r, uneq_k = load_bins(results_dir, pt)

    # Sign reweighting: sign-prone runs store every observable
    # sign-weighted (<O s> per bin) plus the <s> series as a "sign" scalar
    # (measure/manager.py).  The physical estimator is the ratio
    # <O s>/<s>, jackknifed jointly (numerator and denominator correlate).
    # Sign-free runs have no "sign" dataset and analyze exactly as before.
    sign_bins = None
    if "sign" in scalars and len(scalars["sign"]) >= 2:
        sign_bins = np.asarray(scalars["sign"], dtype=np.float64)
        log(f"sign-prone run: reweighting by <sign> = {sign_bins.mean():.4f}")

    def jk(bins):
        if sign_bins is None:
            return jackknife(np.asarray(bins), use_native=use_native)
        return jackknife_ratio_array(np.asarray(bins), sign_bins)

    def jk_array(bins):
        if sign_bins is None:
            return jackknife_array(np.asarray(bins), use_native=use_native)
        return jackknife_ratio_array(np.asarray(bins), sign_bins)

    results = {}
    if scalars:
        with open(os.path.join(out_dir, "scalarObservables.dat"), "w") as f:
            f.write("# Observable Mean Error\n")
            for name, bins in scalars.items():
                if name == "sign":   # <s> itself: plain jackknife
                    mean, err = jackknife(np.asarray(bins),
                                          use_native=use_native)
                else:
                    mean, err = jk(bins)
                results[name] = (mean, err)
                f.write(f"{name} {mean} {err}\n")

    def obs_dir(name: str) -> str:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        return d

    # equal-time, real space: columns rx ry a b mean error
    for name, bins in eq_r.items():
        mean, err = jk_array(bins)
        nx, ny, S = mean.shape
        with open(os.path.join(obs_dir(name), "statr.dat"), "w") as f:
            f.write(f"# Equal-time observable: {name} (Real space)\n")
            f.write(f"# Dimensions: {mean.shape}\n")
            f.write("# Format: rx ry a b mean error\n")
            for x in range(nx):
                for y in range(ny):
                    for s in range(S):
                        a, b = s // n_orb, s % n_orb
                        rx, ry = _r_phys(x, y, info)
                        f.write(f"{rx:12.6f} {ry:12.6f} {a:3d} {b:3d} "
                                f"{mean[x, y, s]:15.8e} {err[x, y, s]:15.8e}\n")

    # equal-time, k space: complex columns
    for name, bins in eq_k.items():
        mean, err = jk_array(bins)
        nkx, nky, S = mean.shape
        with open(os.path.join(obs_dir(name), "statk.dat"), "w") as f:
            f.write(f"# Equal-time observable: {name} (K-space)\n")
            f.write(f"# Dimensions: {mean.shape}\n")
            f.write("# Format: kx ky a b mean_real mean_imag error_real error_imag\n")
            for kx in range(nkx):
                for ky in range(nky):
                    for s in range(S):
                        a, b = s // n_orb, s % n_orb
                        kxp, kyp = _k_phys(kx, ky, info)
                        m, e = mean[kx, ky, s], err[kx, ky, s]
                        f.write(f"{kxp:12.6f} {kyp:12.6f} {a:3d} {b:3d} "
                                f"{m.real:15.8e} {m.imag:15.8e} "
                                f"{e.real:15.8e} {e.imag:15.8e}\n")

    # unequal-time, real space: columns rx ry a b tau mean error (+ statr0)
    for name, bins in uneq_r.items():
        mean, err = jk_array(bins)
        nx, ny, S = mean.shape
        n_tau = S // (n_orb * n_orb)
        d = obs_dir(name)
        with open(os.path.join(d, "statr.dat"), "w") as f:
            f.write(f"# Unequal-time observable: {name} (Real space)\n")
            f.write(f"# Dimensions: {mean.shape}\n")
            f.write("# Format: rx ry a b tau mean error\n")
            for x in range(nx):
                for y in range(ny):
                    for s in range(S):
                        a, b, tau = _ab_tau(s, n_orb, n_tau)
                        rx, ry = _r_phys(x, y, info)
                        f.write(f"{rx:12.6f} {ry:12.6f} {a:3d} {b:3d} {tau:3d} "
                                f"{mean[x, y, s]:15.8e} {err[x, y, s]:15.8e}\n")
        x0 = max(0, min(info["L1"] // 2 - 1, info["L1"] - 1))
        y0 = max(0, min(info["L2"] // 2 - 1, info["L2"] - 1))
        with open(os.path.join(d, "statr0.dat"), "w") as f:
            f.write(f"# Unequal-time observable: {name} (Real space, at rx=0, ry=0)\n")
            f.write(f"# Dimensions: {mean.shape}\n")
            f.write("# Format: a b tau mean error\n")
            for s in range(S):
                a, b, tau = _ab_tau(s, n_orb, n_tau)
                f.write(f"{a:3d} {b:3d} {tau:3d} "
                        f"{mean[x0, y0, s]:15.8e} {err[x0, y0, s]:15.8e}\n")

    # unequal-time, k space
    for name, bins in uneq_k.items():
        mean, err = jk_array(bins)
        nkx, nky, S = mean.shape
        n_tau = S // (n_orb * n_orb)
        with open(os.path.join(obs_dir(name), "statk.dat"), "w") as f:
            f.write(f"# Unequal-time observable: {name} (K-space)\n")
            f.write(f"# Dimensions: {mean.shape}\n")
            f.write("# Format: kx ky a b tau mean_real mean_imag error_real error_imag\n")
            for kx in range(nkx):
                for ky in range(nky):
                    for s in range(S):
                        a, b, tau = _ab_tau(s, n_orb, n_tau)
                        kxp, kyp = _k_phys(kx, ky, info)
                        m, e = mean[kx, ky, s], err[kx, ky, s]
                        f.write(f"{kxp:12.6f} {kyp:12.6f} {a:3d} {b:3d} {tau:3d} "
                                f"{m.real:15.8e} {m.imag:15.8e} "
                                f"{e.real:15.8e} {e.imag:15.8e}\n")

    n_meas = len(next(iter(scalars.values()))) if scalars else 0
    log(f"Total measurements: {n_meas}")
    for name in sorted(set(scalars) | set(eq_r) | set(uneq_r)):
        log(f"{name} success.")
    log("Analysis complete.")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="dqmc_tpu.analysis",
        description="Jackknife analysis for DQMC binned HDF5 output")
    p.add_argument("-d", "--directory", default="results",
                   help="Results directory (default: results)")
    p.add_argument("-p", "--parameters", default="parameters.in",
                   help="Parameter file for PT detection (default: parameters.in)")
    p.add_argument("--native", action="store_true",
                   help="use the C++ statistics core (mathematically "
                        "identical; rounding may differ in the last digits)")
    args = p.parse_args(argv)
    analyze(args.directory, args.parameters, use_native=args.native)


if __name__ == "__main__":
    main()
