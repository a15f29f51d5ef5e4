"""Per-fold error-growth curve of the df32 LDR chain at stretch scale.

Round-5 root cause, step 3.  Established so far (BENCHMARKS round-13 +
appendix): the 2.27e-4 stretch chain error is NOT conditioning (flat
~1e3 equilibrated fold-input conds), NOT the df32.matmul digit planes
(3.1e-15 at k=1024 adversarially), and NOT single-fold QR quality (the
n=1024 XLA-path fold reads orth 4.0e-13 / back 3.4e-13 / d_rel 1.4e-12
on its realistic chain input).  What remains is GROWTH of carried error
along the 64-fold chain (32 -> 64 folds at n=1024 took 2.4e-7 ->
2.3e-4, ~1.24x/fold compounding).

This tool measures the growth curve directly: fold the df chain and an
f64 stabilized shadow chain (host LAPACK) over the SAME slice inputs,
and at every fold k score

  errG(k)   max |G_df(k) - G_64(k)|   (both solved EXACTLY in f64 from
                                       their factors — isolates factor
                                       error from the df solve)
  d_rel(k)  max_j |d_df - d_64|/d_64  (sorted ladders; resolution of
                                       the diagonal)
  r_max(k)  max |R_df|                (the R-product chain is the one
                                       multiword product OUTSIDE the
                                       fold QR — ops/df_linalg.py:253)

An exponential errG curve pins the amplification; a step identifies a
single guilty fold; d_rel-vs-errG says whether the damage sits in the
ladder or in L/R.  Run on the GPU (folds are jitted there; on the CPU
they run eagerly, see platform.jit_multiword).

Usage: python tools/r5_chain_growth.py --n 1024 --beta 16 --nt 320
"""

import argparse
import functools
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        import jax as _jax
        _jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--nt", type=int, default=320)
    p.add_argument("--beta", type=float, default=16.0)
    p.add_argument("--n-stab", type=int, default=5)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--every", type=int, default=1,
                   help="score every k-th fold (1 = all)")
    p.add_argument("--nm", choices=("df32", "tf32"), default="df32")
    args = p.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from dqmc_tpu import compile_cache
    compile_cache.enable()
    import jax.numpy as jnp
    from dqmc_tpu.ops import df32, df_linalg, linalg
    if args.nm == "tf32":
        from dqmc_tpu.ops import tf32 as nm
    else:
        nm = df32

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_df_linalg import _b_chain

    rng = np.random.default_rng(args.seed)
    Bs = _b_chain(rng, args.n, args.nt, args.beta)
    n = args.n
    cpu0 = jax.devices("cpu")[0]
    from dqmc_tpu import platform
    jj = jax.jit if platform.jit_multiword() else (lambda f: f)
    fold_first = jj(functools.partial(df_linalg.to_ldr, nm=nm))
    fold_next = jj(functools.partial(df_linalg.mat_mul_ldr, nm=nm))

    def to64(x):
        return np.asarray(nm.to_f64(x))

    def solve_factors_f64(L, d_full, R):
        with jax.default_device(cpu0):
            Fx = linalg.LDR(jnp.asarray(L), jnp.asarray(d_full),
                            jnp.asarray(R))
            G, _ = linalg.inv_one_plus_ldr_dag(
                linalg.identity_ldr(n, jnp.float64), Fx)
            return np.asarray(G)

    n_stab = args.n_stab
    nt = args.nt
    n_stack = -(-nt // n_stab)
    print(f"n={n} beta={args.beta} nt={nt} n_stab={n_stab} "
          f"({n_stack} folds) nm={args.nm} "
          f"backend={jax.default_backend()}", flush=True)

    Fdf = None
    F64 = None
    t0 = time.time()
    for k, i_blk in enumerate(range(n_stack - 1, -1, -1)):
        blk = Bs[i_blk * n_stab:(i_blk + 1) * n_stab]
        Bbar = np.eye(n)
        for B in blk:
            Bbar = B @ Bbar
        T64 = Bbar.T
        T = nm.from_f64(jnp.asarray(T64, jnp.float64))
        Fdf = fold_first(T) if Fdf is None else fold_next(T, Fdf)
        with jax.default_device(cpu0):
            Tj = jnp.asarray(T64)
            F64 = (linalg.to_ldr(Tj) if F64 is None
                   else linalg.mat_mul_ldr(Tj, F64))
        if k % args.every and k != n_stack - 1:
            continue
        d_df = np.sort(to64(Fdf.d) * np.exp2(
            np.asarray(Fdf.e, np.float64)))[::-1]
        d_64 = np.sort(np.asarray(F64.d))[::-1]
        d_rel = float(np.max(np.abs(d_df - d_64)
                             / np.maximum(d_64, 1e-300)))
        r_max = float(np.abs(to64(Fdf.R)).max())
        G_df = solve_factors_f64(
            to64(Fdf.L),
            to64(Fdf.d) * np.exp2(np.asarray(Fdf.e, np.float64)),
            to64(Fdf.R))
        G_64 = solve_factors_f64(np.asarray(F64.L), np.asarray(F64.d),
                                 np.asarray(F64.R))
        errg = float(np.abs(G_df - G_64).max())
        print(f"fold {k + 1:3d}/{n_stack}: errG={errg:.3e} "
              f"d_rel={d_rel:.3e} maxR={r_max:.3e} "
              f"[{time.time() - t0:.0f}s]", flush=True)


if __name__ == "__main__":
    main()
