"""Physics capstone (VERDICT r4 item 5): the reference's canonical
workload run end-to-end by this framework at production counts.

Workload = the reference's shipped example (examples/parameters.in:
6x6, beta=4, nt=40, U=4, mu=-0.1, n_stab=10, symmetric Trotter;
2000 thermalization sweeps + 1000 bins x 40 sweeps), which is our
examples/basic.  Three arms:

  A (production): dtype=float32 sampling + measure_precision=tf32,
     FULL production counts — the flagship mode doing the reference's
     actual scientific job, through `python -m dqmc_tpu.analysis`.
  B (sampling control): dtype=df32 (~1e-8 sampling) + tf32 measurement,
     1/4 the bins — the capstone-scale arm of the bias A/B (item 1).
  C (oracle): dtype=float64 end-to-end, 1/8 the bins — the strict
     parity mode (1e-10-grade G everywhere).

Output: per-arm scalarObservables.dat via the analysis CLI, plus a
markdown results table with jackknife errors and pairwise z-scores
(A-B and A-C must agree within 2 sigma).  Run on the GPU.

Usage: python tools/r5_capstone.py [--bins 1000] [--walkers 16]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASE = """
[Lattice]
L1 = 6
L2 = 6
[hubbard]
U = 4.0
t = 1.0
mu = -0.1
[simulation]
beta = 4.0
nt = 40
n_therms = {therms}
n_sweeps = 40
n_bins = {bins}
n_stab = {n_stab}
symmetric = true
isMeasureUnequalTime = false
seed = {seed}
dtype = {dtype}
{extra}
[walkers]
n_walkers = {walkers}
"""


def run_arm(tag, out, **kw):
    from dqmc_tpu.config import Parameters
    from dqmc_tpu.run import run_simulation
    from dqmc_tpu.analysis.cli import analyze
    os.makedirs(out, exist_ok=True)
    text = BASE.format(**kw)
    pfile = os.path.join(out, "parameters.in")
    with open(pfile, "w") as f:
        f.write(text)
    rdir = os.path.join(out, "results")
    t0 = time.time()
    summary = run_simulation(Parameters.from_string(text), out_dir=rdir,
                             verbose=False)
    dt = time.time() - t0
    print(f"[{tag}] {kw['bins']} bins x 40 sweeps x {kw['walkers']} walkers "
          f"in {dt:.0f}s ({summary.sweeps_per_sec:.2f} sweeps/s, "
          f"acc={summary.acc_rate:.4f}, "
          f"err_max={summary.max_precision_error:.3e})", flush=True)
    res = analyze(results_dir=rdir, param_file=pfile, out_dir=out,
                  verbose=False)
    return {n: (float(m), float(e)) for n, (m, e) in res.items()}, dt


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--bins", type=int, default=1000)
    p.add_argument("--walkers", type=int, default=16)
    p.add_argument("--therms", type=int, default=2000)
    p.add_argument("--n-stab", type=int, default=10,
                   help="stabilization interval (the reference example's 10 "
                        "is f64-tuned; the f32 engine's envelope at 6x6 "
                        "beta=4 prefers 5)")
    p.add_argument("--skip", default="",
                   help="comma list of arms to skip (A,B,C) — their "
                        "previous results dirs are re-analyzed instead")
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "capstone"))
    args = p.parse_args()
    skip = set(s.strip().upper() for s in args.skip.split(",") if s.strip())

    arms = {
        "A": dict(dtype="float32", extra="measure_precision = tf32",
                  n_stab=args.n_stab,
                  bins=args.bins, therms=args.therms, seed=11,
                  walkers=args.walkers),
        # arm B measures at df32: the measurement-grade delta to tf32
        # (~1e-8) is far below the statistical resolution
        "B": dict(dtype="df32", extra="measure_precision = df32",
                  n_stab=args.n_stab,
                  bins=max(2, args.bins // 4), therms=args.therms,
                  seed=22, walkers=args.walkers),
        "C": dict(dtype="float64", extra="", n_stab=args.n_stab,
                  bins=max(2, args.bins // 8),
                  therms=max(200, args.therms // 4), seed=33,
                  walkers=args.walkers),
    }
    results, times, failures = {}, {}, {}
    for tag, kw in arms.items():
        out = os.path.join(args.out, tag)
        try:
            if tag in skip:
                if not os.path.isdir(os.path.join(out, "results")):
                    # skipped with no prior run on disk: genuinely absent,
                    # not a failure (e.g. arm B dropped for wall budget —
                    # its A-vs-B role is covered at the headline by
                    # tools/r5_bias_ab.py)
                    print(f"[{tag}] skipped (no prior results)", flush=True)
                    continue
                from dqmc_tpu.analysis.cli import analyze
                res = analyze(results_dir=os.path.join(out, "results"),
                              param_file=os.path.join(out, "parameters.in"),
                              out_dir=out, verbose=False)
                results[tag] = {n: (float(m), float(e))
                                for n, (m, e) in res.items()}
                times[tag] = float("nan")
            else:
                results[tag], times[tag] = run_arm(tag, out, **kw)
        except Exception as exc:  # isolate arms: one arm's compile/
            # failure must not void the others' results
            failures[tag] = f"{type(exc).__name__}: {exc}"[:500]
            print(f"[{tag}] FAILED: {failures[tag]}", flush=True)
    if failures and not results:
        print(json.dumps({"ok": False, "failures": failures}))
        return 1
    for tag in failures:
        results.pop(tag, None)

    def z(x, y):
        (mx, ex), (my, ey) = x, y
        d = float(np.hypot(ex, ey))
        return abs(mx - my) / d if d else float("inf")

    tags = [t for t in "ABC" if t in results]
    names = sorted(set.intersection(*(set(results[t]) for t in tags))) \
        if tags else []
    heads = {"A": "A: f32+tf32-meas (production)", "B": "B: df32-sampled",
             "C": "C: f64 oracle"}
    pairs = [(a, b) for i, a in enumerate(tags) for b in tags[i + 1:]]
    lines = ["| observable | " + " | ".join(heads[t] for t in tags)
             + " | " + " | ".join(f"z({a},{b})" for a, b in pairs) + " |",
             "|" + "---|" * (1 + len(tags) + len(pairs))]
    ok = bool(tags)
    for n in names:
        zs = [z(results[a][n], results[b][n]) for a, b in pairs]
        ok &= all(v < 2.0 for v in zs)
        cells = [f"{results[t][n][0]:.6f} ± {results[t][n][1]:.1e}"
                 for t in tags]
        lines.append(f"| {n} | " + " | ".join(cells) + " | "
                     + " | ".join(f"{v:.2f}" for v in zs) + " |")
    table = "\n".join(lines)
    print(table, flush=True)
    verdict = {"tool": "r5_capstone", "bins": args.bins,
               "walkers": args.walkers, "ok": bool(ok and not failures),
               "failures": failures,
               "results": results, "seconds": times}
    with open(os.path.join(args.out, "verdict.json"), "w") as f:
        json.dump(verdict, f, indent=1)
    with open(os.path.join(args.out, "table.md"), "w") as f:
        f.write(table + "\n")
    print(json.dumps({"ok": ok, "seconds": times}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
