"""Golden-reference numpy/scipy implementation of stable LDR algebra.

This is the test oracle: a straightforward float64 implementation using
scipy's true greedy column-pivoted QR (LAPACK geqp3 — the same routine the
reference binary calls through Armadillo/MKL).  The production JAX code in
dqmc_tpu.ops.linalg replaces greedy pivoting with a column-norm pre-sort to
stay batch-friendly; these goldens quantify that the substitution costs
nothing at f64.

Written clean-room from the UDT stabilization math; see
dqmc_tpu/ops/linalg.py docstrings for the factorization derivations.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import scipy.linalg
import scipy.special


class GoldenLDR(NamedTuple):
    L: np.ndarray
    d: np.ndarray
    R: np.ndarray


def to_ldr(M: np.ndarray) -> GoldenLDR:
    Q, R, piv = scipy.linalg.qr(M, pivoting=True)
    d = np.abs(np.diag(R))
    d_safe = np.where(d == 0, 1.0, d)
    Rn = R / d_safe[:, None]
    inv_piv = np.argsort(piv)
    return GoldenLDR(Q, d, Rn[:, inv_piv])


def matrix(F: GoldenLDR) -> np.ndarray:
    return F.L @ (F.d[:, None] * F.R)


def mat_mul_ldr(M: np.ndarray, F: GoldenLDR) -> GoldenLDR:
    q = to_ldr((M @ F.L) * F.d[None, :])
    return GoldenLDR(q.L, q.d, q.R @ F.R)


def ldr_mul_mat(F: GoldenLDR, M: np.ndarray) -> GoldenLDR:
    q = to_ldr(F.d[:, None] * (F.R @ M))
    return GoldenLDR(F.L @ q.L, q.d, q.R)


def ldr_mul_ldr(F1: GoldenLDR, F2: GoldenLDR) -> GoldenLDR:
    q = to_ldr((F1.d[:, None] * (F1.R @ F2.L)) * F2.d[None, :])
    return GoldenLDR(F1.L @ q.L, q.d, q.R @ F2.R)


def _split(d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.maximum(d, 1.0), np.minimum(d, 1.0)


def inv_one_plus_ldr(F: GoldenLDR) -> Tuple[np.ndarray, float]:
    dl, ds = _split(F.d)
    n = len(F.d)
    X = np.linalg.solve(F.R, np.eye(n)) / dl[None, :]
    M = X + F.L * ds[None, :]
    sign, logabs = np.linalg.slogdet(M)
    G = X @ np.linalg.inv(M)
    return G, float(np.sum(np.log(dl)) + logabs)


def inv_one_plus_ldr_mul_ldr(F1: GoldenLDR, F2: GoldenLDR) -> Tuple[np.ndarray, float]:
    d1l, d1s = _split(F1.d)
    d2l, d2s = _split(F2.d)
    n = len(F1.d)
    X = np.linalg.solve(F2.R, np.eye(n)) / d2l[None, :]
    termA = (F1.L.T @ X) / d1l[:, None]
    termB = d1s[:, None] * (F1.R @ (F2.L * d2s[None, :]))
    M = termA + termB
    Y = F1.L.T / d1l[:, None]
    sign, logabs = np.linalg.slogdet(M)
    logdet = float(np.sum(np.log(d1l)) + np.sum(np.log(d2l)) + logabs)
    return X @ np.linalg.solve(M, Y), logdet


def inv_invldr_plus_ldr(F1: GoldenLDR, F2: GoldenLDR) -> np.ndarray:
    d1l, d1s = _split(F1.d)
    d2l, d2s = _split(F2.d)
    n = len(F1.d)
    X = np.linalg.solve(F2.R, np.eye(n)) / d2l[None, :]
    termA = (F1.L.T @ X) / d1l[:, None]
    termB = d1s[:, None] * (F1.R @ (F2.L * d2s[None, :]))
    M = termA + termB
    Y = d1s[:, None] * F1.R
    return X @ np.linalg.solve(M, Y)


# ----------------------------------------------------------------------
# analytic free-fermion (U=0) oracles
# ----------------------------------------------------------------------

def free_fermion_gtt(K: np.ndarray, beta: float) -> np.ndarray:
    """Exact G(0,0) = [I + e^{-beta K}]^{-1} via eigendecomposition."""
    eps, V = np.linalg.eigh(K)
    # stable logistic: 1/(1+e^{-beta eps})
    occ = scipy.special.expit(beta * eps)
    return (V * occ[None, :]) @ V.T


def free_fermion_gt0(K: np.ndarray, beta: float, tau: float) -> np.ndarray:
    """Exact G(tau,0) = [e^{tau K} + e^{-(beta-tau) K}]^{-1}."""
    eps, V = np.linalg.eigh(K)
    w = np.exp(-tau * eps) * scipy.special.expit(beta * eps)
    return (V * w[None, :]) @ V.T


def free_fermion_logdet(K: np.ndarray, beta: float) -> float:
    """log det [I + e^{-beta K}] = sum log(1 + e^{-beta eps})."""
    eps = np.linalg.eigvalsh(K)
    return float(np.sum(np.logaddexp(0.0, -beta * eps)))
