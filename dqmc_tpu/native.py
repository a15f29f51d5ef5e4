"""ctypes loader for the native host runtime (native/libdqmc_host.so).

The compute path is JAX/XLA/Pallas on the device; the host-side runtime
pieces — binned statistics and the asynchronous measurement spool — are
C++ (native/*.cpp), mirroring the reference's native runtime role
(include/measurementh5.h, include/h5utils.h, scripts/analysis.py hot
loops).  The library auto-builds on first use when a compiler is present;
every consumer has a pure-numpy fallback, so the framework degrades
gracefully on toolchain-less hosts.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdqmc_host.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        out = subprocess.run(["make", "-C", _NATIVE_DIR],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            print(f"dqmc_tpu: native build failed:\n{out.stderr[-800:]}",
                  file=sys.stderr)
            return False
        return True
    except Exception as e:  # missing make/compiler
        print(f"dqmc_tpu: native build unavailable ({e})", file=sys.stderr)
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src = [os.path.join(_NATIVE_DIR, f)
               for f in ("dqmc_stats.cpp", "dqmc_spool.cpp")]
        # a library older than its sources (one copied from another
        # machine, or left by an earlier checkout) is rebuilt
        stale = (not os.path.exists(_LIB_PATH)
                 or any(os.path.getmtime(f) > os.path.getmtime(_LIB_PATH)
                        for f in src if os.path.exists(f)))
        if stale and (not all(map(os.path.exists, src)) or not _build()):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            print(f"dqmc_tpu: cannot load native lib: {e}", file=sys.stderr)
            return None
        _declare(lib)
        _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    dptr = ctypes.POINTER(ctypes.c_double)
    i64ptr = ctypes.POINTER(ctypes.c_int64)
    lib.dqmc_jackknife.restype = ctypes.c_int
    lib.dqmc_jackknife.argtypes = [dptr, ctypes.c_int64, ctypes.c_int64,
                                   dptr, dptr]
    lib.dqmc_jackknife_complex.restype = ctypes.c_int
    lib.dqmc_jackknife_complex.argtypes = [dptr, ctypes.c_int64,
                                           ctypes.c_int64, dptr, dptr]
    lib.dqmc_rebin.restype = ctypes.c_int64
    lib.dqmc_rebin.argtypes = [dptr, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, dptr]
    lib.dqmc_autocorr_time.restype = ctypes.c_double
    lib.dqmc_autocorr_time.argtypes = [dptr, ctypes.c_int64]
    lib.spool_open.restype = ctypes.c_void_p
    lib.spool_open.argtypes = [ctypes.c_char_p]
    lib.spool_write.restype = ctypes.c_int
    lib.spool_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int64, ctypes.c_int, i64ptr,
                                ctypes.c_int, dptr]
    lib.spool_flush.restype = ctypes.c_int
    lib.spool_flush.argtypes = [ctypes.c_void_p]
    lib.spool_close.restype = ctypes.c_int
    lib.spool_close.argtypes = [ctypes.c_void_p]


def _as_f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def jackknife_native(data: np.ndarray):
    """(mean, err) over axis 0 using the C++ core; None if unavailable.

    Real data of any trailing shape, or complex128 (routed to the complex
    kernel with the reference's direct complex-variance semantics).
    """
    lib = load()
    if lib is None:
        return None
    data = np.asarray(data)
    n_bins = data.shape[0]
    trailing = data.shape[1:]
    if np.iscomplexobj(data):
        inter = np.empty(data.shape + (2,), dtype=np.float64)
        inter[..., 0] = data.real
        inter[..., 1] = data.imag
        flat = np.ascontiguousarray(inter.reshape(n_bins, -1, 2))
        n_elem = flat.shape[1]
        mean = np.empty((n_elem, 2))
        err = np.empty((n_elem, 2))
        rc = lib.dqmc_jackknife_complex(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_bins, n_elem,
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            return None
        to_c = lambda a: (a[..., 0] + 1j * a[..., 1]).reshape(trailing)
        return to_c(mean), to_c(err)
    flat = _as_f64(data.reshape(n_bins, -1))
    n_elem = flat.shape[1]
    mean = np.empty(n_elem)
    err = np.empty(n_elem)
    rc = lib.dqmc_jackknife(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_bins, n_elem,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    return mean.reshape(trailing), err.reshape(trailing)


def rebin_native(data: np.ndarray, factor: int):
    lib = load()
    if lib is None:
        return None
    data = _as_f64(np.asarray(data).reshape(len(data), -1))
    n_bins, n_elem = data.shape
    out = np.empty((n_bins // factor, n_elem))
    n = lib.dqmc_rebin(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_bins, n_elem, factor,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if n < 0:
        return None
    return out


def autocorr_time_native(x: np.ndarray):
    lib = load()
    if lib is None:
        return None
    x = _as_f64(x)
    return float(lib.dqmc_autocorr_time(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(x)))
