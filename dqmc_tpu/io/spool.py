"""Asynchronous binned-measurement spool (Python side).

Wraps the C++ background-writer spool (native/dqmc_spool.cpp): the
simulation loop enqueues each bin's arrays and returns immediately; a C++
thread appends them to a compact length-prefixed binary log.  After (or
during) the run, `convert_spool_to_h5` replays the log into the reference's
exact HDF5 layout, so the analysis contract is unchanged.

Enable with ``[io] sink = spool`` in parameters.in.  Without the native
library opening a spool raises; without h5py the conversion says so on
stderr and leaves the log in place (``read_spool`` reads it back).
"""

from __future__ import annotations

import ctypes
import os
import struct
import sys
from typing import Dict, Optional

import numpy as np

from dqmc_tpu import native

MAGIC = b"DQMB"


class Spool:
    def __init__(self, path: str | os.PathLike):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native spool unavailable")
        self._lib = lib
        d = os.path.dirname(str(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._h = lib.spool_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open spool {path}")

    def write(self, name: str, bin_idx: int, arr: np.ndarray) -> None:
        arr = np.asarray(arr)
        if np.iscomplexobj(arr):
            kind = 1
            data = np.empty(arr.shape + (2,), dtype=np.float64)
            data[..., 0] = arr.real
            data[..., 1] = arr.imag
        else:
            kind = 0
            data = np.ascontiguousarray(arr, dtype=np.float64)
        shape = np.asarray(arr.shape, dtype=np.int64)
        if arr.ndim == 0:
            shape = np.asarray([1], dtype=np.int64)
        data = np.ascontiguousarray(data)
        rc = self._lib.spool_write(
            self._h, name.encode(), bin_idx, kind,
            shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(shape),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise OSError("spool write failed")

    def flush(self) -> None:
        if self._lib.spool_flush(self._h) != 0:
            raise OSError("spool flush failed")

    def close(self) -> None:
        if self._h:
            rc = self._lib.spool_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError("spool close reported an IO error")


def read_spool(path: str | os.PathLike):
    """Yield (name, bin_idx, array) records from a spool log."""
    with open(path, "rb") as f:
        header = f.read(8)
        if header[:4] != MAGIC:
            raise ValueError(f"{path}: not a dqmc spool file")
        while True:
            raw = f.read(4)
            if not raw:
                return
            (name_len,) = struct.unpack("<I", raw)
            name = f.read(name_len).decode()
            bin_idx, kind, ndim = struct.unpack("<qBI", f.read(13))
            shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
            n = int(np.prod(shape)) * (2 if kind else 1)
            data = np.frombuffer(f.read(8 * n), dtype=np.float64)
            if kind:
                data = (data[0::2] + 1j * data[1::2])
            yield name, bin_idx, data.reshape(shape)


def convert_spool_to_h5(spool_path, h5_path) -> Optional[int]:
    """Replay a spool log into the reference HDF5 layout.

    Record names carry their group as a prefix, e.g. 'scalar/density',
    'equaltime/densityCorr', 'K/unequaltime/greenTau'.  Returns the number
    of bins written, or None when h5py is not installed: the log then
    stays where it is and the reason goes to stderr.
    """
    try:
        import h5py  # noqa: F401
    except ImportError:
        print(f"dqmc_tpu: converting {spool_path} to HDF5 needs h5py, "
              f"which is not installed; the binary log is kept",
              file=sys.stderr)
        return None
    from dqmc_tpu.io.h5out import BinFileWriter

    bins: Dict[int, Dict[str, Dict[str, np.ndarray]]] = {}
    for name, bin_idx, arr in read_spool(spool_path):
        slot = bins.setdefault(bin_idx, {
            "scalar": {}, "eq_r": {}, "eq_k": {}, "uneq_r": {}, "uneq_k": {}})
        if name.startswith("scalar/"):
            slot["scalar"][name[7:]] = float(arr.reshape(-1)[0])
        elif name.startswith("equaltime/"):
            slot["eq_r"][name[10:]] = arr
        elif name.startswith("unequaltime/"):
            slot["uneq_r"][name[12:]] = arr
        elif name.startswith("K/equaltime/"):
            slot["eq_k"][name[12:]] = arr
        elif name.startswith("K/unequaltime/"):
            slot["uneq_k"][name[14:]] = arr
        else:
            raise ValueError(f"unknown spool record group: {name}")

    with BinFileWriter(h5_path) as w:
        for bin_idx in sorted(bins):
            s = bins[bin_idx]
            w.write_bin(bin_idx, s["scalar"], s["eq_r"], s["eq_k"],
                        s["uneq_r"], s["uneq_k"])
    return len(bins)
