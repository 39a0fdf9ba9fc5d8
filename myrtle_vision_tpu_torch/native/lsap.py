"""ctypes wrapper of the repository's native LSAP solver (native/lsap.cpp),
a copy of myrtle_vision_tpu/native/lsap.py for the port.

Host code, not a kernel: the detection matcher solves one small
assignment per image on the CPU.  At first use the source is compiled
with g++ into the git-ignored ``myrtle_vision_tpu_torch/_build/`` (never
into ``native/``); where that fails, :func:`available` is False and the
matcher takes scipy's ``linear_sum_assignment`` (models/matcher.py).
Rectangular problems with rows >= cols are solved transposed (the solver
wants rows <= cols), with scipy's (row_ind, col_ind) contract.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "lsap.cpp"
_BUILD = _PKG / "_build"

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
            so = _BUILD / f"liblsap_{digest}.so"
            if not so.exists():
                _BUILD.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o",
                                str(tmp), str(_SRC)],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.lsap_solve.restype = ctypes.c_int
            lib.lsap_solve.argtypes = [
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def solve(cost: np.ndarray):
    """scipy-compatible LSAP: returns (row_ind, col_ind), length
    min(n_rows, n_cols), row_ind sorted ascending."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native lsap unavailable")
    cost = np.ascontiguousarray(cost, np.float64)
    n_rows, n_cols = cost.shape
    transposed = n_rows > n_cols
    if transposed:
        cost = np.ascontiguousarray(cost.T)
        n_rows, n_cols = n_cols, n_rows
    out = np.zeros(n_rows, np.int32)
    rc = lib.lsap_solve(
        n_rows, n_cols,
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"lsap_solve failed rc={rc}")
    rows = np.arange(n_rows, dtype=np.int64)
    cols = out.astype(np.int64)
    if transposed:
        rows, cols = cols, rows
        order = np.argsort(rows)
        rows, cols = rows[order], cols[order]
    return rows, cols
