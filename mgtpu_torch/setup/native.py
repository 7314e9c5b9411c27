"""The host setup kernels (``csrc/setup_kernels.cpp``) through ctypes.

Counterpart of mgtpu/utils/native.py.  The C++ source is built with g++ at
first use into ``mgtpu_torch/_build/`` (listed in .gitignore); the
library's name carries a digest of the source and flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing is built
at import time.

A failed build or load raises with the compiler's message: there is no
numpy fallback.  The numpy versions (`sa_amg.neighborhood_aggregation`,
`classical_amg.cf_coloring_first` and `cf_coloring_second`) are the plain
versions the tests hold these kernels to; they count their calls in
`PLAIN_CALLS`, the kernels in `CALLS`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import scipy.sparse as sp

__all__ = ["aggregate", "cf_coloring", "cf_coloring_first", "library",
           "CALLS", "PLAIN_CALLS"]

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "setup_kernels.cpp"
BUILD_DIR = PKG / "_build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

CALLS = {"aggregate": 0, "cf_coloring_first": 0, "cf_coloring": 0}
PLAIN_CALLS = {"aggregate": 0, "cf_coloring_first": 0, "cf_coloring": 0}

_LIB = None
_LOCK = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)
_I8P = ctypes.POINTER(ctypes.c_int8)


def lib_path() -> Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsetup_kernels-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the setup kernels are built from "
                           f"{SOURCE} with a host C++ compiler")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.mgt_aggregate.argtypes = [
                ctypes.c_int64, _I64P, _I64P,
                ctypes.POINTER(ctypes.c_double), ctypes.c_double, _I64P]
            for f in (lib.mgt_cf_color_first, lib.mgt_cf_color_second):
                f.argtypes = [ctypes.c_int64, _I64P, _I64P, _I8P]
            for f in (lib.mgt_aggregate, lib.mgt_cf_color_first,
                      lib.mgt_cf_color_second):
                f.restype = None
            _LIB = lib
        return _LIB


def _csr(S):
    """S as canonical CSR (sorted in place when S is CSR already, as
    mgtpu's loader does) and its int64 index arrays."""
    S = S.tocsr()
    if S.shape[0] != S.shape[1]:
        raise ValueError(f"a strength matrix is square, got {S.shape}")
    S.sort_indices()
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int64)
    return S, indptr, indices


def aggregate(S: sp.spmatrix, tau: float = 3.0) -> np.ndarray:
    """SA neighborhood aggregation: aggr[i] = root node of i's aggregate
    (equals `sa_amg.neighborhood_aggregation` on the sorted S)."""
    S, indptr, indices = _csr(S)
    lib = library()
    data = np.ascontiguousarray(S.data, dtype=np.float64)
    aggr = np.empty(S.shape[0], dtype=np.int64)
    lib.mgt_aggregate(S.shape[0], indptr.ctypes.data_as(_I64P),
                      indices.ctypes.data_as(_I64P),
                      data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      float(tau), aggr.ctypes.data_as(_I64P))
    CALLS["aggregate"] += 1
    return aggr


def _color(S, second: bool) -> np.ndarray:
    S, indptr, indices = _csr(S)
    lib = library()
    col = np.zeros(S.shape[0], dtype=np.int8)
    args = (S.shape[0], indptr.ctypes.data_as(_I64P),
            indices.ctypes.data_as(_I64P), col.ctypes.data_as(_I8P))
    lib.mgt_cf_color_first(*args)
    if second:
        lib.mgt_cf_color_second(*args)
    return col


def cf_coloring_first(S: sp.spmatrix) -> np.ndarray:
    """C/F coloring pass 1, 1 = coarse (equals
    `classical_amg.cf_coloring_first`)."""
    col = _color(S, second=False)
    CALLS["cf_coloring_first"] += 1
    return col


def cf_coloring(S: sp.spmatrix) -> np.ndarray:
    """Both C/F coloring passes (equals `classical_amg.cf_coloring_second`
    after `cf_coloring_first`)."""
    col = _color(S, second=True)
    CALLS["cf_coloring"] += 1
    return col
