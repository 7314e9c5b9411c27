"""Kernel E: the lexicographic Vanka sweep, and its plain version.

CUDA source: mgtpu_torch/csrc/vanka.cu (built by ops/cuda/_build.py).  It
runs on the card what mgtpu runs there as one `lax.fori_loop` over the
cells (mgtpu/cycle/vanka.py::_lex_sweep; no Pallas kernel): `num_it`
sequential sweeps, cell after cell, each cell's block residual from its
ELL rows, times its single-precision block inverse, added to x — one
launch a call, one thread block walking the cells.  Values are float32,
float64, complex64 or complex128; the block inverses float32, or complex64
for complex values (the single variant, raised to x's type before the
product as mgtpu's ``dinv.astype(x.dtype)``).

`lex_sweep(x, b, idx, dinv, rows_idx, rows_val, num_it)` launches the
kernel for a CUDA tensor (or raises on anything it does not take) and
takes the plain version, `lex_sweep_plain` (mgtpu's per-cell loop in
torch), only for a tensor on the CPU.  `LAUNCHES` counts kernel launches,
`PLAIN_CALLS` calls of the plain version, per value type of x.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "lex_sweep", "lex_sweep_plain"]

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
LAUNCHES = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
PLAIN_CALLS = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
MAX_SHARED = 48 * 1024           # kMaxShared: the (bs, m) block residual


def _key(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def lex_sweep_plain(x, b, idx, dinv, rows_idx, rows_val, num_it: int):
    """num_it lexicographic sweeps in torch, one cell at a time (mgtpu's
    fori_loop body): r = b[idx[l]] - rows_val[l] . x[rows_idx[l]], then
    x[idx[l]] += dinv[l] r.  x, b (n, m); returns the new x."""
    k = _key(x.dtype)
    PLAIN_CALLS[k] = PLAIN_CALLS.get(k, 0) + 1
    dinv = dinv.to(x.dtype)
    x = x.clone()
    m = x.shape[1]
    for _ in range(num_it):
        for l in range(idx.shape[0]):
            ri = rows_idx[l]
            xg = x[ri.reshape(-1)].reshape(ri.shape + (m,))
            r = b[idx[l]] - torch.einsum("bk,bkm->bm", rows_val[l], xg)
            x.index_add_(0, idx[l], dinv[l] @ r)
    return x


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("vanka")
    fn = lib.mgt_vanka_lex
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return lib


def lex_sweep(x, b, idx, dinv, rows_idx, rows_val, num_it: int):
    """num_it lexicographic Vanka sweeps on x, b (n, m): kernel E on a
    CUDA tensor (one launch; x is not written, the result is a new
    tensor), `lex_sweep_plain` on a CPU one.  idx (L, bs) and rows_idx
    (L, bs, K) int32, dinv (L, bs, bs) float32 (complex64 for complex
    x), rows_val (L, bs, K) of x's type."""
    if x.device.type == "cpu":
        return lex_sweep_plain(x, b, idx, dinv, rows_idx, rows_val, num_it)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel E takes float32, float64, complex64 or "
                        f"complex128, got {x.dtype}")
    if x.ndim != 2 or tuple(b.shape) != tuple(x.shape):
        raise ValueError(f"x and b must be (n, m), got {tuple(x.shape)} "
                         f"and {tuple(b.shape)}")
    b = b.contiguous()
    L, bs = idx.shape
    K = rows_idx.shape[-1]
    n, m = x.shape
    want = {"idx": ((L, bs), torch.int32), "rows_idx": ((L, bs, K),
                                                        torch.int32),
            "dinv": ((L, bs, bs), torch.complex64 if x.dtype.is_complex
                     else torch.float32),
            "rows_val": ((L, bs, K), x.dtype), "b": ((n, m), x.dtype)}
    ops = {"idx": idx, "rows_idx": rows_idx, "dinv": dinv,
           "rows_val": rows_val, "b": b}
    for name, t in ops.items():
        shape, dt = want[name]
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if bs * m * x.element_size() > MAX_SHARED:
        raise ValueError(f"kernel E keeps a ({bs}, {m}) block residual in "
                         f"{MAX_SHARED} bytes of shared memory")
    y = x.contiguous().clone()
    lib = _lib()
    rc = lib.mgt_vanka_lex(
        _DTYPES[x.dtype], L, bs, K, m, n, int(num_it), idx.data_ptr(),
        dinv.data_ptr(), rows_idx.data_ptr(), rows_val.data_ptr(),
        b.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "vanka_lex")
    LAUNCHES[_key(x.dtype)] += 1
    return y
