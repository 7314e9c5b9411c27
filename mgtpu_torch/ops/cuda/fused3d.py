"""Fused 3D cycle ops: kernel B (double apply) and the kernel-A smoother modes.

Counterpart of mgtpu/ops/pallas/fused3d.py:

    residual3d          r  = b - A x                      kernel A, residual
    jacobi3d            x' = x + d .* (b - A x)            kernel A, jacobi
    jacobi_corr3d       x' = s + d .* (b - A s), s = x + p kernel A, jacobi_corr
    jacobi_residual3d   x' = x + d .* (b - A x); r' = b - A x'   kernel B

Kernel B (mgtpu_torch/csrc/fused3d.cu) replaces the Pallas TPU kernel
mgtpu/ops/pallas/fused3d.py ``_jacres_kernel`` (K6) and its two x-band
fixes: the pre-smoothing sweep and the restrict-feed residual in one pass,
with x' kept in shared memory between the two applies.  It is bound by
device memory (x, b, d read and x', r' written once).

As in ops/cuda/const3d.py, a CUDA tensor launches the kernel or raises and a
CPU tensor takes the plain version; `LAUNCHES` and `PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..grid_stencil import const_grid_stencil_matvec
from . import _build
from .const3d import check_fields, kernel_meta, stencil3d_apply

__all__ = ["LAUNCHES", "PLAIN_CALLS", "residual3d", "jacobi3d",
           "jacobi_corr3d", "jacobi_residual3d", "jacobi_residual_plain"]

LAUNCHES = {"jacobi_residual3d": 0}
PLAIN_CALLS = {"jacobi_residual3d": 0}


def residual3d(A, b, x):
    """r = b - A x (exact), one pass; fields (m, X, Y, Z)."""
    return stencil3d_apply(A, "residual", x, b=b)


def jacobi3d(A, d, b, x):
    """x' = x + d .* (b - A x) (exact), one pass."""
    return stencil3d_apply(A, "jacobi", x, b=b, d=d)


def jacobi_corr3d(A, d, b, x, p):
    """x' = s + d .* (b - A s) with s = x + p (exact), one pass — the
    coarse-grid correction add folded into the first post-smoothing sweep."""
    return stencil3d_apply(A, "jacobi_corr", x, b=b, d=d, p=p)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("fused3d")
    fn = lib.mgt_jacobi_residual3d
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    return lib


def jacobi_residual3d(A, d, b, x):
    """(x', r') = (x + d .* (b - A x), b - A x') — kernel B on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return jacobi_residual_plain(A, d, b, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if b.shape != x.shape:
        raise ValueError(f"b has shape {tuple(b.shape)}, x has "
                         f"{tuple(x.shape)}")
    shape = x.shape
    xr = x.reshape((-1,) + tuple(A.grid))
    br = b.reshape((-1,) + tuple(A.grid))
    check_fields(A, xr, b=br, d=d)
    x1 = torch.empty_like(xr)
    r1 = torch.empty_like(xr)
    lib = _lib()
    rc = lib.mgt_jacobi_residual3d(
        kernel_meta(A.offsets, A.grid, A.boxes).ctypes.data, xr.shape[0],
        A.const.data_ptr(), A.band.data_ptr(), xr.data_ptr(), br.data_ptr(),
        d.data_ptr(), x1.data_ptr(), r1.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "jacobi_residual3d")
    LAUNCHES["jacobi_residual3d"] += 1
    return x1.reshape(shape), r1.reshape(shape)


def jacobi_residual_plain(A, d, b, x):
    """Plain torch version of kernel B: two applies of the strip-assembly
    matvec (counted under PLAIN_CALLS, not under kernel A's counters)."""
    PLAIN_CALLS["jacobi_residual3d"] += 1

    def mv(v):
        return const_grid_stencil_matvec(A.const, A.strips, A.offsets,
                                         A.grid, A.boxes, v)
    x1 = x + d * (b - mv(x))
    return x1, b - mv(x1)
