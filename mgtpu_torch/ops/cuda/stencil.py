"""Kernel D: the variable-coefficient stencil apply, and its plain versions.

CUDA source: mgtpu_torch/csrc/stencil.cu (built by ops/cuda/_build.py).  It
replaces the Pallas TPU kernel mgtpu/ops/pallas/stencil_kernel.py
``_stencil_kernel`` (K8): y = A x for a stencil with per-node coefficients,
one read of the coefficients and of x, one write of y, in float32 or
float64, for any number of leading right-hand sides.

Two entry points:

 * `grid_apply(coeff, offsets, x)` — `GridStencil.matvec`'s apply on grid
   fields (..., *grid) of a 1D, 2D or 3D grid whose offsets shift each axis
   by at most one node; taps that leave the grid read zero on every axis.
 * `stencil_matvec(coeff, di, dj, x)` — the counterpart of
   ``stencil_matvec_pallas`` on the slab form G[j, i] = x[i + j NI]:
   coeff (nd, NJ, NI), x (..., NJ, NI), |dj| <= 1, any in-plane shift di;
   taps that leave [0, NJ) x [0, NI) read zero.

The plain versions are `grid_stencil_matvec` (ops/grid_stencil.py) and the
slab `stencil_matvec_plain`, the same shift-multiply-accumulate with
zero-filled shifts.

Dispatch: both entry points launch the kernel for a CUDA tensor (or raise on
anything it does not take) and take the plain version only for a tensor on
the CPU.  `GridStencil.matvec` sends a stencil the kernel does not cover
(`supports_stencil` false) to `grid_apply_plain` on any device.
`LAUNCHES` counts kernel launches, `PLAIN_CALLS` calls of the plain
version, per float type of x.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..grid_stencil import grid_stencil_matvec
from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "supports_stencil", "grid_apply",
           "grid_apply_plain", "stencil_matvec", "stencil_matvec_plain"]

_DTYPES = {torch.float32: 0, torch.float64: 1}
LAUNCHES = {"float32": 0, "float64": 0}
PLAIN_CALLS = {"float32": 0, "float64": 0}
MAX_TAPS = 27


def _key(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def supports_stencil(offsets, grid, dtype) -> bool:
    """Kernel D covers 1D-3D grid stencils of radius 1 per axis (up to 27
    taps) in float32 and float64; anything else takes the plain version."""
    return (1 <= len(grid) <= 3
            and 1 <= len(offsets) <= MAX_TAPS
            and all(len(off) == len(grid) and all(abs(d) <= 1 for d in off)
                    for off in offsets)
            and dtype in _DTYPES)


def _count_plain(dtype) -> None:
    k = _key(dtype)
    PLAIN_CALLS[k] = PLAIN_CALLS.get(k, 0) + 1


def grid_apply_plain(coeff, offsets, x):
    """Counted plain grid apply: `grid_stencil_matvec` on any device."""
    _count_plain(x.dtype)
    return grid_stencil_matvec(coeff, offsets, x)


def stencil_matvec_plain(coeff, di, dj, x):
    """Plain torch version of the slab apply: per tap, x shifted by dj rows
    and di columns with zero fill, times the tap's coefficients, summed."""
    _count_plain(x.dtype)
    return grid_stencil_matvec(coeff, tuple(zip(dj, di)), x)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("stencil")
    fn = lib.mgt_stencil
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _taps(taps) -> np.ndarray:
    """Host int32 (nd, 3) rows of (dz, dy, dx) for the C entry."""
    out = np.ascontiguousarray(np.asarray(taps, dtype=np.int32).reshape(-1, 3))
    out.setflags(write=False)
    return out


def _launch(coeff, box, taps, x):
    """Check the operands and launch kernel D on the (Z, Y, X) box; x is
    (..., *coeff.shape[1:]).  Returns y of x's shape."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel D takes float32 or float64, got {x.dtype}")
    space = tuple(coeff.shape[1:])
    for name, t in (("coeff", coeff), ("x", x)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coeff.shape[0] != len(taps) or not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"coeff has {coeff.shape[0]} taps, the stencil "
                         f"{len(taps)} (at most {MAX_TAPS})")
    if x.ndim < len(space) or tuple(x.shape[x.ndim - len(space):]) != space:
        raise ValueError(f"x must be (..., *{space}), got {tuple(x.shape)}")
    n = int(np.prod(space))
    m = x.numel() // n if n else 0
    if m < 1 or n < 1:
        raise ValueError(f"empty field {tuple(x.shape)}")
    if x.numel() >= 2 ** 31 or coeff.numel() >= 2 ** 31:
        raise ValueError("kernel D indexes with 32-bit integers: "
                         f"{max(x.numel(), coeff.numel())} elements is too "
                         "many")
    if x.device.index is not None and \
            x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    y = torch.empty_like(x)
    lib = _lib()
    rc = lib.mgt_stencil(_DTYPES[x.dtype], len(taps), _taps(taps).ctypes.data,
                         *box, m, coeff.data_ptr(), x.data_ptr(),
                         y.data_ptr(),
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "stencil")
    LAUNCHES[_key(x.dtype)] += 1
    return y


def grid_apply(coeff, offsets, x):
    """y = A x for grid fields x (..., *grid): kernel D on a CUDA tensor,
    `grid_stencil_matvec` on a CPU tensor.  coeff is (nd, *grid) and
    offsets its per-tap per-axis shifts (slowest axis first)."""
    grid = tuple(coeff.shape[1:])
    if x.device.type == "cpu":
        return grid_apply_plain(coeff, offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel D takes float32 or float64, got {x.dtype}")
    offsets = tuple(tuple(int(d) for d in off) for off in offsets)
    if not supports_stencil(offsets, grid, x.dtype):
        raise ValueError(f"kernel D takes 1D-3D radius-1 stencils in "
                         f"float32/float64 (got {len(grid)}D, {x.dtype})")
    pad = 3 - len(grid)
    box = (1,) * pad + grid
    taps = tuple((0,) * pad + off for off in offsets)
    return _launch(coeff, box, taps, x)


def stencil_matvec(coeff, di, dj, x):
    """y = A x on the slab form (the counterpart of stencil_matvec_pallas):
    coeff (nd, NJ, NI), x (..., NJ, NI), per-tap shifts dj (|dj| <= 1) and
    di.  Kernel D on a CUDA tensor, `stencil_matvec_plain` on a CPU one."""
    if len(di) != len(dj):
        raise ValueError("di and dj must have one entry per tap")
    if any(abs(int(d)) > 1 for d in dj):
        raise ValueError("the slab form takes |dj| <= 1")
    if x.device.type == "cpu":
        return stencil_matvec_plain(coeff, di, dj, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if coeff.ndim != 3:
        raise ValueError(f"coeff must be (nd, NJ, NI), got "
                         f"{tuple(coeff.shape)}")
    NJ, NI = coeff.shape[1:]
    taps = tuple((int(j), 0, int(i)) for i, j in zip(di, dj))
    return _launch(coeff, (NJ, 1, NI), taps, x)
