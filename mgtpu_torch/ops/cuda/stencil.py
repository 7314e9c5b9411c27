"""Kernel D: the variable-coefficient stencil apply, and its plain versions.

CUDA source: mgtpu_torch/csrc/stencil.cu (built by ops/cuda/_build.py).  It
replaces the Pallas TPU kernel mgtpu/ops/pallas/stencil_kernel.py
``_stencil_kernel`` (K8): y = A x for a stencil with per-node coefficients,
one read of the coefficients and of x, one write of y, in float32 or
float64, for any number of leading right-hand sides.

Three entry points:

 * `grid_apply(coeff, offsets, x)` — `GridStencil.matvec`'s apply on grid
   fields (..., *grid) of a 1D, 2D or 3D grid, any per-axis shifts, at most
   `MAX_TAPS` taps; taps that leave the grid read zero on every axis.  The
   stride-2 transfers of ops/grid_stencil.py apply through it too.
 * `stencil_matvec(coeff, di, dj, x)` — the counterpart of
   ``stencil_matvec_pallas`` on the slab form G[j, i] = x[i + j NI]:
   coeff (nd, NJ, NI), x (..., NJ, NI), |dj| <= 1, any in-plane shift di;
   taps that leave [0, NJ) x [0, NI) read zero.
 * `dia_apply(data, offsets, x)` — the DIA matrix y_i = sum_d
   data[d, i] x[i + off_d] (ops/dia.py) on flat columns x (n,) or (n, m):
   the kernel on a (1, 1, n) box with taps (0, 0, off_d), zero outside
   [0, n).

The plain versions are `grid_stencil_matvec` (ops/grid_stencil.py), the
slab `stencil_matvec_plain` and `dia_apply_plain`, the same
shift-multiply-accumulate with zero-filled shifts.

Dispatch: every entry point launches the kernel for a CUDA tensor (or raises
on anything it does not take, a stencil of more than `MAX_TAPS` taps
included) and takes the plain version only for a tensor on the CPU.
`GridStencil.matvec` sends a field the kernel has no type for
(`supports_stencil` false: float16, complex) to `grid_apply_plain` on any
device.  `LAUNCHES` counts kernel launches, `PLAIN_CALLS` calls of the plain
version, per float type of x.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..grid_stencil import grid_stencil_matvec
from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "MAX_TAPS", "supports_stencil",
           "grid_apply", "grid_apply_plain", "stencil_matvec",
           "stencil_matvec_plain", "dia_apply", "dia_apply_plain"]

_DTYPES = {torch.float32: 0, torch.float64: 1}
LAUNCHES = {"float32": 0, "float64": 0}
PLAIN_CALLS = {"float32": 0, "float64": 0}
MAX_TAPS = 256                   # kMaxTaps of csrc/stencil.cu


def _key(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def supports_stencil(offsets, grid, dtype) -> bool:
    """Kernel D covers 1D-3D grid stencils with any per-axis shifts in
    float32 and float64; other types take the plain version.  A stencil of
    more than MAX_TAPS taps is covered too: `grid_apply` raises for it on
    the card rather than run it plain."""
    return (1 <= len(grid) <= 3 and len(offsets) >= 1
            and all(len(off) == len(grid) for off in offsets)
            and dtype in _DTYPES)


def _check_taps(n: int) -> None:
    if not 1 <= n <= MAX_TAPS:
        raise ValueError(f"kernel D takes 1 to {MAX_TAPS} taps, the stencil "
                         f"has {n}")


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
    _check_taps(len(taps))
    if coeff.shape[0] != len(taps):
        raise ValueError(f"coeff has {coeff.shape[0]} taps, the stencil "
                         f"{len(taps)}")
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
        raise ValueError(f"kernel D takes 1D-3D stencils in float32/float64 "
                         f"(got {len(grid)}D, {x.dtype})")
    _check_taps(len(offsets))
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


def dia_apply_plain(data, offsets, x):
    """Counted plain DIA apply (mgtpu's dia_matvec): x zero-padded, then
    one shifted slice times its diagonal per offset, summed."""
    _count_plain(x.dtype)
    n = data.shape[1]
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    xp = torch.cat([x2.new_zeros((lo, x2.shape[1])), x2,
                    x2.new_zeros((hi, x2.shape[1]))])
    y = None
    for d, off in enumerate(offsets):
        t = data[d][:, None] * xp[lo + off:lo + off + n]
        y = t if y is None else y + t
    return y[:, 0] if squeeze else y


def dia_apply(data, offsets, x):
    """y = A x for the DIA matrix data (nd, n) with diagonal offsets
    `offsets` on flat columns x (n,) or (n, m): kernel D on a CUDA tensor,
    `dia_apply_plain` on a CPU one."""
    if x.device.type == "cpu":
        return dia_apply_plain(data, offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n = data.shape[1]
    if x.shape[0] != n or x.ndim not in (1, 2):
        raise ValueError(f"x must be ({n},) or ({n}, m), got "
                         f"{tuple(x.shape)}")
    xt = x[None] if x.ndim == 1 else x.T.contiguous()
    taps = tuple((0, 0, int(o)) for o in offsets)
    y = _launch(data, (1, 1, n), taps, xt)
    return y[0] if x.ndim == 1 else y.T
