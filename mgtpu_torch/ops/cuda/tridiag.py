"""Kernel C: the tridiagonal line solve of line Jacobi, and its plain version.

CUDA source: mgtpu_torch/csrc/tridiag.cu (built by ops/cuda/_build.py).  It
replaces the Pallas TPU kernels mgtpu/ops/pallas/tridiag.py ``_fwd_kernel``
and ``_bwd_kernel`` (K7) with one launch that runs both recurrences along
one grid axis of a contiguous (..., *grid) field:

    forward   y_i = alpha_i y_{i-1} + pivot_i r_i
    backward  s_i = -cprime_i s_{i+1} + y_i
    solve     out = omega s          (T^-1 r for omega = 1)
    correct   out = x + omega s

The coefficients are grid-shaped and shared by the leading right-hand
sides.  Values are float32, float64, complex64 or complex128 (mgtpu runs
its complex lines through its XLA doubling scan; the same recurrences with
complex coefficients, no conjugate); omega is real.  The kernel is bound by device memory: per node it reads r (and x),
three coefficients, and writes one output.

`line_plan` chooses, from the shape alone, how the kernel is launched: the
staged variant (a tile of lines held in shared memory, y kept on chip) for
every line whose tile fits in a block's 227 KB, else the streamed variant
(chunks walked from device memory).  The C entry recomputes the plan's
derived numbers and refuses a plan that disagrees.

The plain version is mgtpu's CPU form (cycle/relax.py::_scan_linear): a
Hillis-Steele doubling scan of each recurrence with zero-filled shifts, the
same operations in the same order.

Dispatch: `line_apply` launches the kernel for a CUDA tensor (or raises on
anything the kernel does not take) and takes the plain version only for a
tensor on the CPU.  `LAUNCHES` counts kernel launches, `PLAIN_CALLS` calls
of the plain version: a real call per mode, a complex one per value type.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["MODES", "LAUNCHES", "PLAIN_CALLS", "LinePlan", "line_plan",
           "line_apply", "line_plain", "scan_linear"]

MODES = ("solve", "correct")
COMPLEX = ("complex64", "complex128")
LAUNCHES = dict.fromkeys(MODES + COMPLEX, 0)
PLAIN_CALLS = dict.fromkeys(MODES + COMPLEX, 0)
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
SMALL_SMEM = 48 * 1024     # what a block gets without the opt-in
STAGED, STREAMED = "staged", "streamed"
_VARIANTS = (STAGED, STREAMED)
_STREAMED_THREADS = 256


class LinePlan(NamedTuple):
    """How kernel C is launched on one shape (csrc/tridiag.cu, plan_ok).

    tile: lines per block (a strided tile's lines lie side by side along
    inner; a contiguous tile's one after another); nchunk: chunks per line,
    one per thread; smem: dynamic shared memory in bytes."""
    variant: str
    tile: int
    nchunk: int
    threads: int
    blocks: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def max_smem(itemsize: int) -> int:
    """Dynamic shared memory a staged block may opt into: sm_90's 232 448
    bytes less the kernel's static cross-warp slots (2 x 32 values of at
    least 8 bytes; csrc/tridiag.cu, max_smem)."""
    return 232_448 - 64 * max(itemsize, 8)


MAX_SMEM = max_smem(8)      # the real types' limit


def _key(mode: str, dtype) -> str:
    """The counters' key of a call: its mode, or a complex value type."""
    return str(dtype).rsplit(".", 1)[-1] if dtype.is_complex else mode


@functools.lru_cache(maxsize=256)
def line_plan(outer: int, n: int, inner: int, itemsize: int,
              mode: str) -> LinePlan:
    """The launch plan of `outer` x `inner` lines of n nodes.

    Staged when a tile fits in shared memory (`max_smem`): strided lines
    take tiles of 32 / itemsize lines (each tile row one 32-byte sector, padded by one
    element against bank conflicts), contiguous lines the most of 8, 4, 2
    lines that fit in 48 KB (one line when none does).  Each holds four
    arrays (alpha, pivot, cprime, r), and x in correct mode; one warp per
    strided line, and per contiguous line one warp, two from 512 nodes and
    four from 1024, so that a lane walks about 8 nodes (nchunk = 32 per
    warp).  Otherwise streamed: the PR 2 tiles (32 strided lines when that
    still gives two blocks per SM, else 8), or one warp per contiguous
    line."""
    arrays = 5 if mode == "correct" else 4
    limit = max_smem(itemsize)
    if inner > 1:
        tile = 32 // itemsize
        smem = arrays * n * (tile + 1) * itemsize
        if smem <= limit:
            return LinePlan(STAGED, tile, 32, 32 * tile,
                            outer * _cdiv(inner, tile), smem)
        tl = 32 if outer * _cdiv(inner, 32) >= 264 else 8
        return LinePlan(STREAMED, tl, _STREAMED_THREADS // tl,
                        _STREAMED_THREADS, outer * _cdiv(inner, tl), 0)
    line = arrays * n * itemsize
    chunks = 32 * (4 if n >= 1024 else 2 if n >= 512 else 1)  # lanes per line
    if line <= limit:
        tile = next((t for t in (8, 4, 2) if t * line <= SMALL_SMEM), 1)
        return LinePlan(STAGED, tile, chunks, chunks * tile,
                        _cdiv(outer, tile), tile * line)
    warps = _STREAMED_THREADS // 32
    return LinePlan(STREAMED, warps, 32, _STREAMED_THREADS,
                    _cdiv(outer, warps), 0)


@functools.lru_cache(maxsize=256)
def _plan_array(outer: int, n: int, inner: int, itemsize: int,
                mode: str) -> np.ndarray:
    p = line_plan(outer, n, inner, itemsize, mode)
    out = np.asarray([_VARIANTS.index(p.variant), *p[1:]], dtype=np.int32)
    out.setflags(write=False)
    return out


def _shifted(v, d: int, axis: int, reverse: bool, fill: float):
    """Element i-d (forward) or i+d (reverse) of v along `axis`; positions
    shifted in from outside the line take `fill`."""
    n = v.shape[axis]
    pshape = list(v.shape)
    pshape[axis] = min(d, n)
    pad = v.new_full(pshape, fill)
    if d >= n:
        return pad
    if reverse:
        return torch.cat([v.narrow(axis, d, n - d), pad], dim=axis)
    return torch.cat([pad, v.narrow(axis, 0, n - d)], dim=axis)


def scan_linear(alpha, beta, axis: int, reverse: bool = False):
    """y_i = alpha_i y_{i-1} + beta_i along `axis` (reverse: i+1 -> i), by
    Hillis-Steele doubling: after step d, element i carries the recurrence
    composed over the last 2d terms."""
    n = alpha.shape[axis]
    a, y = alpha, beta
    d = 1
    while d < n:
        a_prev = _shifted(a, d, axis, reverse, 1.0)
        y_prev = _shifted(y, d, axis, reverse, 0.0)
        y = a * y_prev + y
        a = a * a_prev
        d *= 2
    return y


def line_plain(mode: str, alpha, pivot, cprime, axis: int, r, x=None,
               omega: float = 1.0):
    """Plain torch version of the kernel (mgtpu's doubling-scan form)."""
    PLAIN_CALLS[_key(mode, r.dtype)] += 1
    ax = r.ndim - (alpha.ndim - axis)
    beta = pivot * r
    y = scan_linear(alpha.expand(beta.shape), beta, ax)
    s = scan_linear((-cprime).expand(y.shape), y, ax, reverse=True)
    if mode == "correct":
        return x + omega * s
    return s if omega == 1.0 else omega * s


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("tridiag")
    fn = lib.mgt_tridiag
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
                   + [ctypes.c_double] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return lib


def _check(alpha, pivot, cprime, axis: int, r, x) -> None:
    """Raise unless every operand is what the kernel takes: one value type
    (float32, float64, complex64 or complex128), contiguous, on r's device;
    coefficients of the grid's shape, r and x of one shape (..., *grid)."""
    if r.dtype not in _DTYPES:
        raise TypeError(f"the line kernel takes float32, float64, complex64 "
                        f"or complex128, got {r.dtype}")
    grid = tuple(alpha.shape)
    if not 0 <= axis < len(grid):
        raise ValueError(f"line axis {axis} outside a {len(grid)}D grid")
    named = [("alpha", alpha), ("pivot", pivot), ("cprime", cprime),
             ("r", r)] + ([("x", x)] if x is not None else [])
    for name, t in named:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[1:3]:
        if tuple(t.shape) != grid:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, alpha "
                             f"{grid}")
    if r.ndim < len(grid) or tuple(r.shape[r.ndim - len(grid):]) != grid:
        raise ValueError(f"r must be (..., *{grid}), got {tuple(r.shape)}")
    if x is not None and x.shape != r.shape:
        raise ValueError(f"x has shape {tuple(x.shape)}, r has "
                         f"{tuple(r.shape)}")
    if r.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes fields with 32-bit integers: "
                         f"{r.numel()} elements is too many")
    if r.device.index is not None and \
            r.device.index != torch.cuda.current_device():
        raise ValueError(f"r is on {r.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def line_apply(mode: str, alpha, pivot, cprime, axis: int, r, x=None,
               omega: float = 1.0):
    """The line kernel on a CUDA tensor, its plain version on a CPU tensor.

    alpha, pivot, cprime: grid-shaped; axis: grid axis of the lines; r, x:
    (..., *grid).  mode "solve" returns omega T^-1 r, "correct"
    x + omega T^-1 r.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if (mode == "correct") != (x is not None):
        raise ValueError(f"mode {mode!r} {'needs' if x is None else 'takes no'}"
                         " x")
    if r.device.type == "cpu":
        return line_plain(mode, alpha, pivot, cprime, axis, r, x, omega)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    _check(alpha, pivot, cprime, axis, r, x)
    grid = tuple(alpha.shape)
    n = grid[axis]
    inner = 1
    for v in grid[axis + 1:]:
        inner *= v
    outer_c = alpha.numel() // (n * inner)
    outer = r.numel() // (n * inner)
    out = torch.empty_like(r)
    plan = _plan_array(outer, n, inner, r.element_size(), mode)
    lib = _lib()
    rc = lib.mgt_tridiag(
        _DTYPES[r.dtype], x is not None, outer, outer_c, n, inner,
        alpha.data_ptr(), pivot.data_ptr(), cprime.data_ptr(), r.data_ptr(),
        None if x is None else x.data_ptr(),
        float(omega), out.data_ptr(),
        torch.cuda.current_stream(r.device).cuda_stream, plan.ctypes.data)
    _build.check(lib, rc, f"tridiag[{mode}]")
    LAUNCHES[_key(mode, r.dtype)] += 1
    return out
