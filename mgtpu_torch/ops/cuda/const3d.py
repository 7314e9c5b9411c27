"""Kernel A: one-pass 3D constant-interior stencil apply, and its plain version.

CUDA source: mgtpu_torch/csrc/const3d.cu (built by ops/cuda/_build.py).
It replaces the Pallas TPU kernels mgtpu/ops/pallas/const3d.py
``_interior_kernel`` (K1) and ``_xband_fix_kernel`` (K2), and, through its
modes, mgtpu/ops/pallas/fused3d.py ``_fused_kernel`` (K3-K5):

    matvec       y  = A x
    residual     r  = b - A x
    jacobi       x' = x + d .* (b - A x)
    jacobi_corr  x' = s + d .* (b - A s),  s = x + p

The kernel is bound by device memory (a few flops per byte of field).  One
launch has two kinds of block.  An interior block owns a (16, 32) or
(4, 128) tile of the interior (y, z) plane and marches along a run of
x-planes, holding the planes x-1, x, x+1 (and those in flight ahead) of
x, and the tile's b and d, in rings in shared memory, so each byte of x
leaves device memory about once.  A band block gives one thread to each
node of the six band boxes, which reads its box's true coefficients.  So
the kernel is exact on the whole grid.  `apply_plan` computes the launch (tile, x-run, band blocks,
shared memory) on the host; the C entry refuses a plan that does not fit.

Dispatch: `stencil3d_apply` launches the kernel for a CUDA tensor (or
raises on anything the kernel does not take) and takes the plain version
only for a tensor on the CPU.  Both keep a count: `LAUNCHES` counts kernel
launches, `PLAIN_CALLS` counts calls of the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..grid_stencil import const_grid_stencil_matvec
from . import _build

__all__ = ["MODES", "LAUNCHES", "PLAIN_CALLS", "ApplyPlan", "apply_plan",
           "supports_const3d", "stencil3d_apply", "apply_plain",
           "const3d_matvec"]

MODES = ("matvec", "residual", "jacobi", "jacobi_corr")
LAUNCHES = dict.fromkeys(MODES, 0)
PLAIN_CALLS = dict.fromkeys(MODES, 0)
MAX_TAPS = 27
TILES = ((16, 32), (4, 128))   # (y, z) nodes of an interior tile: narrow, wide
THREADS = 256              # each thread computes two nodes of a tile
NSLOT, NBD = 6, 5          # x (p) and b (d) ring slots
BLOCKS_WANTED = 264        # interior blocks per right-hand side: 2 per SM
XRUN_MIN = 4               # fewest planes an interior block walks


class ApplyPlan(NamedTuple):
    """How kernel A is launched on one grid (csrc/const3d.cu, plan_ok).

    Interior block (t, r) computes tile t (ty x tz) of the interior (y, z)
    plane on the x-planes [w + r * xrun, min(X - w, w + (r + 1) * xrun));
    nband band blocks follow, one thread per band node; every block is
    launched once per right-hand side.  smem: dynamic shared memory in bytes (the x ring,
    the b and d rings by mode, the p ring in jacobi_corr)."""
    ty: int
    tz: int
    threads: int
    xrun: int
    nruns: int
    ntiles: int
    nband: int
    smem: int

    def runs(self, X: int, w: int) -> list[tuple[int, int]]:
        """The x-ranges of the interior runs."""
        return [(w + r * self.xrun, min(X - w, w + (r + 1) * self.xrun))
                for r in range(self.nruns)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def apply_plan(grid, boxes, mode: str) -> ApplyPlan:
    """The launch plan of kernel A on an (X, Y, Z) grid with its six band
    boxes ((start, size) each; box 0 is the low x-slab, w planes deep).

    The wide tile where the interior's z extent fills at least 3/4 of it
    (129^3), else the narrow one.  The interior's x range is split into
    balanced runs, as many as give about BLOCKS_WANTED interior blocks but
    none shorter than XRUN_MIN planes: at 129^3 (w = 2) 32 wide tiles x 9
    runs of 14 planes."""
    X, Y, Z = grid
    w = boxes[0][1][0]
    xi, yi, zi = (max(0, v - 2 * w) for v in grid)
    ty, tz = TILES[1] if 4 * zi >= 3 * TILES[1][1] else TILES[0]
    nband = _cdiv(sum(int(np.prod(sz)) for _, sz in boxes), THREADS)
    mi = MODES.index(mode)
    smem = 4 * (NSLOT * (ty + 2) * (tz + 2) * (2 if mi == 3 else 1)
                + NBD * ty * tz * min(mi, 2))
    if not (xi and yi and zi):
        return ApplyPlan(ty, tz, THREADS, 0, 0, 0, nband, smem)
    ntiles = _cdiv(yi, ty) * _cdiv(zi, tz)
    nruns = min(_cdiv(xi, XRUN_MIN), max(1, _cdiv(BLOCKS_WANTED, ntiles)))
    xrun = _cdiv(xi, nruns)
    return ApplyPlan(ty, tz, THREADS, xrun, _cdiv(xi, xrun), ntiles, nband,
                     smem)


@functools.lru_cache(maxsize=256)
def _plan_array(grid, boxes, mode: str) -> np.ndarray:
    out = np.asarray(apply_plan(grid, boxes, mode), dtype=np.int32)
    out.setflags(write=False)
    return out


def supports_const3d(offsets, grid, dtype) -> bool:
    """The kernels cover 3D radius-1 stencils in float32, at any grid size
    (the reference's node floor was a crossover against XLA fusion on its
    own hardware and does not carry over).  f64 and 2D stencils take the
    plain torch versions."""
    return (len(grid) == 3
            and len(offsets) <= MAX_TAPS
            and all(abs(d) <= 1 for off in offsets for d in off)
            and dtype == torch.float32)


@functools.lru_cache(maxsize=128)
def kernel_meta(offsets, grid, boxes) -> np.ndarray:
    """Host int32 stencil description the C entries take (stencil3d.cuh):
    [nd, X, Y, Z, w, dx[nd], dy[nd], dz[nd], box starts (6x3), sizes (6x3)]."""
    if len(boxes) != 6:
        raise ValueError("a 3D constant-interior stencil has six band boxes")
    off = np.asarray(offsets, dtype=np.int32).reshape(-1, 3)
    w = boxes[0][1][0]
    meta = [len(offsets), *grid, w, *off[:, 0], *off[:, 1], *off[:, 2]]
    meta += [v for st, _ in boxes for v in st]
    meta += [v for _, sz in boxes for v in sz]
    out = np.asarray(meta, dtype=np.int32)
    out.setflags(write=False)
    return out


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("const3d")
    fn = lib.mgt_stencil3d_apply
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    return lib


def check_fields(A, x, **fields) -> None:
    """Raise unless A and every field are what the CUDA kernels take:
    float32, contiguous, on x's CUDA device, fields (m, X, Y, Z) and d of
    the grid's shape."""
    if not supports_const3d(A.offsets, A.grid, A.dtype):
        raise ValueError("CUDA stencil kernels take 3D radius-1 float32 "
                         f"stencils (got {len(A.grid)}D, {A.dtype})")
    if len(A.boxes) != 6:
        raise ValueError("stencil is missing its six band boxes")
    dev = x.device
    for name, t in [("A.const", A.const), ("A.band", A.band), ("x", x),
                    *fields.items()]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name == "d":
            if tuple(t.shape) != tuple(A.grid):
                raise ValueError(f"d must have the grid shape {A.grid}")
        elif name not in ("A.const", "A.band") and (
                t.ndim != 4 or tuple(t.shape) != tuple(x.shape)):
            raise ValueError(f"{name} must be (m, *{A.grid}), got "
                             f"{tuple(t.shape)}")
    if tuple(x.shape[1:]) != tuple(A.grid) or x.shape[0] < 1:
        raise ValueError(f"x must be (m, *{A.grid}), got {tuple(x.shape)}")
    if x.numel() >= 2 ** 31:
        raise ValueError("the kernels index fields with 32-bit integers: "
                         f"{x.numel()} elements is too many")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"x is on {dev}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _lead(A, *fields):
    """Flatten leading batch dims of grid fields to one m axis (views)."""
    return [None if f is None else f.reshape((-1,) + tuple(A.grid))
            for f in fields]


def stencil3d_apply(A, mode: str, x, b=None, d=None, p=None):
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor.

    A: ConstGridStencil; x, b, p: (..., X, Y, Z); d: (X, Y, Z) shared by the
    right-hand sides.  Returns a new field of x's shape."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    need = {"matvec": (), "residual": ("b",), "jacobi": ("b", "d"),
            "jacobi_corr": ("b", "d", "p")}[mode]
    given = {"b": b, "d": d, "p": p}
    for k in need:
        if given[k] is None:
            raise ValueError(f"mode {mode!r} needs {k}")
    if x.device.type == "cpu":
        return apply_plain(A, mode, x, b, d, p)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    for k in ("b", "p"):
        if k in need and given[k].shape != x.shape:
            raise ValueError(f"{k} has shape {tuple(given[k].shape)}, "
                             f"x has {tuple(x.shape)}")
    shape = x.shape
    xr, br, pr = _lead(A, x, b, p)
    fields = {k: v for k, v in (("b", br), ("d", d), ("p", pr))
              if k in need}
    check_fields(A, xr, **fields)
    out = torch.empty_like(xr)
    lib = _lib()
    meta = kernel_meta(A.offsets, A.grid, A.boxes)
    rc = lib.mgt_stencil3d_apply(
        MODES.index(mode), meta.ctypes.data, xr.shape[0],
        A.const.data_ptr(), A.band.data_ptr(), xr.data_ptr(), _ptr(br),
        _ptr(d), _ptr(pr), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
        _plan_array(tuple(A.grid), A.boxes, mode).ctypes.data)
    _build.check(lib, rc, f"stencil3d_apply[{mode}]")
    LAUNCHES[mode] += 1
    return out.reshape(shape)


def apply_plain(A, mode: str, x, b=None, d=None, p=None):
    """Plain torch version of kernel A (the strip-assembly matvec plus the
    mode's elementwise arithmetic)."""
    PLAIN_CALLS[mode] += 1
    s = x + p if mode == "jacobi_corr" else x
    ax = const_grid_stencil_matvec(A.const, A.strips, A.offsets, A.grid,
                                   A.boxes, s)
    if mode == "matvec":
        return ax
    r = b - ax
    if mode == "residual":
        return r
    return s + d * r


def const3d_matvec(A, x):
    """y = A x (exact) for a 3D radius-1 float32 ConstGridStencil."""
    return stencil3d_apply(A, "matvec", x)
