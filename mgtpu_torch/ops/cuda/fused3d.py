"""Fused 3D cycle ops: kernel B (double apply) and the kernel-A smoother modes.

Counterpart of mgtpu/ops/pallas/fused3d.py:

    residual3d          r  = b - A x                      kernel A, residual
    jacobi3d            x' = x + d .* (b - A x)            kernel A, jacobi
    jacobi_corr3d       x' = s + d .* (b - A s), s = x + p kernel A, jacobi_corr
    jacobi_residual3d   x' = x + d .* (b - A x); r' = b - A x'   kernel B

Kernel B (mgtpu_torch/csrc/fused3d.cu) replaces the Pallas TPU kernel
mgtpu/ops/pallas/fused3d.py ``_jacres_kernel`` (K6) and its two x-band
fixes: the pre-smoothing sweep and the restrict-feed residual.  It is bound
by device memory (x, b, d read and x', r' written once).  Interior blocks
march along x over 16 x 32 (y, z) tiles of the interior, as kernel A does,
and keep x' in a four-plane shared-memory ring between the two applies; they
write x' on the interior and r' on the core [w+1, N-w-1).  Band blocks
beside them compute x' on the band, and a second launch computes r' on the
shell (the band and the interior's first layer).  `jacres_plan` computes
the launch (x-runs, blocks, shared memory) on the host; the C entry refuses
a plan that does not fit.

As in ops/cuda/const3d.py, a CUDA tensor launches the kernel or raises and a
CPU tensor takes the plain version; `LAUNCHES` and `PLAIN_CALLS` count both
(one launch count per call, though a call is two launches), and
`GRID_LAUNCHES` counts kernel B's calls by grid.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..grid_stencil import const_grid_stencil_matvec
from . import _build
from .const3d import check_fields, kernel_meta, stencil3d_apply

__all__ = ["LAUNCHES", "PLAIN_CALLS", "GRID_LAUNCHES", "JacresPlan",
           "jacres_plan", "layer_boxes", "residual3d", "jacobi3d",
           "jacobi_corr3d", "jacobi_residual3d", "jacobi_residual_plain"]

LAUNCHES = {"jacobi_residual3d": 0}
PLAIN_CALLS = {"jacobi_residual3d": 0}
GRID_LAUNCHES: dict[tuple[int, ...], int] = {}   # kernel B calls by grid
TILE = (16, 32)            # (y, z) nodes of an interior tile
THREADS = 256
NSX, NEP = 6, 12           # ring slots: x planes; b, d and x' planes
BLOCKS_WANTED = 384        # interior blocks per right-hand side: 3 per SM
XRUN_MIN = 1               # fewest planes an interior block walks


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


class JacresPlan(NamedTuple):
    """How kernel B is launched on one grid (csrc/fused3d.cu, plan_ok).

    Interior block (t, r) computes tile t (ty x tz) of the interior (y, z)
    plane on the x-planes [w + r * xrun, min(X - w, w + (r + 1) * xrun));
    nband band blocks follow in the first launch, one thread per band node,
    and nshell blocks, one thread per shell node, make the second.  Every
    block is launched once per right-hand side.  smem: dynamic shared memory
    in bytes (the x, b, d and x' rings)."""
    ty: int
    tz: int
    threads: int
    xrun: int
    nruns: int
    ntiles: int
    nband: int
    nshell: int
    smem: int

    def runs(self, X: int, w: int) -> list[tuple[int, int]]:
        """The x-ranges of the interior runs."""
        return [(w + r * self.xrun, min(X - w, w + (r + 1) * self.xrun))
                for r in range(self.nruns)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def layer_boxes(grid, w: int):
    """The interior's first layer (the interior [w, N-w) less the core
    [w+1, N-w-1)) as six disjoint (start, size) boxes, covered like the band
    (csrc/fused3d.cu, layer_of): two x-slabs of the full interior, two
    y-slabs trimmed to the core's x range, two z-slabs trimmed to the core's
    x and y ranges; a side of one node has one slab, of none no slab."""
    n = [max(0, v - 2 * w) for v in grid]
    core = [max(0, v - 2) for v in n]
    boxes = []
    for a in range(3):
        for hi in (0, 1):
            st = [w + 1 if p < a else w for p in range(3)]
            sz = [core[p] if p < a else n[p] for p in range(3)]
            st[a] = grid[a] - w - 1 if hi else w
            sz[a] = int(n[a] >= 2) if hi else int(n[a] >= 1)
            boxes.append((tuple(st), tuple(sz)))
    return tuple(boxes)


@functools.lru_cache(maxsize=256)
def jacres_plan(grid, boxes, nruns: int | None = None) -> JacresPlan:
    """The launch plan of kernel B on an (X, Y, Z) grid with its six band
    boxes ((start, size) each; box 0 is the low x-slab, w planes deep).

    The interior's x range is split into balanced runs, as many as give
    about BLOCKS_WANTED interior blocks (at 129^3, w = 2: 32 tiles x 12
    runs of 11 planes; below 65^3 runs of one or two planes, the fastest
    there on an H100).  `nruns` asks for another number of runs, for timing
    plans against each other."""
    X, Y, Z = grid
    w = boxes[0][1][0]
    xi, yi, zi = (max(0, v - 2 * w) for v in grid)
    ty, tz = TILE
    band = sum(int(np.prod(sz)) for _, sz in boxes)
    shell = band + sum(int(np.prod(sz)) for _, sz in layer_boxes(grid, w))
    nband, nshell = _cdiv(band, THREADS), _cdiv(shell, THREADS)
    smem = 4 * (NSX * (ty + 4) * (tz + 4) + NEP * (ty + 2) * (tz + 2))
    if not (xi and yi and zi):
        return JacresPlan(ty, tz, THREADS, 0, 0, 0, nband, nshell, smem)
    ntiles = _cdiv(yi, ty) * _cdiv(zi, tz)
    if nruns is None:
        nruns = min(_cdiv(xi, XRUN_MIN), max(1, _cdiv(BLOCKS_WANTED, ntiles)))
    xrun = _cdiv(xi, min(max(1, nruns), xi))
    return JacresPlan(ty, tz, THREADS, xrun, _cdiv(xi, xrun), ntiles, nband,
                      nshell, smem)


@functools.lru_cache(maxsize=256)
def _plan_array(grid, boxes, nruns=None) -> np.ndarray:
    out = np.asarray(jacres_plan(grid, boxes, nruns), dtype=np.int32)
    out.setflags(write=False)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("fused3d")
    fn = lib.mgt_jacobi_residual3d
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    return lib


def jacobi_residual3d(A, d, b, x):
    """(x', r') = (x + d .* (b - A x), b - A x') — kernel B on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return jacobi_residual_plain(A, d, b, x)
    return _launch(A, d, b, x, _plan_array(tuple(A.grid), A.boxes))


def _launch(A, d, b, x, plan: np.ndarray):
    """Kernel B with a given plan (an int32 JacresPlan array)."""
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
        torch.cuda.current_stream(x.device).cuda_stream, plan.ctypes.data)
    _build.check(lib, rc, "jacobi_residual3d")
    LAUNCHES["jacobi_residual3d"] += 1
    grid = tuple(A.grid)
    GRID_LAUNCHES[grid] = GRID_LAUNCHES.get(grid, 0) + 1
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
