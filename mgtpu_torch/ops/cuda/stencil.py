"""Kernel D: the variable-coefficient stencil apply, and its plain versions.

CUDA source: mgtpu_torch/csrc/stencil.cu (built by ops/cuda/_build.py).  It
replaces the Pallas TPU kernel mgtpu/ops/pallas/stencil_kernel.py
``_stencil_kernel`` (K8): y = A x for a stencil with per-node coefficients,
one read of the coefficients and of x, one write of y, in float32,
float64, complex64 or complex128 (mgtpu runs its complex levels through
the same shift-multiply-add in XLA), for any number of leading
right-hand sides.

Entry points:

 * `grid_apply(coeff, offsets, x)` — `GridStencil.matvec`'s apply on grid
   fields (..., *grid) of a 1D, 2D or 3D grid, any per-axis shifts, at most
   `MAX_TAPS` taps; taps that leave the grid read zero on every axis.
 * `cross_apply(coeff, offsets, in_grid, x)` — `CrossGridStencil.matvec`
   (ops/cross_stencil.py): the same apply from a field x (..., *in_grid)
   on another grid than y's (..., *out_grid), coeff (nd, *out_grid); node
   r reads x at r + d_k, zero off in_grid.  A block of a staggered system,
   real or complex.
 * `halo_apply(coeff, offsets, in_grid, x)` — the cross apply from a
   halo-extended block: x (..., *in_grid) holds y's block and its
   neighbours' planes, the taps are shifted by the halo width.  The
   multi-device paths ran it on a torch.cat of the planes before the
   halo form.
 * `halo_stencil(coeff, offsets, x, left, right, axis, b=, d=, rows=,
   out=)` — the halo form (csrc/halo_stencil.cu): a rank's block apply,
   residual b - A x or Jacobi update x + d (b - A x) in one launch,
   reading the owned block x and its neighbours' planes `left` / `right`
   where they lie (None: no neighbour); `rows` picks the output rows
   along `axis` (the overlapped slab's interior, then both edge rows).
   Each node's taps are sliced as `halo_apply` slices them, so each form
   is bit for bit the cat, `halo_apply` and torch's subtraction or
   update (`halo_plan`, cached).
 * `block_apply(op, xs, bs=None)` — a whole block operator of a staggered
   system in one launch (csrc/block_stencil.cu): every output component
   summed over its blocks in block order, or with `bs` the residual
   b - A x; `op` is a `BlockGridOperator` (cycle/systems_grid.py) or a
   `ShardedBlockOperator` (parallel/systems_sharded.py, its inputs the
   halo-extended components).  Each block keeps the tap slicing of its own
   cross-form launch, so the result is the bits of the per-block launches,
   torch's adds and torch's subtraction.  Its static table
   (`block_table`) holds no pointer.
 * `stencil_matvec(coeff, di, dj, x)` — the counterpart of
   ``stencil_matvec_pallas`` on the slab form G[j, i] = x[i + j NI]:
   coeff (nd, NJ, NI), x (..., NJ, NI), |dj| <= 1, any in-plane shift di;
   taps that leave [0, NJ) x [0, NI) read zero.
 * `dia_apply(data, offsets, x)` — the DIA matrix y_i = sum_d
   data[d, i] x[i + off_d] (ops/dia.py) on flat columns x (n,) or (n, m):
   the kernel on a (1, 1, n) box with taps (0, 0, off_d), zero outside
   [0, n).
 * `stride2_prolong(T, xc)` and `stride2_restrict(T, r)` — P xc and P^T r
   of a `Stride2Transfer` (ops/grid_stencil.py) in its packed forms: per
   fine node only the taps of its parity class, reading xc at (f - d) / 2;
   per coarse node the taps at 2c + d of the fine field (P^H r for a
   complex P: `pack_stride2` conjugates the restriction's table).

The plain versions are `grid_stencil_matvec` (ops/grid_stencil.py),
`cross_stencil_matvec` (ops/cross_stencil.py), `halo_stencil_plain` (the
planes catted, zero where missing, the plain cross apply of each row
range, torch's subtraction or update), `block_apply_plain` (the
cross applies of the blocks, added, subtracted from b), the slab
`stencil_matvec_plain`, `dia_apply_plain` and the strided
`stride2_prolong_plain` / `stride2_restrict_plain`: the same
shift-multiply-accumulate with zero-filled shifts, in the kernel's tap
order.

What bounds kernel D is device memory; what held its first version back
was latency: one tap at a time, two loads in flight a thread.  It now
issues the loads of a group of taps together (`group` taps, predicated),
and on grids too small to fill the card splits each node's taps across
`split` threads whose partial sums one of them adds in a fixed order
(csrc/stencil.cu).  `stencil_plan` picks the schedule on the host, cached;
the C entry refuses a plan that does not fit.

Dispatch: every entry point launches the kernel for a CUDA tensor (or raises
on anything it does not take, a stencil of more than `MAX_TAPS` taps
included) and takes the plain version only for a tensor on the CPU.
`GridStencil.matvec` sends a field the kernel has no type for
(`supports_stencil` false: bfloat16, float16) to `grid_apply_plain` on any
device.  `LAUNCHES` counts kernel launches, `PLAIN_CALLS` calls of the plain
version, per value type of x; a prolong or a restrict is one of either.
`CROSS_LAUNCHES` counts, per value type, the launches of the cross form
(a cross block between two different grids, and a `halo_apply`);
`HALO_LAUNCHES` those of the halo form (`halo_stencil`), and
`HALO_FORM_LAUNCHES` them by form and type ("residual.float32");
`BLOCK_LAUNCHES` those of `block_apply`.  The halo and block forms add
to `LAUNCHES` too, not to `CROSS_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..grid_stencil import grid_stencil_matvec
from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "CROSS_LAUNCHES", "HALO_LAUNCHES",
           "HALO_FORMS", "HALO_FORM_LAUNCHES", "HaloPlan", "halo_plan",
           "halo_stencil", "halo_stencil_plain",
           "BLOCK_LAUNCHES", "MAX_TAPS", "block_table", "block_table_parts",
           "block_apply", "block_apply_plain",
           "FORMS", "StencilPlan", "stencil_plan", "plan_fits",
           "supports_stencil", "grid_apply",
           "grid_apply_plain", "cross_apply", "cross_apply_plain",
           "halo_apply",
           "stencil_matvec", "stencil_matvec_plain",
           "dia_apply", "dia_apply_plain", "stride2_prolong",
           "stride2_prolong_plain", "stride2_restrict",
           "stride2_restrict_plain"]

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
LAUNCHES = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
PLAIN_CALLS = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
CROSS_LAUNCHES = {"float32": 0, "float64": 0, "complex64": 0,
                  "complex128": 0}
HALO_LAUNCHES = {"float32": 0, "float64": 0, "complex64": 0,
                 "complex128": 0}
HALO_FORMS = ("apply", "residual", "jacobi")
HALO_FORM_LAUNCHES = {f"{f}.{t}": 0 for f in HALO_FORMS
                      for t in ("float32", "float64", "complex64",
                                "complex128") if f != "jacobi" or
                      t in ("float32", "float64")}
BLOCK_LAUNCHES = {"float32": 0, "float64": 0, "complex64": 0,
                  "complex128": 0}
MAX_TAPS = 256                   # kMaxTaps of csrc/stencil.cu
FORMS = ("apply", "restrict", "prolong", "cross")
THREADS = 256                    # kThreads
MAX_SPLIT = 16                   # kMaxSplit
CLASSES = 8                      # kClasses: parity classes of a 3D box
FILL = 132 * 1024                # threads that keep the H100's 132 SMs busy
MIN_SLICE = 4                    # fewest taps a split slice takes
BLOCK_MAX_COMPS = 4              # kMaxComps of csrc/block_stencil.cu
BLOCK_MAX_BLOCKS = 16            # kMaxBlocks
BLOCK_MAX_TAPS = 320             # kMaxBlockTaps: taps of all blocks
BLOCK_MAX_ZY = 2 ** 15           # input boxes' Z and Y, shifts: 16 bits


class StencilPlan(NamedTuple):
    """How kernel D is launched (csrc/stencil.cu, plan_ok).

    `split` threads share each output node (1: schedule "stream"), each
    taking `per_slice` consecutive taps in groups of `group` whose loads
    are issued together; a block holds THREADS / split nodes; `mb`
    right-hand sides are summed in registers at a time.  smem: dynamic
    shared memory in bytes (a prolong's staged class table, the split's
    partial sums)."""
    form: int
    split: int
    group: int
    mb: int
    threads: int
    blocks: int
    per_slice: int
    smem: int

    @property
    def schedule(self) -> str:
        return "stream" if self.split == 1 else "split"


def _mb(m: int) -> int:
    return 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8


def _group(mb: int) -> int:
    return 8 if mb <= 2 else 16 // mb


def _smem(form: int, split: int, mb: int, nd: int, itemsize: int) -> int:
    table = nd * CLASSES * 16 if form == 2 else 0
    return table + ((split - 1) * (THREADS // split) * mb * itemsize
                    if split > 1 else 0)


def _make_plan(form: int, n: int, nd: int, m: int, itemsize: int,
               split: int) -> StencilPlan:
    mb = _mb(m)
    nb = THREADS // split
    return StencilPlan(form, split, _group(mb), mb, THREADS, -(-n // nb),
                       -(-nd // split), _smem(form, split, mb, nd, itemsize))


@functools.lru_cache(maxsize=512)
def stencil_plan(box, nd: int, m: int, dtype, form: str = "apply",
                 split: int | None = None) -> StencilPlan:
    """The launch plan of kernel D for `nd` taps on an output box (Z, Y, X)
    and m right-hand sides of `dtype`, in `form` (apply, restrict,
    prolong, cross; a prolong's nd is its widest parity class).

    Schedule: "stream" (split 1) where the grid fills the card; else
    "split", doubling the threads a node shares (up to MAX_SPLIT) while
    nodes x split < FILL and each slice keeps MIN_SLICE taps or more:
    65^2 nd 97 takes 16, 129^2 nd 37 takes 8, 513^2 and 129^3 stream.
    `split` forces a split (for tests and measurements)."""
    n = int(np.prod(box))
    if split is None:
        split = 1
        while (split < MAX_SPLIT and n * split < FILL
               and -(-nd // (2 * split)) >= MIN_SLICE):
            split *= 2
    return _make_plan(FORMS.index(form), n, nd, m,
                      torch.empty((), dtype=dtype).element_size(), split)


def plan_fits(plan, box, nd: int, m: int, dtype, form: str) -> bool:
    """True when `plan` is a plan for this launch (csrc/stencil.cu's
    plan_ok): a power-of-two split up to MAX_SPLIT, and every other number
    as `stencil_plan` derives it from that split."""
    plan = tuple(int(v) for v in plan)
    if len(plan) != len(StencilPlan._fields):
        return False
    split = plan[1]
    if not (1 <= split <= MAX_SPLIT and split & (split - 1) == 0):
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    return plan == tuple(_make_plan(FORMS.index(form), int(np.prod(box)), nd,
                                    m, itemsize, split))


@functools.lru_cache(maxsize=512)
def _plan_array(plan: StencilPlan) -> np.ndarray:
    out = np.asarray(plan, dtype=np.int32)
    out.setflags(write=False)
    return out


def _key(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def supports_stencil(offsets, grid, dtype) -> bool:
    """Kernel D covers 1D-3D grid stencils with any per-axis shifts in
    float32, float64, complex64 and complex128; other types take the plain
    version.  A stencil of
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
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _taps(taps) -> np.ndarray:
    """Host int32 (nd, 3) rows of (dz, dy, dx) for the C entry."""
    out = np.ascontiguousarray(np.asarray(taps, dtype=np.int32).reshape(-1, 3))
    out.setflags(write=False)
    return out


def _launch(coeff, box, taps, x, form="apply", in_box=None, in_space=None,
            ptab=None, plan=None):
    """Check the operands and launch kernel D: y on the (Z, Y, X) `box`
    (coeff is (nd, *space)), x (..., *in_space) on `in_box` (y's for an
    apply, any for a cross apply).  `taps`: (dz, dy, dx) per tap (of an apply or a
    restrict; every offset of a prolong's transfer); `ptab`: a prolong's
    (nd, 8, 4) class table on the device.  `plan` overrides `stencil_plan`
    (it must fit).  Returns y (..., *space)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel D takes float32, float64, complex64 or "
                        f"complex128, got {x.dtype}")
    space = tuple(coeff.shape[1:])
    in_space = space if in_space is None else tuple(in_space)
    in_box = box if in_box is None else in_box
    for name, t in (("coeff", coeff), ("x", x)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nd = coeff.shape[0]
    _check_taps(nd)
    if form == "prolong":
        if (ptab is None or ptab.device != x.device
                or ptab.dtype != torch.int32 or not ptab.is_contiguous()
                or tuple(ptab.shape) != (nd, CLASSES, 4)):
            raise ValueError(f"a prolong needs its ({nd}, {CLASSES}, 4) "
                             "int32 class table on x's device")
        _check_taps(len(taps))
    elif nd != len(taps):
        raise ValueError(f"coeff has {nd} taps, the stencil {len(taps)}")
    k = len(in_space)
    if x.ndim < k or tuple(x.shape[x.ndim - k:]) != in_space:
        raise ValueError(f"x must be (..., *{in_space}), got "
                         f"{tuple(x.shape)}")
    n, ni = int(np.prod(space)), int(np.prod(in_space))
    m = x.numel() // ni if ni else 0
    if m < 1 or n < 1:
        raise ValueError(f"empty field {tuple(x.shape)}")
    if max(x.numel(), m * n, coeff.numel()) >= 2 ** 31:
        raise ValueError("kernel D indexes with 32-bit integers: "
                         f"{max(x.numel(), m * n, coeff.numel())} elements "
                         "is too many")
    if x.device.index is not None and \
            x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if plan is None:
        plan = stencil_plan(box, nd, m, x.dtype, form)
    elif not plan_fits(plan, box, nd, m, x.dtype, form):
        raise ValueError(f"plan {tuple(plan)} does not fit {form} of {nd} "
                         f"taps on {box}, m = {m}")
    y = x.new_empty(x.shape[:x.ndim - k] + space)
    lib = _lib()
    rc = lib.mgt_stencil(
        _DTYPES[x.dtype], FORMS.index(form), nd, len(taps),
        _taps(taps).ctypes.data, *box, *in_box, m,
        coeff.data_ptr(), x.data_ptr(), y.data_ptr(),
        None if ptab is None else ptab.data_ptr(),
        _plan_array(StencilPlan(*plan)).ctypes.data,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "stencil")
    LAUNCHES[_key(x.dtype)] += 1
    if form == "cross":
        CROSS_LAUNCHES[_key(x.dtype)] += 1
    return y


def _device_check(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel D takes float32, float64, complex64 or "
                        f"complex128, got {x.dtype}")


def _box(grid) -> tuple[int, int, int]:
    return (1,) * (3 - len(grid)) + tuple(int(v) for v in grid)


def grid_apply(coeff, offsets, x):
    """y = A x for grid fields x (..., *grid): kernel D on a CUDA tensor,
    `grid_stencil_matvec` on a CPU tensor.  coeff is (nd, *grid) and
    offsets its per-tap per-axis shifts (slowest axis first)."""
    grid = tuple(coeff.shape[1:])
    if x.device.type == "cpu":
        return grid_apply_plain(coeff, offsets, x)
    _device_check(x)
    offsets = tuple(tuple(int(d) for d in off) for off in offsets)
    if not supports_stencil(offsets, grid, x.dtype):
        raise ValueError(f"kernel D takes 1D-3D stencils (got "
                         f"{len(grid)}D, {x.dtype})")
    _check_taps(len(offsets))
    pad = 3 - len(grid)
    taps = tuple((0,) * pad + off for off in offsets)
    return _launch(coeff, _box(grid), taps, x)


def cross_apply_plain(coeff, offsets, in_grid, x):
    """Counted plain cross apply: `cross_stencil_matvec` on any device."""
    from ..cross_stencil import cross_stencil_matvec
    _count_plain(x.dtype)
    return cross_stencil_matvec(coeff, offsets, in_grid, x)


def cross_apply(coeff, offsets, in_grid, x):
    """y = A x for a cross-grid stencil: x (..., *in_grid) -> y (...,
    *out_grid) with coeff (nd, *out_grid) and per-tap per-axis shifts
    `offsets` (slowest axis first).  Kernel D on a CUDA tensor,
    `cross_apply_plain` on a CPU one."""
    if x.device.type == "cpu":
        return cross_apply_plain(coeff, offsets, in_grid, x)
    _device_check(x)
    out_grid = tuple(int(v) for v in coeff.shape[1:])
    in_grid = tuple(int(v) for v in in_grid)
    offsets = tuple(tuple(int(d) for d in off) for off in offsets)
    if (not supports_stencil(offsets, out_grid, x.dtype)
            or len(in_grid) != len(out_grid)):
        raise ValueError(f"kernel D takes 1D-3D stencils (got {out_grid} "
                         f"from {in_grid}, {x.dtype})")
    _check_taps(len(offsets))
    pad = 3 - len(out_grid)
    taps = tuple((0,) * pad + off for off in offsets)
    # a square block is a plain apply: the same instantiation and result
    return _launch(coeff, _box(out_grid), taps, x,
                   "apply" if in_grid == out_grid else "cross",
                   in_box=_box(in_grid), in_space=in_grid)


def halo_apply(coeff, offsets, in_grid, x):
    """y = A x for a block y (..., *out_grid), coeff (nd, *out_grid), from
    x (..., *in_grid): the block with its halo planes (the taps shifted
    by the halo width; zero off in_grid).  Kernel D's cross form on a
    CUDA tensor, `cross_apply_plain` on a CPU one."""
    if x.device.type == "cpu":
        return cross_apply_plain(coeff, offsets, in_grid, x)
    _device_check(x)
    out_grid = tuple(int(v) for v in coeff.shape[1:])
    in_grid = tuple(int(v) for v in in_grid)
    offsets = tuple(tuple(int(d) for d in off) for off in offsets)
    if (not supports_stencil(offsets, out_grid, x.dtype)
            or len(in_grid) != len(out_grid)):
        raise ValueError(f"kernel D takes 1D-3D stencils (got {out_grid} "
                         f"from {in_grid}, {x.dtype})")
    _check_taps(len(offsets))
    pad = 3 - len(out_grid)
    taps = tuple((0,) * pad + off for off in offsets)
    return _launch(coeff, _box(out_grid), taps, x, "cross",
                   in_box=_box(in_grid), in_space=in_grid)


# ---------------------------------------------------------------------------
# the halo form (csrc/halo_stencil.cu)
# ---------------------------------------------------------------------------

class HaloPlan(NamedTuple):
    """How kernel D's halo form is launched (csrc/halo_stencil.cu,
    plan_ok): `split` threads share a node (the split of `stencil_plan` of
    the whole output block, so each node's taps are sliced as the cross
    form slices them), `group` taps' loads issued together, `mb` right-hand sides
    summed in registers, `blocks` CUDA blocks of THREADS / split nodes."""
    split: int
    group: int
    mb: int
    threads: int
    blocks: int
    per_slice: int
    smem: int


@functools.lru_cache(maxsize=512)
def halo_plan(box, nodes: int, nd: int, m: int, dtype) -> HaloPlan:
    """The halo form's launch plan for `nodes` output nodes of `nd` taps,
    m right-hand sides of `dtype`: the split of `stencil_plan(box, ...,
    "cross")`, `box` the whole output block whatever rows the launch
    writes."""
    split = stencil_plan(tuple(int(v) for v in box), nd, m, dtype,
                         "cross").split
    mb = _mb(m)
    item = torch.empty((), dtype=dtype).element_size()
    nb = THREADS // split
    return HaloPlan(split, _group(mb), mb, THREADS, -(-nodes // nb),
                    -(-nd // split),
                    (split - 1) * nb * mb * item if split > 1 else 0)


def _halo_reach(offsets, axis: int) -> tuple[int, int]:
    """How far the taps reach past the block along `axis`: (left, right)."""
    return (max(0, -min(int(off[axis]) for off in offsets)),
            max(0, max(int(off[axis]) for off in offsets)))


def _ranges(rows, extent: int):
    return ([(0, extent)] if rows is None
            else [(a, z) for a, z in ((rows[0], rows[1]), (rows[2], rows[3]))
                  if z > a])


def _halo_form(b, d) -> str:
    if d is not None and b is None:
        raise ValueError("the Jacobi form needs b")
    return "apply" if b is None else "residual" if d is None else "jacobi"


def halo_stencil_plain(coeff, offsets, x, left=None, right=None, axis=0, *,
                       b=None, d=None, rows=None, out=None):
    """The plain halo form: the block x extended along `axis` by the
    neighbours' planes (zero planes for a missing one, and where the taps
    reach past the planes given), the counted plain cross apply
    (`cross_apply_plain`) of each row range on its window, then b - y or
    x + d * (b - y) as torch rounds them."""
    form = _halo_form(b, d)
    g = coeff.ndim - 1
    out_grid = tuple(int(v) for v in coeff.shape[1:])
    dim = x.ndim - g + axis
    lead = tuple(x.shape[:x.ndim - g])
    reach = _halo_reach(offsets, axis)
    wl = 0 if left is None else left.shape[dim]
    wr = 0 if right is None else right.shape[dim]
    pl, pr = max(reach[0], wl), max(reach[1], wr)

    def zeros(w):
        shape = list(x.shape)
        shape[dim] = w
        return x.new_zeros(shape)

    xe = torch.cat([p for p in (zeros(pl - wl), left, x, right,
                                zeros(pr - wr)) if p is not None], dim=dim)
    taps = tuple(tuple(int(v) + (pl if a == axis else 0)
                       for a, v in enumerate(off)) for off in offsets)
    for lo, hi in _ranges(rows, out_grid[axis]):
        win = xe.narrow(dim, lo, hi - lo + pl + pr)
        y = cross_apply_plain(coeff.narrow(1 + axis, lo, hi - lo), taps,
                              tuple(win.shape[win.ndim - g:]), win)
        if form != "apply":
            bw = b.narrow(dim, lo, hi - lo)
            y = bw - y
            if form == "jacobi":
                y = x.narrow(dim, lo, hi - lo) + d.narrow(axis, lo,
                                                          hi - lo) * y
        if rows is None and out is None:
            return y
        if out is None:
            out = x.new_empty(lead + out_grid)
        out.narrow(dim, lo, hi - lo).copy_(y)
    return out


@functools.cache
def _halo_lib() -> ctypes.CDLL:
    lib = _build.library("halo_stencil")
    fn = lib.mgt_halo_stencil
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    return lib


def halo_stencil(coeff, offsets, x, left=None, right=None, axis=0, *,
                 b=None, d=None, rows=None, out=None):
    """Kernel D's halo form on a rank's block: for each output node r of
    coeff (nd, *out_grid), y = sum_k coeff[k, r] x[r + d_k], x the owned
    block (..., *in_grid) extended along grid axis `axis` by `left` and
    `right` (its neighbours' planes, read where they lie; None: no
    neighbour, nothing read), zero off the extended block.  `offsets`:
    the taps in x's frame (unshifted along `axis`).  Writes y (b None),
    the residual b - y (b given) or the Jacobi update x + d * (b - y) (b
    and d given, d (*out_grid), out_grid == in_grid), rounded as torch
    rounds them.

    rows: None (the whole block) or (r0, r1, r2, r3), the output rows
    [r0, r1) and [r2, r3) along `axis`, written into `out` (allocated when
    None) and the rest of `out` left alone.  The launch plan is
    `halo_plan` of the output grid and the launch's nodes, whatever rows
    it writes.

    One launch of csrc/halo_stencil.cu on a CUDA tensor (counted in
    LAUNCHES, HALO_LAUNCHES and HALO_FORM_LAUNCHES), `halo_stencil_plain`
    on a CPU one."""
    if x.device.type == "cpu":
        return halo_stencil_plain(coeff, offsets, x, left, right, axis, b=b,
                                  d=d, rows=rows, out=out)
    _device_check(x)
    form = _halo_form(b, d)
    if form == "jacobi" and x.dtype.is_complex:
        raise TypeError("the halo form's Jacobi update takes float32 or "
                        f"float64, got {x.dtype}")
    out_grid = tuple(int(v) for v in coeff.shape[1:])
    g = len(out_grid)
    offsets = tuple(tuple(int(v) for v in off) for off in offsets)
    if not supports_stencil(offsets, out_grid, x.dtype) or not 0 <= axis < g:
        raise ValueError(f"kernel D takes 1D-3D stencils (got {out_grid}, "
                         f"axis {axis}, {x.dtype})")
    _check_taps(len(offsets))
    if x.ndim < g:
        raise ValueError(f"x must be (..., *in_grid), got {tuple(x.shape)}")
    in_grid = tuple(int(v) for v in x.shape[x.ndim - g:])
    lead = tuple(x.shape[:x.ndim - g])
    m = int(np.prod(lead))
    if m < 1 or min(in_grid) < 1:
        raise ValueError(f"empty field {tuple(x.shape)}")
    widths = []
    checks = [("coeff", coeff, (len(offsets),) + out_grid), ("x", x, None)]
    for name, t in (("left", left), ("right", right)):
        if t is None:
            widths.append(0)
            continue
        w = int(t.shape[-g + axis]) if t.ndim == x.ndim else 0
        shape = list(lead + in_grid)
        shape[len(lead) + axis] = w
        checks.append((name, t, tuple(shape)))
        widths.append(w)
    if b is not None:
        checks.append(("b", b, lead + out_grid))
    if d is not None:
        if out_grid != in_grid:
            raise ValueError("the Jacobi form writes the owned block: "
                             f"output {out_grid}, block {in_grid}")
        checks.append(("d", d, out_grid))
    if out is not None:
        checks.append(("out", out, lead + out_grid))
    for name, t, shape in checks:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x "
                             f"{x.dtype} on {x.device}")
        if (shape is not None and tuple(t.shape) != shape) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if min(widths) < 0 or (left is not None and widths[0] < 1) or \
            (right is not None and widths[1] < 1) or \
            max(widths) > in_grid[axis]:
        raise ValueError(f"halo widths {widths} on a block of "
                         f"{in_grid[axis]} planes")
    if max(x.numel(), m * int(np.prod(out_grid)), coeff.numel()) >= 2 ** 31:
        raise ValueError("kernel D indexes with 32-bit integers")
    if x.device.index is not None and \
            x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    ext = out_grid[axis]
    rr = (0, ext, ext, ext) if rows is None else tuple(int(v) for v in rows)
    if not (len(rr) == 4 and 0 <= rr[0] <= rr[1] <= rr[2] <= rr[3] <= ext
            and rr[1] - rr[0] + rr[3] - rr[2] >= 1):
        raise ValueError(f"rows {rows} on an axis of {ext}")
    if rows is not None and out is None:
        out = x.new_empty(lead + out_grid)
    y = x.new_empty(lead + out_grid) if out is None else out
    nodes = int(np.prod(out_grid)) // ext * (rr[1] - rr[0] + rr[3] - rr[2])
    plan = halo_plan(_box(out_grid), nodes, len(offsets), m, x.dtype)
    pad = 3 - g
    taps = tuple((0,) * pad + off for off in offsets)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _halo_lib()
    rc = lib.mgt_halo_stencil(
        _DTYPES[x.dtype], HALO_FORMS.index(form), len(taps),
        _taps(taps).ctypes.data, *_box(out_grid), *_box(in_grid), pad + axis,
        widths[0], widths[1], _rows_array(rr).ctypes.data, m,
        coeff.data_ptr(), x.data_ptr(), ptr(left), ptr(right), ptr(b),
        ptr(d), y.data_ptr(), _plan_array(plan).ctypes.data,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "halo stencil")
    key = _key(x.dtype)
    LAUNCHES[key] += 1
    HALO_LAUNCHES[key] += 1
    HALO_FORM_LAUNCHES[f"{form}.{key}"] += 1
    return y


@functools.lru_cache(maxsize=256)
def _rows_array(rows) -> np.ndarray:
    out = np.asarray(rows, dtype=np.int32)
    out.setflags(write=False)
    return out


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
    _device_check(x)
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
    `dia_apply_plain` on a CPU one or in a floating type below float32 (a
    bfloat16 cycle)."""
    if x.device.type == "cpu" or (x.dtype.is_floating_point
                                  and x.dtype.itemsize < 4):
        return dia_apply_plain(data, offsets, x)
    _device_check(x)
    n = data.shape[1]
    if x.shape[0] != n or x.ndim not in (1, 2):
        raise ValueError(f"x must be ({n},) or ({n}, m), got "
                         f"{tuple(x.shape)}")
    xt = x[None] if x.ndim == 1 else x.T.contiguous()
    taps = tuple((0, 0, int(o)) for o in offsets)
    y = _launch(data, (1, 1, n), taps, xt)
    return y[0] if x.ndim == 1 else y.T


def _lead(x, grid):
    """x (..., *grid) as (m, *grid) (a view) and its leading shape."""
    k = len(grid)
    if x.ndim < k or tuple(x.shape[x.ndim - k:]) != tuple(grid):
        raise ValueError(f"field must be (..., *{tuple(grid)}), got "
                         f"{tuple(x.shape)}")
    return x.reshape((-1,) + tuple(grid)), x.shape[:x.ndim - k]


def stride2_prolong_plain(T, xc):
    """Plain P xc of a packed Stride2Transfer: per parity class q and tap t,
    the class's fine nodes f = p + 2i (p the class's parity) take
    pcoeff[t, f] * xc[i + (p - d) / 2], zero outside the coarse grid."""
    _count_plain(xc.dtype)
    x2, lead = _lead(xc, T.coarse_grid)
    y = x2.new_zeros((x2.shape[0],) + T.fine_grid)
    g = len(T.fine_grid)
    for q, offs in enumerate(T.classes):
        par = [(q >> (g - 1 - a)) & 1 for a in range(g)]
        for t, off in enumerate(offs):
            fs, cs = [slice(None)], [slice(None)]
            for F, C, p, d in zip(T.fine_grid, T.coarse_grid, par, off):
                s = (p - d) // 2
                lo, hi = max(0, -s), min((F - p + 1) // 2, C - s)
                fs.append(slice(p + 2 * lo, p + 2 * hi - 1, 2))
                cs.append(slice(lo + s, hi + s))
                if lo >= hi:
                    break
            else:
                y[tuple(fs)] += T.pcoeff[(t,) + tuple(fs[1:])] * x2[tuple(cs)]
    return y.reshape(lead + T.fine_grid)


def stride2_restrict_plain(T, r):
    """Plain P^H r of a packed Stride2Transfer: per tap k, the coarse nodes
    c with 2c + d_k on the fine grid take rcoeff[k, c] * r[2c + d_k]
    (rcoeff holds the conjugated coefficients)."""
    _count_plain(r.dtype)
    r2, lead = _lead(r, T.fine_grid)
    rc = r2.new_zeros((r2.shape[0],) + T.coarse_grid)
    for k, off in enumerate(T.offsets):
        cs, fs = [slice(None)], [slice(None)]
        for F, C, d in zip(T.fine_grid, T.coarse_grid, off):
            lo, hi = max(0, (1 - d) // 2), min(C, (F - 1 - d) // 2 + 1)
            cs.append(slice(lo, hi))
            fs.append(slice(2 * lo + d, 2 * hi + d - 1, 2))
            if lo >= hi:
                break
        else:
            rc[tuple(cs)] += T.rcoeff[(k,) + tuple(cs[1:])] * r2[tuple(fs)]
    return rc.reshape(lead + T.coarse_grid)


def stride2_prolong(T, xc):
    """P xc, xc (..., *coarse_grid) -> (..., *fine_grid), for a packed
    Stride2Transfer T: kernel D's prolong form on a CUDA tensor,
    `stride2_prolong_plain` on a CPU one."""
    if xc.device.type == "cpu":
        return stride2_prolong_plain(T, xc)
    _device_check(xc)
    pad = 3 - len(T.fine_grid)
    return _launch(T.pcoeff, _box(T.fine_grid),
                   tuple((0,) * pad + off for off in T.offsets),
                   xc.contiguous(), form="prolong",
                   in_box=_box(T.coarse_grid), in_space=T.coarse_grid,
                   ptab=T.ptab)


def stride2_restrict(T, r):
    """P^H r, r (..., *fine_grid) -> (..., *coarse_grid), for a packed
    Stride2Transfer T: kernel D's restrict form on a CUDA tensor,
    `stride2_restrict_plain` on a CPU one."""
    if r.device.type == "cpu":
        return stride2_restrict_plain(T, r)
    _device_check(r)
    pad = 3 - len(T.fine_grid)
    return _launch(T.rcoeff, _box(T.coarse_grid),
                   tuple((0,) * pad + off for off in T.offsets),
                   r.contiguous(), form="restrict",
                   in_box=_box(T.fine_grid), in_space=T.fine_grid)


# ---------------------------------------------------------------------------
# the block-operator form (csrc/block_stencil.cu)
# ---------------------------------------------------------------------------

def _tap_geometry(obox, ibox, d, lo, hi) -> int:
    """One tap of a block: narrows [lo, hi] per axis to the output nodes
    whose source r + d lies in the input box and returns the tap's offset
    in that box; a tap that no output node reaches becomes (iZ, 0, 0),
    always masked (csrc/block_stencil.cu::tap_geometry, stencil.cu's
    make_taps)."""
    reach = True
    for a in range(3):
        l = -d[a] if d[a] < 0 else 0
        h = ibox[a] - 1 - d[a] if ibox[a] - 1 - d[a] >= 0 else -1
        reach = reach and l <= h and l <= obox[a] - 1 and h >= 0
        lo[a] = max(lo[a], l)
        hi[a] = min(hi[a], max(h, -1))
    if not reach:
        d = (ibox[0], 0, 0)
    return (d[0] * ibox[1] + d[1]) * ibox[2] + d[2]


@functools.lru_cache(maxsize=256)
def block_table(out_grids, in_grids, pairs, offsets) -> np.ndarray:
    """The static table of a block operator for kernel D's block form
    (csrc/block_stencil.cu, load_table), int32, read-only:

      header  [ncomp, nblocks, ntaps, ctas]
      comps   per component [oZ, oY, oX, iZ, iY, iX, b0, nb, split, cta0]:
              its output box, the box its input has, its blocks [b0, b0 +
              nb) of the table, the largest split of them, its first CUDA
              block (THREADS / split nodes a block);
      blocks  per block, grouped by output component in block order,
              [src, ci, cj, t0, nd, split, per_slice, lo (3), hi (3)]:
              src its index in `pairs`, its taps [t0, t0 + nd), the split
              of its own cross-form launch (`stencil_plan` of its output
              box), the output nodes whose taps all land in the input box;
      taps    [dz, dy, dx, lin] per tap, lin its offset in the input box.

    out_grids / in_grids: per component the grid of its output and of the
    field the blocks read from it; offsets: per block its taps (per grid
    axis).  No pointer: a cast copy's coefficients are the copy's own."""
    nc, g = len(out_grids), len(out_grids[0])
    if not 1 <= nc <= BLOCK_MAX_COMPS or len(in_grids) != nc:
        raise ValueError(f"kernel D's block form takes 1 to "
                         f"{BLOCK_MAX_COMPS} components, got {nc}")
    if len(pairs) > BLOCK_MAX_BLOCKS or len(offsets) != len(pairs):
        raise ValueError(f"kernel D's block form takes up to "
                         f"{BLOCK_MAX_BLOCKS} blocks, got {len(pairs)}")
    if not 1 <= g <= 3 or any(len(gr) != g for gr in (*out_grids,
                                                       *in_grids)):
        raise ValueError("the components' grids must all be 1D, 2D or 3D")
    obox = [_box(gr) for gr in out_grids]
    ibox = [_box(gr) for gr in in_grids]
    if any(b[0] >= BLOCK_MAX_ZY or b[1] >= BLOCK_MAX_ZY for b in ibox):
        raise ValueError("kernel D's block form takes input boxes under "
                         f"{BLOCK_MAX_ZY} along Z and Y")
    comps, blocks, taps, cta = [], [], [], 0
    for c in range(nc):
        b0, widest = len(blocks), 1
        for src, (ci, cj) in enumerate(pairs):
            if ci != c:
                continue
            nd = len(offsets[src])
            _check_taps(nd)
            split = stencil_plan(obox[ci], nd, 1, torch.float32,
                                 "cross").split
            lo, hi = [0, 0, 0], [v - 1 for v in obox[ci]]
            t0 = len(taps)
            for off in offsets[src]:
                if len(off) != g:
                    raise ValueError(f"tap {off} of block {(ci, cj)} is not "
                                     f"{g}D")
                d = (0,) * (3 - g) + tuple(int(v) for v in off)
                if any(abs(v) >= BLOCK_MAX_ZY for v in d):
                    raise ValueError(f"tap {off}: shifts of kernel D's "
                                     f"block form stay under {BLOCK_MAX_ZY}")
                taps.append(d + (_tap_geometry(obox[ci], ibox[cj], d, lo,
                                               hi),))
            blocks.append((src, ci, cj, t0, nd, split, -(-nd // split),
                           *lo, *hi))
            widest = max(widest, split)
        comps.append((*obox[c], *ibox[c], b0, len(blocks) - b0, widest, cta))
        cta += -(-int(np.prod(obox[c])) // (THREADS // widest))
    if len(taps) > BLOCK_MAX_TAPS:
        raise ValueError(f"kernel D's block form takes {BLOCK_MAX_TAPS} taps "
                         f"in all, the operator has {len(taps)}")
    out = np.concatenate([np.asarray((nc, len(blocks), len(taps), cta)),
                          np.asarray(comps).ravel(),
                          np.asarray(blocks, dtype=np.int64).ravel(),
                          np.asarray(taps, dtype=np.int64).ravel()]
                         ).astype(np.int32)
    out.setflags(write=False)
    return out


def block_table_parts(table):
    """(comps, blocks, taps) of a `block_table`: int32 arrays of 10, 13 and
    4 columns."""
    nc, nb, nt = (int(v) for v in table[:3])
    cut = np.cumsum([4, 10 * nc, 13 * nb])
    return (table[cut[0]:cut[1]].reshape(nc, 10),
            table[cut[1]:cut[2]].reshape(nb, 13),
            table[cut[2]:].reshape(nt, 4))


def block_apply_plain(op, xs, bs=None):
    """The plain block apply: each block's counted plain cross apply
    (`cross_apply_plain` of `op.block_coeffs` and `op.block_offsets` on
    the component it reads), added per output component in block order;
    with `bs` each component subtracted from b."""
    g = len(op.grids[0])
    ys = [None] * len(op.grids)
    for (ci, cj), coeff, offs in zip(op.pairs, op.block_coeffs,
                                     op.block_offsets):
        x = xs[cj]
        t = cross_apply_plain(coeff, offs, tuple(x.shape[x.ndim - g:]), x)
        ys[ci] = t if ys[ci] is None else ys[ci] + t
    lead = tuple(xs[0].shape[:xs[0].ndim - g])
    ys = tuple(xs[0].new_zeros(lead + tuple(gr)) if y is None else y
               for y, gr in zip(ys, op.grids))
    return ys if bs is None else tuple(b - y for b, y in zip(bs, ys))


@functools.cache
def _block_lib() -> ctypes.CDLL:
    lib = _build.library("block_stencil")
    fn = lib.mgt_block_stencil
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _ptrs(ts) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in ts), dtype=np.uint64)


def block_apply(op, xs, bs=None):
    """y = A x (each output component summed over its blocks in block
    order) or, with `bs`, r = b - A x, for a block operator `op` on its
    components' fields xs (m, *grid), in one launch of kernel D's block
    form on a CUDA tensor; `block_apply_plain` on a CPU one.

    `op` gives `pairs`, `grids` (the output components' grids),
    `block_coeffs` and `block_offsets` (per block in pair order, the taps
    on the field it reads) and `block_table` (`block_table` of them)."""
    x0 = xs[0]
    if x0.device.type == "cpu":
        return block_apply_plain(op, xs, bs)
    _device_check(x0)
    table = op.block_table
    comps, blocks, _ = block_table_parts(table)
    grids = tuple(tuple(int(v) for v in gr) for gr in op.grids)
    g = len(grids[0])
    if len(xs) != len(grids) or (bs is not None and len(bs) != len(grids)):
        raise ValueError(f"the operator has {len(grids)} components, got "
                         f"{len(xs)} fields")
    lead = tuple(x0.shape[:x0.ndim - g])
    m = int(np.prod(lead))
    if m < 1:
        raise ValueError(f"empty field {tuple(x0.shape)}")
    bs = None if bs is None else tuple(b.contiguous() for b in bs)
    coeffs = op.block_coeffs
    checks = [(f"x[{c}]", x, lead + tuple(int(v) for v in comps[c, 6 - g:6]))
              for c, x in enumerate(xs)]
    checks += [(f"b[{c}]", b, lead + gr)
               for c, (b, gr) in enumerate(zip(bs or (), grids))]
    checks += [(f"block {op.pairs[s]}", coeffs[s],
                (int(nd),) + grids[ci]) for s, ci, nd in blocks[:, [0, 1, 4]]]
    for name, t, shape in checks:
        if t.device != x0.device or t.dtype != x0.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x[0] "
                             f"{x0.dtype} on {x0.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if x0.device.index is not None and \
            x0.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x0.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    ys = tuple(x0.new_empty(lead + gr) for gr in grids)
    cp = _ptrs(coeffs[s] for s in blocks[:, 0])
    xp, yp = _ptrs(xs), _ptrs(ys)
    bp = None if bs is None else _ptrs(bs)
    lib = _block_lib()
    rc = lib.mgt_block_stencil(
        _DTYPES[x0.dtype], table.ctypes.data, table.size,
        cp.ctypes.data, xp.ctypes.data,
        None if bp is None else bp.ctypes.data, yp.ctypes.data, m,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(lib, rc, "block stencil")
    key = _key(x0.dtype)
    LAUNCHES[key] += 1
    BLOCK_LAUNCHES[key] += 1
    return ys
