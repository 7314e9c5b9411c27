"""Kernel D: the variable-coefficient stencil apply, and its plain versions.

CUDA source: mgtpu_torch/csrc/stencil.cu (built by ops/cuda/_build.py).  It
replaces the Pallas TPU kernel mgtpu/ops/pallas/stencil_kernel.py
``_stencil_kernel`` (K8): y = A x for a stencil with per-node coefficients,
one read of the coefficients and of x, one write of y, in float32 or
float64, for any number of leading right-hand sides.

Entry points:

 * `grid_apply(coeff, offsets, x)` — `GridStencil.matvec`'s apply on grid
   fields (..., *grid) of a 1D, 2D or 3D grid, any per-axis shifts, at most
   `MAX_TAPS` taps; taps that leave the grid read zero on every axis.
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
   per coarse node the taps at 2c + d of the fine field.

The plain versions are `grid_stencil_matvec` (ops/grid_stencil.py), the
slab `stencil_matvec_plain`, `dia_apply_plain` and the strided
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
(`supports_stencil` false: float16, complex) to `grid_apply_plain` on any
device.  `LAUNCHES` counts kernel launches, `PLAIN_CALLS` calls of the plain
version, per float type of x; a prolong or a restrict is one of either.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..grid_stencil import grid_stencil_matvec
from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "MAX_TAPS", "FORMS", "StencilPlan",
           "stencil_plan", "plan_fits", "supports_stencil", "grid_apply",
           "grid_apply_plain", "stencil_matvec", "stencil_matvec_plain",
           "dia_apply", "dia_apply_plain", "stride2_prolong",
           "stride2_prolong_plain", "stride2_restrict",
           "stride2_restrict_plain"]

_DTYPES = {torch.float32: 0, torch.float64: 1}
LAUNCHES = {"float32": 0, "float64": 0}
PLAIN_CALLS = {"float32": 0, "float64": 0}
MAX_TAPS = 256                   # kMaxTaps of csrc/stencil.cu
FORMS = ("apply", "restrict", "prolong")
THREADS = 256                    # kThreads
MAX_SPLIT = 16                   # kMaxSplit
CLASSES = 8                      # kClasses: parity classes of a 3D box
FILL = 132 * 1024                # threads that keep the H100's 132 SMs busy
MIN_SLICE = 4                    # fewest taps a split slice takes


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
    prolong; a prolong's nd is its widest parity class).

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
    (coeff is (nd, *space)), x (..., *in_space) on `in_box` (the same as
    y's for an apply).  `taps`: (dz, dy, dx) per tap (of an apply or a
    restrict; every offset of a prolong's transfer); `ptab`: a prolong's
    (nd, 8, 4) class table on the device.  `plan` overrides `stencil_plan`
    (it must fit).  Returns y (..., *space)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel D takes float32 or float64, got {x.dtype}")
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
    return y


def _device_check(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel D takes float32 or float64, got {x.dtype}")


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
        raise ValueError(f"kernel D takes 1D-3D stencils in float32/float64 "
                         f"(got {len(grid)}D, {x.dtype})")
    _check_taps(len(offsets))
    pad = 3 - len(grid)
    taps = tuple((0,) * pad + off for off in offsets)
    return _launch(coeff, _box(grid), taps, x)


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
    `dia_apply_plain` on a CPU one."""
    if x.device.type == "cpu":
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
    """Plain P^T r of a packed Stride2Transfer: per tap k, the coarse nodes
    c with 2c + d_k on the fine grid take rcoeff[k, c] * r[2c + d_k]."""
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
    """P^T r, r (..., *fine_grid) -> (..., *coarse_grid), for a packed
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
