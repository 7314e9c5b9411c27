"""Kernel E: the lexicographic Vanka sweep, and its plain version.

CUDA source: mgtpu_torch/csrc/vanka.cu (built by ops/cuda/_build.py).  It
runs on the card what mgtpu runs there as one `lax.fori_loop` over the
cells (mgtpu/cycle/vanka.py::_lex_sweep; no Pallas kernel): `num_it`
sequential sweeps, cell after cell, each cell's block residual from its
ELL rows, times its single-precision block inverse, added to x — one
launch a call, one warp walking the cells with the cell tables streamed
ahead into shared memory, x and b staged there too where they fit
("smem_b"), else x alone ("smem"), else left in global memory
("global").  Values are float32, float64, complex64
or complex128; the block inverses float32, or complex64 for complex values
(the single variant, raised to x's type before the product as mgtpu's
``dinv.astype(x.dtype)``).

`pack_cells` bakes the four tables into one record a cell, and the
records remember the tensors they were packed from.  `lex_sweep(x, b,
idx, dinv, rows_idx, rows_val, num_it, cells=None)` launches
the kernel for a CUDA tensor (or raises on anything it does not take,
cells of other tables included), once for each chunk of at most 32 // bs
right-hand sides (they are independent), and takes the plain version,
`lex_sweep_plain` (mgtpu's per-cell loop in torch), only for a tensor on
the CPU.  `LAUNCHES` counts kernel launches, `PLAIN_CALLS` calls of the
plain version, per value type of x; `FORMS` launches per form.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any

import torch

from . import _build
from ._cache import PerTensor, Source

__all__ = ["DTYPES", "LAUNCHES", "PLAIN_CALLS", "FORMS", "Cells",
           "lex_sweep", "lex_sweep_plain", "pack_cells", "smem_bytes"]

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
DTYPES = tuple(_DTYPES)          # the value types the kernel takes
LAUNCHES = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
PLAIN_CALLS = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
FORMS = {"smem_b": 0, "smem": 0, "global": 0}
XSMEM = {"global": 0, "smem": 1, "smem_b": 2}
MAX_SHARED = 232448              # kMaxShared: 227 KB a block on sm_90
AHEAD = 8                        # kAhead: cells of b in flight
REC_RING = 2 * AHEAD + 2         # kRecRing: records l - 1 .. l + 2A
B_RING = AHEAD + 2               # kBRing: b of cells l .. l + A


def _key(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _bytes16(t: torch.Tensor, L: int) -> torch.Tensor:
    """t's values as bytes, (L, nbytes) padded to a multiple of 16."""
    if t.is_complex():
        t = torch.view_as_real(t)
    by = t.contiguous().view(torch.uint8).reshape(L, -1)
    return torch.nn.functional.pad(by, (0, (-by.shape[-1]) % 16))


@dataclass(frozen=True, eq=False)
class Cells:
    """Kernel E's cell records: `rec` (L, rb) bytes, per cell idx[bs] and
    rows_idx[bs * K] (int32), rows_val[bs * K] at ro_val, dinv[bs * bs] at
    ro_dinv, 16-byte aligned parts, one bulk copy a cell; `srcs` the
    `Source`s of the four tables they were packed from."""
    rec: Any
    ro_val: int
    ro_dinv: int
    rb: int
    srcs: tuple

    def of(self, *tables) -> bool:
        """Whether these are the records of (idx, dinv, rows_idx,
        rows_val)."""
        return all(s.holds(t) for s, t in zip(self.srcs, tables))


def pack_cells(idx, dinv, rows_idx, rows_val) -> Cells:
    """Kernel E's cell records of these tables.  Built once per state
    (VankaRelax, on a card), or once per rows_val by `lex_sweep`."""
    L, bs = idx.shape
    ints = torch.cat([idx.reshape(L, bs), rows_idx.reshape(L, -1)],
                     dim=1).to(torch.int32)
    parts = [_bytes16(ints, L), _bytes16(rows_val.reshape(L, -1), L),
             _bytes16(dinv.reshape(L, -1), L)]
    ro_val = parts[0].shape[1]
    ro_dinv = ro_val + parts[1].shape[1]
    return Cells(torch.cat(parts, dim=1).contiguous(), ro_val, ro_dinv,
                 ro_dinv + parts[2].shape[1],
                 tuple(Source(t) for t in (idx, dinv, rows_idx, rows_val)))


_CELLS = PerTensor()           # pack_cells of tables given without them


def smem_bytes(bs: int, K: int, m: int, n: int, item: int, ditem: int,
               form: str) -> int:
    """Shared memory of a launch (vanka.cu `plan_smem`)."""
    a16 = lambda v: -(-v // 16) * 16
    rb = a16((bs + bs * K) * 4) + a16(bs * K * item) + a16(bs * bs * ditem)
    return (a16(8 * (REC_RING + 2)) + REC_RING * rb
            + a16(B_RING * bs * m * item)
            + a16(n * m * item) * (form != "global")
            + n * m * item * (form == "smem_b"))


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
    fn.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib


def lex_sweep(x, b, idx, dinv, rows_idx, rows_val, num_it: int,
              cells: Cells | None = None):
    """num_it lexicographic Vanka sweeps on x, b (n, m): kernel E on a
    CUDA tensor (one launch a chunk of at most 32 // bs right-hand sides;
    x is not written, the result is a new tensor), `lex_sweep_plain` on a
    CPU one.  idx (L, bs) and rows_idx (L, bs, K) int32, dinv (L, bs, bs)
    float32 (complex64 for complex x), rows_val (L, bs, K) of x's type;
    bs <= 32.  `cells` the tables' `pack_cells` (packed once and kept for
    rows_val if not given; cells of other tables raise).  The form is the
    first of "smem_b" (x and b staged in shared memory), "smem" (x
    staged) and "global" that fits in MAX_SHARED."""
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
    if b.data_ptr() % 16:
        b = b.clone()                       # the bulk copy's alignment
    L, bs = idx.shape
    K = rows_idx.shape[-1]
    n, m = x.shape
    dtype_d = torch.complex64 if x.dtype.is_complex else torch.float32
    want = {"idx": ((L, bs), torch.int32), "rows_idx": ((L, bs, K),
                                                        torch.int32),
            "dinv": ((L, bs, bs), dtype_d),
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
    if bs > 32:
        raise ValueError(f"kernel E walks a cell with one warp: bs = {bs} "
                         f"> 32")
    tables = (idx, dinv, rows_idx, rows_val)
    if cells is None:
        cells = _CELLS.get(rows_val, lambda: pack_cells(*tables),
                           valid=lambda c: c.of(*tables))
    elif not cells.of(*tables):
        raise ValueError("the cells were packed from other tables than "
                         "idx, dinv, rows_idx and rows_val")
    if m > 32 // bs:                        # one warp a cell: bs * m <= 32
        w = 32 // bs
        return torch.cat([lex_sweep(x[:, c:c + w], b[:, c:c + w], *tables,
                                    num_it, cells)
                          for c in range(0, m, w)], dim=1)
    item = x.element_size()
    ditem = 8 if x.dtype.is_complex else 4
    fits = [f for f in ("smem_b", "smem", "global")
            if smem_bytes(bs, K, m, n, item, ditem, f) <= MAX_SHARED]
    if not fits:
        raise ValueError(f"kernel E: no form fits {MAX_SHARED} bytes of "
                         f"shared memory (bs {bs}, K {K}, m {m}, n {n}, "
                         f"{x.dtype})")
    y = x.contiguous().clone()
    lib = _lib()
    rc = lib.mgt_vanka_lex(
        _DTYPES[x.dtype], L, bs, K, m, n, int(num_it),
        XSMEM[fits[0]], cells.ro_val, cells.ro_dinv, cells.rb,
        cells.rec.data_ptr(), b.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"vanka_lex ({fits[0]})")
    LAUNCHES[_key(x.dtype)] += 1
    FORMS[fits[0]] += 1
    return y
