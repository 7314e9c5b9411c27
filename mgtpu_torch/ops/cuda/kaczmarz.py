"""Kernel F: the hybrid Kaczmarz sweep, its launch plan, and its plain version.

CUDA source: mgtpu_torch/csrc/kaczmarz.cu (built by ops/cuda/_build.py).
It runs on the card what mgtpu runs there as a `lax.fori_loop` over the
rows of the domains (mgtpu/cycle/kaczmarz.py:70 kaczmarz_sweep, its
row_step at :78-91; no Pallas kernel): step i takes row arr[i, d] of every
domain d, computes r = (b - a.x) * invd * mask from the x of before the
step and adds conj(a) r at the row's columns, collisions across domains
summed — `num_it` sweeps in one launch; in float32, float64, complex64 or
complex128, with the row norms (invd) and the mask in the real type.  The
plain version makes about ten torch calls a step.

`kaczmarz_links` is the setup-time link table: the adds of one column in a
step are summed in a fixed order (a recorded sweep is bitwise its eager
run).  `kaczmarz_plan` turns the tables into the kernel's step streams
(one int32 chunk per step, and where the values it reads lie);
`kaczmarz_records` bakes the values of one (ell_val, invd) pair into
them, and the records remember the tensors they were made from.

`kaczmarz_sweep_kernel(x, b, arr, mask, invd, ell_idx, ell_val, link,
num_it, plan=None, records=None)` launches the kernel for a CUDA tensor
(or raises on anything it does not take, records of other values
included) and takes the plain version, `kaczmarz_sweep_plain` (mgtpu's
row_step in torch), only for a tensor on the CPU or of a type the kernel
does not take (bfloat16).  Without `plan` it builds one from the tables
once and keeps it for that link tensor; without `records` it bakes them
once and keeps them for that ell_val tensor (anew if invd or the plan
changed).  `LAUNCHES` counts kernel launches, `PLAIN_CALLS` calls of the
plain version, per value type of x.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from . import _build
from ._cache import PerTensor, Source

__all__ = ["DTYPES", "LAUNCHES", "PLAIN_CALLS", "MAX_RHS", "KaczmarzPlan",
           "SweepRecords", "kaczmarz_links", "kaczmarz_plan",
           "kaczmarz_records", "smem_bytes", "kaczmarz_sweep_kernel",
           "kaczmarz_sweep_plain"]

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
DTYPES = tuple(_DTYPES)          # the value types the kernel takes
LAUNCHES = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
PLAIN_CALLS = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
MAX_RHS = 4                      # kMaxRhs
AHEAD = 8                        # kAhead: steps of b in flight
REC_RING = 2 * AHEAD + 2         # kRecRing: records s - 1 .. s + 2A
B_RING = AHEAD + 2               # kBRing: b of steps s .. s + A
MAX_SHARED = 232448              # kMaxShared: 227 KB a block on sm_90


def _key(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def kaczmarz_links(arr: np.ndarray, mask: np.ndarray, ell_idx: np.ndarray,
                   counts: np.ndarray) -> np.ndarray:
    """Kernel F's link table, (max_len, ndom * K) int32, on the host.

    Tap (d, k) of step i is column ell_idx[arr[i, d], k] of domain d's row;
    it is live where the domain is not padded (mask != 0) and k is below
    the row's stored count (`counts`, per row; ELL keeps a row's entries
    first and pads after them).  The live taps of a step that share a column
    form a chain in (d, k) order; its first tap owns the column.  Codes:
    c >= 0 owner, next tap c; -1 owner, chain ends; -2 not an owner, chain
    ends (or not live); c <= -3 not an owner, next tap -c - 3."""
    max_len, nd = arr.shape
    K = ell_idx.shape[1]
    taps = nd * K
    live = ((mask != 0)[:, :, None]
            & (np.arange(K)[None, None, :] < counts[arr][:, :, None]))
    step, tap = np.nonzero(live.reshape(max_len, taps))
    col = ell_idx[arr].reshape(max_len, taps)[step, tap]
    order = np.lexsort((tap, col, step))
    step, tap, col = step[order], tap[order], col[order]
    same = np.zeros(len(step), dtype=bool)       # same column as the one before
    same[1:] = (step[1:] == step[:-1]) & (col[1:] == col[:-1])
    has_next = np.zeros(len(step), dtype=bool)
    has_next[:-1] = same[1:]
    nxt = np.full(len(step), -1, dtype=np.int64)
    nxt[:-1] = np.where(has_next[:-1], tap[1:], -1)
    code = np.where(same, np.where(has_next, -nxt - 3, -2),
                    np.where(has_next, nxt, -1))
    link = np.full((max_len, taps), -2, dtype=np.int32)
    link[step, tap] = code
    return link


def _bytes16(t: torch.Tensor, L: int) -> torch.Tensor:
    """t's values as bytes, (L, nbytes) padded to a multiple of 16."""
    if t.is_complex():
        t = torch.view_as_real(t)
    by = t.contiguous().view(torch.uint8).reshape(L, -1)
    return torch.nn.functional.pad(by, (0, (-by.shape[-1]) % 16))


@dataclass(frozen=True, eq=False)
class KaczmarzPlan:
    """Kernel F's step streams.  `tab` (max_len, stride) int32: per step
    rows[nd] (every domain's row, -1 where padded) | slot[nd * kr] (the
    rows' taps: x's row, 0 where padded) | own[nd * kr * terms] (for each
    tap that owns its column's chain, the chain's terms domain << 8 | tap
    in order, the tap first; -1 none).  `pos` (max_len, nd * kr * (1 +
    terms) + nd) int64: where the values a step reads lie (the rows' taps,
    the own terms' coefficients, in ell_val's flat index; the rows in
    invd; -1 none)."""
    nd: int         # domains
    kr: int         # taps a row read (the longest live row)
    terms: int      # terms a chain (the longest)
    stride: int     # ints a chunk (a multiple of 4)
    tab: Any
    pos: Any

    def to(self, device) -> "KaczmarzPlan":
        t = lambda a: torch.as_tensor(a, device=device)
        return KaczmarzPlan(self.nd, self.kr, self.terms, self.stride,
                            t(self.tab), t(self.pos))


@dataclass(frozen=True, eq=False)
class SweepRecords:
    """Kernel F's records of one plan and one (ell_val, invd) pair: `rec`
    (max_len, rb) bytes, each the step's int chunk, then the values the
    plan's `pos` names (the rows' taps; the own terms' coefficients;
    invd), 16-byte aligned parts at ro_vals, ro_coef, ro_invd.  `srcs`:
    the plan, and the `Source`s of the ell_val and invd they were baked
    from."""
    rec: Any
    ro_vals: int
    ro_coef: int
    ro_invd: int
    rb: int
    srcs: tuple

    def of(self, plan: KaczmarzPlan, ell_val, invd) -> bool:
        """Whether these are the records of `plan` and these values."""
        p, v, d = self.srcs
        return p is plan and v.holds(ell_val) and d.holds(invd)


def _chains(link):
    """Every step's chains: (step, taps (chains, T) in chain order, -1
    padded) from the link table."""
    step, tap = np.nonzero(link >= -1)          # owners
    terms = [tap]
    nxt = link[step, tap].astype(np.int64)
    while (nxt >= 0).any():
        has = nxt >= 0
        terms.append(np.where(has, nxt, -1))
        c2 = link[step, np.maximum(nxt, 0)]
        nxt = np.where(has & (c2 <= -3), -c2.astype(np.int64) - 3, -1)
    return step, np.stack(terms, axis=1)


def kaczmarz_plan(arr: np.ndarray, mask: np.ndarray, ell_idx: np.ndarray,
                  link: np.ndarray) -> KaczmarzPlan:
    """Kernel F's step streams (host numpy) from the state's tables: the
    chains of the link table as update entries, the rows' taps up to the
    longest live row (the ELL stores a row's entries first)."""
    arr = np.asarray(arr)
    ell_idx = np.asarray(ell_idx)
    link = np.asarray(link)
    live = np.asarray(mask) != 0
    L, nd = arr.shape
    K = ell_idx.shape[1]
    if K > 256:
        raise ValueError(f"kernel F takes ELL rows of at most 256 taps, "
                         f"got {K}")
    step, taps = _chains(link)
    kr = int((taps[taps >= 0] % K).max()) + 1 if taps.size else 1
    T = taps.shape[1]
    term = np.where(taps >= 0, (taps // K) << 8 | (taps % K), -1)
    rows = np.where(live, arr, -1).astype(np.int32)
    nr = nd * kr
    S = -(-(nd + nr + nr * T) // 4) * 4
    tab = np.full((L, S), -1, dtype=np.int32)
    tab[:, :nd] = rows
    tab[:, nd:nd + nr] = np.where(live[:, :, None], ell_idx[arr, :kr],
                                  0).reshape(L, nr)
    pos = np.full((L, nr * (1 + T) + nd), -1, dtype=np.int64)
    r = rows.astype(np.int64)[:, :, None]
    pos[:, :nr] = np.where(r >= 0, r * K + np.arange(kr), -1).reshape(L, nr)
    pos[:, nr * (1 + T):] = rows
    at = (taps[:, 0] // K * kr + taps[:, 0] % K) * T   # the owner's entry
    for t in range(T):
        tm = term[:, t]
        tab[step, nd + nr + at + t] = tm
        pos[step, nr + at + t] = np.where(
            tm >= 0, rows[step, np.maximum(tm, 0) >> 8].astype(np.int64) * K
            + (tm & 255), -1)
    return KaczmarzPlan(nd, kr, T, S, tab, pos)


def kaczmarz_records(plan: KaczmarzPlan, ell_val: torch.Tensor,
                     invd: torch.Tensor) -> SweepRecords:
    """The plan's records with these values baked in (on the plan's
    device: built at setup, `KaczmarzRelax`, or once per ell_val by
    `kaczmarz_sweep_kernel`)."""
    L, nr, T = plan.tab.shape[0], plan.nd * plan.kr, plan.terms
    nv = nr * (1 + T)
    vp = plan.pos[:, :nv]
    vals = torch.where(vp >= 0, ell_val.reshape(-1)[vp.clamp(min=0)],
                       torch.zeros((), dtype=ell_val.dtype,
                                   device=ell_val.device))
    ip = plan.pos[:, nv:]
    iv = torch.where(ip >= 0, invd[ip.clamp(min=0)],
                     torch.zeros((), dtype=invd.dtype, device=invd.device))
    parts = [plan.tab.contiguous().view(torch.uint8).reshape(L, -1),
             _bytes16(vals[:, :nr], L), _bytes16(vals[:, nr:], L),
             _bytes16(iv, L)]
    offs = [int(o) for o in np.cumsum([p.shape[-1] for p in parts])]
    return SweepRecords(torch.cat(parts, dim=-1).contiguous(), *offs,
                        (plan, Source(ell_val), Source(invd)))


def smem_bytes(plan: KaczmarzPlan, m: int, item: int, real: int) -> int:
    """Shared memory of a launch: its rings (kaczmarz.cu `plan_smem`)."""
    a16 = lambda v: -(-v // 16) * 16
    nd, nr = plan.nd, plan.nd * plan.kr
    rb = (plan.stride * 4 + a16(nr * item) + a16(nr * plan.terms * item)
          + a16(nd * real))
    return (a16(8 * REC_RING) + a16(2 * nd * m * item) + REC_RING * rb
            + a16(B_RING * nd * m * item))


def kaczmarz_sweep_plain(x, b, arr, mask, invd, ell_idx, ell_val,
                         num_it: int):
    """num_it hybrid Kaczmarz sweeps in torch, step by step (mgtpu's
    row_step): per step, the rows' block residual from the x of before the
    step, then one `index_add` of conj(a) r at their columns.  x, b (n, m);
    returns the new x."""
    k = _key(x.dtype)
    PLAIN_CALLS[k] = PLAIN_CALLS.get(k, 0) + 1
    max_len, nd = arr.shape
    K = ell_idx.shape[1]
    m = x.shape[1]
    arr = arr.long()
    for _ in range(num_it):
        for i in range(max_len):
            rows = arr[i]
            ri = ell_idx[rows]
            rv = ell_val[rows]
            xg = x[ri.reshape(-1)].reshape(nd, K, m)
            ax = torch.einsum("dk,dkm->dm", rv, xg)
            inner = (b[rows] - ax) * (invd[rows] * mask[i])[:, None]
            contrib = rv.conj()[:, :, None] * inner[:, None, :]
            x = x.index_add(0, ri.reshape(-1), contrib.reshape(nd * K, m))
    return x


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("kaczmarz")
    fn = lib.mgt_kaczmarz
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return lib


_PLANS = PerTensor()           # plans of tables given without one
_RECORDS = PerTensor()         # records of values given without them


def _plan_of(arr, mask, ell_idx, link) -> KaczmarzPlan:
    """The plan of tables given without one, built once per link tensor."""
    return _PLANS.get(link, lambda: kaczmarz_plan(
        arr.cpu().numpy(), mask.cpu().numpy(), ell_idx.cpu().numpy(),
        link.cpu().numpy()).to(link.device))


def kaczmarz_sweep_kernel(x, b, arr, mask, invd, ell_idx, ell_val, link,
                          num_it: int, plan: KaczmarzPlan | None = None,
                          records: SweepRecords | None = None):
    """num_it hybrid Kaczmarz sweeps on x, b (n, m): kernel F on a CUDA
    tensor (one launch; x is not written, the result is a new tensor),
    `kaczmarz_sweep_plain` on a CPU one or in a type below float32.  arr
    (max_len, ndom), ell_idx (n, K) and link (max_len, ndom * K) int32;
    mask (max_len, ndom) and invd (n) of x's real type, ell_val (n, K) of
    x's type; `plan` the tables' `kaczmarz_plan` on x's device, `records`
    its `kaczmarz_records` of these ell_val and invd (each built once and
    kept if not given; records of other values raise)."""
    if x.device.type == "cpu" or (x.device.type == "cuda"
                                  and x.dtype not in _DTYPES
                                  and x.is_floating_point()):
        # the CPU, or a type the kernel does not take (a bfloat16 cycle)
        return kaczmarz_sweep_plain(x, b, arr, mask, invd, ell_idx, ell_val,
                                    num_it)
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError(f"no kernel for a {x.dtype} tensor on {x.device}")
    if x.ndim != 2 or tuple(b.shape) != tuple(x.shape):
        raise ValueError(f"x and b must be (n, m), got {tuple(x.shape)} "
                         f"and {tuple(b.shape)}")
    n, m = x.shape
    if m > MAX_RHS:
        raise ValueError(f"kernel F takes at most {MAX_RHS} right-hand "
                         f"sides, got {m}")
    max_len, nd = arr.shape
    K = ell_idx.shape[1]
    b = b.contiguous()
    real = x.dtype.to_real()
    want = {"arr": ((max_len, nd), torch.int32),
            "mask": ((max_len, nd), real), "invd": ((n,), real),
            "ell_idx": ((n, K), torch.int32), "ell_val": ((n, K), x.dtype),
            "link": ((max_len, nd * K), torch.int32), "b": ((n, m), x.dtype)}
    ops = {"arr": arr, "mask": mask, "invd": invd, "ell_idx": ell_idx,
           "ell_val": ell_val, "link": link, "b": b}
    for name, t in ops.items():
        shape, dt = want[name]
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if plan is None:
        plan = _plan_of(arr, mask, ell_idx, link)
    if (plan.tab.device != x.device or tuple(plan.tab.shape[:1]) != (max_len,)
            or plan.nd != nd or not plan.tab.is_contiguous()):
        raise ValueError("the plan is not this state's on this device")
    if records is None:
        records = _RECORDS.get(
            ell_val, lambda: kaczmarz_records(plan, ell_val, invd),
            valid=lambda r: r.of(plan, ell_val, invd))
    elif not records.of(plan, ell_val, invd):
        raise ValueError("the records were baked from another plan or other "
                         "values than ell_val and invd")
    need = smem_bytes(plan, m, x.element_size(), invd.element_size())
    if need > MAX_SHARED:
        raise ValueError(f"kernel F: its rings need {need} bytes of shared "
                         f"memory, more than {MAX_SHARED} ({nd} domains, m "
                         f"{m}, {x.dtype})")
    y = x.contiguous().clone()
    dims = (ctypes.c_int * 12)(max_len, nd, plan.kr, plan.terms,
                               plan.stride, m, n, int(num_it),
                               records.ro_vals, records.ro_coef,
                               records.ro_invd, records.rb)
    lib = _lib()
    rc = lib.mgt_kaczmarz(
        _DTYPES[x.dtype], ctypes.cast(dims, ctypes.c_void_p),
        records.rec.data_ptr(), b.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "kaczmarz")
    LAUNCHES[_key(x.dtype)] += 1
    return y
