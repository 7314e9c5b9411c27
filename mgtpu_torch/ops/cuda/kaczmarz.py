"""Kernel F: the hybrid Kaczmarz sweep, and its plain version.

CUDA source: mgtpu_torch/csrc/kaczmarz.cu (built by ops/cuda/_build.py).
It runs on the card what mgtpu runs there as a `lax.fori_loop` over the
rows of the domains (mgtpu/cycle/kaczmarz.py:70 kaczmarz_sweep, its
row_step at :78-91; no Pallas kernel): step i takes row arr[i, d] of every
domain d, computes r = (b - a.x) * invd * mask from the x of before the
step and adds conj(a) r at the row's columns, collisions across domains
summed — `num_it` sweeps in one launch, one thread block walking the
steps; in float32, float64, complex64 or complex128, with the row norms
(invd) and the mask in the real type.  The plain version makes about ten
torch calls a step.

`kaczmarz_sweep_kernel(x, b, arr, mask, invd, ell_idx, ell_val, link,
num_it)` launches the kernel for a CUDA tensor (or raises on anything it
does not take) and takes the plain version, `kaczmarz_sweep_plain`
(mgtpu's row_step in torch), only for a tensor on the CPU or of a type
the kernel does not take (bfloat16).  `link` is
`kaczmarz_links`'s setup-time table: the kernel sums the adds of one
column in a fixed order instead of racing atomics.  `LAUNCHES` counts
kernel launches, `PLAIN_CALLS` calls of the plain version, per value type
of x.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "MAX_RHS", "kaczmarz_links",
           "kaczmarz_sweep_kernel", "kaczmarz_sweep_plain", "threads_for"]

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
LAUNCHES = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
PLAIN_CALLS = {"float32": 0, "float64": 0, "complex64": 0, "complex128": 0}
MAX_RHS = 4                      # kMaxRhs
MAX_THREADS = 1024               # kMaxThreads


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


def threads_for(nd: int, K: int, m: int) -> int:
    """The kernel's block: one thread per (tap, right-hand side) pair of a
    step, a multiple of 32, at most 1024 (the threads loop beyond)."""
    return int(min(MAX_THREADS, max(32, -(-nd * K * m // 32) * 32)))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("kaczmarz")
    fn = lib.mgt_kaczmarz
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    return lib


def kaczmarz_sweep_kernel(x, b, arr, mask, invd, ell_idx, ell_val, link,
                          num_it: int):
    """num_it hybrid Kaczmarz sweeps on x, b (n, m): kernel F on a CUDA
    tensor (one launch; x is not written, the result is a new tensor),
    `kaczmarz_sweep_plain` on a CPU one or in a type below float32.  arr
    (max_len, ndom), ell_idx
    (n, K) and link (max_len, ndom * K) int32; mask (max_len, ndom) and
    invd (n) of x's real type, ell_val (n, K) of x's type."""
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
    y = x.contiguous().clone()
    lib = _lib()
    rc = lib.mgt_kaczmarz(
        _DTYPES[x.dtype], max_len, nd, K, m, n, int(num_it),
        threads_for(nd, K, m), arr.data_ptr(), mask.data_ptr(),
        invd.data_ptr(), ell_idx.data_ptr(), ell_val.data_ptr(),
        link.data_ptr(), b.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "kaczmarz")
    LAUNCHES[_key(x.dtype)] += 1
    return y
