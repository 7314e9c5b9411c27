"""Hybrid (domain-decomposed) row Kaczmarz smoother.

Counterpart of mgtpu/cycle/kaczmarz.py (the reference's parRelax.jl:8-79
and parRelax.h:7-43): the rows are split into lexicographic subdomains
(dd/indices.py); the domains are swept side by side, the rows of a domain
one after the other.  Damping is omega / ||a_row||^2, the update direction
the conjugated row.  Step i takes row i of every domain at once and sums
the adds of domains that meet at a column.

`kaczmarz_sweep` runs kernel F (ops/cuda/kaczmarz.py, one launch a call)
on the card and its plain step-by-step version on the CPU.  The state
carries the setup-time link table the kernel sums colliding adds by, so
that a recorded sweep is bitwise its eager run, the kernel's step streams
built from it (`kaczmarz_plan`), and on a card their records with the
state's values baked in.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from ..dd import indices as dd_indices
from ..models.mesh import RegularMesh
from ..ops.cuda import kaczmarz as kf
from ..ops.ell import ell_arrays_from_scipy

__all__ = ["KaczmarzRelax", "setup_hybrid_kaczmarz", "kaczmarz_sweep",
           "make_kaczmarz_precond"]


@dataclass(frozen=True, eq=False)
class KaczmarzRelax:
    """Kaczmarz smoother state: host numpy arrays at setup, tensors in a
    device hierarchy (`to`).  On a card it carries kernel F's records of
    its own values (`records`, baked when the state is made: by `to`, and
    anew for a copy of other values such as cast_hierarchy's)."""
    arr: Any        # (max_len, ndomains) int32 row ids (0 where padded)
    mask: Any       # (max_len, ndomains) of {0, 1} (real type on a device)
    invd: Any       # (n,) omega / ||a_row||^2 (real)
    ell_idx: Any    # (n, K) int32 ELL columns of A
    ell_val: Any    # (n, K) ELL values of A
    link: Any       # (max_len, ndomains * K) int32: kernel F's link table
    num_domains: tuple
    num_it: int
    omega: float
    plan: Any = None    # kf.KaczmarzPlan: kernel F's step streams
    records: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        v = self.ell_val
        if (isinstance(v, torch.Tensor) and v.device.type == "cuda"
                and v.dtype in kf.DTYPES and self.plan is not None):
            object.__setattr__(self, "records", kf.kaczmarz_records(
                self.plan, v, self.invd))

    def to(self, dtype, device) -> "KaczmarzRelax":
        """The tables as tensors on `device`, the values in `dtype`, the
        mask and invd in its real type (kernel F's operands), and the
        plan (built here from the tables if the state has none)."""
        t = lambda a: torch.as_tensor(np.asarray(a), device=device)
        r = lambda a: t(a).real.to(dtype.to_real()).contiguous()
        plan = (self.plan if self.plan is not None else kf.kaczmarz_plan(
            self.arr, self.mask, self.ell_idx, self.link)).to(device)
        return KaczmarzRelax(t(self.arr), r(self.mask), r(self.invd),
                             t(self.ell_idx), t(self.ell_val).to(dtype),
                             t(self.link), self.num_domains, self.num_it,
                             self.omega, plan)


def setup_hybrid_kaczmarz(A: sp.spmatrix, mesh: RegularMesh, num_domains,
                          index_fn, omega: float, num_it: int,
                          dtype=None) -> KaczmarzRelax:
    """The Kaczmarz smoother's state on the host (reference
    parRelax.jl:39-47); `index_fn` is one of dd/indices.py's per-layout
    index functions (nodal, cell-centered, faces with or without
    pressure)."""
    A = A.tocsr()
    dt = dtype if dtype is not None else A.dtype
    row_norms = np.asarray(A.multiply(A.conj()).sum(axis=1)).ravel().real
    invd = (omega / np.maximum(row_norms, 1e-300)).astype(
        np.zeros((), dt).real.dtype)
    arr = dd_indices.indices_of_cells_array(
        mesh, np.zeros(len(num_domains), dtype=np.int64),
        np.asarray(num_domains), index_fn)
    mask = (arr >= 0).astype(dt)
    arr = np.where(arr >= 0, arr, 0).astype(np.int32)
    idx, val, _ = ell_arrays_from_scipy(A, dtype=dt)
    A.sum_duplicates()
    link = kf.kaczmarz_links(arr, mask, idx, np.diff(A.indptr))
    return KaczmarzRelax(arr, mask, invd, idx, val, link,
                         tuple(int(d) for d in num_domains), int(num_it),
                         float(omega), kf.kaczmarz_plan(arr, mask, idx, link))


def kaczmarz_sweep(x: torch.Tensor, b: torch.Tensor, kz: KaczmarzRelax,
                   num_it: int | None = None) -> torch.Tensor:
    """num_it hybrid Kaczmarz sweeps over all domains; x, b (n, m)."""
    num_it = kz.num_it if num_it is None else num_it
    return kf.kaczmarz_sweep_kernel(x, b, kz.arr, kz.mask, kz.invd,
                                    kz.ell_idx, kz.ell_val, kz.link, num_it,
                                    plan=kz.plan, records=kz.records)


def make_kaczmarz_precond(kz: KaczmarzRelax):
    """Preconditioner closure: r -> num_it Kaczmarz sweeps on A x = r from
    zero (reference getHybridKaczmarzPrecond, parRelax.jl:49-59); r is
    (n,) or (n, m)."""
    def prec(r):
        squeeze = r.ndim == 1
        rr = r[:, None] if squeeze else r
        x = kaczmarz_sweep(torch.zeros_like(rr), rr, kz)
        return x[:, 0] if squeeze else x
    return prec
