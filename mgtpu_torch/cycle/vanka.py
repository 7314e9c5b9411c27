"""Cell-wise Vanka block smoothers of the flat engine (torch).

Counterpart of mgtpu/cycle/vanka.py (the reference's Vanka tier,
src/Multigrid/Vanka.jl:294-496): cell-wise block relaxation for staggered
face(+pressure) systems, swept by 2^dim cell colors so that the updates of
one color touch disjoint variables.  All cells of one color are one
batched contraction: block residuals from the pre-gathered ELL rows (one
gather of x), times the precomputed block inverses, added back.  Vectors
are flat columns (n, m).  Variants (reference Vanka.jl:13-17):

 * "vanka"          — colored sweep (scalar damping diagonalises the
                      velocity block before inversion, Vanka.jl:333-334);
 * "econ-vanka"     — velocity diagonal scaled by 1/w;
 * "vanka-lex"      — lexicographic sequential sweep: kernel E
                      (ops/cuda/vanka.py), one launch a call, on the card
                      (its cell records packed with the state); its plain
                      per-cell loop on the CPU;
 * "vanka-add"      — additive, boundary-weighted, overlapping updates;
 * "kaczmarz-vanka" — cell-wise block Kaczmarz: t = inv((A A^H)_cc) r_c,
                      x += A_c^H t (reference Vanka.h:185-259).

Adds that collide (the overlapping faces of vanka-add, the shared columns
of kaczmarz-vanka) go through a setup-time scatter table: column j of the
table adds every variable's j-th contribution, so the order is fixed and no
atomics run (a recorded sweep is bitwise its eager run).  The colored
sweeps' adds never collide (padding adds exact zeros) and use `index_add`.

Block inverses are stored in single precision like the reference
(`toSingle`, Vanka.jl:34-42, 296) and promoted on use.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..ops.cuda import vanka as vk

__all__ = ["VankaRelax", "vanka_sweep"]


@dataclass(frozen=True, eq=False)
class VankaRelax:
    """Colored, padded Vanka tables; host numpy arrays at setup, tensors
    in a device hierarchy (`to`).  A vanka-lex state on a card carries
    kernel E's cell records of its own tables (`cells`, packed when the
    state is made: by `to`, and anew for a copy of other values such as
    cast_hierarchy's)."""
    idx: Any        # (ncolors, L, bs) int32 variable ids per cell (0-pad)
    dinv: Any       # (ncolors, L, bs, bs) block inverses (0 on padding)
    rows_idx: Any   # (ncolors, L, bs, K) int32 ELL column ids of the rows
    rows_val: Any   # (ncolors, L, bs, K) ELL values of the block rows
    variant: str
    scatter: tuple | None = None   # per color: (n, c) int32 scatter table
    cells: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        v = self.rows_val
        if (self.variant == "vanka-lex" and isinstance(v, torch.Tensor)
                and v.device.type == "cuda" and v.dtype in vk.DTYPES):
            object.__setattr__(self, "cells", vk.pack_cells(
                self.idx[0], self.dinv[0], self.rows_idx[0], v[0]))

    @property
    def ncolors(self) -> int:
        return self.idx.shape[0]

    def to(self, dtype, device) -> "VankaRelax":
        """The tables as tensors on `device`, the row values in `dtype`."""
        t = lambda a: torch.tensor(np.asarray(a), device=device)
        sc = (None if self.scatter is None
              else tuple(t(s) for s in self.scatter))
        return VankaRelax(t(self.idx), t(self.dinv), t(self.rows_idx),
                          t(self.rows_val).to(dtype), self.variant, sc)


def _block_residual(x, b, idx_c, rows_idx_c, rows_val_c):
    """r_cell = b[idx] - A[idx, :] x for all cells of one color, batched.
    x: (n, m); returns (L, bs, m)."""
    L, bs, K = rows_idx_c.shape
    m = x.shape[1]
    xg = x[rows_idx_c.reshape(-1)].reshape(L, bs, K, m)
    ax = torch.einsum("lbk,lbkm->lbm", rows_val_c, xg)
    return b[idx_c.reshape(-1)].reshape(L, bs, m) - ax


def _block_apply(dinv, r):
    """dinv (L, bs, bs) times r (L, bs, m) per cell, as a broadcast product
    and a sum (an einsum runs a batched gemm of tiny blocks)."""
    return (dinv.unsqueeze(-1) * r.unsqueeze(1)).sum(dim=2)


def _scatter_add(x, contrib, table):
    """x plus the contributions (flat (P, m)) that `table` routes to each
    variable, added column by column (a fixed order)."""
    ext = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))])
    for j in range(table.shape[1]):
        x = x + ext[table[:, j]]
    return x


def vanka_sweep(x, b, vr: VankaRelax, num_it: int):
    """num_it Vanka sweeps. x, b are (n, m)."""
    if vr.variant in ("vanka", "econ-vanka"):
        return _colored_sweep(x, b, vr, num_it)
    if vr.variant == "vanka-add":
        return _additive_sweep(x, b, vr, num_it)
    if vr.variant == "vanka-lex":
        return vk.lex_sweep(x, b, vr.idx[0], vr.dinv[0], vr.rows_idx[0],
                            vr.rows_val[0], num_it, cells=vr.cells)
    if vr.variant == "kaczmarz-vanka":
        return _kaczmarz_cell_sweep(x, b, vr, num_it)
    raise ValueError(f"unknown Vanka variant {vr.variant}")


def _colored_sweep(x, b, vr, num_it):
    m = x.shape[1]
    for _ in range(num_it):
        for c in range(vr.ncolors):
            r = _block_residual(x, b, vr.idx[c], vr.rows_idx[c],
                                vr.rows_val[c])
            u = _block_apply(vr.dinv[c].to(x.dtype), r)
            x = x.index_add(0, vr.idx[c].reshape(-1), u.reshape(-1, m))
    return x


def _additive_sweep(x, b, vr, num_it):
    # one group holding ALL cells; overlapping face updates accumulate (the
    # additive variant weights interior faces by 1/2 at setup, reference
    # Vanka.jl:339-353).  mgtpu computes every sweep's residual from the
    # entry iterate; so does this port.
    y = x
    m = x.shape[1]
    for _ in range(num_it):
        r = _block_residual(y, b, vr.idx[0], vr.rows_idx[0], vr.rows_val[0])
        u = _block_apply(vr.dinv[0].to(x.dtype), r)
        x = _scatter_add(x, u.reshape(-1, m), vr.scatter[0])
    return x


def _kaczmarz_cell_sweep(x, b, vr, num_it):
    # block Kaczmarz: the correction lives in row space, x += A_c^H (D r_c)
    m = x.shape[1]
    for _ in range(num_it):
        for c in range(vr.ncolors):
            r = _block_residual(x, b, vr.idx[c], vr.rows_idx[c],
                                vr.rows_val[c])
            t = _block_apply(vr.dinv[c].to(x.dtype), r)
            contrib = torch.einsum("lbk,lbm->lbkm", vr.rows_val[c].conj(), t)
            x = _scatter_add(x, contrib.reshape(-1, m), vr.scatter[c])
    return x
