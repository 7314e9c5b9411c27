"""Cross-grid stencils: structured operators between different node grids.

Counterpart of mgtpu/ops/cross_stencil.py.  Face-staggered systems
(elasticity, Stokes) couple fields living on DIFFERENT grids — face-j
velocity grids and the cell-centered pressure grid.  Each block A[ci, cj]
of such an operator is still a stencil: the entry at output node r (on
ci's grid) reads input nodes r + d (on cj's grid) for a small static set of
per-axis shifts d.  Stored grid-form, the block SpMV is the
shift-multiply-accumulate of the square `GridStencil`, with different
input and output extents: kernel D's cross apply on a CUDA tensor
(ops/cuda/stencil.py::cross_apply), `cross_stencil_matvec` (the plain
version) on a CPU one.

Decomposition is done on COORDINATES (row/col unraveled per axis), not flat
offsets, so there is no wrap-around aliasing to guard against.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["CrossGridStencil", "cross_stencil_from_csr",
           "cross_stencil_matvec"]


@dataclass(frozen=True, eq=False)
class CrossGridStencil:
    """coeff[k, *r] = A[flat(r), flat(r + offsets[k])] on the output grid.

    Grid axis order: slowest mesh dim first (grid view of a dim-0-fastest
    flat vector).  Entries that would read outside the input grid do not
    exist in A, so their coefficients are zero and the zero-filled reads
    are exact.  `coeff` is a numpy array on the host, a tensor on the
    device."""
    coeff: object                          # (ndiags, *out_grid)
    offsets: tuple[tuple[int, ...], ...]   # per diag, per grid axis
    out_grid: tuple[int, ...]
    in_grid: tuple[int, ...]

    @property
    def dtype(self):
        return self.coeff.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (int(np.prod(self.out_grid)), int(np.prod(self.in_grid)))

    @property
    def nnz(self) -> int:
        return int(np.prod(self.coeff.shape))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., *in_grid) -> (..., *out_grid): kernel D's cross apply
        on a CUDA tensor, its plain version on a CPU one."""
        from .cuda.stencil import cross_apply
        return cross_apply(self.coeff, self.offsets, self.in_grid, x)

    def to(self, device) -> "CrossGridStencil":
        return CrossGridStencil(torch.as_tensor(self.coeff, device=device),
                                self.offsets, self.out_grid, self.in_grid)

    def to_scipy(self) -> sp.csr_matrix:
        no, ni = self.shape
        g = len(self.out_grid)
        strides_in = np.ones(g, dtype=np.int64)
        for a in range(g - 2, -1, -1):
            strides_in[a] = strides_in[a + 1] * self.in_grid[a + 1]
        c = self.coeff
        c = c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else c
        coeff = np.asarray(c).reshape(len(self.offsets), no)
        rows, cols, vals = [], [], []
        idx = np.arange(no)
        coords = np.stack(np.unravel_index(idx, self.out_grid), axis=1)
        for k, off in enumerate(self.offsets):
            tgt = coords + np.asarray(off)
            ok = np.all((tgt >= 0) & (tgt < np.asarray(self.in_grid)), axis=1)
            rows.append(idx[ok])
            cols.append((tgt[ok] * strides_in).sum(axis=1))
            vals.append(coeff[k, ok])
        A = sp.coo_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(no, ni))
        A.sum_duplicates()
        return A.tocsr()


def cross_stencil_from_csr(A: sp.spmatrix, out_nodes, in_nodes, dtype=None,
                           max_shift: int = 2) -> CrossGridStencil:
    """The host (numpy) cross-grid stencil of a block operator.

    out_nodes / in_nodes: per-mesh-dim extents, dim 0 fastest.  Raises
    ValueError when an entry's per-axis shift exceeds max_shift.  The taps
    are the distinct per-axis shifts in lexicographic order (mgtpu's
    ``np.unique(axis=0)``, here on one integer key per shift)."""
    out_nodes = [int(v) for v in np.asarray(out_nodes).ravel()]
    in_nodes = [int(v) for v in np.asarray(in_nodes).ravel()]
    no, ni = int(np.prod(out_nodes)), int(np.prod(in_nodes))
    if A.shape != (no, ni):
        raise ValueError("block size does not match the node grids")
    out_grid = tuple(reversed(out_nodes))
    in_grid = tuple(reversed(in_nodes))
    g = len(out_grid)

    Ac = A.tocoo()
    rc = np.unravel_index(Ac.row, out_grid)
    cc = np.unravel_index(Ac.col, in_grid)
    d = [c.astype(np.int64) - r for c, r in zip(cc, rc)]
    if Ac.nnz and max(int(np.abs(da).max()) for da in d) > max_shift:
        raise ValueError("block entry shift exceeds the stencil radius")
    base = 2 * max_shift + 1
    key = np.zeros(Ac.nnz, dtype=np.int64)
    for da in d:                           # slowest axis most significant
        key = key * base + (da + max_shift)
    keys, pos = np.unique(key, return_inverse=True)
    offs = []
    for kv in keys:
        off = []
        for _ in range(g):
            off.append(int(kv % base) - max_shift)
            kv //= base
        offs.append(tuple(reversed(off)))
    dt = dtype if dtype is not None else Ac.dtype
    coeff = np.zeros((max(len(offs), 1), no), dtype=dt)
    # (pos, row) pairs are unique for a deduplicated sparse matrix
    coeff[pos, Ac.row] = Ac.data.astype(dt, copy=False)
    offsets = tuple(offs) if offs else ((0,) * g,)
    return CrossGridStencil(coeff.reshape((-1,) + out_grid), offsets,
                            out_grid, in_grid)


def cross_stencil_matvec(coeff: torch.Tensor, offsets, in_grid,
                         x: torch.Tensor) -> torch.Tensor:
    """y = A x; x (..., *in_grid) -> (..., *out_grid): x zero-padded, then
    one window per tap times its coefficients, summed in tap order."""
    g = coeff.ndim - 1
    out_grid = tuple(coeff.shape[1:])
    lead = tuple(x.shape[:x.ndim - g])
    lo = [max(0, -min(off[a] for off in offsets)) for a in range(g)]
    hi = [max(0, max(off[a] + out_grid[a] - in_grid[a] for off in offsets))
          for a in range(g)]
    xp = x.new_zeros(lead + tuple(in_grid[a] + lo[a] + hi[a]
                                  for a in range(g)))
    xp[(Ellipsis,) + tuple(slice(lo[a], lo[a] + in_grid[a])
                           for a in range(g))] = x
    y = None
    for k, off in enumerate(offsets):
        win = xp[(Ellipsis,) + tuple(
            slice(lo[a] + off[a], lo[a] + off[a] + out_grid[a])
            for a in range(g))]
        t = coeff[k] * win
        y = t if y is None else y + t
    return y
