"""Grid-form stencil operators on torch tensors.

Counterpart of mgtpu/ops/grid_stencil.py.  Operators from tensor-product
discretizations on regular meshes (and all their full-weighting Galerkin
coarsenings) are stencils whose offsets decompose per mesh axis.  Stored in
grid form — ``coeff[k, ..., j, i] = A[row(j,i), row(j,i) + off_k]`` — the
SpMV becomes shift-multiply-accumulate along the grid axes.

Grid axis order: the flat vector has mesh dim 0 fastest, so the grid view is
``x.reshape(*reversed(node_counts))`` — grid axis -1 is mesh dim 0.  Batched
right-hand sides lead: fields are (m, *grid), contiguous in torch.

Host analysis (CSR extraction, structured RAP, constant-interior
compression, stride-2 transfer extraction) runs in numpy; the results move
to the device once.  A 3D radius-1 float32 `ConstGridStencil` applies
through the hand-written CUDA kernel A (ops/cuda/const3d.py); a float32 or
float64 `GridStencil` of any radius, and both applies of a
`Stride2Transfer`, through kernel D (ops/cuda/stencil.py); every other
stencil applies through the plain torch versions here.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..config import torch_dtype

__all__ = [
    "GridStencil", "ConstGridStencil", "flat_to_grid", "grid_to_flat",
    "make_grid_stencil", "grid_stencil_from_csr", "grid_stencil_matvec",
    "structured_fw_rap", "compress_grid_stencil", "const_grid_stencil_matvec",
    "Stride2Transfer", "pack_stride2", "stride2_transfer_from_scipy",
]


def _np(a) -> np.ndarray:
    """Host numpy view of a numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _is_flat(x: torch.Tensor, grid) -> bool:
    g = len(grid)
    return x.ndim <= 2 and (g != x.ndim or tuple(x.shape) != tuple(grid))


@dataclass(frozen=True, eq=False)
class GridStencil:
    """Variable-coefficient stencil on a node grid.

    coeff:   (ndiags, *grid) — coeff[k] holds A[row, row+off_k] per node
             (zero where the entry does not exist).  A numpy array while
             setup analyses it on the host, a tensor once on the device.
    offsets: per-diagonal tuple of per-grid-axis shifts (slowest axis first).
    grid:    node grid shape (slowest mesh dim first).
    """
    coeff: object
    offsets: tuple[tuple[int, ...], ...]
    grid: tuple[int, ...]

    @property
    def dtype(self):
        return self.coeff.dtype

    def to(self, device) -> "GridStencil":
        return GridStencil(torch.as_tensor(self.coeff, device=device),
                           self.offsets, self.grid)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x on grid fields (m, *grid) or flat (n,) / (n, m).

        A float32 or float64 x goes through kernel D's wrapper
        (ops/cuda/stencil.py), which raises on a CUDA x whose dtype is not
        the coefficients' or for more taps than the kernel takes; any other
        type through the counted plain `grid_apply_plain`."""
        if _is_flat(x, self.grid):
            squeeze = x.ndim == 1
            x2 = x[:, None] if squeeze else x
            y = grid_to_flat(self.matvec(flat_to_grid(x2, self.grid)))
            return y[:, 0] if squeeze else y
        from .cuda.stencil import (grid_apply, grid_apply_plain,
                                   supports_stencil)
        if supports_stencil(self.offsets, self.grid, x.dtype):
            return grid_apply(self.coeff, self.offsets, x)
        return grid_apply_plain(self.coeff, self.offsets, x)

    def to_scipy(self) -> sp.csr_matrix:
        """Stencil -> CSR via scipy's DIA container (one linear diagonal per
        offset; explicit zeros are dropped by the conversion)."""
        n = int(np.prod(self.grid))
        g = len(self.grid)
        strides = [int(np.prod(self.grid[a + 1:])) for a in range(g)]
        coeff = _np(self.coeff)
        lin = [int(sum(d * s for d, s in zip(off, strides)))
               for off in self.offsets]
        order = np.argsort(lin)
        data = np.zeros((len(lin), n), dtype=coeff.dtype)
        for j, k in enumerate(order):
            off = self.offsets[k]
            # keep only the in-box band (a boundary-crossing linear index
            # would alias the wrapped grid row in DIA form)
            sl = tuple(slice(max(0, -d), self.grid[a] - max(0, d))
                       for a, d in enumerate(off))
            ck = np.zeros(self.grid, dtype=coeff.dtype)
            ck[sl] = coeff[(k,) + sl]
            flat = ck.reshape(-1)
            o = lin[k]
            if o >= 0:
                data[j, o:] = flat[:n - o] if o else flat
            else:
                data[j, :n + o] = flat[-o:]
        A = sp.dia_matrix((data, np.asarray(lin)[order]), shape=(n, n))
        return A.tocsr()


def flat_to_grid(x2: torch.Tensor, grid) -> torch.Tensor:
    """(n, m) flat columns -> (m, *grid) contiguous batched grid fields."""
    return x2.T.reshape((x2.shape[1],) + tuple(grid)).contiguous()


def grid_to_flat(xg: torch.Tensor) -> torch.Tensor:
    """(m, *grid) -> (n, m)."""
    return xg.reshape(xg.shape[0], -1).T


def make_grid_stencil(A: sp.spmatrix, node_counts, dtype=None,
                      max_shift: int = 2, width: int = 2, device="cpu"):
    """Extract + constant-interior-compress in one host pass.

    Returns a ConstGridStencil on `device` when the coefficients are
    constant away from the boundary band, else a GridStencil."""
    gs = grid_stencil_from_csr(A, node_counts, dtype=dtype,
                               max_shift=max_shift)
    cs = compress_grid_stencil(gs, width=width, device=device)
    if cs is not None:
        return cs
    return gs.to(device)


def grid_stencil_from_csr(A: sp.spmatrix, node_counts, dtype=None,
                          max_shift: int = 2) -> GridStencil:
    """Host (numpy) grid-form stencil of A on a node grid.

    node_counts: per-mesh-dim node counts, dim 0 fastest.  Raises ValueError
    when A is not a tensor-product stencil with per-axis shifts within
    ``max_shift``.
    """
    node_counts = [int(v) for v in np.asarray(node_counts).ravel()]
    n = int(np.prod(node_counts))
    if A.shape != (n, n):
        raise ValueError("operator size does not match the node grid")
    dim = len(node_counts)
    strides = np.concatenate([[1], np.cumprod(node_counts[:-1])]).astype(np.int64)

    # map every representable offset to its per-axis decomposition; prefer the
    # smallest shift radius that covers the matrix (radius 1 stays unambiguous
    # down to 3-node grids, where radius 2 aliases)
    Ac = A.tocoo()
    if Ac.col.dtype == Ac.row.dtype and n <= np.iinfo(Ac.col.dtype).max:
        off_all = Ac.col - Ac.row
    else:
        off_all = Ac.col.astype(np.int64) - Ac.row.astype(np.int64)
    offs = np.unique(off_all)

    decomp: dict[int, tuple[int, ...]] = {}
    last_err = None
    for radius in range(1, max_shift + 1):
        cand: dict[int, tuple[int, ...]] = {}
        ambiguous = False
        for combo in itertools.product(range(-radius, radius + 1), repeat=dim):
            off = int(sum(c * s for c, s in zip(combo, strides)))
            if off in cand:
                ambiguous = True
                break
            # grid axis order is reversed (slowest mesh dim first)
            cand[off] = tuple(reversed(combo))
        if ambiguous:
            last_err = "ambiguous stencil decomposition (grid too small)"
            break
        decomp = cand
        if all(int(o) in decomp for o in offs):
            break
        last_err = "matrix offsets exceed the stencil shift radius"
    if not decomp:
        raise ValueError(last_err)
    offsets = []
    for off in offs:
        d = decomp.get(int(off))
        if d is None:
            raise ValueError(f"matrix offset {off} is not a grid stencil shift")
        offsets.append(d)

    dt = dtype if dtype is not None else Ac.dtype
    coeff = np.zeros((len(offs), n), dtype=dt)
    pos = np.searchsorted(offs, off_all)
    # (pos, row) pairs are unique for a deduplicated sparse matrix
    coeff[pos, Ac.row] = Ac.data.astype(dt, copy=False)
    grid = tuple(reversed(node_counts))
    # entries that would shift across a grid boundary cannot exist in a true
    # grid stencil; verify so wrap-around never aliases silently
    coeff = coeff.reshape((len(offs),) + grid)
    for k, off in enumerate(offsets):
        for a, da in enumerate(off):
            if da == 0:
                continue
            sl = [slice(None)] * len(grid)
            sl[a] = slice(grid[a] - da, None) if da > 0 else slice(0, -da)
            if np.any(coeff[(k,) + tuple(sl)]):
                raise ValueError("stencil entry crosses the grid boundary")
    return GridStencil(coeff, tuple(offsets), grid)


def _shift(x: torch.Tensor, axis: int, d: int, size: int) -> torch.Tensor:
    """y[..., i, ...] = x[..., i + d, ...] with zero fill, along `axis`."""
    if d == 0:
        return x
    zshape = list(x.shape)
    zshape[axis] = min(abs(d), size)
    z = x.new_zeros(zshape)
    if abs(d) >= size:
        return z
    if d > 0:
        return torch.cat([x.narrow(axis, d, size - d), z], dim=axis)
    return torch.cat([z, x.narrow(axis, 0, size + d)], dim=axis)


def grid_stencil_matvec(coeff: torch.Tensor, offsets, x: torch.Tensor):
    """y = A x for grid fields x of shape (..., *grid)."""
    g = coeff.ndim - 1
    grid = coeff.shape[1:]
    y = None
    for k, off in enumerate(offsets):
        xs = x
        for a, da in enumerate(off):
            xs = _shift(xs, xs.ndim - g + a, da, grid[a])
        t = coeff[k] * xs
        y = t if y is None else y + t
    return y


def structured_fw_rap(gs: GridStencil, axes=None) -> GridStencil:
    """Galerkin RAP under separable full-weighting transfers on odd grids,
    computed axis-by-axis on the host stencil coefficient arrays.

    A_c = R A P with P = kron of 1D [0.5, 1, 0.5] interpolations and
    R = 0.5^dim P^T factorises per axis: coarsening one axis maps offset s
    to t with
      Ac_t[.., I, ..] += 0.5 * w(u) * w(v) * A_s[.., 2I+u, ..],
    v = u + s - 2t, u, v in {-1,0,1}.  Boundary truncation of the 1D
    factors is reproduced exactly by zero padding.  Host-side, numpy in/out.
    """
    coeff = _np(gs.coeff)
    offsets = [tuple(o) for o in gs.offsets]
    if any(abs(d) > 1 for o in offsets for d in o):
        raise ValueError("structured RAP needs a +-1 stencil")
    grid = list(gs.grid)
    W = {-1: 0.5, 0: 1.0, 1: 0.5}
    for a in (range(len(grid)) if axes is None else axes):
        F_ = grid[a]
        if (F_ - 1) % 2:
            raise ValueError("structured RAP needs odd extents per axis")
        C = (F_ - 1) // 2 + 1
        pad = [(0, 0)] * coeff.ndim
        pad[1 + a] = (1, 1)
        cp = np.pad(coeff, pad)
        out: dict = {}
        for k, off in enumerate(offsets):
            s = off[a]
            ck = cp[k]
            for u in (-1, 0, 1):
                for v in (-1, 0, 1):
                    if (u + s - v) % 2:
                        continue
                    t = (u + s - v) // 2
                    if abs(t) > 1:
                        continue
                    sl = [slice(None)] * ck.ndim
                    sl[a] = slice(u + 1, u + 2 * C, 2)
                    contrib = (0.5 * W[u] * W[v]) * ck[tuple(sl)]
                    noff = off[:a] + (t,) + off[a + 1:]
                    if noff in out:
                        out[noff] += contrib
                    else:
                        out[noff] = contrib
        offsets = sorted(out.keys())
        grid[a] = C
        coeff = np.stack([out[o] for o in offsets], axis=0)
    return GridStencil(coeff, tuple(offsets), tuple(grid))


# ---------------------------------------------------------------------------
# stride-2 grid transfers (matrix-dependent prolongators: smoothed
# aggregation with block-2^dim aggregates on a grid)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Stride2Transfer:
    """Prolongation whose column of fine node f is the coarse node c with
    f = 2c + off for a small static set of per-axis offsets (mgtpu's
    ``coeff[k, *f] = P[flat(f), flat((f - offsets[k]) / 2)]``), kept in the
    two packed forms that kernel D applies (`pack_stride2`):

    prolong:  y[f] = sum_t pcoeff[t, f] xc[(f - d) / 2] over the taps d of
              f's parity class: an entry P[f, c] has f - 2c = d, so d has
              f's parity on every axis, and a class keeps only its own taps
              (`classes`, in tap order; `ptab` the same table on the
              device with each tap's offset in the coarse box, padded with
              an offset that reads nothing);
    restrict: rc[c] = sum_k rcoeff[k, c] r[2c + offsets[k]] = P^T r (the
              SA convention R = P', reference SA-AMG.jl:49), with
              rcoeff[k, c] = coeff[k, 2c + offsets[k]] (zero outside).

    Neither reads the stencil form's zeros: no upsampled field, no outputs
    on odd fine nodes.  Both apply through kernel D on a CUDA tensor (its
    plain strided versions on a CPU one), one call each."""
    pcoeff: torch.Tensor                   # (T, *fine_grid)
    ptab: torch.Tensor                     # (T, 8, 4) int32
    classes: tuple                         # 8 tuples of per-axis offsets
    rcoeff: torch.Tensor                   # (ndiags, *coarse_grid)
    offsets: tuple[tuple[int, ...], ...]
    fine_grid: tuple[int, ...]
    coarse_grid: tuple[int, ...]

    @property
    def dtype(self):
        return self.pcoeff.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (int(np.prod(self.fine_grid)), int(np.prod(self.coarse_grid)))

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        """xc: (..., *coarse_grid) -> (..., *fine_grid)."""
        from .cuda.stencil import stride2_prolong
        return stride2_prolong(self, xc)

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """P^T r: (..., *fine_grid) -> (..., *coarse_grid)."""
        from .cuda.stencil import stride2_restrict
        return stride2_restrict(self, r)


def _shift_np(c: np.ndarray, off) -> np.ndarray:
    """out[f] = c[f + off] with zero fill, over every axis of c."""
    out = np.zeros_like(c)
    src = tuple(slice(max(0, d), n - max(0, -d)) for n, d in zip(c.shape, off))
    dst = tuple(slice(max(0, -d), n - max(0, d)) for n, d in zip(c.shape, off))
    out[dst] = c[src]
    return out


# a class table's padding: f - d lands past every axis of the coarse box,
# and its linear offset is INT_MIN
_NO_TAP = -(1 << 30)
_NO_LIN = -(1 << 31)


def pack_stride2(coeff, offsets, fine_grid, coarse_grid,
                 device="cpu") -> Stride2Transfer:
    """A Stride2Transfer on `device` from the stencil form ``coeff[k, *f] =
    P[f, (f - offsets[k]) / 2]`` (ndiags, *fine_grid), host numpy.

    Parity classes are numbered over a (Z, Y, X) box, the grid's axes
    last: bit 2 z, bit 1 y, bit 0 x.  Raises ValueError when coeff has a
    nonzero off its parity class (not a stride-2 prolongation)."""
    coeff = np.asarray(coeff)
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    fine_grid = tuple(int(v) for v in fine_grid)
    coarse_grid = tuple(int(v) for v in coarse_grid)
    g = len(fine_grid)
    if len(coarse_grid) != g or any(2 * c - 1 > f for f, c in
                                    zip(fine_grid, coarse_grid)):
        raise ValueError(f"coarse grid {coarse_grid} is not a stride-2 "
                         f"subgrid of {fine_grid}")

    def cls(par):
        return sum((int(p) & 1) << (g - 1 - a) for a, p in enumerate(par))

    classes = [[] for _ in range(8)]
    for k, off in enumerate(offsets):
        classes[cls(off)].append(k)
    tmax = max(1, max(len(ks) for ks in classes))
    pcoeff = np.zeros((tmax,) + fine_grid, dtype=coeff.dtype)
    ptab = np.full((tmax, 8, 4), _NO_TAP, dtype=np.int32)
    ptab[..., 3] = _NO_LIN
    _, cy, cx = (1,) * (3 - g) + coarse_grid
    for q, ks in enumerate(classes):
        par = [(q >> (g - 1 - a)) & 1 for a in range(g)]
        sl = tuple(slice(p, None, 2) for p in par)
        for t, k in enumerate(ks):
            pcoeff[(t,) + sl] = coeff[(k,) + sl]
            # xc's index is f // 2 - (d - p) / 2 per axis: the kernel
            # subtracts this offset from f // 2's linear index
            hz, hy, hx = (0,) * (3 - g) + tuple(
                (d - p) // 2 for d, p in zip(offsets[k], par))
            ptab[t, q] = (0,) * (3 - g) + offsets[k] + (
                (hz * cy + hy) * cx + hx,)
    if np.count_nonzero(pcoeff) != np.count_nonzero(coeff):
        raise ValueError("stride-2 coefficients off their parity class")
    even = (slice(None),) + tuple(slice(None, 2 * c - 1, 2)
                                  for c in coarse_grid)
    rcoeff = np.stack([_shift_np(coeff[k], o)
                       for k, o in enumerate(offsets)])[even]
    return Stride2Transfer(
        torch.as_tensor(pcoeff, device=device),
        torch.as_tensor(ptab, device=device),
        tuple(tuple(offsets[k] for k in ks) for ks in classes),
        torch.as_tensor(np.ascontiguousarray(rcoeff), device=device),
        offsets, fine_grid, coarse_grid)


def stride2_transfer_from_scipy(P: sp.spmatrix, fine_nodes, coarse_nodes,
                                dtype=None, max_delta: int = 3,
                                device="cpu") -> Stride2Transfer:
    """A Stride2Transfer on `device` from an assembled prolongation.

    fine_nodes/coarse_nodes: per-mesh-dim extents (dim 0 fastest).  Raises
    ValueError when some entry's delta = f - 2c exceeds max_delta on an
    axis."""
    fine_nodes = [int(v) for v in np.asarray(fine_nodes).ravel()]
    coarse_nodes = [int(v) for v in np.asarray(coarse_nodes).ravel()]
    nf, nc = int(np.prod(fine_nodes)), int(np.prod(coarse_nodes))
    if P.shape != (nf, nc):
        raise ValueError("prolongation size does not match the node grids")
    fg = tuple(reversed(fine_nodes))
    cg = tuple(reversed(coarse_nodes))
    Pc = P.tocoo()
    fcoord = np.stack(np.unravel_index(Pc.row, fg), axis=1)
    ccoord = np.stack(np.unravel_index(Pc.col, cg), axis=1)
    d = fcoord - 2 * ccoord
    if d.size and int(np.abs(d).max()) > max_delta:
        raise ValueError("prolongation entry outside the stride-2 stencil")
    offs, pos = np.unique(d, axis=0, return_inverse=True)
    dt = dtype if dtype is not None else Pc.dtype
    coeff = np.zeros((len(offs), nf), dtype=dt)
    np.add.at(coeff, (pos.ravel(), Pc.row), Pc.data.astype(dt))
    return pack_stride2(coeff.reshape((-1,) + fg), offs, fg, cg, device)


# ---------------------------------------------------------------------------
# constant-interior compression
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class ConstGridStencil:
    """Stencil whose coefficients are constant away from the grid boundary.

    Constant-coefficient discretizations and all their full-weighting
    Galerkin coarsenings deviate from a constant interior stencil only within
    a w-node band at the grid boundary.  The apply reads x once, writes y
    once, and touches O(surface) band coefficients.

    const:  (ndiags,) interior coefficients.
    band:   every boundary box's (ndiags, *box_size) coefficients, packed box
            after box in one flat tensor (the layout the CUDA kernels read);
            `strips` are views into it.
    boxes:  per strip, (start, size) index boxes — a disjoint cover of the
            boundary band: two slabs per grid axis, each axis's slabs trimmed
            to the interior of the earlier axes.
    """
    const: torch.Tensor
    band: torch.Tensor
    offsets: tuple[tuple[int, ...], ...]
    grid: tuple[int, ...]
    boxes: tuple

    @classmethod
    def from_arrays(cls, const, strips, offsets, grid, boxes,
                    device="cpu") -> "ConstGridStencil":
        """Pack host (or device) const/strips into a stencil on `device`."""
        const = _np(const)
        dt = torch_dtype(const.dtype)
        band = np.concatenate([_np(s).reshape(-1) for s in strips])
        return cls(torch.tensor(const, dtype=dt, device=device),
                   torch.tensor(band, dtype=dt, device=device),
                   tuple(tuple(int(v) for v in o) for o in offsets),
                   tuple(int(v) for v in grid),
                   tuple((tuple(int(v) for v in st), tuple(int(v) for v in sz))
                         for st, sz in boxes))

    @property
    def dtype(self):
        return self.const.dtype

    @property
    def strips(self) -> tuple:
        nd = len(self.offsets)
        out, o = [], 0
        for _, size in self.boxes:
            cnt = nd * int(np.prod(size))
            out.append(self.band[o:o + cnt].view((nd,) + tuple(size)))
            o += cnt
        return tuple(out)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if _is_flat(x, self.grid):
            squeeze = x.ndim == 1
            x2 = x[:, None] if squeeze else x
            y = grid_to_flat(self.matvec(flat_to_grid(x2, self.grid)))
            return y[:, 0] if squeeze else y
        from .cuda.const3d import supports_const3d, const3d_matvec
        if supports_const3d(self.offsets, self.grid,
                            torch.promote_types(self.dtype, x.dtype)):
            return const3d_matvec(self, x)
        return const_grid_stencil_matvec(self.const, self.strips,
                                         self.offsets, self.grid, self.boxes,
                                         x)


def compress_grid_stencil(gs: GridStencil, width: int = 2,
                          rtol: float = 1e-13,
                          device="cpu") -> ConstGridStencil | None:
    """Compress to constant-interior form on `device`, or None when the
    interior is not constant (or the grid is too small for the band)."""
    grid = gs.grid
    dim = len(grid)
    if any(n < 3 * width for n in grid):
        return None
    coeff = _np(gs.coeff)
    center = tuple(n // 2 for n in grid)
    c = coeff[(slice(None),) + center]
    delta = coeff - c.reshape((-1,) + (1,) * dim)
    interior = (slice(None),) + tuple(slice(width, n - width) for n in grid)
    scale = max(float(np.abs(coeff).max()), 1e-300)
    if float(np.abs(delta[interior]).max()) > rtol * scale:
        return None

    boxes, strips = [], []
    for a in range(dim):
        start = [0] * dim
        size = list(grid)
        for prev in range(a):       # stay disjoint from earlier axes' slabs
            start[prev] = width
            size[prev] = grid[prev] - 2 * width
        for s0 in (0, grid[a] - width):
            st, sz = list(start), list(size)
            st[a], sz[a] = s0, width
            boxes.append((tuple(st), tuple(sz)))
            sl = tuple(slice(b, b + z) for b, z in zip(st, sz))
            strips.append(coeff[(slice(None),) + sl])
    return ConstGridStencil.from_arrays(c, strips, gs.offsets, grid, boxes,
                                        device=device)


def const_grid_stencil_matvec(const, strips, offsets, grid, boxes,
                              x: torch.Tensor) -> torch.Tensor:
    """y = A x for a constant-interior stencil; x is (..., *grid).

    The plain strip-assembly matvec: the output is assembled from disjoint
    regions — two boundary slabs per axis plus the constant-coefficient
    interior — concatenated along each axis, so every region is written
    exactly once.  One eager pass per tap and region; the CUDA kernel
    (ops/cuda/const3d.py) does the 3D radius-1 float32 case in one pass.
    """
    g = len(grid)
    nb = x.ndim - g
    lo = [max(0, -min(off[a] for off in offsets)) for a in range(g)]
    hi = [max(0, max(off[a] for off in offsets)) for a in range(g)]
    pad = []
    for a in reversed(range(g)):           # F.pad lists the last axis first
        pad += [lo[a], hi[a]]
    xp = F.pad(x, pad)

    def apply_box(start, size, coeffs):
        acc = None
        for k, off in enumerate(offsets):
            sl = (slice(None),) * nb + tuple(
                slice(lo[a] + start[a] + off[a],
                      lo[a] + start[a] + off[a] + size[a]) for a in range(g))
            t = coeffs[k] * xp[sl]
            acc = t if acc is None else acc + t
        return acc

    def assemble(a, start, size):
        if a == g:                       # fully-trimmed interior region
            return apply_box(start, size, const)
        (lo_start, lo_size), lo_strip = boxes[2 * a], strips[2 * a]
        (hi_start, hi_size), hi_strip = boxes[2 * a + 1], strips[2 * a + 1]
        w = lo_size[a]
        mid_start, mid_size = list(start), list(size)
        mid_start[a] = start[a] + w
        mid_size[a] = size[a] - 2 * w
        mid = assemble(a + 1, mid_start, mid_size)
        low = apply_box(lo_start, lo_size, lo_strip)
        high = apply_box(hi_start, hi_size, hi_strip)
        return torch.cat([low, mid, high], dim=nb + a)

    return assemble(0, [0] * g, list(grid))
