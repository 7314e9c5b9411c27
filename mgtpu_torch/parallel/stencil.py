"""Slab form of a banded grid operator, its halo exchange and transfers.

Counterpart of mgtpu/parallel/stencil.py.  A flat vector x (dim-0 fastest)
is viewed as G[j, i] = x[i + j*NI], with j the last mesh dimension (the J
axis, split into slabs over the ranks) and i the flattened remaining ones;
every stencil offset decomposes as off = dj*NI + di with |dj| <= 1.  Fields
are (..., S, NI) slabs, the right-hand sides leading (mgtpu's are (S, NI,
m)).

 * `exchange_halo` gives a slab its neighbours' edge planes (comm.py's
   batch_isend_irecv; zero planes at the ends of the axis).
 * `stencil_matvec_local` applies the slab's rows from the halo-extended
   slab: kernel D's cross form (ops/cuda/stencil.py::halo_apply) with the
   taps shifted by one plane.
 * `slab_apply` is kernel D's halo form (ops/cuda/stencil.py::
   halo_stencil): the apply, the residual b - A x or the Jacobi update
   x + d (b - A x) in one launch, reading the neighbours' planes where
   they arrived (none at an end of the axis), no extended slab.
   `stencil_matvec_overlapped` posts the exchange, writes the interior
   rows [1, S-1) from the local planes while it is in flight, then both
   edge rows in one launch: bitwise the fused form, since each node sums
   the same taps in the same order under the same launch plan.
 * The matrix-free tensor-product full-weighting transfers on odd node
   counts, factored as S_J o S_I with S_* the separable [0.5, 1, 0.5]
   smoothing along the J axis / in the plane:
       P  = S_J(S_I(upsample(xc)))
       R  = 0.5^dim * downsample(S_J(S_I(xf)))
   which reproduces the fw_interp operators (setup/transfers.py), interior
   and boundary, on odd extents.  Elementwise torch, as in mgtpu (XLA).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["StencilLevel", "stencil_from_banded", "exchange_halo",
           "stencil_matvec_local", "slab_apply", "stencil_matvec_overlapped",
           "TransferPlan", "make_transfer_plan", "smooth_inplane",
           "smooth_j", "restrict_local", "prolong_local"]


@dataclass(frozen=True, eq=False)
class StencilLevel:
    """One level: variable stencil coefficients + Jacobi diagonal, slab form.

    coeff: (ndiags, NJ, NI) with coeff[k, j, i] = A[row(j,i), row(j,i)+off_k];
    d:     (NJ, NI) damped-Jacobi inverse diagonal;
    di/dj: per-diagonal offset decomposition; shape = (NJ, NI).
    Host numpy arrays.
    """
    coeff: np.ndarray
    d: np.ndarray
    di: tuple[int, ...]
    dj: tuple[int, ...]
    shape: tuple[int, int]


def stencil_from_banded(A: sp.spmatrix, n_nodes, omega: float,
                        dtype=np.float32) -> StencilLevel:
    """The slab-form stencil of a banded operator on an n_nodes grid.

    n_nodes: per-dim node counts (dim 0 fastest).  NI = prod(n_nodes[:-1]),
    NJ = n_nodes[-1].  Raises ValueError when an offset reaches beyond the
    neighbouring plane."""
    n_nodes = [int(v) for v in np.asarray(n_nodes).ravel()]
    NI = int(np.prod(n_nodes[:-1]))
    NJ = n_nodes[-1]
    A = A.tocoo()
    off_all = A.col.astype(np.int64) - A.row.astype(np.int64)
    offs = np.unique(off_all)
    dj = np.round(offs / NI).astype(np.int64)
    di = offs - dj * NI
    if np.any(np.abs(dj) > 1):
        raise ValueError("operator is not a 1-plane-halo stencil on this grid")
    coeff = np.zeros((len(offs), NJ * NI), dtype=dtype)
    pos = np.searchsorted(offs, off_all)
    np.add.at(coeff, (pos, A.row), A.data.astype(dtype))
    coeff = coeff.reshape(len(offs), NJ, NI)
    diag = A.tocsr().diagonal()
    d = (omega / diag).astype(dtype).reshape(NJ, NI)
    return StencilLevel(coeff, d, tuple(int(v) for v in di),
                        tuple(int(v) for v in dj), (NJ, NI))


# ---------------------------------------------------------------------------
# the halo exchange and the slab apply
# ---------------------------------------------------------------------------

def exchange_halo(x_loc, comm, axis: int = 0):
    """x_loc (..., S, NI) -> (..., S+2, NI) with the neighbours' planes
    along `axis` of the rank grid `comm` (zero planes at its ends: the
    zero-extended global grid boundary)."""
    return comm.exchange_halo(x_loc, axis, 1, dim=-2)


def _halo_taps(di, dj):
    """The slab taps on the halo-extended slab: (dj + 1, di)."""
    return tuple((int(j) + 1, int(i)) for i, j in zip(di, dj))


def stencil_matvec_local(coeff_loc, di, dj, x_halo):
    """y = A x on a halo-extended slab: coeff_loc (nd, S, NI), x_halo
    (..., S+2, NI) -> (..., S, NI).  Kernel D's cross form (`halo_apply`)
    on a CUDA tensor, the plain cross apply on a CPU one.  The slab GMG
    reads the planes where they lie instead (`slab_apply`)."""
    from ..ops.cuda.stencil import halo_apply
    S, NI = coeff_loc.shape[1:]
    return halo_apply(coeff_loc, _halo_taps(di, dj), (S + 2, NI), x_halo)


def slab_apply(coeff_loc, di, dj, x_loc, left, right, b=None, d=None,
               rows=None, out=None):
    """Kernel D's halo form on a slab x_loc (..., S, NI) and its
    neighbours' planes left / right (..., 1, NI), None at an end of the
    axis: y = A x, with b the residual b - A x, with b and d (S, NI) the
    Jacobi update x + d * (b - A x) (ops/cuda/stencil.py::halo_stencil;
    its plain version on a CPU tensor).  rows / out: the output rows
    written (see halo_stencil)."""
    from ..ops.cuda.stencil import halo_stencil
    return halo_stencil(coeff_loc, tuple(zip(dj, di)), x_loc, left, right,
                        0, b=b, d=d, rows=rows, out=out)


def stencil_matvec_overlapped(coeff_loc, di, dj, x_loc, comm, axis: int = 0,
                              b=None, d=None):
    """y = A x on a slab with the halo exchange split off the interior;
    with b the residual b - A x, with b and d the Jacobi update
    x + d * (b - A x) (`slab_apply`).

    The exchange is posted first (under NCCL it runs on NCCL's stream);
    the interior rows [1, S-1), which read only local planes, are written
    while it is in flight; then one launch writes both edge rows into the
    same tensor from the planes where they arrived.  Every node sums the
    same taps in the same order under the whole slab's plan, so the result
    is bitwise the fused `exchange_halo` + `stencil_matvec_local` (and
    torch's subtraction or update).  At S < 2 the edge windows would read a
    duplicated local plane (mgtpu's note): the whole slab after the
    exchange."""
    S = coeff_loc.shape[1]
    halo = comm.post_halo(x_loc, axis, 1, dim=-2, zeros=False)
    if S < 2:
        return slab_apply(coeff_loc, di, dj, x_loc, *halo.wait(), b, d)
    out = (slab_apply(coeff_loc, di, dj, x_loc, None, None, b, d,
                      rows=(1, S - 1, S - 1, S - 1)) if S > 2 else None)
    left, right = halo.wait()
    return slab_apply(coeff_loc, di, dj, x_loc, left, right, b, d,
                      rows=(0, 1, S - 1, S), out=out)


# ---------------------------------------------------------------------------
# matrix-free tensor-product full-weighting transfers (slab form)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TransferPlan:
    """Static plan for the matrix-free P/R between a fine grid and its
    coarse one: in-plane smoothing offsets and weights, grid extents.  The
    validity masks and the I-axis downsample map are arrays, kept on the
    level (parallel/sharded.py::ShardedLevel)."""
    offsets: tuple
    NI: int
    NIc: int
    NJ: int
    NJc: int
    dim: int


def make_transfer_plan(n_nodes):
    """(plan, masks (noffs, NI) float32, ds_map (NIc,) int64) for an
    n_nodes grid (dim 0 fastest, odd node counts)."""
    n_nodes = [int(v) for v in np.asarray(n_nodes).ravel()]
    if any((nd - 1) % 2 for nd in n_nodes):
        raise ValueError("matrix-free transfers need odd node counts per dim")
    inplane = n_nodes[:-1]
    NI = int(np.prod(inplane))
    idx = np.arange(NI)
    coords, rem = [], idx.copy()
    for nd in inplane:
        coords.append(rem % nd)
        rem = rem // nd
    coords = np.stack(coords, axis=1) if inplane else np.zeros((1, 0),
                                                               np.int64)
    strides = (np.concatenate([[1], np.cumprod(inplane[:-1])]).astype(
        np.int64) if inplane else np.array([1]))
    combos = [((), 1.0, np.ones(NI, dtype=bool))]
    for d in range(len(inplane)):
        new = []
        for steps, w, mask in combos:
            for s, ws in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                if s == -1:
                    m2 = mask & (coords[:, d] >= 1)
                elif s == 1:
                    m2 = mask & (coords[:, d] <= inplane[d] - 2)
                else:
                    m2 = mask
                new.append((steps + (s,), w * ws, m2))
        combos = new
    offsets = tuple((int(sum(s * strides[d] for d, s in enumerate(steps))),
                     float(w)) for steps, w, _ in combos)
    masks = np.stack([m for _, _, m in combos]).astype(np.float32)

    nc_inplane = [(nd - 1) // 2 + 1 for nd in inplane]
    NIc = int(np.prod(nc_inplane)) if nc_inplane else 1
    ds = np.zeros(NIc, dtype=np.int64)
    cidx = np.arange(NIc)
    for d, ncd in enumerate(nc_inplane):
        cstride = int(np.prod(nc_inplane[:d]))
        fstride = int(np.prod(inplane[:d]))
        coord = (cidx // cstride) % ncd
        ds += 2 * coord * fstride
    plan = TransferPlan(offsets, NI, NIc, n_nodes[-1],
                        (n_nodes[-1] - 1) // 2 + 1, len(n_nodes))
    return plan, masks, ds


def _shift_i(x, di: int):
    """y[..., i] = x[..., i + di] along the last (I) axis, zero fill."""
    if di == 0:
        return x
    z = x.new_zeros(x.shape[:-1] + (abs(di),))
    if di > 0:
        return torch.cat([x[..., di:], z], dim=-1)
    return torch.cat([z, x[..., :di]], dim=-1)


def smooth_inplane(x, plan: TransferPlan, masks):
    """S_I: the in-plane [0.5, 1, 0.5]^(dim-1) smoothing, local to a rank.
    x (..., NI)."""
    y = torch.zeros_like(x)
    for k, (off, w) in enumerate(plan.offsets):
        y = y + w * (_shift_i(x, off) * masks[k])
    return y


def smooth_j(x_halo):
    """S_J: [0.5, 1, 0.5] along J on a halo-extended slab (..., S+2, NI)
    -> (..., S, NI)."""
    S = x_halo.shape[-2] - 2
    return (0.5 * x_halo[..., :S, :] + x_halo[..., 1:S + 1, :]
            + 0.5 * x_halo[..., 2:, :])


def restrict_local(xf_halo, plan: TransferPlan, masks, ds_map,
                   S_coarse: int):
    """R xf on a slab: smooth, then downsample both axes; scale 0.5^dim.
    xf_halo (..., Sf+2, NI) with Sf = 2 S_coarse -> (..., S_coarse, NIc)."""
    y = smooth_j(smooth_inplane(xf_halo, plan, masks))
    yj = y[..., 0::2, :][..., :S_coarse, :]           # aligned: fine 2c
    return (0.5 ** plan.dim) * yj.index_select(-1, ds_map)


def prolong_local(xc_loc, plan: TransferPlan, masks, ds_map, comm,
                  Sf: int, axis: int = 0):
    """P xc on a slab: upsample both axes, then smooth (one fine-halo
    exchange).  xc_loc (..., Sc, NIc) -> (..., Sf, NI), Sf = 2 Sc."""
    Sc = xc_loc.shape[-2]
    up = xc_loc.new_zeros(xc_loc.shape[:-2] + (2 * Sc, plan.NI))
    up[..., 0::2, :].index_copy_(-1, ds_map, xc_loc)
    up_halo = exchange_halo(up, comm, axis)
    return smooth_j(smooth_inplane(up_halo, plan, masks))[..., :Sf, :]
