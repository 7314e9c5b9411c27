"""Smoother setup (host side): diagonal preconditioners, spectral bounds,
line-Jacobi pivots and the cell-wise Vanka blocks.

Counterpart of mgtpu/setup/smoothers.py.  Everything here runs once at
setup on the host (numpy/scipy); the hierarchies move the diagonals, line
coefficients and Vanka tables to the device.  The Vanka host products
(cell index sets, colors, gathered blocks, weighted inverses) are mgtpu's
bit for bit; `gather_blocks` walks the cells in chunks so that its match
tensor stays small.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..config import single_variant
from ..cycle.relax import (AltLineRelax, ChebyshevRelax, DiagRelax,
                           LineRelax)
from ..cycle.vanka import VankaRelax
from ..models.mesh import RegularMesh, cs2loc

__all__ = ["jacobi_diag", "spai_diag", "jacobi_prec", "spai_prec",
           "estimate_lam_max", "chebyshev_prec", "line_prec",
           "vanka_cell_indices", "gather_blocks", "vanka_block_inverses",
           "setup_vanka", "vanka_scatter"]


def jacobi_diag(A: sp.spmatrix, omega) -> np.ndarray:
    """Host-side damped-Jacobi diagonal d = omega / diag(A)."""
    return np.asarray(omega / A.diagonal())


def spai_diag(A: sp.spmatrix, omega) -> np.ndarray:
    """Host-side SPAI(0) diagonal minimising ||I - M A||_F:
    d_i = omega * conj(a_ii) / ||A e_i||^2."""
    A = A.tocsr()
    s = np.asarray(A.multiply(A.conj()).sum(axis=0)).ravel().real
    return omega * np.conj(A.diagonal()) / np.maximum(s, 1e-300)


def jacobi_prec(A: sp.spmatrix, omega, dtype=None) -> DiagRelax:
    """Damped Jacobi: d = omega / diag(A)."""
    d = jacobi_diag(A, omega)
    return DiagRelax(d.astype(dtype if dtype is not None else d.dtype))


def spai_prec(A: sp.spmatrix, omega, dtype=None) -> DiagRelax:
    """SPAI(0) diagonal preconditioner (see spai_diag)."""
    d = spai_diag(A, omega)
    return DiagRelax(d.astype(dtype if dtype is not None else d.dtype))


def estimate_lam_max(A: sp.spmatrix, d: np.ndarray, iters: int = 15,
                     seed: int = 7, safety: float = 1.05) -> float:
    """Power-iteration bound on spec(D^-1 A) (host, once at setup)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(A.shape[0])
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = d * (A @ x)
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam * safety)


def chebyshev_prec(A: sp.spmatrix, omega, dtype=None) -> ChebyshevRelax:
    """Chebyshev smoother state: inverse diagonal + spectral upper bound.
    `omega` is accepted for dispatch uniformity but unused."""
    d = 1.0 / np.asarray(A.diagonal())
    lam = estimate_lam_max(A.tocsr(), d)
    return ChebyshevRelax(d.astype(dtype if dtype is not None else d.dtype),
                          lam)


def line_prec(A: sp.spmatrix, mesh, omega, dtype=None, axis=None):
    """Line-Jacobi smoother state: the tridiagonal part of A along one grid
    axis with host-computed Thomas pivots (see cycle.relax.LineRelax).

    axis: grid axis of the lines (slowest mesh dim first); None picks the
    axis with the strongest mean unit-offset coupling; "alt" gives
    alternating-direction lines over every grid axis (AltLineRelax).
    `omega` may be a float or a {"omega": w, "axis": a} mapping."""
    if isinstance(omega, dict) and omega.get("axis") == "alt":
        axis, omega = "alt", omega.get("omega", 1.0)
    if axis == "alt":
        g = len(np.asarray(mesh.n).ravel())
        return AltLineRelax(tuple(
            line_prec(A, mesh, omega, dtype=dtype, axis=a)
            for a in range(g)))
    from ..ops.grid_stencil import grid_stencil_from_csr

    if isinstance(omega, dict):
        axis = omega.get("axis", axis)
        omega = omega.get("omega", 1.0)
    if mesh is None:
        raise ValueError("line-jacobi needs a regular mesh (grid engine)")
    nodes = [int(v) + 1 for v in np.asarray(mesh.n).ravel()]
    gs = grid_stencil_from_csr(sp.csr_matrix(A), nodes)
    grid = gs.grid
    g = len(grid)
    coeff = np.asarray(gs.coeff, dtype=np.float64)

    def unit_coeff(a, sgn):
        want = tuple(sgn if k == a else 0 for k in range(g))
        for k, off in enumerate(gs.offsets):
            if tuple(off) == want:
                return coeff[k]
        return np.zeros(grid)

    if axis is None:
        strength = [abs(unit_coeff(a, -1)).mean() + abs(unit_coeff(a, 1)).mean()
                    for a in range(g)]
        axis = int(np.argmax(strength))

    diag = unit_coeff(axis, 0)       # the offset-0 coefficient
    sub = np.moveaxis(unit_coeff(axis, -1), axis, -1)
    sup = np.moveaxis(unit_coeff(axis, 1), axis, -1)
    dia = np.moveaxis(diag, axis, -1)
    n = dia.shape[-1]
    piv = np.zeros_like(dia)
    cp = np.zeros_like(dia)
    piv[..., 0] = 1.0 / dia[..., 0]
    cp[..., 0] = sup[..., 0] * piv[..., 0]
    for i in range(1, n):
        piv[..., i] = 1.0 / (dia[..., i] - sub[..., i] * cp[..., i - 1])
        cp[..., i] = sup[..., i] * piv[..., i]
    alpha = -piv * sub               # zero at line starts (sub[..., 0] == 0)
    dt = dtype if dtype is not None else coeff.dtype
    mv = lambda a: np.ascontiguousarray(np.moveaxis(a, -1, axis).astype(dt))
    return LineRelax(mv(alpha), mv(piv), mv(cp), int(axis), float(omega))


# ---------------------------------------------------------------------------
# Vanka block setup (reference Vanka.jl:294-370)
# ---------------------------------------------------------------------------

def vanka_cell_indices(mesh: RegularMesh,
                       include_pressure: bool) -> tuple[np.ndarray, np.ndarray]:
    """(idx, colors): per-cell Vanka variable sets and 2^dim cell colors.

    idx[c] lists the faces of cell c (low, high per dimension) followed by
    its pressure dof when include_pressure (reference Vanka.jl:45-95
    geometry, 0-based).  colors[c] in [0, 2^dim) from per-axis parity
    (reference cellColor, Vanka.jl:105-135)."""
    n = np.asarray(mesh.n)
    dim = mesh.dim
    ncells = int(np.prod(n))
    loc = cs2loc(np.arange(ncells), n)           # (ncells, dim)
    nf = []
    for j in range(dim):
        sj = n.copy()
        sj[j] += 1
        nf.append(int(np.prod(sj)))
    offsets = np.concatenate([[0], np.cumsum(nf)])
    cols = []
    for j in range(dim):
        sj = n.copy()
        sj[j] += 1
        strides = np.concatenate([[1], np.cumprod(sj[:-1])])
        base = offsets[j] + (loc * strides).sum(axis=1)
        cols.append(base)                         # low face along axis j
        cols.append(base + strides[j])            # high face along axis j
    if include_pressure:
        strides = np.concatenate([[1], np.cumprod(n[:-1])])
        cols.append(offsets[dim] + (loc * strides).sum(axis=1))
    idx = np.stack(cols, axis=1).astype(np.int64)
    colors = np.zeros(ncells, dtype=np.int64)
    for d in range(dim):
        colors |= (loc[:, d] % 2) << d
    return idx, colors


def _host_ell(A: sp.csr_matrix):
    """Padded-row (ELL) host view of a CSR matrix; padding: idx=0, val=0."""
    counts = np.diff(A.indptr)
    K = max(1, int(counts.max()))
    n = A.shape[0]
    idx = np.zeros((n, K), dtype=np.int64)
    val = np.zeros((n, K), dtype=A.dtype)
    within = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    rows = np.repeat(np.arange(n), counts)
    idx[rows, within] = A.indices
    val[rows, within] = A.data
    return idx, val


GATHER_CHUNK = 1 << 16      # cells per chunk of gather_blocks' match tensor


def gather_blocks(A: sp.csr_matrix, I: np.ndarray, ell=None) -> np.ndarray:
    """B[c, i, j] = A[I[c,i], I[c,j]] for all cells c, vectorised over
    chunks of GATHER_CHUNK cells (each cell's product is the same whatever
    the chunk).  `ell`: A's `_host_ell`, if already made."""
    idx, val = _host_ell(A) if ell is None else ell
    ncells, bs = I.shape
    out = np.empty((ncells, bs, bs), dtype=val.dtype)
    for c0 in range(0, ncells, GATHER_CHUNK):
        Ic = I[c0:c0 + GATHER_CHUNK]
        rows_idx = idx[Ic]                # (c, bs, K)
        rows_val = val[Ic]
        match = rows_idx[:, :, None, :] == Ic[:, None, :, None]
        out[c0:c0 + len(Ic)] = np.einsum("cbk,cbjk->cbj", rows_val,
                                         match.astype(val.dtype))
    return out


def _velocity_diagonal(blocks: np.ndarray, scale=1.0) -> np.ndarray:
    """The blocks with the velocity-velocity part cut to its diagonal
    (divided by `scale`: x / 1.0 is x bit for bit), the pressure row and
    column kept."""
    bs = blocks.shape[1]
    out = np.zeros_like(blocks)
    rng = np.arange(bs - 1)
    out[:, rng, rng] = blocks[:, rng, rng] / scale
    out[:, -1, :] = blocks[:, -1, :]
    out[:, :, -1] = blocks[:, :, -1]
    return out


def vanka_block_inverses(A: sp.spmatrix, mesh: RegularMesh, w,
                         include_pressure: bool, variant: str = "vanka",
                         dtype=None, ell=None):
    """(I, colors, dinv): per-cell Vanka index sets, 2^dim colors and the
    precomputed (weighted) block inverses — the variant-specific host math
    shared by the flat table smoother and the grid-form smoother.

    Variant semantics follow the reference (Vanka.jl:315-368):
      vanka, vanka-lex (scalar w) : diagonalised velocity block, inverse
                                    scaled by w
      vanka, vanka-lex ((w_u, w_p)): full inverse, row-weighted
      econ-vanka        : velocity diagonal divided by w before full inverse
      vanka-add         : full inverse with 1/2 interior-face weights
      kaczmarz-vanka    : inverse of the (A A^H) block, scaled by w
    `ell`: A's `_host_ell`, if already made."""
    A = A.tocsr()
    I, colors = vanka_cell_indices(mesh, include_pressure)
    ncells, bs = I.shape
    n = np.asarray(mesh.n)
    dim = mesh.dim

    if variant == "kaczmarz-vanka":
        blocks = gather_blocks((A @ A.conj().T).tocsr(), I)
    else:
        blocks = gather_blocks(A, I, ell)

    W = np.ones(bs)
    scalar_w = np.isscalar(w)
    if not scalar_w:
        W[:] = w[0]
        if include_pressure:
            W[-1] = w[1]

    if variant in ("vanka", "vanka-lex"):
        if scalar_w:
            dinv = w * np.linalg.inv(_velocity_diagonal(blocks))
        else:
            dinv = W[None, :, None] * np.linalg.inv(blocks)
    elif variant == "econ-vanka":
        dinv = np.linalg.inv(_velocity_diagonal(blocks, w))
    elif variant == "vanka-add":
        # boundary-weighted additive damping (reference Vanka.jl:339-353):
        # interior faces (shared by two cells) get 1/2, boundary faces 1
        loc = cs2loc(np.arange(ncells), n)
        t = 0.5 * np.ones((ncells, bs))
        for d in range(dim):
            t[loc[:, d] == 0, 2 * d] = 1.0
            t[loc[:, d] == n[d] - 1, 2 * d + 1] = 1.0
        if include_pressure:
            t[:, -1] = 1.0
        ww = w if scalar_w else W[None, :]
        dinv = (t * ww)[:, :, None] * np.linalg.inv(blocks)
    elif variant == "kaczmarz-vanka":
        dinv = w * np.linalg.inv(blocks)
    else:
        raise ValueError(f"unknown Vanka variant {variant}")
    return I, colors, dinv


def setup_vanka(A: sp.spmatrix, mesh: RegularMesh, w, include_pressure: bool,
                variant: str = "vanka", dtype=None) -> VankaRelax:
    """Per-cell block inverses + colored row tables (the flat engine's
    Vanka, host numpy arrays; the hierarchy moves them to the device).

    Block inverses are stored in single precision (reference
    Vanka.jl:296).  The scatter table of the overlapping variants
    (`VankaRelax.scatter`) is built here."""
    A = A.tocsr()
    dt = np.dtype(dtype if dtype is not None else A.dtype)
    prec_dt = single_variant(dt)
    dim = mesh.dim
    ell = _host_ell(A)
    I, colors, dinv = vanka_block_inverses(A, mesh, w, include_pressure,
                                           variant, dtype=dt, ell=ell)
    ncells, bs = I.shape

    # colored, padded tables
    idx_host, val_host = ell
    K = idx_host.shape[1]
    if variant in ("vanka-add", "vanka-lex"):
        groups = [np.arange(ncells)]
    else:
        ncolors = 2 ** dim
        groups = [np.nonzero(colors == c)[0] for c in range(ncolors)]
    L = max(len(g) for g in groups)
    ng = len(groups)
    gi = np.zeros((ng, L, bs), dtype=np.int32)
    gd = np.zeros((ng, L, bs, bs), dtype=prec_dt)
    gri = np.zeros((ng, L, bs, K), dtype=np.int32)
    grv = np.zeros((ng, L, bs, K), dtype=dt)
    for g, cells in enumerate(groups):
        k = len(cells)
        gi[g, :k] = I[cells]
        gd[g, :k] = dinv[cells].astype(prec_dt)
        gri[g, :k] = idx_host[I[cells]]
        grv[g, :k] = val_host[I[cells]].astype(dt)
    return VankaRelax(gi, gd, gri, grv, variant,
                      vanka_scatter(variant, gi, gri, grv, A.shape[0]))


def vanka_scatter(variant: str, idx, rows_idx, rows_val, n: int):
    """The scatter tables (one per color) of the variants whose adds
    collide, else None: vanka-add adds to the cells' overlapping faces,
    kaczmarz-vanka to their rows' shared columns (ELL padding, whose
    values are zero, left out)."""
    if variant == "vanka-add":
        return (_scatter_table(idx[0].reshape(-1), n),)
    if variant == "kaczmarz-vanka":
        return tuple(_scatter_table(rows_idx[g].reshape(-1), n,
                                    rows_val[g].reshape(-1) != 0)
                     for g in range(idx.shape[0]))
    return None


def _scatter_table(targets: np.ndarray, n: int, live=None) -> np.ndarray:
    """(n, c) int32 positions into a flat list of contributions whose
    target variables are `targets`: row v lists the positions aimed at v in
    increasing order, padded with len(targets) (the zero appended to the
    contributions).  Adding column 0, then 1, ... replays a sequential
    scatter-add in its order, with no atomics.  `live` masks out
    contributions that are zero by construction (ELL padding)."""
    pos = np.arange(len(targets))
    if live is not None:
        pos = pos[live]
    tgt = targets[pos]
    order = np.argsort(tgt, kind="stable")
    tgt, pos = tgt[order], pos[order]
    counts = np.bincount(tgt, minlength=n)
    c = max(1, int(counts.max()))
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(tgt)) - np.repeat(start, counts)
    tab = np.full((n, c), len(targets), dtype=np.int32)
    tab[tgt, rank] = pos
    return tab
