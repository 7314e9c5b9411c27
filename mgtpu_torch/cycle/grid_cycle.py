"""Grid-form multigrid cycle — the structured engine on torch tensors.

Counterpart of mgtpu/cycle/grid_cycle.py.  Every operation is expressed on
the node grid:

 * level operators are `GridStencil`s / `ConstGridStencil`s;
 * P/R are separable [0.5, 1, 0.5] full-weighting transfers applied as one
   small dense matmul per grid axis (exactly the fw_interp factors, boundary
   rows included); under semicoarsening an axis that does not coarsen has
   no factor;
 * the coarsest solve is one dense matmul with a host-computed f64 inverse,
   or a Jacobi-preconditioned FGMRES projection (`GridIterativeCoarse`).

Fields are (m, *grid) with the fastest mesh axis last.  On a 3D radius-1
float32 level the Jacobi/SPAI branch runs the fused ops of
ops/cuda/fused3d.py, and line-Jacobi levels run the line kernel of
ops/cuda/tridiag.py; variable-coefficient levels apply through kernel D
(ops/cuda/stencil.py): kernels on the card, their plain versions on the
CPU.  Cycle types V, W, F and K (FGMRES-accelerated coarse corrections);
`grid_fmg` is the full-multigrid start of the refined solve.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..config import torch_dtype
from ..ops.grid_stencil import (ConstGridStencil, GridStencil,
                                compress_grid_stencil, make_grid_stencil)
from ..ops.cuda.const3d import supports_const3d
from ..ops.cuda import fused3d as f3k
from .relax import (AltLineRelax, LineRelax, chebyshev_smooth,
                    chebyshev4_smooth, fgmres_relaxation, line_smooth)

__all__ = ["GridLevel", "GridHierarchy", "DenseInverse",
           "GridIterativeCoarse", "grid_restrict", "grid_prolong",
           "grid_cycle", "grid_fmg", "build_grid_hierarchy"]


@dataclass(frozen=True, eq=False)
class GridLevel:
    A: GridStencil | ConstGridStencil
    d: torch.Tensor | None      # pointwise relax diagonal, grid-shaped
    P1: tuple | None            # per-grid-axis dense 1D prolongation (f_a, c_a),
                                # None for an axis that does not coarsen
    lam: float | None = None    # spec(D^-1 A) bound (chebyshev smoothing)
    line: LineRelax | AltLineRelax | None = None   # line-jacobi state


@dataclass(frozen=True, eq=False)
class DenseInverse:
    """Dense inverse of the coarsest operator (one matmul per solve)."""
    inv: torch.Tensor           # (nc, nc)
    grid: tuple[int, ...]

    def solve(self, bg: torch.Tensor) -> torch.Tensor:
        """bg: (m, *grid) -> (m, *grid)."""
        m = bg.shape[0]
        xf = bg.reshape(m, -1) @ self.inv.T
        return xf.reshape((m,) + tuple(self.grid))


@dataclass(frozen=True, eq=False)
class GridIterativeCoarse:
    """Jacobi-preconditioned one-shot FGMRES coarsest solve (the reference's
    MGcycle.jl:152-168 escape hatch): `inner` projection steps from zero."""
    A: GridStencil | ConstGridStencil
    d: torch.Tensor             # grid-shaped damped inverse diagonal
    inner: int

    def solve(self, bg: torch.Tensor) -> torch.Tensor:
        return fgmres_relaxation(self.A.matvec, lambda r: self.d * r,
                                 bg, torch.zeros_like(bg), self.inner)


@dataclass(frozen=True, eq=False)
class GridHierarchy:
    levels: tuple               # GridLevel per level (coarsest included)
    coarse: DenseInverse | GridIterativeCoarse

    @property
    def fine_grid(self) -> tuple[int, ...]:
        return self.levels[0].A.grid


# ---------------------------------------------------------------------------
# tensor-product full-weighting transfers as per-axis 1D matmuls
# ---------------------------------------------------------------------------

def _axis_matmul(x: torch.Tensor, W: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract `axis` of x with W (in, out)."""
    return torch.movedim(torch.movedim(x, axis, -1) @ W, -1, axis)


def grid_restrict(rg: torch.Tensor, P1) -> torch.Tensor:
    """R r = 0.5^c P^T r, c the number of coarsened axes; rg is
    (m, *fine_grid).  A None factor (semicoarsening) leaves its axis as is."""
    y = rg
    nc = 0
    for a, W in enumerate(P1):
        if W is None:
            continue
        nc += 1
        y = _axis_matmul(y, W, 1 + a)
    return ((0.5 ** nc) * y).contiguous()


def grid_prolong(xc: torch.Tensor, P1) -> torch.Tensor:
    """P xc; xc is (m, *coarse_grid)."""
    y = xc
    for a, W in enumerate(P1):
        if W is None:
            continue
        y = _axis_matmul(y, W.T, 1 + a)
    return y.contiguous()


# ---------------------------------------------------------------------------
# cycle
# ---------------------------------------------------------------------------

def _fused3d(cfg, lvl: GridLevel) -> bool:
    """True when this level's Jacobi/SPAI sweeps run the fused 3D ops — a
    static rule on the stencil (3D, radius 1, float32) and the diagonal."""
    if cfg.relax_type not in ("jacobi", "spai") or lvl.d is None:
        return False
    A = lvl.A
    return (isinstance(A, ConstGridStencil)
            and supports_const3d(A.offsets, A.grid, A.dtype)
            and tuple(lvl.d.shape) == tuple(A.grid))


def _grid_smooth(cfg, lvl: GridLevel, r, x, b, nu: int,
                 x_zero: bool = False):
    if nu <= 0:
        return x
    if cfg.relax_type == "chebyshev":
        return chebyshev_smooth(lvl.A.matvec, lvl.d, lvl.lam,
                                cfg.cheby_degree * nu, cfg.cheby_frac,
                                r, x, b)
    if cfg.relax_type == "chebyshev4":
        return chebyshev4_smooth(lvl.A.matvec, lvl.d, lvl.lam,
                                 cfg.cheby_degree * nu, r, x)
    if cfg.relax_type == "line-jacobi":
        return line_smooth(lvl.A.matvec, lvl.line, r, x, b, nu, x_zero)
    if cfg.relax_type == "jac-gmres":
        return fgmres_relaxation(lvl.A.matvec, lambda v: lvl.d * v, r, x, nu)
    # jacobi / spai: x += d .* r with the residual refreshed between sweeps
    for _ in range(nu - 1):
        x = x + lvl.d * r
        r = b - lvl.A.matvec(x)
    return x + lvl.d * r


def grid_cycle(cfg, gh: GridHierarchy, b, x, level: int = 0,
               ctype: str | None = None, x_zero: bool = False):
    """One multigrid cycle (V, W, F or K) on grid fields b, x of shape
    (m, *grid_level).  The K-cycle replaces the coarse-level cycle by a
    `kcycle_inner`-step FGMRES projection preconditioned with K-cycles on
    the next level.

    `x_zero` declares the incoming iterate to be exactly zero — true for
    every coarse-level entry inside a cycle and for the correction cycles of
    the refined driver.  The entry residual is then b itself, so the
    r = b - A*0 matvec is skipped.  On the fused 3D path the pre-smooth
    collapses to d*b plus one residual apply."""
    ctype = cfg.cycle_type if ctype is None else ctype
    if ctype not in ("V", "W", "F", "K"):
        raise NotImplementedError(f"cycle type {ctype!r} not yet ported")
    nlev = len(gh.levels)
    if level == nlev - 1:
        return gh.coarse.solve(b)

    lvl = gh.levels[level]
    matvec = lvl.A.matvec
    fused = _fused3d(cfg, lvl)
    if fused:
        # every sweep recomputes its residual inside one kernel pass; the
        # LAST pre-smooth sweep and the restrict-feed residual share the
        # double-apply kernel
        nu = cfg.nu_pre[level]
        if x_zero and nu >= 1:
            # first sweep off a zero iterate is elementwise (x1 = d*b)
            x = lvl.d * b
            nu -= 1
            if nu == 0:
                r = f3k.residual3d(lvl.A, b, x)
        if nu >= 1:
            for _ in range(nu - 1):
                x = f3k.jacobi3d(lvl.A, lvl.d, b, x)
            x, r = f3k.jacobi_residual3d(lvl.A, lvl.d, b, x)
        elif not x_zero:
            r = f3k.residual3d(lvl.A, b, x)
        elif cfg.nu_pre[level] == 0:
            r = b
    else:
        r = b if x_zero else b - matvec(x)
        x = _grid_smooth(cfg, lvl, r, x, b, cfg.nu_pre[level], x_zero)
        r = b - matvec(x) if cfg.nu_pre[level] > 0 or not x_zero else b
    bc = grid_restrict(r, lvl.P1)
    if level == nlev - 2:
        xc = gh.coarse.solve(bc)
    elif ctype == "K":
        prec = lambda v: grid_cycle(cfg, gh, v, torch.zeros_like(v),
                                    level + 1, "K", x_zero=True)
        xc = fgmres_relaxation(gh.levels[level + 1].A.matvec, prec, bc,
                               torch.zeros_like(bc), cfg.kcycle_inner)
    else:
        xc = grid_cycle(cfg, gh, bc, torch.zeros_like(bc), level + 1,
                        ctype, x_zero=True)
        if ctype == "W":
            xc = grid_cycle(cfg, gh, bc, xc, level + 1, "W")
        elif ctype == "F":
            xc = grid_cycle(cfg, gh, bc, xc, level + 1, "V")

    p = grid_prolong(xc, lvl.P1)
    if fused:
        if cfg.nu_post[level] > 0:
            # correction add folded into the first post-smooth pass
            x = f3k.jacobi_corr3d(lvl.A, lvl.d, b, x, p)
            for _ in range(cfg.nu_post[level] - 1):
                x = f3k.jacobi3d(lvl.A, lvl.d, b, x)
        else:
            x = x + p
    else:
        x = x + p
        r = b - matvec(x)
        x = _grid_smooth(cfg, lvl, r, x, b, cfg.nu_post[level])
    return x


@functools.lru_cache(maxsize=None)
def _cubic_factor_np(nf: int) -> np.ndarray:
    """1D cubic solution-prolongation factor (nf x nc) on an odd node grid.

    Coarse nodes inject; midpoints interpolate cubically through the four
    nearest coarse nodes ([-1, 9, 9, -1]/16 inside, one-sided
    [5, 15, -5, 1]/16 at the ends; linear when there are fewer than four
    coarse nodes).  FMG moves the SOLUTION at higher order than the
    correction transfers."""
    assert nf % 2 == 1 and nf >= 3
    nc = (nf - 1) // 2 + 1
    P = np.zeros((nf, nc), dtype=np.float64)
    P[np.arange(0, nf, 2), np.arange(nc)] = 1.0
    w_int = np.array([-1.0, 9.0, 9.0, -1.0]) / 16.0
    w_lo = np.array([5.0, 15.0, -5.0, 1.0]) / 16.0
    for m in range(nc - 1):               # midpoint between coarse m, m+1
        r = 2 * m + 1
        if nc < 4:
            P[r, m:m + 2] = 0.5
        elif m == 0:
            P[r, 0:4] = w_lo
        elif m == nc - 2:
            P[r, nc - 4:nc] = w_lo[::-1]
        else:
            P[r, m - 1:m + 3] = w_int
    return P


def _cubic_prolong(xc: torch.Tensor, fine_grid) -> torch.Tensor:
    """Per-axis cubic solution prolongation (m, *coarse) -> (m, *fine); an
    axis that did not coarsen (semicoarsening) is left as is."""
    y = xc
    for a, nf in enumerate(fine_grid):
        if y.shape[1 + a] == nf:
            continue
        W = torch.as_tensor(_cubic_factor_np(int(nf)), dtype=xc.dtype,
                            device=xc.device)
        y = _axis_matmul(y, W.T, 1 + a)
    return y.contiguous()


def grid_fmg(cfg, gh: GridHierarchy, b):
    """Full multigrid (nested iteration): solve on the coarsest level, then
    on each finer level start from the cubic prolongation of the coarser
    solution and polish it with one cycle.  b is (m, *fine_grid)."""
    nlev = len(gh.levels)
    bs = [b]
    for l in range(nlev - 1):
        bs.append(grid_restrict(bs[-1], gh.levels[l].P1))
    x = gh.coarse.solve(bs[-1])
    for l in range(nlev - 2, -1, -1):
        x = _cubic_prolong(x, gh.levels[l].A.grid)
        x = grid_cycle(cfg, gh, bs[l], x, level=l)
    return x


# ---------------------------------------------------------------------------
# construction from a host hierarchy
# ---------------------------------------------------------------------------

GRID_RELAX = ("jacobi", "spai", "jac-gmres", "chebyshev", "chebyshev4",
              "line-jacobi")
HOST_INV_MAX = 4096       # host f64 inverse below this many coarsest dofs


def _checked_inverse(Ad: np.ndarray) -> np.ndarray:
    """Plain inverse with a residual check, pseudo-inverse fallback.

    Neumann-type operators reach the coarsest level exactly singular
    (constant nullspace) and need the minimal-norm pinv; for the regular
    (shifted) case LU inversion is ~10x cheaper than the SVD."""
    n = Ad.shape[0]
    try:
        with np.errstate(all="ignore"):
            inv = np.linalg.inv(Ad)
        # kappa ~ |A| |A^-1| must be far from 1/eps, else the nullspace
        # leaks huge components into the inverse and only pinv is safe
        kappa = float(np.abs(Ad).max()) * float(np.abs(inv).max()) * n
        cols = (np.arange(n) if n <= 512
                else np.random.RandomState(0).choice(n, 256, replace=False))
        eye = np.zeros((n, len(cols)), dtype=Ad.dtype)
        eye[cols, np.arange(len(cols))] = 1.0
        err = float(np.abs(Ad @ inv[:, cols] - eye).max())
        if np.isfinite(inv).all() and kappa < 1e12 and err < 1e-6:
            return inv
    except np.linalg.LinAlgError:
        pass
    return np.linalg.pinv(Ad, rcond=1e-12)


def line_state_to(rs, dtype, device):
    """A host LineRelax / AltLineRelax with its arrays as tensors."""
    if isinstance(rs, AltLineRelax):
        return AltLineRelax(tuple(line_state_to(c, dtype, device)
                                  for c in rs.lines))
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return LineRelax(t(rs.alpha), t(rs.pivot), t(rs.cprime), int(rs.axis),
                     float(rs.omega))


def build_grid_hierarchy(state, relax_states, device) -> GridHierarchy:
    """Build the grid engine on `device` for an MGState that mg_setup made
    (scalar full-weighting or semicoarsening transfers, pointwise, line or
    Jac-GMRES smoothing, a dense-inverse or FGMRES coarsest; mg_setup checks
    the options).  Raises NotImplementedError
    for levels this port cannot run yet."""
    from ..setup import transfers as tr
    from ..setup.hierarchy import _resolve_relax
    cfg = state.config
    dt = torch_dtype(cfg.dtype)
    gs_cache = getattr(state, "_gs_cache", None) or {}
    levels = []
    for l in range(state.num_levels):
        nodes = [int(v) + 1 for v in np.asarray(state.meshes[l].n).ravel()]
        gs_host = gs_cache.get(l)
        if gs_host is not None and gs_host.grid == tuple(reversed(nodes)):
            # stencil-form coefficients already produced by the structured
            # RAP at setup — skip the CSR re-extraction
            gnp = GridStencil(np.asarray(gs_host.coeff, dtype=cfg.dtype),
                              gs_host.offsets, gs_host.grid)
            A = compress_grid_stencil(gnp, device=device)
            if A is None:
                A = gnp.to(device)
        else:
            A = make_grid_stencil(state.As[l], nodes, dtype=cfg.dtype,
                                  device=device)
        d = P1 = lam = line = None
        if l < state.num_levels - 1:
            rs = _resolve_relax(relax_states[l])
            if isinstance(rs, (LineRelax, AltLineRelax)):
                line = line_state_to(rs, dt, device)
            else:
                d = torch.as_tensor(np.asarray(rs.d).reshape(A.grid),
                                    dtype=dt, device=device)
            # dense per-axis 1D transfer factors (mg_setup's transfers are
            # these factors by construction); an axis whose extent does not
            # shrink (semicoarsening) has none
            nodes_c = [int(v) + 1
                       for v in np.asarray(state.meshes[l + 1].n).ravel()]
            P1 = tuple(None if nn == ncn else torch.as_tensor(
                np.asarray(tr.fw_interp_1d(nn)[0].todense(), dtype=cfg.dtype),
                device=device)
                for nn, ncn in zip(reversed(nodes), reversed(nodes_c)))
            lam = getattr(rs, "lam_max", None)
        levels.append(GridLevel(A, d, P1, lam, line))

    A_c = state.As[-1]
    grid_c = levels[-1].A.grid
    if cfg.coarse_solve == "gmres":
        rp = state.relax_param
        omega = rp if np.isscalar(rp) else 1.0
        d_c = torch.as_tensor(
            np.asarray(omega / A_c.diagonal()).astype(cfg.dtype)
            .reshape(grid_c), device=device)
        return GridHierarchy(tuple(levels), GridIterativeCoarse(
            levels[-1].A, d_c, cfg.gmres_coarse_inner))
    if A_c.shape[0] > HOST_INV_MAX:
        raise NotImplementedError(
            f"coarsest level of {A_c.shape[0]} dofs: only the host dense "
            f"inverse (<= {HOST_INV_MAX} dofs) is ported yet")
    # invert at float64 on the host, then cast (the f64 factorization error
    # is far below the f32 storage rounding)
    Ad = np.asarray(sp.csr_matrix(A_c).astype(np.float64).todense())
    inv = _checked_inverse(Ad)
    coarse = DenseInverse(torch.as_tensor(inv.astype(cfg.dtype),
                                          device=device), tuple(grid_c))
    return GridHierarchy(tuple(levels), coarse)
