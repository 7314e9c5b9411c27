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

Smoothed-aggregation hierarchies on a grid (setup/sa_amg.py) carry a
`Stride2Transfer` in place of the per-axis factors: a matrix-dependent P
applied as a stencil on the upsampled field, and R = P^T.

The coarsest solve depends on its size: up to 4096 dofs a host f64
inverse; up to 20480 a dense inverse built on the device (COO assembled on
the card, LU, solve against I, a sampled identity residual deciding
whether the coarsest needs the reference's regularising shift); beyond,
host SuperLU (`GridSparseLU`), a host round trip per solve.

Fields are (m, *grid) with the fastest mesh axis last.  On a 3D radius-1
float32 level the Jacobi/SPAI branch runs the fused ops of
ops/cuda/fused3d.py, and line-Jacobi levels run the line kernel of
ops/cuda/tridiag.py; variable-coefficient levels and the stride-2
transfers apply through kernel D (ops/cuda/stencil.py): kernels on the
card, their plain versions on the CPU.  Cycle types V, W, F and K
(FGMRES-accelerated coarse corrections); `grid_fmg` is the full-multigrid
start of the refined solve.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from .. import spans
from ..config import double_variant, full_fp32, torch_dtype
from ..ops.grid_stencil import (ConstGridStencil, GridStencil,
                                Stride2Transfer, compress_grid_stencil,
                                flat_to_grid, grid_to_flat, make_grid_stencil)
from ..ops.cuda.const3d import supports_const3d
from ..ops.cuda import fused3d as f3k
from .capture import host_step, run, static_config
from .relax import (AltLineRelax, LineRelax, chebyshev_smooth,
                    chebyshev4_smooth, fgmres_relaxation, line_smooth)

__all__ = ["GridLevel", "GridHierarchy", "DenseInverse", "GridSparseLU",
           "GridIterativeCoarse", "grid_dense_inverse_from_scipy",
           "grid_restrict", "grid_prolong", "grid_cycle", "grid_cycle_jit",
           "grid_cycle_flat",
           "grid_fmg", "build_grid_hierarchy"]


@dataclass(frozen=True, eq=False)
class GridLevel:
    A: GridStencil | ConstGridStencil | None   # None: an SA coarsest that
                                               # only its solver reads
    d: torch.Tensor | None      # pointwise relax diagonal, grid-shaped
    P1: tuple | Stride2Transfer | None  # per-grid-axis dense 1D
                                # prolongation (f_a, c_a), None for an axis
                                # that does not coarsen; or a stride-2 P
    lam: float | None = None    # spec(D^-1 A) bound (chebyshev smoothing)
    line: LineRelax | AltLineRelax | None = None   # line-jacobi state


@dataclass(frozen=True, eq=False)
class DenseInverse:
    """Dense inverse of the coarsest operator (one matmul per solve)."""
    inv: torch.Tensor           # (nc, nc)
    grid: tuple[int, ...]

    def solve(self, bg: torch.Tensor) -> torch.Tensor:
        """bg: (m, *grid) -> (m, *grid), in full float32 (no TF32)."""
        m = bg.shape[0]
        with full_fp32():
            xf = bg.reshape(m, -1) @ self.inv.T
        return xf.reshape((m,) + tuple(self.grid))


def _dense_inverse_device(rows, cols, data, n: int, shift_rel: float):
    """COO -> dense (+ a relative diagonal shift) -> LU -> inverse, on the
    device of `data`.  Returns (inv, err): err is the largest entry of
    |A inv - I| over a stride sample of 256 columns."""
    with full_fp32():
        Ad = torch.zeros((n, n), dtype=data.dtype, device=data.device)
        Ad.index_put_((rows, cols), data, accumulate=True)
        eye = torch.eye(n, dtype=data.dtype, device=data.device)
        if shift_rel:
            Ad = Ad + (shift_rel * Ad.abs().sum(dim=0).max()) * eye
        lu, piv = torch.linalg.lu_factor(Ad)
        inv = torch.linalg.lu_solve(lu, piv, eye)
        cols_s = torch.arange(0, n, max(1, n // 256), device=data.device)
        err = (Ad @ inv[:, cols_s] - eye[:, cols_s]).abs().max()
    return inv, float(err)


def grid_dense_inverse_from_scipy(A_c: sp.spmatrix, grid_c, dtype,
                                  device="cpu") -> DenseInverse:
    """Dense inverse of a large coarsest operator, built on `device` in
    `dtype`: no O(nc^3) host inversion.

    The plain inverse comes first; only if its sampled identity residual is
    not finite or above 1e-2 (f32) / 1e-6 (f64) — a near-singular coarsest,
    such as a Neumann constant nullspace — is the reference's coarsest
    regularisation applied (SA-AMG.jl:63), 1e-6 x the largest column sum in
    float32 (where 1e-8 is lost in the addition) and 1e-8 in float64.  A
    float32 inverse is good to about eps * cond(A_c)."""
    Ac = A_c.tocoo()
    dt = torch_dtype(dtype)
    args = (torch.as_tensor(Ac.row.astype(np.int64), device=device),
            torch.as_tensor(Ac.col.astype(np.int64), device=device),
            torch.as_tensor(Ac.data, device=device).to(dt))
    n = int(A_c.shape[0])
    inv, err = _dense_inverse_device(*args, n, 0.0)
    single = np.finfo(np.dtype(dtype)).eps > 1e-10
    if not np.isfinite(err) or err > (1e-2 if single else 1e-6):
        inv, _ = _dense_inverse_device(*args, n, 1e-6 if single else 1e-8)
    return DenseInverse(inv, tuple(int(v) for v in grid_c))


@dataclass(frozen=True, eq=False)
class GridSparseLU:
    """Host SuperLU coarsest solve on grid fields: (m, *grid) goes to the
    host, is solved in float64 (complex128) and comes back in its own type
    (the reference's UMFPACK design point for coarsest levels beyond the
    replicated-dense budget, MGsetup.jl:350)."""
    factor: object          # scipy SuperLU (float64 or complex128)
    grid: tuple[int, ...]

    def solve(self, bg: torch.Tensor) -> torch.Tensor:
        """A host step (capture.host_step): inside a recorded program the
        program splits around it."""
        return host_step(self._host_solve, bg)

    def _host_solve(self, bh: torch.Tensor) -> torch.Tensor:
        m = bh.shape[0]
        xh = self.factor.solve(
            bh.reshape(m, -1).numpy().astype(self.factor.U.dtype).T)
        return torch.from_numpy(np.ascontiguousarray(xh.T)).to(
            bh.dtype).reshape(bh.shape)


@dataclass(frozen=True, eq=False)
class GridIterativeCoarse:
    """Jacobi-preconditioned one-shot FGMRES coarsest solve (the reference's
    MGcycle.jl:152-168 escape hatch): `inner` projection steps from zero."""
    A: GridStencil | ConstGridStencil
    d: torch.Tensor             # grid-shaped damped inverse diagonal
    inner: int

    def solve(self, bg: torch.Tensor, reduce=None) -> torch.Tensor:
        return fgmres_relaxation(self.A.matvec, lambda r: self.d * r,
                                 bg, torch.zeros_like(bg), self.inner,
                                 reduce)


@dataclass(frozen=True, eq=False)
class GridHierarchy:
    """The grid engine's device hierarchy.  `reduce` sums a tensor over the
    ranks when the fields are this rank's blocks (parallel/grid_sharded.py):
    the cycle's FGMRES projections (Jac-GMRES, K-cycles, the iterative
    coarsest) pass it to `fgmres_relaxation`; None on one device."""
    levels: tuple               # GridLevel per level (coarsest included)
    coarse: DenseInverse | GridIterativeCoarse
    reduce: Any = None

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
    """R r; rg is (m, *fine_grid).  Per-axis factors give full weighting,
    R = 0.5^c P^T with c the number of coarsened axes (a None factor,
    under semicoarsening, leaves its axis as is); a Stride2Transfer gives
    R = P^T, the SA convention; a transfer object that is not a tuple of
    factors (a Stride2Transfer, the multi-device tier's
    parallel/grid_sharded.py::ShardedTransfer) applies itself."""
    if not isinstance(P1, tuple):
        return P1.restrict(rg)
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
    if not isinstance(P1, tuple):
        return P1.prolong(xc)
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
                 x_zero: bool = False, reduce=None):
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
        return fgmres_relaxation(lvl.A.matvec, lambda v: lvl.d * v, r, x, nu,
                                 reduce)
    # jacobi / spai: x += d .* r with the residual refreshed between sweeps
    for _ in range(nu - 1):
        x = x + lvl.d * r
        r = lvl.A.residual(b, x)
    return x + lvl.d * r


def _coarse_solve(gh: GridHierarchy, b):
    """The coarsest solve; an iterative coarsest takes the hierarchy's
    reduce hook."""
    if isinstance(gh.coarse, GridIterativeCoarse):
        return gh.coarse.solve(b, gh.reduce)
    return gh.coarse.solve(b)


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
        return _coarse_solve(gh, b)

    lvl = gh.levels[level]
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
        r = b if x_zero else lvl.A.residual(b, x)
        x = _grid_smooth(cfg, lvl, r, x, b, cfg.nu_pre[level], x_zero,
                         gh.reduce)
        r = (lvl.A.residual(b, x) if cfg.nu_pre[level] > 0 or not x_zero
             else b)
    bc = grid_restrict(r, lvl.P1)
    if level == nlev - 2:
        xc = _coarse_solve(gh, bc)
    elif ctype == "K":
        prec = lambda v: grid_cycle(cfg, gh, v, torch.zeros_like(v),
                                    level + 1, "K", x_zero=True)
        xc = fgmres_relaxation(gh.levels[level + 1].A.matvec, prec, bc,
                               torch.zeros_like(bc), cfg.kcycle_inner,
                               gh.reduce)
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
        r = lvl.A.residual(b, x)
        x = _grid_smooth(cfg, lvl, r, x, b, cfg.nu_post[level],
                         reduce=gh.reduce)
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


@functools.lru_cache(maxsize=None)
def _cubic_factor(nf: int, dtype: torch.dtype, device: torch.device):
    """_cubic_factor_np on the device, made once: no host copy inside a
    cycle, so `grid_fmg` records."""
    return torch.as_tensor(_cubic_factor_np(nf), dtype=dtype, device=device)


def _cubic_prolong(xc: torch.Tensor, fine_grid) -> torch.Tensor:
    """Per-axis cubic solution prolongation (m, *coarse) -> (m, *fine); an
    axis that did not coarsen (semicoarsening) is left as is."""
    y = xc
    for a, nf in enumerate(fine_grid):
        if y.shape[1 + a] == nf:
            continue
        W = _cubic_factor(int(nf), xc.dtype, xc.device)
        y = _axis_matmul(y, W.T, 1 + a)
    return y.contiguous()


def grid_fmg(cfg, gh: GridHierarchy, b, n_cycles: int = 1):
    """Full multigrid (nested iteration): solve on the coarsest level, then
    on each finer level start from the cubic prolongation of the coarser
    solution and polish it with `n_cycles` cycles.  b is (m, *fine_grid)."""
    nlev = len(gh.levels)
    bs = [b]
    for l in range(nlev - 1):
        bs.append(grid_restrict(bs[-1], gh.levels[l].P1))
    x = gh.coarse.solve(bs[-1])
    for l in range(nlev - 2, -1, -1):
        P1 = gh.levels[l].P1
        if isinstance(P1, Stride2Transfer):
            x = grid_prolong(x, P1)       # matrix-dependent P: kept as is
        else:
            x = _cubic_prolong(x, gh.levels[l].A.grid)
        for _ in range(n_cycles):
            x = grid_cycle(cfg, gh, bs[l], x, level=l)
    return x


def _grid_cycle_program(ctx, b, x):
    cfg, gh, x_zero = ctx
    return grid_cycle(cfg, gh, b, x, x_zero=x_zero)


def grid_cycle_jit(cfg, gh: GridHierarchy, b, x, x_zero: bool = False):
    """One cycle on grid fields (m, *grid) as a recorded program (mgtpu's
    jitted cycle): a CUDA graph replayed on the card, recorded on first use
    per field shape, dtype and `x_zero`; `grid_cycle` itself on the CPU."""
    return run(gh, ("grid_cycle", static_config(cfg), bool(x_zero)),
               _grid_cycle_program,
               (cfg, gh, bool(x_zero)), b, x)


def grid_cycle_flat(cfg, gh: GridHierarchy, b2, x2, ctype: str | None = None,
                    x_zero: bool = False):
    """grid_cycle on flat (n, m) columns: the flat engine's form."""
    grid = gh.fine_grid
    xg = grid_cycle(cfg, gh, flat_to_grid(b2, grid), flat_to_grid(x2, grid),
                    0, ctype, x_zero=x_zero)
    return grid_to_flat(xg)


# ---------------------------------------------------------------------------
# construction from a host hierarchy
# ---------------------------------------------------------------------------

GRID_RELAX = ("jacobi", "spai", "jac-gmres", "chebyshev", "chebyshev4",
              "line-jacobi")
HOST_INV_MAX = 4096       # host f64 inverse up to this many coarsest dofs
DENSE_LU_MAX = 20480      # dense coarsest up to this many (20480^2 f32 =
                          # 1.7 GB), on either engine; host SuperLU beyond


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


def _check_separable(state) -> None:
    """Raise ValueError unless each level's stored prolongation is the
    Kronecker product of the full-weighting factors the grid engine
    applies (None, an axis that does not coarsen: the identity).  The
    re-discretization path builds its transfers in geometric mode, which
    can differ on even node counts."""
    from ..setup import transfers as tr
    for l in range(state.num_levels - 1):
        nodes = [int(v) + 1 for v in np.asarray(state.meshes[l].n).ravel()]
        nodes_c = [int(v) + 1
                   for v in np.asarray(state.meshes[l + 1].n).ravel()]
        K = None
        for nn, ncn in zip(nodes, nodes_c):
            pm = (sp.identity(nn, format="csr") if nn == ncn
                  else tr.fw_interp_1d(nn)[0])
            K = pm if K is None else sp.kron(pm, K, format="csr")
        P = state.Ps[l]
        if K.shape != P.shape or (K != P).nnz != 0:
            raise ValueError("hierarchy transfers are not the separable "
                             "full-weighting factors")


def build_grid_hierarchy(state, relax_states, device) -> GridHierarchy:
    """Build the grid engine on `device` for an MGState that mg_setup made
    (scalar full-weighting or semicoarsening transfers, pointwise, line or
    Jac-GMRES smoothing, a dense-inverse, LU or FGMRES coarsest).  Raises
    ValueError where the hierarchy is not a grid one (the caller may hand
    it to the flat engine) and NotImplementedError for options this port
    cannot run yet."""
    from ..setup import transfers as tr
    from ..setup.hierarchy import _resolve_relax
    cfg = state.config
    if cfg.transfer_type not in ("full-weighting", "semicoarsening"):
        raise ValueError("grid engine needs scalar full-weighting or "
                         "semicoarsening transfers")
    if cfg.relax_type not in GRID_RELAX:
        raise ValueError("grid engine supports pointwise relaxations only")
    if not state.meshes or len(state.meshes) < state.num_levels:
        raise ValueError("grid engine needs per-level meshes")
    if (cfg.coarse_solve not in ("lu", "gmres")
            or state.coarse_solver is not None):
        raise ValueError("grid engine supports lu/gmres coarsest solves")
    if not state._fw_separable:
        _check_separable(state)
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
            with spans.span("setup.grid_convert", into=state.setup_times,
                            timed=True):
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

    with spans.span("setup.coarsest", into=state.setup_times):
        coarse = grid_coarsest(state, levels[-1].A, levels[-1].A.grid, device)
    return GridHierarchy(tuple(levels), coarse)


def grid_coarsest(state, A, grid_c, device, host_inverse=_checked_inverse):
    """The grid engine's coarsest solver, in mgtpu's order: FGMRES on the
    last level's stencil A under coarse_solve="gmres"; else a dense inverse
    made at float64 (complex128) on the host by `host_inverse` up to
    HOST_INV_MAX dofs
    (then cast: the f64 factorization error is far below the f32 storage
    rounding), the device-built inverse up to DENSE_LU_MAX, host SuperLU
    beyond (its O(nnz) factor instead of an O(nc^2) one on the card)."""
    cfg = state.config
    A_c = state.As[-1]
    grid_c = tuple(int(v) for v in grid_c)
    if cfg.coarse_solve == "gmres":
        return grid_iterative_coarse(state, A, grid_c, device)
    fdt = double_variant(A_c.dtype)
    if A_c.shape[0] <= HOST_INV_MAX:
        Ad = np.asarray(sp.csr_matrix(A_c).astype(fdt).todense())
        return DenseInverse(torch.as_tensor(
            host_inverse(Ad).astype(cfg.dtype), device=device), grid_c)
    if A_c.shape[0] > DENSE_LU_MAX:
        from scipy.sparse.linalg import splu
        return GridSparseLU(splu(A_c.tocsc().astype(fdt)), grid_c)
    return grid_dense_inverse_from_scipy(A_c, grid_c, cfg.dtype, device)


def grid_iterative_coarse(state, A, grid_c, device) -> GridIterativeCoarse:
    """The FGMRES coarsest on the last level's stencil A."""
    rp = state.relax_param
    omega = rp if np.isscalar(rp) else 1.0
    d_c = torch.as_tensor(
        np.asarray(omega / state.As[-1].diagonal()).astype(
            state.config.dtype).reshape(grid_c), device=device)
    return GridIterativeCoarse(A, d_c, state.config.gmres_coarse_inner)

