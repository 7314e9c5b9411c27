"""Multigrid configuration, geometric setup and the device hierarchy.

Counterpart of mgtpu/setup/hierarchy.py on the matrix path with
full-weighting, semicoarsening or face-staggered systems transfers:

 * `MGConfig` — immutable solver configuration (levels, cycle type
   including the K-cycle, relaxation including Jac-GMRES, per-level sweep
   counts, transfer family, coarse solver: dense inverse, LU or FGMRES,
   the AMG strength and filtering parameters, the engine).
 * `get_mg_param` — the configuration constructor, with the reference's
   spellings accepted as aliases.
 * `mg_setup` — Galerkin hierarchy built on the host (structured
   full-weighting RAP on the stencil coefficients; under semicoarsening
   only the strongly coupled axes coarsen; the staggered systems
   transfers of Systems.jl under scipy's RAP), or a re-discretized one
   from an `OperatorConstructor`; an external coarsest solver
   (`coarse_solver=`: `DirectSolver`, `DDSolver`,
   `SchurComplementSolver`) takes the hierarchy to the flat engine.
   `MGState.setup_times` keeps the host seconds of its stages.
 * The lifecycle (reference MGsetup.jl:226-318, MGdef.jl:138-210):
   `hierarchy_exists`, `replace_matrix_in_hierarchy` (new values, the
   same transfers), `transpose_hierarchy` (A^H, for adjoint solves),
   `copy_solver` and `clear`.  A rebuilt hierarchy drops the recorded
   programs of the old one.
 * `build_device_hierarchy` — the engine choice: the structured grid
   engine (cycle/grid_cycle.py) or, for staggered systems, the systems
   grid engine (cycle/systems_grid.py) where the hierarchy is a grid
   one, else the flat ELL/DIA engine (`Hierarchy`, cycle/cycle.py; Vanka
   smoothers from cycle/vanka.py).  Under
   ``engine="auto"`` a `ValueError` of the grid engine (a matrix that is
   no grid stencil, say) hands the hierarchy to the flat engine;
   ``engine="grid"`` re-raises it and ``engine="flat"`` skips the grid
   engine.

Options the port does not have yet raise NotImplementedError("... not yet
ported"), which no engine choice catches.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device, torch_dtype
from ..models.mesh import RegularMesh, get_regular_mesh
from . import smoothers as sm
from . import transfers as tr

__all__ = ["MGConfig", "get_mg_param", "Level", "Hierarchy", "MGState",
           "OperatorConstructor", "mg_setup", "build_device_hierarchy",
           "hierarchy_exists", "replace_matrix_in_hierarchy",
           "transpose_hierarchy", "copy_solver", "clear", "VANKA_TYPES"]

VANKA_TYPES = ("vanka", "econ-vanka", "vanka-lex", "vanka-add",
               "kaczmarz-vanka")
SYSTEMS_TRANSFERS = ("systems-faces", "systems-faces-mixed")

# reference relaxType spellings accepted as aliases
_RELAX_ALIASES = {
    "Jac": "jacobi", "Jac-GMRES": "jac-gmres", "SPAI": "spai",
    "VankaFaces": "vanka", "EconVankaFaces": "econ-vanka",
    "VankaFacesLex": "vanka-lex", "VankaFacesAdd": "vanka-add",
    "hybridKaczmarzNodal": "hybrid-kaczmarz",
    "hybridVankaFacesKaczmarz": "kaczmarz-vanka",
    "Cheb": "chebyshev", "Chebyshev": "chebyshev",
    "Cheb4": "chebyshev4", "Chebyshev4": "chebyshev4",
    "LineJac": "line-jacobi",
}
_TRANSFER_ALIASES = {
    "FullWeighting": "full-weighting",
    "SemiCoarsening": "semicoarsening",
    "SystemsFacesLinear": "systems-faces",
    "SystemsFacesMixedLinear": "systems-faces-mixed",
}
_COARSE_ALIASES = {"NoMUMPS": "lu", "Julia": "lu", "MUMPS": "lu",
                   "GMRES": "gmres", "BiCGSTAB": "gmres"}


@dataclass(frozen=True, eq=True)
class MGConfig:
    """Static multigrid configuration."""
    levels: int = 3
    max_outer_iter: int = 20
    relative_tol: float = 1e-6
    relax_type: str = "spai"
    nu_pre: tuple[int, ...] = ()     # per level; filled by get_mg_param
    nu_post: tuple[int, ...] = ()
    cycle_type: str = "V"
    coarse_solve: str = "lu"         # "lu" | "gmres" | "external"
    strong_conn_param: float = 0.4   # AMG strength-of-connection threshold
    filtering_param: float = 0.0     # non-Galerkin SA magnitude filter
    transfer_type: str = "full-weighting"
    dtype: Any = np.float64
    kcycle_inner: int = 2            # FGMRES steps per K-cycle level
    gmres_coarse_inner: int = 10     # FGMRES steps of the iterative coarsest
    engine: str = "auto"             # "auto" | "grid" | "flat"
    cheby_degree: int = 3            # polynomial degree per chebyshev sweep
    cheby_frac: float = 0.25         # smoothing interval [frac*lam, lam]

    @property
    def mixed(self) -> bool:
        """Staggered systems with a cell-centered pressure block."""
        return self.transfer_type == "systems-faces-mixed"


def get_mg_param(levels: int = 3, max_outer_iter: int = 20,
                 relative_tol: float = 1e-6, relax_type: str = "spai",
                 relax_param=1.0, nu_pre=2, nu_post=2, cycle_type: str = "V",
                 coarse_solve: str = "lu", strong_conn_param: float = 0.4,
                 filtering_param: float = 0.0,
                 transfer_type: str = "full-weighting",
                 dtype=np.float64, engine: str = "auto",
                 cheby_degree: int = 3,
                 cheby_frac: float = 0.25) -> tuple[MGConfig, Any]:
    """Configuration constructor mirroring getMGparam (the parameters this
    port reads so far).

    Returns (config, relax_param); sweep counts may be ints or per-level
    sequences/callables."""
    relax_type = _RELAX_ALIASES.get(relax_type, relax_type)
    transfer_type = _TRANSFER_ALIASES.get(transfer_type, transfer_type)
    coarse_solve = _COARSE_ALIASES.get(coarse_solve, coarse_solve)

    def to_tuple(v):
        if callable(v):
            return tuple(int(v(l)) for l in range(levels))
        if np.isscalar(v):
            return (int(v),) * levels
        return tuple(int(x) for x in v)

    cfg = MGConfig(levels=levels, max_outer_iter=max_outer_iter,
                   relative_tol=relative_tol, relax_type=relax_type,
                   nu_pre=to_tuple(nu_pre), nu_post=to_tuple(nu_post),
                   cycle_type=cycle_type, coarse_solve=coarse_solve,
                   strong_conn_param=strong_conn_param,
                   filtering_param=filtering_param,
                   transfer_type=transfer_type, dtype=np.dtype(dtype).type,
                   engine=engine, cheby_degree=cheby_degree,
                   cheby_frac=cheby_frac)
    return cfg, relax_param


@dataclass(frozen=True, eq=False)
class Level:
    """A flat-engine level: operator, transfers and smoother state on the
    device (P, R and relax are None on the coarsest level)."""
    A: Any                 # ELL | DIA
    P: Any                 # ELL | None
    R: Any                 # ELL | None
    relax: Any             # DiagRelax | ChebyshevRelax | VankaRelax |
                           # KaczmarzRelax | None


@dataclass(frozen=True, eq=False)
class Hierarchy:
    """The flat engine's device hierarchy.  `reduce` sums a tensor over
    the ranks when the levels hold row blocks of partitioned vectors
    (parallel/part_amg.py): the cycle's FGMRES projections (Jac-GMRES,
    K-cycles) pass it to `fgmres_relaxation`; None on one device."""
    levels: tuple          # Level per level, coarsest included
    coarse: Any            # DenseLU | IterativeCoarse | SparseLUCoarse |
                           # an external solver's device state
    reduce: Any = None


@dataclass
class OperatorConstructor:
    """PDE re-discretization callback (reference
    multilevelOperatorConstructor, MGdef.jl:31-46): get_operator(mesh,
    param) -> scipy matrix (get_operator(mesh) without restrict_params);
    restrict_params(mesh_fine, mesh_coarse, param, level) -> coarse
    param."""
    param: Any
    get_operator: Callable
    restrict_params: Callable | None = None

    def operator(self, mesh):
        if self.restrict_params is None:
            return self.get_operator(mesh)
        return self.get_operator(mesh, self.param)

    def restricted(self, mesh_f, mesh_c, level):
        if self.restrict_params is None:
            return self
        new_param = self.restrict_params(mesh_f, mesh_c, self.param, level)
        return OperatorConstructor(new_param, self.get_operator,
                                   self.restrict_params)


class _LazySparseList:
    """Per-level transfer matrices, made on first access.

    The flat P/R (a kron of the 1D factors) are read only by the flat
    engine and by tests: the grid engine applies the transfers from the 1D
    factors.  Entries are sparse matrices or 0-argument thunks making one."""

    def __init__(self):
        self._items = []

    def append(self, item):
        self._items.append(item)

    def __getitem__(self, i):
        it = self._items[i]
        if callable(it):
            it = self._items[i] = it()
        return it

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return (self[i] for i in range(len(self._items)))


@dataclass(eq=False)
class MGState:
    """Host-side solver handle: config, host matrices, device hierarchy."""
    config: MGConfig
    relax_param: Any
    As: list            # host CSR per level
    Ps: Any             # host CSR prolongations (coarse -> fine)
    Rs: Any             # host CSR restrictions (fine -> coarse)
    meshes: list
    device: Any = None             # torch.device the hierarchy lives on
    hier: Any = None               # GridHierarchy | Hierarchy
    A_input: Any = None            # fine operator at its ORIGINAL precision
    coarse_solver: Any = None      # external coarsest solver, if any
    do_transpose: int = 0          # 1 while the hierarchy holds A^H
    time_setup: float = 0.0
    time_solve: float = 0.0
    setup_times: dict = field(default_factory=dict)   # host s per stage
    n_iter: int = 0
    _gs_cache: dict = field(default_factory=dict, repr=False)
    _fw_separable: bool = field(default=False, repr=False)
    _outer_ops: dict = field(default_factory=dict, repr=False)
    _lo_hier: Any = field(default=None, repr=False)

    @property
    def num_levels(self) -> int:
        return len(self.As)

    @property
    def nnz_per_level(self) -> list:
        return [int(a.nnz) for a in self.As]

    def operator_complexity(self) -> float:
        return sum(a.nnz for a in self.As) / max(self.As[0].nnz, 1)


# ---------------------------------------------------------------------------
# relaxation setup dispatch
# ---------------------------------------------------------------------------

def _setup_relax(A: sp.spmatrix, cfg: MGConfig, relax_param, mesh):
    rt = cfg.relax_type
    if rt in ("jacobi", "jac-gmres"):
        return sm.jacobi_prec(A, relax_param, dtype=cfg.dtype)
    if rt == "spai":
        return sm.spai_prec(A, relax_param, dtype=cfg.dtype)
    if rt in ("chebyshev", "chebyshev4"):
        return sm.chebyshev_prec(A, relax_param, dtype=cfg.dtype)
    if rt == "line-jacobi":
        return sm.line_prec(A, mesh, relax_param, dtype=cfg.dtype)
    if rt in VANKA_TYPES:
        return sm.setup_vanka(A, mesh, relax_param, cfg.mixed, rt,
                              dtype=cfg.dtype)
    if rt == "hybrid-kaczmarz":
        from ..cycle.kaczmarz import setup_hybrid_kaczmarz
        from ..dd.indices import nodal_indices_of_box
        opts = relax_param          # a KaczmarzOptions-like mapping
        return setup_hybrid_kaczmarz(
            A, mesh, opts["num_domains"],
            opts.get("index_fn", nodal_indices_of_box),
            opts.get("omega", 0.8), opts.get("num_it", 1), dtype=cfg.dtype)
    raise NotImplementedError(f"relax_type {rt!r} not yet ported")


class _RelaxThunk:
    """Deferred relaxation setup (resolved when the hierarchy is built).
    The grid engines rebuild smoother state in grid form (the systems
    engine makes its Vanka inverses itself), so the flat Vanka tables are
    only made when the flat engine is taken."""

    def __init__(self, *args):
        self._args = args
        self._val = None

    def resolve(self):
        if self._val is None:
            self._val = _setup_relax(*self._args)
            self._args = None
        return self._val


def _resolve_relax(rs):
    return rs.resolve() if isinstance(rs, _RelaxThunk) else rs


def _per_level_relax_param(relax_param, levels: int):
    if isinstance(relax_param, (list, tuple)) and not np.isscalar(relax_param):
        if len(relax_param) == levels and all(
                np.isscalar(v) or isinstance(v, tuple) for v in relax_param):
            return list(relax_param)
    return [relax_param] * levels


def _check_ported(cfg: MGConfig) -> None:
    """Raise for configuration options this port does not have."""
    from ..cycle.grid_cycle import GRID_RELAX
    checks = [
        (cfg.transfer_type in ("full-weighting", "semicoarsening")
         + SYSTEMS_TRANSFERS, f"transfer_type {cfg.transfer_type!r}"),
        (cfg.relax_type in GRID_RELAX + VANKA_TYPES + ("hybrid-kaczmarz",),
         f"relax_type {cfg.relax_type!r}"),
        (cfg.cycle_type in ("V", "W", "F", "K"),
         f"cycle_type {cfg.cycle_type!r}"),
        (cfg.coarse_solve in ("lu", "gmres", "external"),
         f"coarse_solve {cfg.coarse_solve!r}"),
    ]
    for ok, what in checks:
        if not ok:
            raise NotImplementedError(f"{what} not yet ported")


def _semicoarsen_axes(gs, theta: float = 0.25) -> list:
    """Per-MESH-axis coarsening flags: coarsen the axes whose pure-axis
    coupling is within `theta` of the strongest (the robust-MG
    semicoarsening rule).  gs: host grid stencil of the level operator."""
    coeff = np.asarray(gs.coeff)
    dim = len(gs.grid)
    strength = np.zeros(dim)
    for k, off in enumerate(gs.offsets):
        nz = [a for a, d in enumerate(off) if d != 0]
        if len(nz) == 1 and abs(off[nz[0]]) == 1:
            ga = nz[0]
            strength[dim - 1 - ga] = max(strength[dim - 1 - ga],
                                         float(np.abs(coeff[k]).mean()))
    smax = strength.max() if dim else 0.0
    return [bool(sv >= theta * smax and sv > 0) for sv in strength]


def _to_device_matrix(A: sp.spmatrix, dtype, prefer_dia: bool = True,
                      device="cpu"):
    """DIA where its stored size stays within 3x the nonzeros (at most 40
    diagonals), else ELL."""
    from ..ops.dia import dia_from_scipy
    from ..ops.ell import ell_from_scipy
    if prefer_dia:
        D = dia_from_scipy(A, dtype=dtype, max_diags=40, device=device)
        if D is not None and D.data.numel() <= 3 * A.nnz:
            return D
    return ell_from_scipy(A.tocsr(), dtype=dtype, device=device)


def _relax_to(rs, dtype, device):
    """A host smoother state with its diagonal (or its Vanka or Kaczmarz
    tables) as tensors on `device`."""
    from ..cycle.kaczmarz import KaczmarzRelax
    from ..cycle.relax import ChebyshevRelax, DiagRelax
    from ..cycle.vanka import VankaRelax
    if isinstance(rs, (VankaRelax, KaczmarzRelax)):
        return rs.to(dtype, device)
    d = torch.as_tensor(np.asarray(rs.d), device=device).to(dtype)
    if isinstance(rs, ChebyshevRelax):
        return ChebyshevRelax(d, rs.lam_max)
    if isinstance(rs, DiagRelax):
        return DiagRelax(d)
    raise ValueError(f"the flat engine takes diagonal smoothers, got "
                     f"{type(rs).__name__}")


def _setup_coarse(state: MGState, verbose: bool = False):
    """The flat engine's coarsest solver (reference defineCoarsestAinv,
    MGsetup.jl:323-355)."""
    from ..cycle import coarse as co
    from ..cycle import grid_cycle as gc
    cfg, dev = state.config, state.device
    A_c = state.As[-1]
    if state.coarse_solver is not None:
        mesh_c = state.meshes[-1] if state.meshes else None
        return state.coarse_solver.setup_coarse(A_c, mesh_c, device=dev)
    if cfg.coarse_solve == "gmres":
        rp = _per_level_relax_param(state.relax_param, cfg.levels)[-1]
        omega = rp if np.isscalar(rp) else 1.0
        return co.iterative_coarse_from_scipy(
            A_c, omega, inner=cfg.gmres_coarse_inner, dtype=cfg.dtype,
            device=dev)
    if A_c.shape[0] > gc.DENSE_LU_MAX:
        if verbose:
            print(f"_setup_coarse: nc={A_c.shape[0]} > {gc.DENSE_LU_MAX}, "
                  "using the host SuperLU coarsest (a host round trip per "
                  "solve)")
        return co.sparse_lu_from_scipy(A_c, dtype=cfg.dtype)
    return co.dense_lu_from_scipy(A_c, dtype=cfg.dtype, device=dev)


def build_device_hierarchy(state: MGState, relax_states: list,
                           verbose: bool = False):
    """The device hierarchy on `state.device`: the grid engine when the
    configuration allows it and the hierarchy is a grid one, else the flat
    ELL/DIA engine (see the module docstring for ``engine``)."""
    cfg = state.config
    if cfg.engine not in ("auto", "grid", "flat"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.engine in ("auto", "grid"):
        from ..cycle.grid_cycle import build_grid_hierarchy
        from ..cycle.systems_grid import build_systems_grid_hierarchy
        build = (build_systems_grid_hierarchy
                 if cfg.transfer_type in SYSTEMS_TRANSFERS
                 else build_grid_hierarchy)
        try:
            gh = build(state, relax_states, state.device)
            if verbose:
                print("build_device_hierarchy: using the grid stencil engine")
            return gh
        except ValueError as e:
            if cfg.engine == "grid":
                raise ValueError(f"engine='grid' not applicable: {e}") from e
    from ..ops.ell import ell_from_scipy
    dev, dt = state.device, torch_dtype(cfg.dtype)
    # DIA for the pointwise smoothers; the other states read rows
    prefer_dia = cfg.relax_type in ("jacobi", "jac-gmres", "spai")
    nlev = state.num_levels
    levels = []
    for l in range(nlev):
        A_dev = _to_device_matrix(state.As[l], cfg.dtype, prefer_dia, dev)
        if l < nlev - 1:
            P_dev = ell_from_scipy(state.Ps[l].tocsr(), dtype=cfg.dtype,
                                   device=dev)
            R_dev = ell_from_scipy(state.Rs[l].tocsr(), dtype=cfg.dtype,
                                   device=dev)
            levels.append(Level(A_dev, P_dev, R_dev, _relax_to(
                _resolve_relax(relax_states[l]), dt, dev)))
        else:
            levels.append(Level(A_dev, None, None, None))
    if verbose:
        print("build_device_hierarchy: using the flat ELL/DIA engine")
    return Hierarchy(tuple(levels), _setup_coarse(state, verbose))


# ---------------------------------------------------------------------------
# geometric multigrid setup (Galerkin RAP on the matrix path)
# ---------------------------------------------------------------------------

def mg_setup(A_or_ctor, mesh: RegularMesh, cfg: MGConfig, relax_param=None,
             coarse_solver=None, verbose: bool = False,
             device=None) -> MGState:
    """Build a geometric hierarchy (full-weighting, semicoarsening or
    staggered systems transfers) on `mesh` and move it to `device` ("cuda"
    unless the caller asks for the CPU; raises when no card is present) on
    the engine `cfg.engine` selects.

    `A_or_ctor` is the operator as a scipy sparse matrix (Galerkin coarse
    operators) or an `OperatorConstructor` (each level re-discretized on
    its mesh).  `coarse_solver` is an external coarsest solver with
    `setup_coarse(A_c, mesh_c, device=)` (DirectSolver, DDSolver,
    SchurComplementSolver); the grid engines refuse it, so under
    ``engine="auto"`` such a hierarchy runs on the flat engine."""
    t_all = time.perf_counter()
    dev = resolve_device(device)
    _check_ported(cfg)
    systems = cfg.transfer_type in SYSTEMS_TRANSFERS
    if relax_param is None:
        relax_param = 1.0
    geometric = isinstance(A_or_ctor, OperatorConstructor)
    ctor = A_or_ctor if geometric else None
    A = sp.csr_matrix(ctor.operator(mesh) if geometric else A_or_ctor)
    A_input = A
    A = A.astype(cfg.dtype)

    from ..ops.grid_stencil import grid_stencil_from_csr, structured_fw_rap
    rp_arr = _per_level_relax_param(relax_param, cfg.levels)
    As, meshes, relax_states = [A], [mesh], []
    Ps, Rs = _LazySparseList(), _LazySparseList()
    n = np.asarray(mesh.n)
    levels = cfg.levels
    gs_cache: dict = {}

    def host_stencil(l):
        gs = gs_cache.get(l)
        if gs is None:
            gs = gs_cache[l] = grid_stencil_from_csr(As[l], list(n + 1))
        return gs

    def coarse_operator(l, mesh_c, galerkin):
        """Level l + 1's operator: re-discretized by the constructor, else
        `galerkin()`."""
        nonlocal ctor
        if ctor is None:
            return galerkin()
        ctor = ctor.restricted(meshes[l], mesh_c, l)
        return sp.csr_matrix(ctor.operator(mesh_c))

    times: dict = {}
    for l in range(cfg.levels - 1):
        t0 = time.perf_counter()
        A_l = As[l]
        sc_axes = None                   # mesh-axis coarsening flags (semi)
        if systems:
            P, R, nc = tr.linear_operators_systems_faces(list(n), cfg.mixed)
            if P.shape[0] == P.shape[1]:
                if verbose:
                    print(f"mg_setup: stopped coarsening at level {l}")
                levels = l + 1
                break
            relax_states.append(_RelaxThunk(A_l, cfg, rp_arr[l], meshes[l]))
            Ps.append(P.tocsr())
            Rs.append(((0.5 ** mesh.dim) * R).tocsr())
            meshes.append(get_regular_mesh(meshes[l].domain, nc))
            t1 = time.perf_counter()
            times["transfers"] = times.get("transfers", 0.0) + t1 - t0
            As.append(coarse_operator(
                l, meshes[-1], lambda: (Rs[l] @ A_l @ Ps[l]).tocsr()
            ).astype(cfg.dtype))
            times["rap"] = times.get("rap", 0.0) + time.perf_counter() - t1
            if verbose:
                print(f"mg_setup: level {l} ({int(np.prod(n))} cells) took "
                      f"{time.perf_counter() - t0:.3f}s")
            n = np.asarray(nc)
            continue
        if cfg.transfer_type == "semicoarsening":
            # coarsen only the strongly coupled axes
            try:
                sc_axes = _semicoarsen_axes(host_stencil(l))
            except ValueError as e:
                raise ValueError(
                    "transfer_type='semicoarsening' needs a grid-stencil "
                    f"operator (strong-axis detection): {e}") from e
            p1s, nc1s = [], []
            for a, nd in enumerate(n + 1):
                nd = int(nd)
                if sc_axes[a] and nd % 2 == 1 and nd >= 5:
                    P1, c1 = tr.fw_interp_1d(nd)
                else:
                    sc_axes[a] = False
                    P1, c1 = sp.identity(nd, format="csr"), nd
                p1s.append(P1)
                nc1s.append(c1)
            stop = not any(sc_axes)
            d_c = int(sum(sc_axes))
        else:
            # re-discretization keeps integer cells: an even node count
            # stops coarsening (fw_interp_1d's geometric mode)
            p1s, nc1s = zip(*(tr.fw_interp_1d(int(nd), geometric)
                              for nd in (n + 1)))
            stop = all(m.shape[0] == m.shape[1] for m in p1s)
            d_c = mesh.dim
        nc = np.asarray(nc1s, dtype=np.int64) - 1
        if stop:
            if verbose:
                print(f"mg_setup: stopped coarsening at level {l}")
            levels = l + 1
            break
        relax_states.append(_RelaxThunk(A_l, cfg, rp_arr[l], meshes[l]))
        # the flat P and R = 0.5^c P^T, made only when read
        Ps.append(lambda ms=tuple(p1s): tr._kron_nd(list(ms)))
        Rs.append(lambda ms=tuple(p1s), d=d_c:
                  ((0.5 ** d) * tr._kron_nd(list(ms)).T).tocsr())
        meshes.append(get_regular_mesh(meshes[l].domain, nc))

        def galerkin():
            # structured stencil RAP on the grid-form coefficients (which
            # the grid engine reuses via the cache); scipy's triple product
            # where the operator is not a +-1 stencil on odd grids
            try:
                gs_f = host_stencil(l)
                dim_g = len(gs_f.grid)
                rap_axes = (None if sc_axes is None else
                            tuple(dim_g - 1 - a
                                  for a, c in enumerate(sc_axes) if c))
                gs_c = structured_fw_rap(gs_f, axes=rap_axes)
                gs_cache[l + 1] = gs_c
                A_c = gs_c.to_scipy().tocsr()
                A_c.eliminate_zeros()   # boundary non-entries
                return A_c
            except ValueError:
                return (Rs[l] @ A_l @ Ps[l]).tocsr()

        As.append(coarse_operator(l, meshes[-1], galerkin).astype(cfg.dtype))
        if verbose:
            print(f"mg_setup: level {l} ({int(np.prod(n))} cells) took "
                  f"{time.perf_counter() - t0:.3f}s")
        n = np.asarray(nc)

    cfg = replace(cfg, levels=levels,
                  nu_pre=cfg.nu_pre[:levels], nu_post=cfg.nu_post[:levels])
    state = MGState(cfg, relax_param, As, Ps, Rs, meshes, device=dev,
                    A_input=A_input, coarse_solver=coarse_solver,
                    setup_times=times)
    state._gs_cache = {k: v for k, v in gs_cache.items()
                       if v.coeff.dtype == np.dtype(cfg.dtype)}
    # the full-weighting transfers built above are the separable
    # fw_interp factors the grid engine applies; on the re-discretization
    # path (geometric factors) the grid engine checks them first
    state._fw_separable = (cfg.transfer_type in ("full-weighting",
                                                 "semicoarsening")
                           and not geometric)
    state.hier = build_device_hierarchy(state, relax_states, verbose)
    state.time_setup += time.perf_counter() - t_all
    return state


# ---------------------------------------------------------------------------
# lifecycle (reference MGsetup.jl:226-318, MGdef.jl:138-210)
# ---------------------------------------------------------------------------

def hierarchy_exists(state: MGState | None) -> bool:
    return state is not None and state.hier is not None and len(state.As) > 0


def _rebuild(state: MGState, relax_states, verbose: bool) -> None:
    """A new device hierarchy for the state's host levels; the old one's
    recorded programs (and their memory pool) go with it."""
    from ..cycle import capture
    old, state.hier = state.hier, None
    if old is not None:
        capture.forget(old)
    del old
    state._outer_ops, state._lo_hier = {}, None
    state.hier = build_device_hierarchy(state, relax_states, verbose)


def replace_matrix_in_hierarchy(state: MGState, A: sp.spmatrix,
                                verbose: bool = False) -> MGState:
    """Re-setup for a new matrix of the same sparsity and geometry, reusing
    the transfers (reference replaceMatrixInHierarchy, MGsetup.jl:226-270).
    Where the transfers are mg_setup's separable full-weighting factors the
    coarse operators come from the structured stencil RAP (two scipy
    SpGEMMs a level otherwise), and its stencils seed the grid engine."""
    from ..ops.grid_stencil import grid_stencil_from_csr, structured_fw_rap
    state._gs_cache = {}        # the host stencils are stale
    cfg = state.config
    t_all = time.perf_counter()
    rp_arr = _per_level_relax_param(state.relax_param, cfg.levels)
    As = [sp.csr_matrix(A).astype(cfg.dtype)]
    state.A_input = sp.csr_matrix(A)
    relax_states = []
    use_rap = (cfg.transfer_type == "full-weighting" and state._fw_separable
               and bool(state.meshes))
    for l in range(state.num_levels - 1):
        mesh_l = state.meshes[l] if state.meshes else None
        relax_states.append(_RelaxThunk(As[l], cfg, rp_arr[l], mesh_l))
        A_c = None
        if use_rap:
            try:
                gs_f = state._gs_cache.get(l)
                if gs_f is None:
                    n_l = np.asarray(state.meshes[l].n)
                    gs_f = grid_stencil_from_csr(As[l], list(n_l + 1))
                    state._gs_cache[l] = gs_f
                gs_c = structured_fw_rap(gs_f)
                state._gs_cache[l + 1] = gs_c
                A_c = gs_c.to_scipy().tocsr().astype(cfg.dtype)
                A_c.eliminate_zeros()
            except ValueError:
                use_rap = False
                A_c = None
        if A_c is None:
            A_c = (state.Rs[l] @ As[l] @ state.Ps[l]).tocsr().astype(
                cfg.dtype)
        As.append(A_c)
    state._gs_cache = {k: v for k, v in state._gs_cache.items()
                       if v.coeff.dtype == np.dtype(cfg.dtype)}
    state.As = As
    _rebuild(state, relax_states, verbose)
    state.do_transpose = 0
    state.time_setup += time.perf_counter() - t_all
    return state


def transpose_hierarchy(state: MGState, verbose: bool = False) -> MGState:
    """Flip the hierarchy to solve A^H x = b (reference
    transposeHierarchy, MGsetup.jl:274-318): every level conjugate-
    transposed, P and R swapped, the smoothers and the coarsest made
    anew.  Pointwise relaxations only, as in the reference."""
    state._gs_cache = {}
    if state.config.relax_type not in ("jacobi", "jac-gmres", "spai"):
        raise NotImplementedError(
            "transpose is supported for pointwise relaxations only "
            "(same restriction as the reference, MGsetup.jl:288-291)")
    t_all = time.perf_counter()
    state.As = [a.conj().T.tocsr() for a in state.As]
    if state.A_input is not None:
        state.A_input = state.A_input.conj().T.tocsr()
    new_Ps = [r.conj().T.tocsr() for r in state.Rs]
    new_Rs = [p.conj().T.tocsr() for p in state.Ps]
    state.Ps, state.Rs = new_Ps, new_Rs
    cfg = state.config
    rp_arr = _per_level_relax_param(state.relax_param, cfg.levels)
    relax_states = [
        _RelaxThunk(state.As[l], cfg, rp_arr[l],
                    state.meshes[l] if state.meshes else None)
        for l in range(state.num_levels - 1)]
    _rebuild(state, relax_states, verbose)
    state.do_transpose = (state.do_transpose + 1) % 2
    state.time_setup += time.perf_counter() - t_all
    return state


def copy_solver(state: MGState) -> MGState:
    """The configuration without the setup (reference copySolver,
    MGdef.jl:138-145)."""
    return MGState(state.config, state.relax_param, [], [], [], [],
                   device=state.device, coarse_solver=state.coarse_solver)


def clear(state: MGState) -> None:
    """Drop the hierarchy and its factors (reference clear! /
    destroyCoarsestLU, MGdef.jl:179-206); the device memory is freed with
    the last reference, the recorded programs with the hierarchy."""
    from ..cycle import capture
    if state.hier is not None:
        capture.forget(state.hier)
    state.As, state.Ps, state.Rs, state.meshes = [], [], [], []
    state.hier = None
    state._outer_ops, state._lo_hier = {}, None
    state._gs_cache = {}
