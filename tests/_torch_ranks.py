"""What the ranks of the multi-device tests run (mgtpu_torch only).

The CPU tests of mgtpu_torch/parallel/ and dd/parallel.py spawn gloo ranks
(parallel/launch.py::run_ranks); each rank imports this module to unpickle
its function, so it imports torch, numpy, scipy and mgtpu_torch and
nothing else (no JAX: a rank does not pay for it).  Each function runs all
of one test file's cases for one rank group and returns numpy arrays; the
test files hold them against mgtpu.  The problems are made here from seeds,
so the parent builds the same inputs for mgtpu.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

import mgtpu_torch as mt
from mgtpu_torch.models.operators import (nodal_div_sig_grad_matrix,
                                          nodal_laplacian_matrix)

DEADLINE_S = 60.0          # a rank group that has not finished fails


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def poisson(n: int, dim: int = 2, shift: float = 1e-4):
    """The n^dim-cell nodal Laplacian + shift * (max column sum) I."""
    M = mt.get_regular_mesh([0.0, 1.0] * dim, [n] * dim)
    L = nodal_laplacian_matrix(M)
    return M, (L + shift * abs(L).sum(axis=0).max()
               * sp.identity(L.shape[0])).tocsr()


def divsig(n: int, seed: int = 3, scale: float = 0.3, shift: float = 1e-4):
    """mgtpu's test_sharded_variable_coefficients_multirhs operator."""
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(scale * np.random.RandomState(seed).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    return M, (A + shift * abs(A).sum(axis=0).max()
               * sp.identity(A.shape[0])).tocsr()


def params(levels: int, dtype, **kw):
    """Jacobi 0.8 V(1,1), mgtpu's sharded tests' configuration."""
    kw.setdefault("max_outer_iter", 5)
    kw.setdefault("relative_tol", 1e-12)
    return dict(levels=levels, relax_type="jacobi", relax_param=0.8,
                nu_pre=1, nu_post=1, dtype=dtype, **kw)


def setup(M, A, **kw):
    cfg, rp = mt.get_mg_param(**kw)
    return mt.mg_setup(A, M, cfg, rp, device="cpu")


def rhs(A, m=None, seed=1):
    """A @ rand, normalised (m columns, or a vector)."""
    rng = np.random.RandomState(seed)
    b = A @ (rng.rand(A.shape[0]) if m is None else rng.rand(A.shape[0], m))
    return b / np.linalg.norm(b)


def slab_field(m: int, nj: int, ni: int, seed: int = 7, dtype=np.float64):
    return np.random.RandomState(seed).rand(m, nj, ni).astype(dtype)


# slab tier problems: name -> (cells a side, levels)
SLAB_CASES = {"poisson": (32, 3), "poisson3d": (16, 3), "divsig": (32, 3)}
CONVERGE = (128, 4)        # mgtpu's test_sharded_converges_to_contract
HALO_NI = 5                # in-plane width of the halo cases


def slab_problem(name):
    n, levels = SLAB_CASES[name]
    if name == "poisson":
        M, A = poisson(n)
        return M, A, levels, rhs(A)
    if name == "poisson3d":
        M, A = poisson(n, dim=3)
        return M, A, levels, rhs(A)
    M, A = divsig(n)
    return M, A, levels, rhs(A, 2, seed=5)


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------

def _slab(full, world, rank):
    s = full.shape[-2] // world
    return torch.tensor(full[..., rank * s:(rank + 1) * s, :].copy())


def parallel_cases(rank, world, device):
    """tests/test_torch_parallel.py: the halo exchange, the slab apply in
    its fused and overlapped forms, the transfers, the slab cycle."""
    from mgtpu_torch.parallel import stencil as ps
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.sharded import (build_sharded_mg,
                                              make_sharded_solver)
    comm = RankGrid(None, "gloo")
    out = {}
    # halo exchange: widths 1 and 2 on a (2, 4 world, NI) field
    full = slab_field(2, 4 * world, HALO_NI)
    x = _slab(full, world, rank)
    out["halo1"] = ps.exchange_halo(x, comm).numpy()
    out["halo2"] = comm.exchange_halo(x, 0, 2, dim=-2).numpy()
    out["bcast"] = comm.broadcast(torch.full((3,), float(rank)),
                                  src=world - 1).numpy()

    # the slab apply on the fine level of the 2D problem; S = 1 slabs too
    M, A, levels, b = slab_problem("poisson")
    state = setup(M, A, **params(levels, np.float64))
    mg = build_sharded_mg(state, world, rank, np.float64, device)
    lvl = mg.levels[0]
    xs = _slab(slab_field(2, lvl.slab * world, lvl.plan.NI, seed=8),
               world, rank)
    fused = ps.stencil_matvec_local(lvl.coeff, lvl.di, lvl.dj,
                                    ps.exchange_halo(xs, comm))
    over = ps.stencil_matvec_overlapped(lvl.coeff, lvl.di, lvl.dj, xs, comm)
    out["apply_fused"], out["apply_over"] = fused.numpy(), over.numpy()
    c1 = lvl.coeff[:, :1].contiguous()
    x1 = xs[:, :1].contiguous()
    out["s1_fused"] = ps.stencil_matvec_local(
        c1, lvl.di, lvl.dj, ps.exchange_halo(x1, comm)).numpy()
    out["s1_over"] = ps.stencil_matvec_overlapped(c1, lvl.di, lvl.dj, x1,
                                                  comm).numpy()
    # transfers on level 0 (fields zero in the pad, as in a cycle): R r
    # from a halo-extended slab, P xc
    r = slab_field(1, lvl.slab * world, lvl.plan.NI, seed=9)
    r[:, lvl.plan.NJ:] = 0
    out["restrict"] = ps.restrict_local(
        ps.exchange_halo(_slab(r, world, rank), comm), lvl.plan, lvl.masks,
        lvl.ds_map, lvl.slab // 2).numpy()
    xc = slab_field(1, lvl.slab // 2 * world, lvl.plan.NIc, seed=10)
    xc[:, lvl.plan.NJc:] = 0
    xc = _slab(xc, world, rank)
    out["prolong"] = ps.prolong_local(xc, lvl.plan, lvl.masks, lvl.ds_map,
                                      comm, lvl.slab).numpy()

    # one slab cycle of each problem, f64, and its residual norm
    for name in SLAB_CASES:
        M, A, levels, b = slab_problem(name)
        state = setup(M, A, **params(levels, np.float64))
        mg, step, to_grid, from_grid = make_sharded_solver(
            state, comm, dtype=np.float64, device=device)
        bg = to_grid(b)
        xg, rn = step(mg, bg, torch.zeros_like(bg))
        out[f"cycle_{name}"] = from_grid(xg).numpy()
        out[f"rn_{name}"] = float(rn)
    # five cycles at 128^2, 4 levels (mgtpu's convergence contract)
    M, A = poisson(CONVERGE[0])
    b = rhs(A)
    state = setup(M, A, **params(CONVERGE[1], np.float64))
    mg, step, to_grid, from_grid = make_sharded_solver(
        state, comm, dtype=np.float64, device=device)
    bg, xg = to_grid(b), to_grid(np.zeros_like(b))
    for _ in range(5):
        xg, rn = step(mg, bg, xg)
    out["converge"] = from_grid(xg).numpy()[:, 0]
    out["sent"] = dict(comm.sent)
    return out


# grid-sharded problems (mgtpu's test_grid_sharded.py, test_sharded_solve.py)
CYCLE_N, CYCLE_LEVELS = 32, 3
SOLVE_N, SOLVE_LEVELS = 32, 3
# the other smoothers and cycle shapes the sharded grid engine takes:
# name -> (relax_type, relax_param, cycle_type)
CYCLE_OPTIONS = {"chebyshev-W": ("chebyshev", 1.0, "W"),
                 "chebyshev4-V": ("chebyshev4", 1.0, "V"),
                 "spai-F": ("spai", 1.0, "F")}


def cycle_params(option):
    """The cycle problem's parameters, f64, with `option`'s smoother and
    cycle shape."""
    relax, rp, ctype = CYCLE_OPTIONS[option]
    p = params(CYCLE_LEVELS, np.float64)
    p.update(relax_type=relax, relax_param=rp, cycle_type=ctype)
    return p


def grid_sharded_cases(rank, world, device, shape):
    """tests/test_torch_grid_sharded.py: three grid-sharded cycles and the
    refined solve on a slab or pencil rank grid; on a slab the Krylov
    solves too (mgtpu's tests run them on a slab mesh)."""
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.grid_sharded import make_grid_sharded_cycle
    from mgtpu_torch.parallel.sharded_solve import make_sharded_refined_solver
    comm = RankGrid(shape, "gloo")
    axes = tuple(range(len(comm.shape)))
    out = {}
    M, A = poisson(CYCLE_N)
    state = setup(M, A, **params(CYCLE_LEVELS, np.float64))
    gh, cycle, to_grid, from_grid = make_grid_sharded_cycle(state, comm, axes,
                                                            device)
    bg = to_grid(np.random.RandomState(3).rand(A.shape[0], 2))
    xg = torch.zeros_like(bg)
    for _ in range(3):
        xg = cycle(gh, bg, xg)
    out["cycle"] = from_grid(xg).numpy()
    for option in CYCLE_OPTIONS:
        st = setup(M, A, **cycle_params(option))
        gh, cycle, to_grid, from_grid = make_grid_sharded_cycle(st, comm,
                                                                axes, device)
        xg = torch.zeros_like(bg)
        for _ in range(2):
            xg = cycle(gh, bg, xg)
        out[option] = from_grid(xg).numpy()

    M, A = poisson(SOLVE_N)
    state = setup(M, A, **params(SOLVE_LEVELS, np.float32,
                                 max_outer_iter=40, relative_tol=1e-6))
    solver = make_sharded_refined_solver(state, comm, axes, device)
    b = rhs(A, seed=1)
    x, info = solver.solve_refined(b, tol=1e-8)
    out["refined"] = (x, info["iters"], info["resvec"])
    B = np.random.RandomState(2).rand(A.shape[0], 3)
    x, info = solver.solve_refined(B, tol=1e-8)
    out["refined_multi"] = (x, info["iters"])
    x, info = solver.solve_refined(b, tol=1e-8, cycle_dtype=np.float64)
    out["refined_f64_cycles"] = (x, int(info["iters"]))
    if len(comm.shape) > 1:
        out["sent"] = dict(comm.sent)
        return out
    b = np.random.RandomState(3).rand(A.shape[0])
    b /= np.linalg.norm(b)
    for name in ("solve_fgmres", "solve_cg", "solve_bicgstab"):
        x, info = getattr(solver, name)(b, tol=1e-8, max_iter=30)
        out[name] = (x, int(info["iters"]))
    b32 = np.random.RandomState(4).rand(A.shape[0]).astype(np.float32)
    x, info = solver.solve_fgmres(b32, tol=1e-6, max_iter=30)
    out["fgmres_f32"] = (x, int(info["iters"]))
    rng = np.random.RandomState(5)
    base = rng.rand(A.shape[0], 1)
    B = base + 0.05 * rng.rand(A.shape[0], 3)
    out["block_cg"] = tuple(
        (x, int(info["iters"])) for x, info in
        (solver.solve_cg(B, tol=1e-8, max_iter=30, block=blk)
         for blk in (True, False)))
    out["sent"] = dict(comm.sent)
    return out


DD_N, DD_DOMAINS, DD_OVERLAP = 32, (4, 4), (1, 1)


def dd_cases(rank, world, device):
    """tests/test_torch_dd.py's parallel case: one sharded sweep from zero,
    and FGMRES(5) preconditioned by it (mgtpu's test_dd.py:79)."""
    from mgtpu_torch.dd.parallel import dd_parallel_preconditioner
    from mgtpu_torch.dd.schwarz import DDSolver
    from mgtpu_torch.krylov import fgmres
    from mgtpu_torch.ops.ell import ell_from_scipy
    from mgtpu_torch.parallel.comm import RankGrid
    comm = RankGrid(None, "gloo")
    M, A = poisson(DD_N)
    dd = DDSolver(M, list(DD_DOMAINS), list(DD_OVERLAP), layout="nodal",
                  device=device).setup(A)
    prec = dd_parallel_preconditioner(dd, comm, device)
    b = rhs(A, seed=6)
    x = prec(torch.tensor(b, device=device))
    E = ell_from_scipy(A, dtype=np.float64, device=device)
    mv = lambda v: E.matvec(v.T).T
    B = torch.tensor(b, device=device)[None]
    X, info = fgmres(mv, B, restart=5, prec=lambda v: prec(v.T).T,
                     tol=1e-8, max_iter=10, device_loop=False)
    return {"sweep": x.cpu().numpy(), "x": X[0].cpu().numpy(),
            "restarts": int(info["iters"]), "sent": dict(comm.sent)}


def sleeper(rank, world, device, seconds):
    """A rank that outlives its deadline (the launcher's hang test)."""
    import time
    time.sleep(seconds)
    return rank


def failer(rank, world, device):
    """Rank 1 raises (the launcher's failure test)."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


# ---------------------------------------------------------------------------
# the systems tier (tests/test_torch_systems_sharded.py)
# ---------------------------------------------------------------------------

# cycle cases: name -> (cells a side, dim, levels, mixed, relax_type, nu)
SYSTEMS_CYCLES = {"mixed": (16, 2, 3, True, "VankaFaces", 1),
                  "econ": (16, 2, 3, True, "EconVankaFaces", 1),
                  "add": (16, 2, 3, True, "VankaFacesAdd", 1),
                  "spai": (16, 2, 3, False, "SPAI", 2),
                  "mixed3d": (8, 3, 3, True, "VankaFaces", 1)}
SYSTEMS_SOLVE = (32, 2, 3, True, "VankaFaces", 1)


def elasticity(n: int, dim: int = 2, mixed: bool = True,
               shift: float = 1e-3):
    """(Mixed) linear elasticity, mu = lambda = 1, on n^dim cells + shift *
    (max column sum) I (mgtpu's tests/test_systems_sharded.py)."""
    from mgtpu_torch.models.operators import (
        linear_elasticity_operator, linear_elasticity_operator_mixed)
    M = mt.get_regular_mesh([0.0, 1.0] * dim, [n] * dim)
    mu = np.ones(M.num_cells)
    A = (linear_elasticity_operator_mixed if mixed
         else linear_elasticity_operator)(M, mu, mu)
    return M, (A + shift * abs(A).sum(axis=0).max()
               * sp.identity(A.shape[0])).tocsr()


def systems_params(levels: int, mixed: bool, relax: str, nu: int, dtype,
                   **kw):
    return dict(levels=levels, relax_type=relax, relax_param=0.75,
                nu_pre=nu, nu_post=nu, dtype=dtype,
                transfer_type=("SystemsFacesMixedLinear" if mixed
                               else "SystemsFacesLinear"), **kw)


def systems_case(name, dtype=np.float64, **kw):
    n, dim, levels, mixed, relax, nu = (SYSTEMS_CYCLES.get(name)
                                        or SYSTEMS_SOLVE)
    M, A = elasticity(n, dim, mixed)
    return M, A, systems_params(levels, mixed, relax, nu, dtype, **kw)


def _pad_is_zero(xs, lay, true_grids, comm) -> bool:
    """Every plane of the gathered padded fields past the true grids (the
    pad, the dead slots among them) is exactly zero."""
    ok = True
    for c, (x, g) in enumerate(zip(xs, true_grids)):
        full = lay.gather(x, c, comm)
        ok &= bool((full[:, g[0]:] == 0).all())
    return ok


def systems_sharded_cases(rank, world, device, ref_padded):
    """tests/test_torch_systems_sharded.py: two sharded cycles of every
    SYSTEMS_CYCLES case (f64, 2 right-hand sides), the same from mgtpu's
    padded arrays (`ref_padded`, made for `world` ranks), the refined solve
    of SYSTEMS_SOLVE (f32; one and two columns), and the K-cycle
    refusal."""
    from mgtpu_torch.convert import sharded_systems_from_arrays
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.sharded_solve import make_sharded_systems_solver
    from mgtpu_torch.parallel.systems_sharded import (
        make_systems_sharded_cycle)
    comm = RankGrid(None, "gloo")
    out = {"shift": tuple(comm.shift(torch.full((2,), float(rank)),
                                     step=s).numpy() for s in (1, -1))}
    comm.reset_counts()
    for name in SYSTEMS_CYCLES:
        M, A, p = systems_case(name)
        st = setup(M, A, **p)
        gh, cycle, to_fields, from_fields = make_systems_sharded_cycle(
            st, comm, device)
        bf = to_fields(np.random.RandomState(3).rand(A.shape[0], 2))
        xf = tuple(torch.zeros_like(t) for t in bf)
        for _ in range(2):
            xf = cycle(gh, bf, xf)
        out[name] = from_fields(xf).numpy()
        out[f"{name}_pad_zero"] = _pad_is_zero(
            xf, gh.levels[0].A.layout, st.hier.fine_grids, comm)
        if name == "mixed":
            levels, inv, true_grids = ref_padded
            gh2 = sharded_systems_from_arrays(levels, inv, true_grids, comm,
                                              device=device)
            xf = tuple(torch.zeros_like(t) for t in bf)
            for _ in range(2):
                xf = cycle(gh2, bf, xf)
            out["convert"] = from_fields(xf).numpy()
    # K-cycles, refused until the cycles took a reduce hook: one from zero
    M, A, p = systems_case("mixed", cycle_type="K")
    gh, cycle, to_fields, from_fields = make_systems_sharded_cycle(
        setup(M, A, **p), comm, device)
    bf = to_fields(np.random.RandomState(3).rand(A.shape[0], 2))
    out["K"] = from_fields(cycle(gh, bf, tuple(torch.zeros_like(t)
                                               for t in bf), True)).numpy()
    M, A, p = systems_case("solve", np.float32, max_outer_iter=40)
    solver = make_sharded_systems_solver(setup(M, A, **p), comm, device)
    x, info = solver.solve_refined(rhs(A, seed=9), tol=1e-8)
    out["refined"] = (x, int(info["iters"]), info["resvec"])
    B = np.random.RandomState(10).rand(A.shape[0], 2)
    x, info = solver.solve_refined(B, tol=1e-8)
    out["refined_multi"] = (x, int(info["iters"]))
    x, info = solver.solve_refined(rhs(A, seed=9), tol=1e-8,
                                   cycle_dtype=np.float64)
    out["refined_f64_cycles"] = (x, int(info["iters"]))
    out["sent"] = dict(comm.sent)
    return out


# ---------------------------------------------------------------------------
# kernel D's block form on sharded levels (tests/test_torch_block_stencil.py)
# ---------------------------------------------------------------------------

BLOCK_CASES = ("mixed", "mixed3d")


def block_fields(grids, m: int, seed: int):
    """(m, *grid) float64 fields of every component, from one seed."""
    rng = np.random.RandomState(seed)
    return [rng.rand(m, *g) for g in grids]


def block_stencil_cases(rank, world, device):
    """tests/test_torch_block_stencil.py: on every level of BLOCK_CASES'
    hierarchies (f64), the sharded level operator's residual b - A x and
    apply A x of block_fields(seeds 80 + l, 90 + l) padded and cut into
    this rank's blocks (the dead slots zero), gathered back to the padded
    fields: {(case, level): (r, y)}, per component (m, padded extent,
    ...)."""
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.systems_sharded import (_pad_axis,
                                                      pad_systems_hierarchy,
                                                      shard_block_operator)
    comm = RankGrid(None, "gloo")
    out = {}
    for name in BLOCK_CASES:
        st = setup(*systems_case(name)[:2], **systems_case(name)[2])
        gh_pad, _ = pad_systems_hierarchy(st.hier, world)
        for l, (lv, lp) in enumerate(zip(st.hier.levels, gh_pad.levels)):
            sop = shard_block_operator(lp.A, comm, device)
            lay = sop.layout

            def local(fs):
                return tuple(lay.local(_pad_axis(torch.from_numpy(f),
                                                 pg[0], 1), c, 1)
                             for c, (f, pg) in enumerate(zip(fs,
                                                             lp.A.grids)))

            xs = local(block_fields(lv.A.grids, 2, 80 + l))
            bs = local(block_fields(lv.A.grids, 2, 90 + l))
            out[(name, l)] = tuple(
                [lay.gather(t, c, comm).numpy() for c, t in enumerate(v)]
                for v in (sop.residual(bs, xs), sop.matvec(xs)))
    return out


# ---------------------------------------------------------------------------
# the row-sharded flat tier (tests/test_torch_sharded_amg.py)
# ---------------------------------------------------------------------------

AMG_N = 64
# cycle cases: name -> (setup, hierarchy dtype, cycle type)
AMG_CYCLES = {"sa": ("sa", np.float32, "V"), "cl": ("cl", np.float32, "V"),
              "sa64": ("sa", np.float64, "V"),
              "cl64": ("cl", np.float64, "V"),
              "sa64-K": ("sa", np.float64, "K"),
              "sa64-W": ("sa", np.float64, "W"),
              "sa-K": ("sa", np.float32, "K"),
              "sa-W": ("sa", np.float32, "W")}


def amg_problem(n: int = AMG_N):
    """mgtpu's tests/test_sharded_amg.py operator: nodal DivSigGrad with
    sigma = exp(RandomState(0).randn) + 1e-4 (max column sum) I."""
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(np.random.RandomState(0).randn(n * n))
    L = nodal_div_sig_grad_matrix(M, sig)
    return (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()


def amg_params(dtype, **kw):
    """Jacobi 0.8 V(1,1), 4 levels (mgtpu's _amg_state)."""
    kw.setdefault("relax_type", "jacobi")
    return dict(levels=4, relax_param=0.8, nu_pre=1, nu_post=1, dtype=dtype,
                max_outer_iter=60, relative_tol=1e-8, **kw)


def amg_setup(kind, L, **p):
    cfg, rp = mt.get_mg_param(**p)
    if kind == "sa":
        return mt.sa_amg_setup(L, cfg, rp, device="cpu")
    return mt.classical_amg_setup(L, cfg, rp, coarsening="pmis",
                                  device="cpu")


def _refuses(fn) -> bool:
    try:
        fn()
    except ValueError as e:
        return "pointwise" in str(e) or "grid engine" in str(e)
    return False


def sharded_amg_cases(rank, world, device, ref_padded):
    """tests/test_torch_sharded_amg.py: one cycle of every AMG_CYCLES case
    (ShardedAMGSolver.cycle for the f32 V-cycles, recursive_cycle on
    shard_flat_hierarchy's levels else, with the pad rows of its result),
    one from mgtpu's padded arrays (`ref_padded`), the refined solves and
    FGMRES, and the refusals."""
    from mgtpu_torch.convert import sharded_flat_from_arrays
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.sharded_amg import (ShardedAMGSolver,
                                                  shard_flat_hierarchy)
    comm = RankGrid(None, "gloo")
    L = amg_problem()
    n = L.shape[0]
    b = np.random.RandomState(2).rand(n, 2)
    out = {}
    states = {}
    for name, (kind, dt, ctype) in AMG_CYCLES.items():
        st = amg_setup(kind, L, **amg_params(dt, cycle_type=ctype))
        states[name] = st
        if dt == np.float32 and ctype == "V":
            out[name] = ShardedAMGSolver(st, comm, device).cycle(
                b.astype(dt))
            continue
        hier = shard_flat_hierarchy(st.hier, comm, device)
        n_pad = hier.levels[0].A.shape[0]
        bp = torch.zeros((n_pad, 2), dtype=torch.float64 if dt == np.float64
                         else torch.float32)
        bp[:n] = torch.tensor(b)
        y = mt.recursive_cycle(st.config, hier, bp, torch.zeros_like(bp))
        out[name] = y[:n].numpy()
        out[f"{name}_pad_zero"] = bool((y[n:] == 0).all())
    levels, coarse, nc = ref_padded
    hier = sharded_flat_from_arrays(levels, coarse, nc, comm, device=device)
    bp = torch.zeros((hier.levels[0].A.shape[0], 2), dtype=torch.float32)
    bp[:n] = torch.tensor(b)
    out["convert"] = mt.recursive_cycle(states["sa"].config, hier, bp,
                                        torch.zeros_like(bp))[:n].numpy()
    b3 = rhs(L, seed=3)
    for name in ("sa", "cl"):
        x, info = ShardedAMGSolver(states[name], comm, device).solve_refined(
            b3, tol=1e-8, max_iter=80)
        out[f"refined_{name}"] = (x, int(info["iters"]))
    x, info = ShardedAMGSolver(states["sa"], comm, device).solve_fgmres(
        rhs(L, seed=4).astype(np.float32), tol=1e-5, max_iter=10)
    out["fgmres"] = (x, int(info["iters"]))
    jg = amg_setup("sa", L, **amg_params(np.float32, relax_type="jac-gmres",
                                         cycle_type="K"))
    out["refuses_jacgmres"] = _refuses(
        lambda: ShardedAMGSolver(jg, comm, device))
    lex = setup(*elasticity(8), **systems_params(2, True, "VankaFacesLex", 1,
                                                 np.float32))
    out["refuses_vanka"] = _refuses(
        lambda: shard_flat_hierarchy(lex.hier, comm, device))
    M, A = poisson(16)
    grid = setup(M, A, **params(2, np.float32))
    out["refuses_grid"] = _refuses(
        lambda: ShardedAMGSolver(grid, comm, device))
    out["sent"] = dict(comm.sent)
    return out


# ---------------------------------------------------------------------------
# the partitioned flat tier (tests/test_torch_part_amg.py)
# ---------------------------------------------------------------------------

# mgtpu's tests/test_part_amg.py cases: name -> (cells a side, dim, sigma
# seed, parameters, cycle b seed, refined (b seed, tol, max_iter) or None)
PART_CASES = {
    "spai": (48, 2, 1, dict(levels=3, relax_type="spai"), 2, (3, 1e-8, 40)),
    "cheb": (40, 2, 1, dict(levels=3, relax_type="chebyshev",
                            cheby_degree=2, nu_pre=1, nu_post=1), None,
             (4, 1e-8, 60)),
    "kcycle": (48, 2, 1, dict(levels=3, relax_type="jac-gmres",
                              relax_param=1.0, nu_pre=1, nu_post=1,
                              cycle_type="K"), 7, (8, 1e-8, 40)),
    "sparselu": (48, 2, 1, dict(levels=3, relax_type="spai"), 9, None),
    "gmres": (48, 2, 1, dict(levels=3, relax_type="spai",
                             coarse_solve="gmres"), 15, (16, 1e-6, 60)),
    "3d": (20, 3, 11, dict(levels=3, relax_type="spai"), 12, (13, 1e-8, 60)),
}
PART_MULTI_P = 50               # rows a rank of the multi-distance plan
PART_MULTI_DIAGS = [(0, 4.0), (1, -1.0), (-1, -1.0), (75, -0.5),
                    (-75, -0.5), (125, -0.25), (-125, -0.25)]


def part_operator(n: int, dim: int = 2, seed: int = 1):
    """mgtpu's test_part_amg.py operator: nodal DivSigGrad with sigma =
    exp(RandomState(seed).randn) per cell + 1e-8 (max column sum) I."""
    M = mt.get_regular_mesh([0.0, 1.0] * dim, [n] * dim)
    sig = np.exp(np.random.RandomState(seed).randn(n ** dim))
    A = nodal_div_sig_grad_matrix(M, sig)
    return (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()


def part_case(name):
    """(operator, get_mg_param keywords) of a PART_CASES entry (float32)."""
    n, dim, seed, p, *_ = PART_CASES[name]
    return part_operator(n, dim, seed), dict(p, dtype=np.float32)


def part_state(name, device="cpu"):
    """The port's SA state of a PART_CASES entry; "sparselu" swaps in the
    host SuperLU coarsest, as mgtpu's test does."""
    import dataclasses
    from mgtpu_torch.cycle.coarse import sparse_lu_from_scipy
    A, p = part_case(name)
    cfg, rp = mt.get_mg_param(**p)
    st = mt.sa_amg_setup(A, cfg, rp, device=device)
    if name == "sparselu":
        st.hier = dataclasses.replace(st.hier, coarse=sparse_lu_from_scipy(
            st.As[-1], dtype=np.float32))
    return A, st


def part_rhs(A, seed):
    """A @ RandomState(seed).rand(n), normalised (the refined b)."""
    b = A @ np.random.RandomState(seed).rand(A.shape[0])
    return b / np.linalg.norm(b)


def part_multi_matrix(world: int):
    """mgtpu's multi-distance operator on world * PART_MULTI_P rows."""
    n = world * PART_MULTI_P
    return sp.csr_matrix(sum(sp.diags(np.full(n - abs(o), v), o,
                                      shape=(n, n))
                             for o, v in PART_MULTI_DIAGS if abs(o) < n))


def part_amg_cases(rank, world, device, ref_arrays):
    """tests/test_torch_part_amg.py: for every PART_CASES entry the
    partitioned solver's cycle from zero (and with an explicit zero x, its
    bytes), its refined solve, its halo plan's sizes and vector rows; the
    multi-distance plan's apply through the ring permute; one cycle from
    mgtpu's own plan arrays (`ref_arrays`, built for `world` devices)."""
    from mgtpu_torch.convert import partitioned_flat_from_arrays
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.part_amg import (PartitionedAMGSolver,
                                               part_ell, partition_plan)
    from mgtpu_torch.parallel.sharded_amg import pad_flat_hierarchy
    comm = RankGrid(None, "gloo")
    out = {}
    for name, (*_, cyc_seed, refined) in PART_CASES.items():
        A, st = part_state(name)
        solver = PartitionedAMGSolver(st, comm, device)
        out[f"{name}_comm"] = solver.comm_entries_per_cycle()
        out[f"{name}_rows"] = solver.local_vector_rows()
        out[f"{name}_coarse"] = type(solver.hier.coarse).__name__
        if cyc_seed is not None:
            b = np.random.RandomState(cyc_seed).rand(A.shape[0]).astype(
                np.float32)
            sent = dict(comm.sent)
            out[name] = solver.cycle(b)
            zero = {k: v - sent[k] for k, v in comm.sent.items()}
            sent = dict(comm.sent)
            out[f"{name}_explicit"] = solver.cycle(b, np.zeros_like(b))
            out[f"{name}_bytes"] = (zero, {k: v - sent[k] for k, v in
                                           comm.sent.items()})
            bl, _ = solver.to_block(b)
            y = mt.recursive_cycle(st.config, solver.hier, bl,
                                   torch.zeros_like(bl), x_zero=True)
            pad = solver.n_true - rank * solver.p[0]
            out[f"{name}_pad_zero"] = bool((y[max(pad, 0):] == 0).all())
            bt = torch.tensor(b[:, None])
            out[f"{name}_single"] = mt.recursive_cycle(
                st.config, st.hier, bt, torch.zeros_like(bt))[:, 0].numpy()
            out[f"{name}_ell"] = mt.recursive_cycle(
                st.config, pad_flat_hierarchy(st.hier, 1), bt,
                torch.zeros_like(bt), x_zero=True)[:, 0].numpy()
        if refined is not None:
            seed, tol, max_iter = refined
            x, info = solver.solve_refined(part_rhs(A, seed), tol=tol,
                                           max_iter=max_iter)
            out[f"{name}_refined"] = (x, int(info["iters"]),
                                      float(info["relres"]))
    # the multi-distance plan, applied through the ring permute
    Am = part_multi_matrix(world)
    idx3, val3, dists, sends, H = partition_plan(
        Am, world, PART_MULTI_P, PART_MULTI_P, np.float32)
    op = part_ell(idx3, val3, dists, sends, (PART_MULTI_P,
                                             PART_MULTI_P + H), comm, device)
    xm = np.random.RandomState(21).rand(Am.shape[0], 1).astype(np.float32)
    xb = torch.tensor(xm[rank * PART_MULTI_P:(rank + 1) * PART_MULTI_P])
    out["multi"] = (torch.cat(list(comm.all_gather(op.matvec(xb)))).numpy(),
                    dists)
    # one cycle on mgtpu's own plan arrays: its solver's (SPAI, f32), and
    # the K-cycle's plan of its float64 state (mgtpu's solver takes f32
    # only; the f64 cycle holds the reduce hook to 1e-10)
    A, st = part_state("spai")
    solver = PartitionedAMGSolver(st, comm, device)
    for key, name, dt in (("convert", "spai", np.float32),
                          ("kcycle64", "kcycle", np.float64)):
        levels, coarse = ref_arrays[key]
        hier = partitioned_flat_from_arrays(levels, coarse, comm,
                                            device=device)
        A, p = part_case(name)
        cfg, _ = mt.get_mg_param(**dict(p, dtype=dt))
        b = np.random.RandomState(PART_CASES[name][4]).rand(A.shape[0])
        bl, _ = solver.to_block(b, torch.float64 if dt == np.float64
                                else torch.float32)
        y = mt.recursive_cycle(cfg, hier, bl, torch.zeros_like(bl),
                               x_zero=True)
        out[key] = solver.from_block(y, True)
    out["sent"] = dict(comm.sent)
    return out


# ---------------------------------------------------------------------------
# Jac-GMRES and K-cycles on the sharded grid and systems engines
# (tests/test_torch_sharded_kcycle.py)
# ---------------------------------------------------------------------------

KCYCLE_N, KCYCLE_LEVELS = 32, 4
# grid options: name -> (relax_type, relax_param, cycle_type)
KCYCLE_OPTIONS = {"jacgmres-V": ("jac-gmres", 1.0, "V"),
                  "jacobi-K": ("jacobi", 0.8, "K"),
                  "jacgmres-K": ("jac-gmres", 1.0, "K")}
KCYCLE_SYSTEMS = (32, 2, 4, True, "VankaFaces", 1)


def kcycle_params(option, dtype=np.float64, **kw):
    """The grid problem's parameters with `option`'s smoother and cycle."""
    relax, rp, ctype = KCYCLE_OPTIONS[option]
    p = params(KCYCLE_LEVELS, dtype, **kw)
    p.update(relax_type=relax, relax_param=rp, cycle_type=ctype)
    return p


def kcycle_systems_case(dtype=np.float64, **kw):
    """KCYCLE_SYSTEMS's operator and K-cycle parameters."""
    n, dim, levels, mixed, relax, nu = KCYCLE_SYSTEMS
    M, A = elasticity(n, dim, mixed)
    return M, A, systems_params(levels, mixed, relax, nu, dtype,
                                cycle_type="K", **kw)


def _dead_slot_max(A, xs) -> float:
    """The largest |entry| in the dead slots of block fields xs (planes of a
    component past its owned ones on this rank)."""
    return max((float(x.narrow(1, w, x.shape[1] - w).abs().max())
                for x, w in zip(xs, A.layout.owned) if x.shape[1] > w),
               default=0.0)


def sharded_kcycle_cases(rank, world, device, shape):
    """tests/test_torch_sharded_kcycle.py: two f64 cycles from zero of each
    KCYCLE_OPTIONS entry on the grid engine (slab or pencil) and whether
    their pad is zero; the f32 Jac-GMRES K-cycle's refined solve, FGMRES,
    CG and BiCGSTAB; on a slab also two f64
    systems K-cycles with the dead slot of every Krylov vector z, A z
    and right-hand side recorded, and the systems refined solve."""
    import mgtpu_torch.cycle.systems_grid as sg
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.grid_sharded import (_gather,
                                                   make_grid_sharded_cycle)
    from mgtpu_torch.parallel.sharded_solve import (
        make_sharded_refined_solver, make_sharded_systems_solver)
    from mgtpu_torch.parallel.systems_sharded import (
        make_systems_sharded_cycle)
    comm = RankGrid(shape, "gloo")
    axes = tuple(range(len(comm.shape)))
    out = {}
    M, A = poisson(KCYCLE_N)
    b2 = np.random.RandomState(3).rand(A.shape[0], 2)
    for option in KCYCLE_OPTIONS:
        st = setup(M, A, **kcycle_params(option))
        gh, cycle, to_grid, from_grid = make_grid_sharded_cycle(st, comm,
                                                                axes, device)
        bg = to_grid(b2)
        xg = cycle(gh, bg, torch.zeros_like(bg), True)
        xg = cycle(gh, bg, xg)
        out[option] = from_grid(xg).numpy()
        full = _gather(xg, comm, gh.levels[0].A.shard, 1)
        n0, n1 = st.hier.fine_grid
        out[f"{option}_pad_zero"] = bool((full[:, n0:] == 0).all()
                                         and (full[:, :, n1:] == 0).all())
    st = setup(M, A, **kcycle_params("jacgmres-K", np.float32,
                                     max_outer_iter=40))
    solver = make_sharded_refined_solver(st, comm, axes, device)
    b = rhs(A, seed=1)
    x, info = solver.solve_refined(b, tol=1e-8)
    out["refined"] = (x, int(info["iters"]))
    bk = np.random.RandomState(3).rand(A.shape[0])
    bk /= np.linalg.norm(bk)
    for name in ("solve_fgmres", "solve_cg", "solve_bicgstab"):
        x, info = getattr(solver, name)(bk, tol=1e-8, max_iter=30)
        out[name] = (x, int(info["iters"]))
    if len(comm.shape) > 1:
        out["sent"] = dict(comm.sent)
        return out

    # the systems engine: K-cycles with every FGMRES watched
    dead, calls = [], []
    fgmres_fields = sg._fields_fgmres

    def watched(Aop, prec, bb, inner, reduce=None):
        calls.append(reduce is not None)
        dead.append(_dead_slot_max(Aop, bb))

        def prec_w(v):
            z = prec(v)
            dead.append(_dead_slot_max(Aop, z))
            dead.append(_dead_slot_max(Aop, Aop.matvec(z)))
            return z

        return fgmres_fields(Aop, prec_w, bb, inner, reduce)

    Ms, As, ps = kcycle_systems_case()
    st = setup(Ms, As, **ps)
    gh, cycle, to_fields, from_fields = make_systems_sharded_cycle(
        st, comm, device)
    bf = to_fields(np.random.RandomState(3).rand(As.shape[0], 2))
    sg._fields_fgmres = watched
    try:
        xf = cycle(gh, bf, tuple(torch.zeros_like(t) for t in bf), True)
        xf = cycle(gh, bf, xf)
    finally:
        sg._fields_fgmres = fgmres_fields
    out["systems"] = from_fields(xf).numpy()
    out["systems_pad_zero"] = _pad_is_zero(xf, gh.levels[0].A.layout,
                                           st.hier.fine_grids, comm)
    out["systems_dead"] = (max(dead), len(calls), all(calls))
    Ms, As, ps = kcycle_systems_case(np.float32, max_outer_iter=40)
    solver = make_sharded_systems_solver(setup(Ms, As, **ps), comm, device)
    x, info = solver.solve_refined(rhs(As, seed=9), tol=1e-8)
    out["systems_refined"] = (x, int(info["iters"]))
    out["sent"] = dict(comm.sent)
    return out


# ---------------------------------------------------------------------------
# kernel D's halo form (tests/test_torch_halo_form.py)
# ---------------------------------------------------------------------------

HALO_GRIDS = {"2d": (32, 2), "3d": (16, 3)}   # cells a side, dimension
HALO_LEVELS = 3
HALO_MS = (1, 2, 5)
HALO_DTYPES = (np.float64, np.float32)


def halo_inputs(grid, m: int, seed: int, dtype):
    """(x, b), each (m, *grid), from one seed."""
    rng = np.random.RandomState(seed)
    return (rng.rand(m, *grid).astype(dtype),
            rng.rand(m, *grid).astype(dtype))


def padded_block_grid(op, comm) -> tuple:
    """The padded global grid of a rank's ShardedGridStencil."""
    pad = list(op.grid)
    for ga, ra in op.shard:
        pad[ga] *= comm.axis_size(ra)
    return tuple(pad)


def halo_form_cases(rank, world, device, shape):
    """tests/test_torch_halo_form.py: on the rank grid `shape`, every level
    of the grid-sharded hierarchies of HALO_GRIDS (f64 and f32): the
    ShardedGridStencil's residual and matvec of halo_inputs on this rank's
    blocks, gathered back to the padded grid, and whether residual is
    bitwise b - matvec; on a slab layout also the slab GMG's residual and
    Jacobi sweep (parallel/sharded.py) on every level of the slab cases
    poisson and poisson3d, gathered, and whether each is bitwise the fused
    exchange + `stencil_matvec_local` and torch's subtraction or
    update."""
    from mgtpu_torch.parallel import sharded as psh
    from mgtpu_torch.parallel import stencil as ps
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.grid_sharded import (_gather, _local,
                                                   make_grid_sharded_cycle)
    comm = RankGrid(shape, "gloo")
    axes = tuple(range(len(comm.shape)))
    out = {}
    for name, (n, dim) in HALO_GRIDS.items():
        M, A = poisson(n, dim)
        for dt in HALO_DTYPES:
            st = setup(M, A, **params(HALO_LEVELS, dt))
            gh = make_grid_sharded_cycle(st, comm, axes, device)[0]
            for l, lvl in enumerate(gh.levels):
                op = lvl.A
                for m in HALO_MS:
                    x, b = halo_inputs(padded_block_grid(op, comm), m,
                                       10 * l + m, dt)
                    xs = _local(torch.from_numpy(x), comm, op.shard, 1)
                    bs = _local(torch.from_numpy(b), comm, op.shard, 1)
                    r, y = op.residual(bs, xs), op.matvec(xs)
                    out[("grid", name, np.dtype(dt).name, l, m)] = (
                        _gather(r, comm, op.shard, 1).numpy(),
                        _gather(y, comm, op.shard, 1).numpy(),
                        bool(torch.equal(r, bs - y)))
    if len(comm.shape) > 1:
        return out

    def gather(t):
        return torch.cat(list(comm.all_gather(t, 0)), dim=-2).numpy()

    for name in ("poisson", "poisson3d"):
        M, A, levels, _ = slab_problem(name)
        for dt in HALO_DTYPES:
            st = setup(M, A, **params(levels, dt))
            mg = psh.build_sharded_mg(st, world, rank, dt, device)
            for l, lvl in enumerate(mg.levels):
                for m in HALO_MS:
                    x, b = halo_inputs((lvl.slab * world, lvl.plan.NI), m,
                                       20 + 10 * l + m, dt)
                    xs, bs = _slab(x, world, rank), _slab(b, world, rank)
                    r = psh._residual(lvl, bs, xs, comm, 0)
                    xj = psh._relax(lvl, xs, bs, 1, comm, 0)
                    y = ps.stencil_matvec_local(lvl.coeff, lvl.di, lvl.dj,
                                                ps.exchange_halo(xs, comm))
                    out[("slab", name, np.dtype(dt).name, l, m)] = (
                        gather(r), gather(xj),
                        bool(torch.equal(r, bs - y)),
                        bool(torch.equal(xj, xs + lvl.d * (bs - y))))
    return out
