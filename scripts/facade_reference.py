"""Reference counts of the façade, direct, DD and Kaczmarz contracts, from
mgtpu (JAX) on the CPU, and the port's counts beside mgtpu's at a small
size.

Rows (their full sizes; b = A RandomState(4).rand(n), normalised, in
float64 unless named):

    W        (f)'s operator (1024^2 cells, sigma = exp(RandomState(3).randn),
             + 1e-8 (max column sum) I), 6 levels, f32, SPAI V(2,2),
             relative_tol 1e-8, max_outer_iter 100; B = A RandomState(4)
             .rand(n, 4), columns normalised; MGSolver with krylov gmres
             (inner 5), pcg, bicgstab: iterations a column
    W-3d     the 128^3 shifted Laplacian (+ 1e-4 (max column sum) I), 5
             levels, f32, SPAI V(2,2), MGSolver(krylov="pcg")
    W-amg    512^2, sigma from RandomState(5), 4 levels, f32, SPAI V(2,2);
             B from RandomState(6), 4 columns; SAAMGSolver and
             ClassicalAMGSolver under pcg
    W-adj    the 1024^2 Laplacian + 1e-3 (max column sum) I + the 0.05
             convection band (test_coverage_extra.py:167), 6 levels, f32,
             Jacobi 0.7 V(1,1), MGSolver(sym=0, krylov="gmres",
             gmres_inner=10): solve, transpose=True, solve again
    R        the 1024^2 shifted Laplacian, Jacobi 0.8 V(1,1), 6 levels,
             f32: replace_matrix_in_hierarchy with 1.7 L, L, 1.7 L, L
             (bench.py:269-280), then solve_mg_refined (tol 1e-8)
    R-sigma  (f)'s state (Jacobi 0.8 V(1,1), relative_tol 1e-8,
             max_outer_iter 100) replaced by sigma' = exp(RandomState(7)
             .randn), then solve_cg_mg; and a fresh mg_setup on sigma'
    D-coarse the 1024^2 shifted Laplacian, 6 levels, Jacobi 0.8 V(1,1), f32,
             coarse_solver=DirectSolver("dense"), solve_mg_refined
    DD-256   the 256^2 Laplacian + 1e-4 (max column sum) I, f64,
             DDSolver(M, [8, 8], [2, 2], "nodal"), solve_linear_system(
             tol=1e-8, max_iter=200, restart=5): restarts
    DD-coarse test_dd.py:101's problem at 1024^2, Jacobi 0.8 V(1,1), 6
             levels, f32, coarse_solver=DDSolver(None, [2, 2], [1, 1]),
             solve_mg_refined
    K-mg     256^2, sigma = exp(0.3 RandomState(3).randn), + 1e-4 shift, 4
             levels, f64, hybrid Kaczmarz [4, 4], omega 0.8, num_it 2,
             V(1,1), solve_mg (relative_tol 1e-8, max_outer_iter 60)
    K-prec   test_dd.py:115 at 256^2 (sigma = exp(RandomState(3).randn),
             + 0.2 shift), [4, 4], omega 0.8, num_it 5, FGMRES (restart 5,
             tol 1e-10, max_iter 3) preconditioned by make_kaczmarz_precond;
             B = A RandomState(4).rand(n, 2), normalised
    bf16     the 3D 128^3 Jacobi 0.8 V(1,1) path, 5 levels, f32,
             solve_mg_refined(cycle_dtype=bfloat16)
    RD       test_coverage_extra.py:190 at 512^2 cells: mixed elasticity
             re-discretized with coefficient coarsening, VankaFaces 0.75
             V(1,1), 6 levels, f32, solve_mg_refined

Each run prints the iteration count, the true float64 relative residual
(scipy) and the seconds.

    python scripts/facade_reference.py [--rows W W-3d ...] [--cells 1024]
        [--cells3d 128] [--packages mgtpu port]

`--cells` / `--cells3d` shrink the 2D / 3D meshes (one level less for each
halving, two at least; DD-256, K-mg, K-prec and RD scale with --cells as
their share of 1024); `--packages port` runs the PyTorch port (mgtpu_torch,
on the CPU) on the same inputs.  At the full sizes mgtpu takes minutes and
a few GB a row.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = ("W", "W-3d", "W-amg", "W-adj", "R", "R-sigma", "D-coarse", "DD-256",
        "DD-coarse", "K-mg", "K-prec", "bf16", "RD")


def package(name: str):
    """(the package, its solver modules, keyword arguments for its entry
    points)."""
    if name == "mgtpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import mgtpu as pkg
        from mgtpu.cycle import kaczmarz
        from mgtpu.dd import indices, schwarz
        return pkg, (kaczmarz, indices, schwarz), {}
    import mgtpu_torch as pkg
    from mgtpu_torch.cycle import kaczmarz
    from mgtpu_torch.dd import indices, schwarz
    return pkg, (kaczmarz, indices, schwarz), {"device": "cpu"}


def levels_for(full_levels: int, full_cells: int, cells: int) -> int:
    lv, c = full_levels, full_cells
    while c > cells and lv > 2:
        c //= 2
        lv -= 1
    return lv


def shifted(A, s):
    return (A + s * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
            ).tocsr()


def laplacian(dims, shift=1e-4):
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    import mgtpu_torch as mt
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    return shifted(nodal_laplacian_matrix(M), shift)


def divsig(dims, shift=1e-8, seed=3, scale=1.0):
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    import mgtpu_torch as mt
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    sig = np.exp(scale * np.random.RandomState(seed).randn(M.num_cells))
    return shifted(nodal_div_sig_grad_matrix(M, sig), shift)


def rhs(A, m=None, seed=4):
    rng = np.random.RandomState(seed)
    if m is None:
        b = A @ rng.rand(A.shape[0])
        return b / np.linalg.norm(b)
    B = A @ rng.rand(A.shape[0], m)
    return B / np.linalg.norm(B, axis=0)


def relres(A, b, x) -> float:
    xh = np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x,
                    dtype=np.float64)
    return float(np.max(np.linalg.norm(b - A @ xh, axis=0)
                        / np.linalg.norm(b, axis=0)))


def report(tag, what, iters, rr, t0):
    print(f"[{tag}] {what} {iters}, true f64 relres {rr:.3e}, "
          f"{time.perf_counter() - t0:.1f} s (CPU)", flush=True)


def row(key, cells, cells3d, pname):
    pkg, (kz, ddi, sw), kw = package(pname)
    lv2 = lambda full: levels_for(full, 1024, cells)
    tag = f"{pname} {key} {cells}^2/{cells3d}^3"
    mesh = lambda dims: pkg.get_regular_mesh([0.0, 1.0] * len(dims),
                                             list(dims))
    t0 = time.perf_counter()
    if key == "W":
        dims = [cells, cells]
        A = divsig(dims)
        B = rhs(A, 4)
        cfg, rp = pkg.get_mg_param(levels=lv2(6), dtype=np.float32,
                                   relative_tol=1e-8, max_outer_iter=100)
        for k in ("gmres", "pcg", "bicgstab"):
            t0 = time.perf_counter()
            s = pkg.MGSolver(cfg, rp, mesh=mesh(dims), krylov=k, **kw)
            X = s.solve_linear_system(A, B)
            report(tag, f"MGSolver({k}) iterations a column",
                   s.n_iter // 4, relres(A, B, X), t0)
    elif key == "W-3d":
        dims = [cells3d] * 3
        A = laplacian(dims)
        b = rhs(A)
        cfg, rp = pkg.get_mg_param(levels=levels_for(5, 128, cells3d),
                                   dtype=np.float32, relative_tol=1e-8,
                                   max_outer_iter=100)
        s = pkg.MGSolver(cfg, rp, mesh=mesh(dims), krylov="pcg", **kw)
        x = s.solve_linear_system(A, b)
        report(tag, "MGSolver(pcg) iterations", s.n_iter, relres(A, b, x),
               t0)
    elif key == "W-amg":
        n = max(cells // 2, 16)
        A = divsig([n, n], seed=5)
        B = rhs(A, 4, seed=6)
        cfg, rp = pkg.get_mg_param(levels=levels_for(4, 512, n),
                                   dtype=np.float32, relative_tol=1e-8,
                                   max_outer_iter=100)
        for cls in (pkg.SAAMGSolver, pkg.ClassicalAMGSolver):
            t0 = time.perf_counter()
            s = cls(cfg, rp, krylov="pcg", **kw)
            X = s.solve_linear_system(A, B)
            report(tag, f"{cls.__name__}(pcg) iterations a column",
                   s.n_iter // 4, relres(A, B, X), t0)
    elif key == "W-adj":
        dims = [cells, cells]
        L = laplacian(dims, 0.0)
        n = L.shape[0]
        opn1 = abs(L).sum(axis=0).max()
        C = sp.diags([np.ones(n - 1)], [1], shape=(n, n)) * (0.05 * opn1 / 8)
        A = (L + 1e-3 * opn1 * sp.identity(n) + C).tocsr()
        b = rhs(A)
        cfg, rp = pkg.get_mg_param(levels=lv2(6), max_outer_iter=20,
                                   relative_tol=1e-8, relax_type="jacobi",
                                   relax_param=0.7, nu_pre=1, nu_post=1,
                                   dtype=np.float32)
        s = pkg.MGSolver(cfg, rp, mesh=mesh(dims), sym=0, krylov="gmres",
                         gmres_inner=10, **kw)
        for i, tr in enumerate((False, True, False)):
            t0 = time.perf_counter()
            before = s.n_iter
            x = s.solve_linear_system(A, b, transpose=tr)
            Ax = A.conj().T if tr else A
            report(tag, f"solve {i + 1} (transpose={tr}) restarts",
                   s.n_iter - before, relres(Ax, b, x), t0)
    elif key in ("R", "D-coarse", "DD-coarse"):
        dims = [cells, cells]
        A = laplacian(dims)
        b = rhs(A)
        cfg, rp = pkg.get_mg_param(levels=lv2(6), relax_type="jacobi",
                                   relax_param=0.8, nu_pre=1, nu_post=1,
                                   dtype=np.float32)
        coarse = {"R": None,
                  "D-coarse": lambda: pkg.DirectSolver("dense"),
                  "DD-coarse": lambda: sw.DDSolver(None, [2, 2], [1, 1],
                                                   layout="nodal")}[key]
        st = pkg.mg_setup(A, mesh(dims), cfg, rp,
                          coarse_solver=None if coarse is None else coarse(),
                          **kw)
        if key == "R":
            for A_new in ((1.7 * A).tocsr(), A, (1.7 * A).tocsr(), A):
                t1 = time.perf_counter()
                pkg.replace_matrix_in_hierarchy(st, A_new)
                print(f"[{tag}] replace {time.perf_counter() - t1:.2f} s",
                      flush=True)
        t0 = time.perf_counter()
        x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
        report(tag, f"{type(st.hier).__name__}: refined iterations",
               info["iters"], relres(A, b, x), t0)
    elif key == "R-sigma":
        dims = [cells, cells]
        A = divsig(dims)
        A2 = divsig(dims, seed=7)
        b = rhs(A2)
        cfg, rp = pkg.get_mg_param(levels=lv2(6), relax_type="jacobi",
                                   relax_param=0.8, nu_pre=1, nu_post=1,
                                   dtype=np.float32, relative_tol=1e-8,
                                   max_outer_iter=100)
        st = pkg.mg_setup(A, mesh(dims), cfg, rp, **kw)
        pkg.replace_matrix_in_hierarchy(st, A2)
        x, info = pkg.solve_cg_mg(st, b)
        report(tag, "replaced: CG iterations", int(info["iters"]),
               relres(A2, b, x), t0)
        t0 = time.perf_counter()
        st = pkg.mg_setup(A2, mesh(dims), cfg, rp, **kw)
        x, info = pkg.solve_cg_mg(st, b)
        report(tag, "fresh setup: CG iterations", int(info["iters"]),
               relres(A2, b, x), t0)
    elif key == "DD-256":
        n = max(cells // 4, 32)
        A = laplacian([n, n])
        b = rhs(A)
        dd = sw.DDSolver(mesh([n, n]), [8, 8], [2, 2], layout="nodal",
                         **kw).setup(A)
        print(f"[{tag}] setup {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        x, info = dd.solve_linear_system(A, b, tol=1e-8, max_iter=200,
                                         restart=5)
        report(tag, f"{n}^2: restarts", info["iters"], relres(A, b, x), t0)
    elif key == "K-mg":
        n = max(cells // 4, 32)
        A = divsig([n, n], shift=1e-4, scale=0.3)
        b = rhs(A)
        cfg, _ = pkg.get_mg_param(levels=levels_for(4, 256, n),
                                  relax_type="hybridKaczmarzNodal",
                                  nu_pre=1, nu_post=1, relative_tol=1e-8,
                                  max_outer_iter=60)
        rp = {"num_domains": [4, 4], "omega": 0.8, "num_it": 2,
              "index_fn": ddi.nodal_indices_of_box}
        st = pkg.mg_setup(A, mesh([n, n]), cfg, rp, **kw)
        print(f"[{tag}] setup {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        x, info = pkg.solve_mg(st, b)
        report(tag, f"{n}^2: cycles", info["iters"], relres(A, b, x), t0)
    elif key == "K-prec":
        n = max(cells // 4, 32)
        A = divsig([n, n], shift=2e-1, seed=3)
        B = A @ np.random.RandomState(4).rand(A.shape[0], 2)
        B /= np.linalg.norm(B)
        k = kz.setup_hybrid_kaczmarz(A, mesh([n, n]), [4, 4],
                                     ddi.nodal_indices_of_box, 0.8, 5)
        if pname == "mgtpu":
            import jax.numpy as jnp
            from mgtpu.krylov import fgmres
            from mgtpu.ops.ell import ell_from_scipy
            X, info = fgmres(ell_from_scipy(A).matvec, jnp.asarray(B),
                             restart=5, prec=kz.make_kaczmarz_precond(k),
                             tol=1e-10, max_iter=3)
        else:
            import torch
            from mgtpu_torch.krylov import fgmres
            from mgtpu_torch.ops.ell import ell_from_scipy
            E = ell_from_scipy(A)
            prec = kz.make_kaczmarz_precond(k.to(torch.float64, "cpu"))
            X, info = fgmres(lambda v: E.matvec(v.T).T,
                             torch.tensor(B.T.copy()), restart=5,
                             prec=lambda v: prec(v.T).T, tol=1e-10,
                             max_iter=3)
            X = X.T
        rr = float(np.linalg.norm(A @ np.asarray(X) - B) / np.linalg.norm(B))
        report(tag, f"{n}^2: restarts", info["iters"], rr, t0)
    elif key == "bf16":
        dims = [cells3d] * 3
        A = laplacian(dims)
        b = rhs(A)
        cfg, rp = pkg.get_mg_param(levels=levels_for(5, 128, cells3d),
                                   relax_type="jacobi", relax_param=0.8,
                                   nu_pre=1, nu_post=1, dtype=np.float32)
        st = pkg.mg_setup(A, mesh(dims), cfg, rp, **kw)
        if pname == "mgtpu":
            import jax.numpy as jnp
            bf16 = jnp.bfloat16
        else:
            import torch
            bf16 = torch.bfloat16
        t0 = time.perf_counter()
        x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=60,
                                       cycle_dtype=bf16)
        report(tag, "bf16 cycles: refined iterations", info["iters"],
               relres(A, b, x), t0)
        t0 = time.perf_counter()
        x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
        report(tag, "f32 cycles: refined iterations", info["iters"],
               relres(A, b, x), t0)
    elif key == "RD":
        from mgtpu_torch.models.operators import \
            linear_elasticity_operator_mixed
        from mgtpu_torch.setup.transfers import \
            restrict_cell_centered_variables
        n = max(cells // 2, 16)
        M = mesh([n, n])
        mu0 = 1.0 + (np.arange(n * n) % 4) * 0.25
        scale = {}

        def get_op(m, mu):
            A = linear_elasticity_operator_mixed(m, mu, mu)
            if "s" not in scale:
                scale["s"] = 1e-3 * abs(A).sum(axis=0).max()
            return A + scale["s"] * sp.identity(A.shape[0])

        ctor = pkg.OperatorConstructor(
            mu0, get_op, lambda mf, mc, mu, lvl:
            restrict_cell_centered_variables(mu, list(mf.n)))
        cfg, rp = pkg.get_mg_param(levels=levels_for(6, 512, n),
                                   relax_type="VankaFaces", relax_param=0.75,
                                   nu_pre=1, nu_post=1, dtype=np.float32,
                                   transfer_type="SystemsFacesMixedLinear")
        st = pkg.mg_setup(ctor, M, cfg, rp, **kw)
        A = get_op(M, mu0).tocsr()
        b = rhs(A)
        print(f"[{tag}] {type(st.hier).__name__}, levels "
              f"{[a.shape[0] for a in st.As]}, setup "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
        report(tag, f"{n}^2: refined iterations", info["iters"],
               relres(A, b, x), t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="+", default=list(ROWS))
    ap.add_argument("--cells", type=int, default=1024)
    ap.add_argument("--cells3d", type=int, default=128)
    ap.add_argument("--packages", nargs="+", default=["mgtpu"])
    args = ap.parse_args()
    for key in args.rows:
        for p in args.packages:
            row(key, args.cells, args.cells3d, p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
