"""Reference counts of the complex-hierarchy contracts, from mgtpu (JAX) on
the CPU, and the port's counts beside mgtpu's at a small size.

The Helmholtz operator is A = L - (1 - 0.5i) diag(k^2): L the nodal
Laplacian of the unit square or cube, k = (kh / h) / c with c =
exp(0.2 RandomState(3).randn(n_nodes)); every level is a variable grid
stencil.  b = A RandomState(4).rand(n), normalised, in complex128.
Hierarchies are complex64 unless named.  Rows (their full sizes):

    H-2d       Helmholtz, 1024^2 cells, kh 0.125, Jacobi 0.8 V(1,1), 5
               levels, solve_mg_refined(tol=1e-8, max_iter=60)
    H-bicg     the same hierarchy (max_outer_iter 100, relative_tol 1e-8),
               solve_bicgstab_mg
    H-gmres    the same, solve_gmres_mg (flexible, inner 5): restarts
    H-K        the same operator, jac-gmres 1.0, cycle_type "K", V(1,1), 5
               levels, refined
    H-3d       Helmholtz, 128^3 cells, kh 0.125, Jacobi 0.8 V(1,1), 5
               levels, refined
    H-3d-bicg / H-3d-gmres   the same hierarchy, as H-bicg / H-gmres
    Z-sa       512^2 nodal DivSigGrad, sigma = exp(RandomState(5).randn),
               + (1e-2 + 1e-2i) (max column sum) I, b from RandomState(6);
               sa_amg_setup without a mesh (flat engine), SPAI 1.0 V(2,2),
               4 levels, refined (max_iter 80)
    Z-cl       the same operator, classical_amg_setup, the same smoother
    K-c        Helmholtz at 256^2, kh 0.25, complex128, hybridKaczmarzNodal
               ([4, 4], omega 0.8, num_it 2, nodal boxes), V(1,1), 4
               levels, solve_mg (max_outer_iter 60, relative_tol 1e-8)

Each run prints the hierarchy (level grids or sizes, operator complexity),
the iteration count, the true complex128 relative residual (scipy) and the
seconds.

    python scripts/complex_reference.py [--rows H-2d ...] [--cells 1024]
        [--cells3d 128] [--packages mgtpu port]

`--cells` / `--cells3d` shrink the 2D / 3D meshes (one level less for each
halving, three at least; Z-sa, Z-cl and K-c scale with --cells as their
share of 1024); kh stays as named, so a smaller mesh has a smaller kh on
its coarsest level.  `--packages port` runs the PyTorch port
(mgtpu_torch, on the CPU) on the same inputs.  At the full sizes mgtpu
takes minutes and a few GB a row.
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

ROWS = ("H-2d", "H-bicg", "H-gmres", "H-K", "H-3d", "H-3d-bicg",
        "H-3d-gmres", "Z-sa", "Z-cl", "K-c")


def package(name: str):
    """(the package, its Kaczmarz index module, keyword arguments for its
    entry points)."""
    if name == "mgtpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import mgtpu as pkg
        from mgtpu.dd import indices
        return pkg, indices, {}
    import mgtpu_torch as pkg
    from mgtpu_torch.dd import indices
    return pkg, indices, {"device": "cpu"}


def levels_for(full_levels: int, full_cells: int, cells: int) -> int:
    lv, c = full_levels, full_cells
    while c > cells and lv > 3:
        c //= 2
        lv -= 1
    return lv


def helmholtz(dims, kh: float):
    """L - (1 - 0.5i) diag(k^2), k = (kh / h) / c on the unit box."""
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    L = nodal_laplacian_matrix(M)
    c = np.exp(0.2 * np.random.RandomState(3).randn(L.shape[0]))
    k = (kh * dims[0]) / c
    return (L - (1 - 0.5j) * sp.diags(k ** 2)).tocsr()


def shifted_divsig(dims, seed=5):
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    return (A + (1e-2 + 1e-2j) * abs(A).sum(axis=0).max()
            * sp.identity(A.shape[0])).tocsr()


def rhs(A, seed=4):
    b = A @ np.random.RandomState(seed).rand(A.shape[0])
    return b / np.linalg.norm(b)


def relres(A, b, x) -> float:
    xh = np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x,
                    dtype=np.complex128)
    return float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b))


def describe(st) -> str:
    if type(st.hier).__name__ == "GridHierarchy":
        lv = "grids " + " -> ".join(
            "x".join(str(v) for v in lvl.A.grid) if lvl.A is not None
            else "-" for lvl in st.hier.levels)
    else:
        lv = "dofs " + " / ".join(str(a.shape[0]) for a in st.As)
    return (f"{type(st.hier).__name__}, {lv}, op. complexity "
            f"{st.operator_complexity():.4f}, coarsest "
            f"{type(st.hier.coarse).__name__}")


def row(key, cells, cells3d, pname):
    pkg, ddi, kw = package(pname)
    tag = f"{pname} {key} {cells}^2/{cells3d}^3"
    mesh = lambda dims: pkg.get_regular_mesh([0.0, 1.0] * len(dims),
                                             list(dims))
    t0 = time.perf_counter()
    three = key.startswith("H-3d")
    if key.startswith("H-"):
        dims = [cells3d] * 3 if three else [cells, cells]
        lv = (levels_for(5, 128, cells3d) if three
              else levels_for(5, 1024, cells))
        A = helmholtz(dims, 0.125)
        b = rhs(A)
        relax = dict(relax_type="jacobi", relax_param=0.8)
        if key == "H-K":
            relax = dict(relax_type="jac-gmres", relax_param=1.0,
                         cycle_type="K")
        cfg, rp = pkg.get_mg_param(levels=lv, nu_pre=1, nu_post=1,
                                   dtype=np.complex64, max_outer_iter=100,
                                   relative_tol=1e-8, **relax)
        st = pkg.mg_setup(A, mesh(dims), cfg, rp, **kw)
        print(f"[{tag}] {describe(st)}, setup "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        if key.endswith("bicg"):
            x, info = pkg.solve_bicgstab_mg(st, b)
            what = "BiCGSTAB iterations"
        elif key.endswith("gmres"):
            x, info = pkg.solve_gmres_mg(st, b)
            what = "FGMRES(5) restarts"
        else:
            x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
            what = "refined iterations"
        iters = int(info["iters"])
    elif key in ("Z-sa", "Z-cl"):
        n = max(cells // 2, 32)
        A = shifted_divsig([n, n])
        b = rhs(A, seed=6)
        cfg, rp = pkg.get_mg_param(levels=levels_for(4, 512, n),
                                   relax_type="spai", dtype=np.complex64)
        setup = pkg.sa_amg_setup if key == "Z-sa" else \
            pkg.classical_amg_setup
        st = setup(A, cfg, rp, **kw)
        print(f"[{tag}] {describe(st)}, setup "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=80)
        what, iters = "refined iterations", int(info["iters"])
    elif key == "K-c":
        n = max(cells // 4, 32)
        A = helmholtz([n, n], 0.25)
        b = rhs(A)
        cfg, _ = pkg.get_mg_param(levels=levels_for(4, 256, n),
                                  relax_type="hybridKaczmarzNodal",
                                  nu_pre=1, nu_post=1, relative_tol=1e-8,
                                  max_outer_iter=60, dtype=np.complex128)
        rp = {"num_domains": [4, 4], "omega": 0.8, "num_it": 2,
              "index_fn": ddi.nodal_indices_of_box}
        st = pkg.mg_setup(A, mesh([n, n]), cfg, rp, **kw)
        print(f"[{tag}] {describe(st)}, setup "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        x, info = pkg.solve_mg(st, b)
        what, iters = "cycles", int(info["iters"])
    else:
        raise ValueError(f"unknown row {key!r}")
    print(f"[{tag}] {what} {iters}, true c128 relres "
          f"{relres(A, b, x):.3e}, {time.perf_counter() - t0:.1f} s (CPU)",
          flush=True)
    return iters


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
