"""Reference counts of the staggered-systems contracts, from mgtpu (JAX) on
the CPU, and the port's counts beside mgtpu's at a small size.

Configurations (bench.py:388-414's problem): the operator is
linear_elasticity_operator(_mixed)(M, mu, mu) with mu = ones, plus
1e-3 * (max column sum) * I; float32 hierarchies; b = A
RandomState(4).rand(n), normalised, in float64:

    V-2d  mixed elasticity, 1024^2 cells, SystemsFacesMixedLinear,
          VankaFaces 0.75, V(1,1), 6 levels, solve_mg_refined
    E-2d  elasticity, 1024^2 cells, SystemsFacesLinear, SPAI 0.75, V(2,2),
          6 levels, solve_mg_refined
    V-3d  mixed elasticity, 64^3 cells, VankaFaces 0.75, V(1,1), 5 levels,
          solve_mg_refined
    E-cg  E-2d's hierarchy under solve_cg_mg (max_outer_iter 100,
          relative_tol 1e-8)

and the Vanka variants on the 64^2 mixed problem, 4 levels, V(1,1):

    econ   EconVankaFaces 0.75            (the systems grid engine)
    add    VankaFacesAdd 0.75             (the systems grid engine)
    tuple  VankaFaces (0.75, 0.75)        (the systems grid engine)
    lex    VankaFacesLex 0.75             (the flat engine)
    kacz   hybridVankaFacesKaczmarz 0.9, V(2,2)   (the flat engine)

The refined solves run solve_mg_refined(tol=1e-8, max_iter=60).  Each run
prints the hierarchy (level sizes, coarsest size), the setup seconds, the
iteration count and the true float64 relative residual (scipy).

    python scripts/systems_reference.py [--runs V-2d E-2d V-3d E-cg econ
        add tuple lex kacz] [--cells 1024] [--cells3d 64]
        [--packages mgtpu port]

`--cells` / `--cells3d` shrink the contracts' meshes (one level less for
each halving, two at least; the variants keep 64^2); `--packages port` runs
the PyTorch port (mgtpu_torch, on the CPU) on the same inputs, and both
print side by side.  At the full sizes mgtpu takes one to three minutes
and a few GB a run; at `--cells 64 --cells3d 16` the whole script takes
about a minute.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = {
    # key: (dim, cells at full size (None: --cells / --cells3d), mixed,
    #       relax, weight, sweeps, levels at full size)
    "V-2d": (2, None, True, "VankaFaces", 0.75, 1, 6),
    "E-2d": (2, None, False, "SPAI", 0.75, 2, 6),
    "V-3d": (3, None, True, "VankaFaces", 0.75, 1, 5),
    "E-cg": (2, None, False, "SPAI", 0.75, 2, 6),
    "econ": (2, 64, True, "EconVankaFaces", 0.75, 1, 4),
    "add": (2, 64, True, "VankaFacesAdd", 0.75, 1, 4),
    "tuple": (2, 64, True, "VankaFaces", (0.75, 0.75), 1, 4),
    "lex": (2, 64, True, "VankaFacesLex", 0.75, 1, 4),
    "kacz": (2, 64, True, "hybridVankaFacesKaczmarz", 0.9, 2, 4),
}


def problem(dim: int, cells: int, mixed: bool):
    """The operator (from the port's copy of the models, which tests hold
    bitwise mgtpu's), its mesh extents and b."""
    from mgtpu_torch.models import operators as ops
    import mgtpu_torch as mt
    M = mt.get_regular_mesh([0.0, 1.0] * dim, [cells] * dim)
    mu = np.ones(M.num_cells)
    A = (ops.linear_elasticity_operator_mixed if mixed
         else ops.linear_elasticity_operator)(M, mu, mu)
    A = (A + 1e-3 * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
         ).tocsr()
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    return [cells] * dim, A, b / np.linalg.norm(b)


def levels_for(full_levels: int, full_cells: int, cells: int) -> int:
    """The full configuration's depth, less one level for each halving of
    the mesh, and at least 2."""
    lv = full_levels
    c = full_cells
    while c > cells and lv > 2:
        c //= 2
        lv -= 1
    return lv


def package(name: str):
    if name == "mgtpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import mgtpu
        return mgtpu, {}
    import mgtpu_torch
    return mgtpu_torch, {"device": "cpu"}


def run(key: str, cells: int, cells3d: int, pkg_name: str) -> None:
    dim, fixed, mixed, relax, w, nu, full_levels = RUNS[key]
    full = 1024 if dim == 2 else 64
    n = cells if dim == 2 else cells3d
    levels = levels_for(full_levels, full, n)
    if fixed is not None:
        n, levels = fixed, full_levels
    dims, A, b = problem(dim, n, mixed)
    pkg, kw = package(pkg_name)
    t0 = time.perf_counter()
    cfg, rp = pkg.get_mg_param(
        levels=levels, relax_type=relax, relax_param=w, nu_pre=nu,
        nu_post=nu, dtype=np.float32, max_outer_iter=60,
        transfer_type="SystemsFacesMixedLinear" if mixed
        else "SystemsFacesLinear")
    M = pkg.get_regular_mesh([0.0, 1.0] * dim, dims)
    st = pkg.mg_setup(A, M, cfg, rp, **kw)
    setup = time.perf_counter() - t0
    sizes = [a.shape[0] for a in st.As]
    print(f"[{pkg_name} {key} {n}^{dim}] {type(st.hier).__name__}, levels "
          f"{sizes}, coarsest {sizes[-1]} dofs, nnz {A.nnz}; setup "
          f"{setup:.1f} s", flush=True)
    t0 = time.perf_counter()
    if key == "E-cg":
        st.config = dataclasses.replace(st.config, max_outer_iter=100,
                                        relative_tol=1e-8)
        x, info = pkg.solve_cg_mg(st, b)
        what = "CG"
    else:
        x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
        what = "refined"
    xh = np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x,
                    dtype=np.float64)
    rr = np.linalg.norm(b - A @ xh) / np.linalg.norm(b)
    print(f"[{pkg_name} {key} {n}^{dim}] {what} iterations "
          f"{int(info['iters'])}, true f64 relres {rr:.3e}, solve "
          f"{time.perf_counter() - t0:.1f} s (CPU)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", nargs="+", default=list(RUNS))
    ap.add_argument("--cells", type=int, default=1024)
    ap.add_argument("--cells3d", type=int, default=64)
    ap.add_argument("--packages", nargs="+", default=["mgtpu"])
    args = ap.parse_args()
    for key in args.runs:
        for p in args.packages:
            run(key, args.cells, args.cells3d, p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
