"""Reference counts of the complex line-relaxation, semicoarsening,
staggered-systems, device-aggregation and lower-cycle-type contracts, from
mgtpu (JAX) on the CPU, and the port's counts beside mgtpu's at a small
size.

Shifted operators: the anisotropic and Helmholtz rows take A - (1 - 0.5i)
diag(k^2), k = (kh n) / c with c = exp(0.2 RandomState(3).randn(n_nodes))
(scripts/complex_reference.py's shift); the systems rows take the
elasticity operators of scripts/systems_reference.py plus (1e-3 + 1e-3i)
(max column sum) I.  b = A RandomState(4).rand(n), normalised, in
complex128; hierarchies are complex64 unless named; every refined solve is
solve_mg_refined(tol=1e-8, max_iter=60).  Rows (their full sizes):

    CL-2d   eps u_xx + u_yy, eps = 100 (tests/test_line_smoother.py::_aniso),
            shifted, kh 0.125, 1024^2 cells; line-jacobi 0.8, V(1,1), 5
            levels (contiguous lines)
    CL-3d   the 7-point operator with eps = 50 on grid axis 0 (strided
            lines), shifted, kh 0.125, 128^3 cells; line-jacobi 0.8,
            V(1,1), 5 levels
    CS-2d   eps = 0.01, shifted, kh 0.01, 1024^2 cells; semicoarsening +
            line-jacobi 0.9, V(1,1), 7 levels
    CV-2d   linear_elasticity_operator_mixed(M, 1, 1), shifted, 1024^2
            cells; SystemsFacesMixedLinear, VankaFaces 0.75, V(1,1), 6
            levels (the systems grid engine)
    CE-2d   linear_elasticity_operator(M, 1, 1), shifted, 1024^2 cells;
            SystemsFacesLinear, SPAI 0.75, V(2,2), 6 levels
    C-lex   CV-2d's operator at 64^2; VankaFacesLex 0.75, V(1,1), 4 levels
            (the flat engine, kernel E)
    C-kacz  the same; hybridVankaFacesKaczmarz 0.9, V(2,2), 4 levels
    Z-dev   512^2 complex-shifted rough DivSigGrad (complex_reference.py's
            Z-sa operator, b from RandomState(6)); MGTPU_AGG=device,
            sa_amg_setup without a mesh, SPAI 1.0 V(2,2), 4 levels, refined
            (max_iter 80)
    H-cd    complex_reference.py's H-2d (1024^2, kh 0.125) in a complex128
            hierarchy, Jacobi 0.8 V(1,1), 5 levels, refined with
            cycle_dtype=complex64
    CL-2d-c128, C-lex-c128   CL-2d and C-lex in complex128 hierarchies
            (kernels C and E in complex128 on a solve's path)

Each run prints the hierarchy (level grids or sizes), the setup seconds,
the iteration count, the true complex128 relative residual (scipy) and the
solve seconds.

    python scripts/complex_rest_reference.py [--rows CL-2d ...]
        [--cells 1024] [--cells3d 128] [--packages mgtpu port]

`--cells` / `--cells3d` shrink the 2D / 3D meshes (one level less for each
halving, three at least; Z-dev takes half of --cells, at least 32); C-lex
and C-kacz keep 64^2.  kh stays as named.  `--packages port` runs the
PyTorch port (mgtpu_torch, on the CPU) on the same inputs.  At the full
sizes mgtpu takes minutes and several GB a row: run those on a machine
that has them.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ROWS = ("CL-2d", "CL-3d", "CS-2d", "CV-2d", "CE-2d", "C-lex", "C-kacz",
        "Z-dev", "H-cd", "CL-2d-c128", "C-lex-c128")


def package(name: str):
    """(the package, keyword arguments for its entry points)."""
    if name == "mgtpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import mgtpu as pkg
        return pkg, {}
    import mgtpu_torch as pkg
    return pkg, {"device": "cpu"}


def levels_for(full_levels: int, full_cells: int, cells: int) -> int:
    lv, c = full_levels, full_cells
    while c > cells and lv > 3:
        c //= 2
        lv -= 1
    return lv


def shift(A, kh: float, n: int):
    """A - (1 - 0.5i) diag(k^2), k = (kh n) / c, c = exp(0.2 randn)."""
    c = np.exp(0.2 * np.random.RandomState(3).randn(A.shape[0]))
    return (A - (1 - 0.5j) * sp.diags((kh * n / c) ** 2)).tocsr()


def aniso2d(n: int, eps: float):
    """eps u_xx + u_yy on the (n+1)^2 node grid, 5-point."""
    N = n + 1
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    I = sp.identity(N)
    return sp.csr_matrix(eps * sp.kron(I, T) + sp.kron(T, I))


def aniso3d(dims, strong: int, eps: float = 50.0):
    """The 3D 7-point operator with eps on grid axis `strong`; dims per
    mesh axis."""
    Ts = [sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(d + 1, d + 1))
          * (d ** 2) for d in reversed(dims)]          # grid axes (z, y, x)
    A = 0
    for k in range(3):
        mats = [sp.identity(d + 1) for d in reversed(dims)]
        mats[k] = Ts[k]
        A = A + (eps if k == strong else 1.0) * sp.kron(
            sp.kron(mats[0], mats[1]), mats[2])
    return sp.csr_matrix(A)


def elasticity(cells: int, mixed: bool):
    """scripts/systems_reference.py's operator on cells^2, shifted by
    (1e-3 + 1e-3i) (max column sum) I."""
    import mgtpu_torch as mt
    from mgtpu_torch.models import operators as ops
    M = mt.get_regular_mesh([0.0, 1.0] * 2, [cells] * 2)
    mu = np.ones(M.num_cells)
    A = (ops.linear_elasticity_operator_mixed if mixed
         else ops.linear_elasticity_operator)(M, mu, mu)
    return (A + (1e-3 + 1e-3j) * abs(A).sum(axis=0).max()
            * sp.identity(A.shape[0])).tocsr()


def rhs(A, seed=4):
    b = A @ np.random.RandomState(seed).rand(A.shape[0])
    return b / np.linalg.norm(b)


def relres(A, b, x) -> float:
    xh = np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x,
                    dtype=np.complex128)
    return float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b))


def problem(key: str, cells: int, cells3d: int):
    """(operator, mesh cells per axis, get_mg_param keywords, b seed,
    refinement keywords) of a row."""
    if key.endswith("-c128"):
        A, dims, kw, seed, solve_kw = problem(key[:-5], cells, cells3d)
        return A, dims, dict(kw, dtype=np.complex128), seed, solve_kw
    jac = dict(nu_pre=1, nu_post=1)
    if key == "CL-2d":
        return (shift(aniso2d(cells, 100.0), 0.125, cells), [cells] * 2,
                dict(levels=levels_for(5, 1024, cells),
                     relax_type="line-jacobi", relax_param=0.8, **jac), 4, {})
    if key == "CL-3d":
        return (shift(aniso3d([cells3d] * 3, 0), 0.125, cells3d),
                [cells3d] * 3,
                dict(levels=levels_for(5, 128, cells3d),
                     relax_type="line-jacobi", relax_param=0.8, **jac), 4, {})
    if key == "CS-2d":
        return (shift(aniso2d(cells, 0.01), 0.01, cells), [cells] * 2,
                dict(levels=levels_for(7, 1024, cells),
                     relax_type="line-jacobi", relax_param=0.9,
                     transfer_type="semicoarsening", **jac), 4, {})
    if key in ("CV-2d", "CE-2d", "C-lex", "C-kacz"):
        mixed = key != "CE-2d"
        n = 64 if key in ("C-lex", "C-kacz") else cells
        lv = 4 if key in ("C-lex", "C-kacz") else levels_for(6, 1024, cells)
        relax = {"CV-2d": ("VankaFaces", 0.75, 1),
                 "CE-2d": ("SPAI", 0.75, 2),
                 "C-lex": ("VankaFacesLex", 0.75, 1),
                 "C-kacz": ("hybridVankaFacesKaczmarz", 0.9, 2)}[key]
        return (elasticity(n, mixed), [n] * 2,
                dict(levels=lv, relax_type=relax[0], relax_param=relax[1],
                     nu_pre=relax[2], nu_post=relax[2],
                     transfer_type="SystemsFacesMixedLinear" if mixed
                     else "SystemsFacesLinear"), 4, {})
    if key == "Z-dev":
        from complex_reference import shifted_divsig
        n = max(cells // 2, 32)
        return (shifted_divsig([n, n]), [n] * 2,
                dict(levels=levels_for(4, 512, n), relax_type="spai",
                     relax_param=1.0, nu_pre=2, nu_post=2), 6,
                dict(max_iter=80))
    if key == "H-cd":
        from complex_reference import helmholtz
        return (helmholtz([cells] * 2, 0.125), [cells] * 2,
                dict(levels=levels_for(5, 1024, cells), relax_type="jacobi",
                     relax_param=0.8, dtype=np.complex128, **jac), 4,
                dict(cycle_dtype=np.complex64))
    raise ValueError(f"unknown row {key!r}")


@contextlib.contextmanager
def device_aggregation():
    """MGTPU_AGG=device for the length of one setup."""
    old = os.environ.get("MGTPU_AGG")
    os.environ["MGTPU_AGG"] = "device"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MGTPU_AGG"]
        else:
            os.environ["MGTPU_AGG"] = old


def setup(key: str, pname: str, A, dims, kw):
    """The row's state in package `pname`."""
    pkg, pkw = package(pname)
    kw = dict(dtype=np.complex64, max_outer_iter=60) | kw
    cfg, rp = pkg.get_mg_param(**kw)
    if key == "Z-dev":
        with device_aggregation():
            return pkg.sa_amg_setup(A, cfg, rp, **pkw)
    M = pkg.get_regular_mesh([0.0, 1.0] * len(dims), dims)
    return pkg.mg_setup(A, M, cfg, rp, **pkw)


def describe(st) -> str:
    if type(st.hier).__name__ == "GridHierarchy":
        lv = "grids " + " -> ".join(
            "x".join(str(v) for v in lvl.A.grid) if lvl.A is not None
            else "-" for lvl in st.hier.levels)
    else:
        lv = "dofs " + " / ".join(str(a.shape[0]) for a in st.As)
    return f"{type(st.hier).__name__}, {lv}"


def row(key: str, cells: int, cells3d: int, pname: str) -> int:
    pkg, _ = package(pname)
    A, dims, kw, seed, solve_kw = problem(key, cells, cells3d)
    b = rhs(A, seed)
    tag = f"{pname} {key} {'x'.join(str(v) for v in dims)} cells"
    t0 = time.perf_counter()
    st = setup(key, pname, A, dims, kw)
    print(f"[{tag}] {describe(st)}, setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    x, info = pkg.solve_mg_refined(st, b, tol=1e-8,
                                   **({"max_iter": 60} | solve_kw))
    iters = int(info["iters"])
    print(f"[{tag}] refined iterations {iters}, true c128 relres "
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
