"""Reference counts of the classical-AMG and device-setup contracts, from
mgtpu (JAX) on the CPU, beside the port (mgtpu_torch) on the CPU.

The problem is bench.py:618-660's agg_ab: a 2D 512^2-cell nodal DivSigGrad
operator with sigma = exp(RandomState(5).randn(ncells)), shifted by
1e-8 * (max column sum) * I, float32 hierarchies of 4 levels with SPAI
V(2,2) (get_mg_param(levels=4, relax_type="spai", dtype=float32)), and
b = A RandomState(6).rand(n), normalised, in float64:

    C-cc    classical_amg_setup(A, cfg, rp): common-C coloring (the C++
            kernels), direct interpolation; solve_mg_refined(tol=1e-8,
            max_iter=60)
    C-pmis  the same with coarsening="pmis" (PMIS on the device, then
            enforce_common_c)
    SA-dev  sa_amg_setup(A, cfg, rp) with no mesh and MGTPU_AGG=device
            (MIS-2 aggregation)
    C-cg    C-cc's hierarchy with max_outer_iter=100, relative_tol=1e-8,
            under solve_cg_mg (mgtpu stops on its CG recurrence's residual,
            so the true relres is above 1e-8)

Each run prints, for each package, the hierarchy (level sizes, level
formats, coarsest solver, operator complexity), the setup seconds, the
iteration count and the true float64 relative residual (scipy).

    python scripts/classical_reference.py [--runs C-cc C-pmis SA-dev C-cg]
        [--cells 512] [--packages mgtpu port]

Runs on the CPU (JAX_PLATFORMS=cpu, x64 on); at 512^2 each run takes about
half a minute per package and under 4 GB.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace

import numpy as np
import scipy.sparse as sp

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import mgtpu  # noqa: E402
import mgtpu_torch  # noqa: E402
from mgtpu.models.operators import nodal_div_sig_grad_matrix  # noqa: E402
from mgtpu.setup.classical_amg import classical_amg_setup  # noqa: E402
from mgtpu.setup.sa_amg import sa_amg_setup  # noqa: E402

RUNS = {
    # setup, options, solve
    "C-cc": ("classical", {}, "refined"),
    "C-pmis": ("classical", dict(coarsening="pmis"), "refined"),
    "SA-dev": ("sa", {}, "refined"),
    "C-cg": ("classical", {}, "cg"),
}


def agg_ab(cells: int):
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [cells, cells])
    sig = np.exp(np.random.RandomState(5).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    b = A @ np.random.RandomState(6).rand(A.shape[0])
    return A, b / np.linalg.norm(b)


def describe(st) -> str:
    sizes = [a.shape[0] for a in st.As]
    kinds = [type(lv.A).__name__ for lv in st.hier.levels]
    opc = sum(a.nnz for a in st.As) / st.As[0].nnz
    return (f"levels {sizes}, operators {kinds}, coarsest "
            f"{type(st.hier.coarse).__name__}, operator complexity "
            f"{opc:.4f}")


def run(name: str, package: str, A, b) -> None:
    setup, opts, solve = RUNS[name]
    pkg = mgtpu if package == "mgtpu" else mgtpu_torch
    kw = {} if package == "mgtpu" else dict(device="cpu")
    cfg, rp = pkg.get_mg_param(levels=4, relax_type="spai",
                               dtype=np.float32)
    t0 = time.perf_counter()
    if setup == "sa":
        os.environ["MGTPU_AGG"] = "device"
        try:
            st = (sa_amg_setup if package == "mgtpu"
                  else mgtpu_torch.sa_amg_setup)(A, cfg, rp, **kw)
        finally:
            del os.environ["MGTPU_AGG"]
    else:
        st = (classical_amg_setup if package == "mgtpu"
              else mgtpu_torch.classical_amg_setup)(A, cfg, rp, **opts, **kw)
    t_setup = time.perf_counter() - t0
    print(f"[{name} {package}] {describe(st)}; setup {t_setup:.1f} s (CPU)",
          flush=True)
    t0 = time.perf_counter()
    if solve == "cg":
        st.config = replace(st.config, max_outer_iter=100,
                            relative_tol=1e-8)
        x, info = pkg.solve_cg_mg(st, b)
    else:
        x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
    x = np.asarray(x.numpy() if hasattr(x, "numpy") else x, np.float64)
    rr = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    print(f"[{name} {package}] {solve} iterations {int(info['iters'])}, "
          f"true f64 relres {rr:.3e}, solve {time.perf_counter() - t0:.1f} "
          "s (CPU)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", nargs="+", default=list(RUNS),
                    choices=list(RUNS))
    ap.add_argument("--cells", type=int, default=512)
    ap.add_argument("--packages", nargs="+", default=["mgtpu", "port"],
                    choices=["mgtpu", "port"])
    args = ap.parse_args()
    A, b = agg_ab(args.cells)
    for name in args.runs:
        for package in args.packages:
            run(name, package, A, b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
