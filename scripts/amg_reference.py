"""Reference counts of the smoothed-aggregation and 6-level (b) contracts,
from mgtpu (JAX) on the CPU.

SA configurations (bench.py:530-660's problem): a 2D 512^2-cell nodal
DivSigGrad operator with sigma = exp(RandomState(s).randn(ncells)), shifted
by 1e-8 * (max column sum) * I, float32 hierarchies of 4 levels, and
b = A RandomState(s + 1).rand(n), normalised, in float64:

    SA-s  sa_amg_setup(A, cfg, 1.0, mesh=M), SPAI V(2,2), s = 3, max_iter 60
    SA-K  the same operator, Jac-GMRES 1.0 V(1,1) K-cycles, max_iter 70
    SA-f  sa_amg_setup(A, cfg, 1.0) with no mesh (greedy aggregation, the
          flat engine), SPAI V(2,2), s = 5, max_iter 60

(b6) is configuration (b) of chip_smoke.py at 6 levels: eps * u_xx + u_yy,
eps = 0.01, on 1025^2 nodes, semicoarsening + line Jacobi 0.9 V(1,1),
float32, b = A RandomState(0).rand(n) normalised, max_iter 60; its coarsest
level is 33 x 257 = 8481 dofs.

Each run prints the hierarchy (engine, level sizes, coarsest solver,
operator complexity), setup seconds, the refined iteration count of
solve_mg_refined(tol=1e-8) and the true float64 relative residual (scipy).

    python scripts/amg_reference.py [--runs SA-s SA-K SA-f b6]

Runs on the CPU (JAX_PLATFORMS=cpu, x64 on); each run takes one to a few
minutes and under 4 GB.
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

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import mgtpu  # noqa: E402
from mgtpu.models.operators import nodal_div_sig_grad_matrix  # noqa: E402
from mgtpu.setup.sa_amg import sa_amg_setup  # noqa: E402
from mgtpu.solvers.mg_solver import solve_mg_refined  # noqa: E402

SA = {
    "SA-s": (3, True, dict(relax_type="spai"), 60),
    "SA-K": (3, True, dict(relax_type="jac-gmres", relax_param=1.0,
                           nu_pre=1, nu_post=1, cycle_type="K"), 70),
    "SA-f": (5, False, dict(relax_type="spai"), 60),
}


def divsig(cells: int, seed: int):
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [cells, cells])
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    b = A @ np.random.RandomState(seed + 1).rand(A.shape[0])
    return M, A, b / np.linalg.norm(b)


def aniso_b(n: int = 1024, eps: float = 0.01):
    N = n + 1
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    A = sp.csr_matrix(eps * sp.kron(sp.identity(N), T)
                      + sp.kron(T, sp.identity(N)))
    b = A @ np.random.RandomState(0).rand(A.shape[0])
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    return M, A, b / np.linalg.norm(b)


def describe(st) -> str:
    h = st.hier
    sizes = [a.shape[0] for a in st.As]
    kinds = [type(lv.A).__name__ for lv in h.levels]
    return (f"{type(h).__name__}, levels {sizes}, operators {kinds}, "
            f"coarsest {type(h.coarse).__name__} of {sizes[-1]}, operator "
            f"complexity {st.operator_complexity():.4f}")


def run(name: str) -> None:
    t0 = time.perf_counter()
    if name == "b6":
        M, A, b = aniso_b()
        cfg, rp = mgtpu.get_mg_param(levels=6, relax_type="line-jacobi",
                                     relax_param=0.9, nu_pre=1, nu_post=1,
                                     transfer_type="semicoarsening",
                                     dtype=np.float32)
        st = mgtpu.mg_setup(A, M, cfg, rp)
        max_iter = 60
        grids = [tuple(lv.A.grid) for lv in st.hier.levels]
        print(f"[{name}] grids {grids}", flush=True)
    else:
        seed, structured, opts, max_iter = SA[name]
        M, A, b = divsig(512, seed)
        cfg, rp = mgtpu.get_mg_param(levels=4, dtype=np.float32, **opts)
        st = sa_amg_setup(A, cfg, rp, mesh=M if structured else None)
    setup = time.perf_counter() - t0
    print(f"[{name}] {describe(st)}; setup {setup:.1f} s", flush=True)
    t0 = time.perf_counter()
    x, info = solve_mg_refined(st, b, tol=1e-8, max_iter=max_iter)
    rr = np.linalg.norm(b - A @ np.asarray(x, np.float64)) / np.linalg.norm(b)
    print(f"[{name}] refined iterations {info['iters']}, true f64 relres "
          f"{rr:.3e}, solve {time.perf_counter() - t0:.1f} s (CPU)",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", nargs="+", default=["SA-s", "SA-K", "SA-f",
                                                  "b6"])
    for name in ap.parse_args().runs:
        run(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
