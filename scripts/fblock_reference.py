"""Reference iteration counts of f-block: block CG on the rough-sigma
DivSigGrad problem, from mgtpu (JAX) and mgtpu_torch on the CPU.

The problem is configuration (f) of chip_smoke.py: a 2D 1024^2-cell nodal
DivSigGrad operator with sigma = exp(RandomState(3).randn(ncells)), shifted
by 1e-8 * (max column sum) * I, a 6-level Jacobi 0.8 V(1,1) hierarchy,
max_outer_iter 100 and relative_tol 1e-8.  Right-hand sides:
RandomState(4).rand(n, 4) with normalised columns, in float64.

Each run builds its own hierarchy (float32 or float64) in one package and
solves with solve_cg_mg(block=True); the script prints the count, the true
float64 relative residual of every column (scipy), and the per-step
residual histories side by side.  As a check that the problem is (f)'s, it
first prints mgtpu's single right-hand-side CG count on b = A
RandomState(4).rand(n), normalised.

    python scripts/fblock_reference.py [--cells 1024] [--levels 6]
        [--runs mgtpu-f32 mgtpu-f64 port-f32 port-f64]

Runs on the CPU (JAX_PLATFORMS=cpu, x64 on); 1024^2 takes about 2 GB and
two minutes.
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

jax.config.update("jax_enable_x64", True)

import mgtpu  # noqa: E402
import mgtpu_torch  # noqa: E402
from mgtpu.models.operators import nodal_div_sig_grad_matrix  # noqa: E402


def problem(cells: int):
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [cells, cells])
    sig = np.exp(np.random.RandomState(3).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    B = np.random.RandomState(4).rand(A.shape[0], 4)
    return M, A, b / np.linalg.norm(b), B / np.linalg.norm(B, axis=0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=6)
    ap.add_argument("--runs", nargs="+", default=[
        "mgtpu-f32", "mgtpu-f64", "port-f32", "port-f64"])
    args = ap.parse_args()
    M, A, b, B = problem(args.cells)
    base = dict(levels=args.levels, max_outer_iter=100, relative_tol=1e-8,
                relax_type="jacobi", relax_param=0.8, nu_pre=1, nu_post=1)

    st = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**base, dtype=np.float32))
    x, info = mgtpu.solve_cg_mg(st, b)
    rr = np.linalg.norm(b - A @ np.asarray(x)) / np.linalg.norm(b)
    print(f"check (f): mgtpu f32 hierarchy, single RHS CG "
          f"{int(info['iters'])} iterations, true relres {rr:.3e}",
          flush=True)

    hist = {}
    for run in args.runs:
        pkg, prec = run.split("-")
        dt = {"f32": np.float32, "f64": np.float64}[prec]
        cfg, rp = (mgtpu if pkg == "mgtpu" else mgtpu_torch).get_mg_param(
            **base, dtype=dt)
        t0 = time.perf_counter()
        if pkg == "mgtpu":
            st = mgtpu.mg_setup(A, M, cfg, rp)
            x, info = mgtpu.solve_cg_mg(st, B, block=True)
            x, rv = np.asarray(x), np.asarray(info["resvec"])
        else:
            Mp = mgtpu_torch.get_regular_mesh([0.0, 1.0, 0.0, 1.0],
                                              [args.cells] * 2)
            st = mgtpu_torch.mg_setup(A, Mp, cfg, rp, device="cpu")
            x, info = mgtpu_torch.solve_cg_mg(st, B, block=True)
            x, rv = x.numpy(), info["resvec"].numpy()
        k = int(info["iters"])
        rr = np.linalg.norm(B - A @ x, axis=0) / np.linalg.norm(B, axis=0)
        hist[run] = rv[:k + 1] / rv[0]
        print(f"f-block {run}: {k} iterations, true relres "
              f"{np.array2string(rr, precision=3)}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    print("relative residual per column, step by step:")
    print("k  " + "  ".join(f"{r:>36s}" for r in hist))
    for k in range(max(len(h) for h in hist.values())):
        print(f"{k:<2d} " + "  ".join(
            (np.array2string(h[k], precision=3, max_line_width=200)
             if k < len(h) else "").rjust(36) for h in hist.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
