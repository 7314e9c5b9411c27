"""Reference counts of the partitioned flat tier's contracts, from mgtpu
(JAX) on the CPU, and the port's counts beside mgtpu's.

Rows (b = A RandomState(6).rand(n), normalised, float64; the operator is
SA-f's: nodal DivSigGrad on cells^2 cells, sigma = exp(RandomState(5)
.randn) per cell, + 1e-8 (max column sum) I; smoothed aggregation without
a mesh (the flat engine), 4 levels, float32):

    PA-sa    SPAI V(2,2): PartitionedAMGSolver on 4 devices,
             solve_refined(tol=1e-8, max_iter=60)
    PA-K     Jac-GMRES 1.0 V(1,1) K-cycles: the same with max_iter 80, and
             the single-device solve_mg_refined(tol=1e-8, max_iter=80)

Each run prints the iteration count, the true float64 relative residual
(scipy), the level sizes, a device's vector rows a level
(`local_vector_rows`), the halo entries of A a level
(`comm_entries_per_cycle`) and the seconds.

    python scripts/part_reference.py [--rows PA-sa PA-K] [--cells 512]
        [--packages mgtpu port]

mgtpu runs on 4 virtual CPU devices (XLA's host device count), the port
(mgtpu_torch) on 4 spawned gloo ranks on the CPU.  At 512^2 cells mgtpu
takes a few minutes a row.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = {"PA-sa": (dict(relax_type="spai"), 60),
        "PA-K": (dict(relax_type="jac-gmres", relax_param=1.0, nu_pre=1,
                      nu_post=1, cycle_type="K"), 80)}
DEVICES = 4


def problem(cells: int):
    """SA-f's operator and b."""
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    import mgtpu_torch as mt
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [cells, cells])
    sig = np.exp(np.random.RandomState(5).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(axis=0).max()
         * sp.identity(A.shape[0])).tocsr()
    b = A @ np.random.RandomState(6).rand(A.shape[0])
    return A, b / np.linalg.norm(b)


def relres(A, b, x) -> float:
    return float(np.linalg.norm(b - A @ np.asarray(x, np.float64))
                 / np.linalg.norm(b))


def report(tag, what, iters, rr, more, t0):
    print(f"[{tag}] {what}: iterations {iters}, true relres {rr:.3e}"
          f"{more}, {time.perf_counter() - t0:.1f} s", flush=True)


def plan_text(st, solver) -> str:
    comm = solver.comm_entries_per_cycle()
    return (f"; levels {[int(a.shape[0]) for a in st.As]}, rows a device "
            f"{list(solver.local_vector_rows().values())}, halo entries of A "
            f"{[comm[l]['A']['halo_entries'] for l in sorted(comm)]}")


def mgtpu_row(key, cells):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from jax.sharding import Mesh
    from mgtpu import get_mg_param
    from mgtpu.parallel.part_amg import PartitionedAMGSolver
    from mgtpu.setup.sa_amg import sa_amg_setup
    from mgtpu.solvers.mg_solver import solve_mg_refined
    opts, max_iter = ROWS[key]
    A, b = problem(cells)
    t0 = time.perf_counter()
    st = sa_amg_setup(A, *get_mg_param(levels=4, dtype=np.float32, **opts))
    solver = PartitionedAMGSolver(
        st, Mesh(np.array(jax.devices()[:DEVICES]), ("x",)))
    x, info = solver.solve_refined(b, tol=1e-8, max_iter=max_iter)
    report("mgtpu", f"{key} {cells}^2, {DEVICES} devices", info["iters"],
           relres(A, b, x), plan_text(st, solver), t0)
    if key == "PA-K":
        t0 = time.perf_counter()
        x, info = solve_mg_refined(st, b, tol=1e-8, max_iter=max_iter)
        report("mgtpu", f"{key} {cells}^2, one device", info["iters"],
               relres(A, b, x), "", t0)


def _port_rank(rank, world, device, key, cells):
    import mgtpu_torch as mt
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.part_amg import PartitionedAMGSolver
    opts, max_iter = ROWS[key]
    A, b = problem(cells)
    cfg, rp = mt.get_mg_param(levels=4, dtype=np.float32, **opts)
    st = mt.sa_amg_setup(A, cfg, rp, device=device)
    solver = PartitionedAMGSolver(st, RankGrid(None, "gloo"), device)
    x, info = solver.solve_refined(b, tol=1e-8, max_iter=max_iter)
    out = dict(iters=int(info["iters"]), relres=relres(A, b, x),
               plan=plan_text(st, solver))
    if key == "PA-K" and rank == 0:
        x, info = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=max_iter)
        out["single"] = (int(info["iters"]), relres(A, b, x))
    return out


def port_row(key, cells):
    from mgtpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    out = run_ranks(_port_rank, DEVICES, "cpu", "gloo", 3600.0,
                    args=(key, cells))[0]
    report("port", f"{key} {cells}^2, {DEVICES} gloo ranks", out["iters"],
           out["relres"], out["plan"], t0)
    if "single" in out:
        report("port", f"{key} {cells}^2, one device", out["single"][0],
               out["single"][1], "", t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="+", default=list(ROWS),
                    choices=list(ROWS))
    ap.add_argument("--cells", type=int, default=512)
    ap.add_argument("--packages", nargs="+", default=["mgtpu"],
                    choices=["mgtpu", "port"])
    args = ap.parse_args()
    for key in args.rows:
        for p in args.packages:
            (mgtpu_row if p == "mgtpu" else port_row)(key, args.cells)
    return 0


if __name__ == "__main__":
    sys.exit(main())
