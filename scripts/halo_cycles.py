#!/usr/bin/env python3
"""Cycles of the multi-device grid tier on one NCCL rank, one CUDA card:
device operations a cycle (torch.profiler), kernel D's launches a cycle,
cycle time by CUDA events and by the host clock.

    python3 scripts/halo_cycles.py [--root DIR] [--label NAME] [--out FILE]

--root is the checkout whose mgtpu_torch runs (default: this one), for
example a parent commit unpacked with `git archive` under _chip/, so that
two versions run in turns on one card (parent, change, change,
parent).  The problems and helpers come from this checkout's
chip_smoke.py, so both versions run the same cycles:

* MS-2d: one step of the slab GMG (parallel/sharded.py: a V-cycle and the
  residual norm) on 1025^2 at 6 levels, f32;
* MG-2d and MG-3d: one correction cycle from zero of the grid-sharded
  engine (ShardedGridSolver.cycle) on 1025^2 at 6 levels and 129^3 at 5;
* the f64 refined residual b - A x of MG-2d's solver (its fine operator
  in f64; `residual` where the checkout has it, else b - matvec).

The rank group is one process on the card, its store on localhost.  Each
cycle is warmed first; its time is the mean of 20 back to back by CUDA
events and the median of five synchronised host-clock calls; its device
operations (kernels and copies) and kernel D's launches are those of one
call.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import socket
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def d_launches() -> int:
    from mgtpu_torch.ops.cuda import stencil
    return sum(stencil.LAUNCHES.values())


def measure(cs, label, fn, card):
    """Warm `fn`, then its event and host times, device operations and
    kernel D's launches a call."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        fn()
    e1.record()
    torch.cuda.synchronize()
    ev = e0.elapsed_time(e1) / 20
    n0 = d_launches()
    fn()
    torch.cuda.synchronize()
    d = d_launches() - n0
    ops = cs.cycle_kernels(fn, torch.device("cuda", 0))
    cs.log(f"[halo-cycles] {label}: {ev:.3f} ms a cycle by events, "
           f"{float(np.median(host)):.3f} ms host clock; kernel D "
           f"{d} launches; device operations {cs.device_ops_note(ops)} "
           f"({card})")
    return dict(event_ms=ev, host_ms=float(np.median(host)),
                d_launches=d, device_ops=ops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose mgtpu_torch runs")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=None, help="JSON file to write")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("halo_cycles: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import mgtpu_torch
    pkg = Path(mgtpu_torch.__file__).resolve()
    if root not in pkg.parents:
        raise RuntimeError(f"mgtpu_torch came from {pkg}, not {root}")
    import torch.distributed as dist
    from mgtpu_torch import get_mg_param, mg_setup
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.sharded import make_sharded_solver
    from mgtpu_torch.parallel.sharded_solve import ShardedGridSolver
    cs = load_smoke()
    smi, name = cs.phase_card()
    card = f"{name}, {smi.split(',')[-1].strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    out = dict(label=args.label, root=str(root), card=smi, kind=name,
               torch=torch.__version__, rows={})
    try:
        comm = RankGrid(None, "nccl")
        dev = torch.device("cuda", 0)
        jac = dict(relax_type="jacobi", relax_param=0.8, nu_pre=1,
                   nu_post=1, dtype=np.float32)
        M2, L2 = cs.shifted_laplacian((cs.N2, cs.N2))
        st2 = mg_setup(L2, M2, *get_mg_param(levels=cs.LEVELS2, **jac),
                       device="cpu")
        M3, L3 = cs.shifted_laplacian((cs.N3,) * 3)
        st3 = mg_setup(L3, M3, *get_mg_param(levels=cs.LEVELS3, **jac),
                       device="cpu")
        b2 = L2 @ np.random.RandomState(cs.SEED).rand(L2.shape[0])
        b3 = L3 @ np.random.RandomState(cs.SEED).rand(L3.shape[0])
        mg, step, to_grid, _ = make_sharded_solver(st2, comm, device=dev)
        bg = to_grid(b2 / np.linalg.norm(b2))
        xg = torch.zeros_like(bg)
        out["rows"]["MS-2d"] = measure(cs, "MS-2d slab step", lambda: step(
            mg, bg, xg), card)
        for row, st, b in (("MG-2d", st2, b2), ("MG-3d", st3, b3)):
            s = ShardedGridSolver(st, comm, (0,), dev)
            rv = s.to_grid(b / np.linalg.norm(b))[0]
            z = torch.zeros_like(rv)
            out["rows"][row] = measure(cs, f"{row} cycle",
                                       lambda: s.cycle(s.gh, rv, z, True),
                                       card)
            if row == "MG-2d":
                A64 = s.f64_operator()
                bv = s.to_grid(b2, torch.float64)[0]
                xv = torch.ones_like(bv)
                res = getattr(A64, "residual",
                              lambda b, x: b - A64.matvec(x))
                out["rows"]["MG-2d f64 residual"] = measure(
                    cs, "MG-2d refined residual (f64)",
                    lambda: res(bv, xv), card)
    finally:
        dist.destroy_process_group()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
