#!/usr/bin/env python3
"""Device times of kernels A, B and C on one CUDA card, at every shape of the
PERF.md kernel tables, and the event time and busy share of four cycles.

    python3 scripts/kernel_times.py [--root DIR] [--label NAME] [--out FILE]

--root is the checkout whose mgtpu_torch is timed (default: this one), for
example a parent commit unpacked with `git archive` under _chip/, so that two
versions run in turns in one session on one card (parent, change, change,
parent).  The problems, the timer and the cycle helpers come from this
checkout's chip_smoke.py, so both versions are timed the same way:

* kernel C (line_apply, float32, m = 1) in solve and correct mode on the
  lines of configurations (a) (1025^2, axes 0 and 1) and (d) (129^3, axes 0
  and 2);
* kernel A (stencil3d_apply, m = 1) in its four modes on the 129^3 fine
  operator (nd 7), the 129^3 Galerkin operator (nd 27) and the 65^3, 33^3
  and 17^3 levels of the 3D hierarchy; beside each, the bytes bound, the
  plain version and, for matvec, conv3d of the interior constants;
* kernel B (jacobi_residual3d, m = 1) on the same five operators, beside
  its bytes bound, its plain version and kernel A's jacobi followed by its
  residual (the same function in two launches), with the device time of
  each of its launches (torch.profiler); where the checkout has
  jacres_plan and with --sweep, also with x-runs of 1 to 32 planes;
* one V-cycle of the 3D Jacobi V(1,1) hierarchy, of the default SPAI
  V(2,2) hierarchy (kernel B on every level) and of (a) and (d): CUDA
  events and torch.profiler's device time (busy share).

Each kernel time is 40 calls back to back by CUDA events, rotating over four
independent input sets (coefficients included) so that at the large shapes
each call finds its inputs evicted from the 50 MB L2.  A SHA-1 of each
kernel's output on fixed inputs lets two versions be compared bit for bit.
Needs a card; prints one line per shape and, with --out, writes every
number as JSON.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
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


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def cuda_tensor(a, dtype):
    return torch.tensor(a, dtype=dtype, device="cuda")


def line_rows(cs, timer, card):
    """Kernel C on the four line shapes, both modes."""
    from mgtpu_torch.cycle.relax import LineRelax
    from mgtpu_torch.ops.cuda import tridiag
    ops = {"1025^2": cs.aniso2d(1024, 100.0), "129^3": cs.aniso3d([128] * 3, 0)}
    rows = []
    for label, axes in (("1025^2", (0, 1)), ("129^3", (0, 2))):
        states = cs.line_states(*ops[label], torch.float32)
        for axis in axes:
            lr = states[axis]
            # four independent sets: coefficient copies, r, x
            sets = []
            for j in range(4):
                rng = np.random.RandomState(100 + j)
                co = [c.clone() for c in (lr.alpha, lr.pivot, lr.cprime)]
                r, x = (cuda_tensor(rng.rand(1, *lr.alpha.shape),
                                    torch.float32) for _ in range(2))
                sets.append((LineRelax(*co, lr.axis, lr.omega), r, x))
            nodes = lr.alpha.numel()
            grid = tuple(lr.alpha.shape)
            inner = int(np.prod(grid[axis + 1:]))
            planner = getattr(tridiag, "line_plan", None)
            for name in ("tridiag.solve", "tridiag.correct"):
                plan = None if planner is None else planner(
                    nodes // (grid[axis] * inner), grid[axis], inner, 4,
                    name.split(".")[1])._asdict()
                calls = [lambda s=s: cs.run_line(name, s[0], s[1], s[2], False)
                         for s in sets]
                ms, host_ms = timer(calls)
                plain_ms, _ = timer(
                    [lambda s=s: cs.run_line(name, s[0], s[1], s[2], True)
                     for s in sets])
                fbytes = (cs.KERNELS[name][2] + 3) * 4 * nodes
                flops = (7 if name.endswith("correct") else 6) * nodes
                bound = max(fbytes / cs.HBM_BYTES_PER_S,
                            flops / cs.FP32_FLOPS) * 1e3
                h = digest(calls[0]())
                row = dict(kernel=name, shape=f"{label} axis {axis}",
                           ms=ms, bound_ms=bound, plain_ms=plain_ms,
                           host_ms=host_ms, share=bound / ms, plan=plan,
                           sha1=h)
                rows.append(row)
                cs.log(f"[C] {label} axis {axis} {name:16s} {ms * 1e3:8.2f} us"
                       f"  bound {bound * 1e3:6.2f} us  share "
                       f"{bound / ms:5.1%}  plain {plain_ms * 1e3:8.1f} us  "
                       f"plan {plan}  ({card})")
    return rows


def stencil_cases(cs, st):
    """The five operators of the kernel A and B tables."""
    levels = [lv.A for lv in st.hier.levels[:-1]]
    t0 = time.perf_counter()
    g129 = cs.galerkin_stencil(256, "cuda")
    cs.log(f"[A] 129^3 Galerkin operator built in "
           f"{time.perf_counter() - t0:.1f} s")
    return [("129^3 nd 7", levels[0]), ("129^3 nd 27", g129),
            ("65^3 nd 27", levels[1]), ("33^3 nd 27", levels[2]),
            ("17^3 nd 27", levels[3])]


def stencil_rows(cs, timer, cases, card):
    """Kernel A in its four modes on the 3D levels and the 129^3 Galerkin
    operator."""
    from mgtpu_torch.ops.cuda import const3d
    rows = []
    for label, A in cases:
        sets = [cs.fields(A.grid, 1, 1 + j) for j in range(4)]
        nodes = int(np.prod(A.grid))
        conv_ms, _ = timer([cs.conv3d_yardstick(A, x) for x, _, _, _ in sets])
        for name in cs.STENCIL_KERNELS:
            if name == "jacobi_residual3d":
                continue
            mode = name.split(".")[1]
            plan = getattr(const3d, "apply_plan", None)
            plan = None if plan is None else plan(tuple(A.grid), A.boxes,
                                                mode)._asdict()
            calls = [lambda f=f: cs.run_kernel(name, A, *f, plain=False)
                     for f in sets]
            ms, host_ms = timer(calls)
            plain_ms, _ = timer([lambda f=f: cs.run_kernel(name, A, *f,
                                                           plain=True)
                                 for f in sets])
            fbytes = cs.KERNELS[name][2] * 4 * nodes
            flops = 2 * len(A.offsets) * nodes
            bound = max(fbytes / cs.HBM_BYTES_PER_S,
                        flops / cs.FP32_FLOPS) * 1e3
            h = digest(calls[0]())
            rows.append(dict(kernel=name, shape=label, ms=ms, bound_ms=bound,
                             plain_ms=plain_ms, host_ms=host_ms,
                             share=bound / ms, plan=plan, sha1=h,
                             library_ms=conv_ms if mode == "matvec" else None))
            cs.log(f"[A] {label:11s} {mode:12s} {ms * 1e3:8.2f} us  bound "
                   f"{bound * 1e3:6.2f} us  share {bound / ms:5.1%}  plain "
                   f"{plain_ms * 1e3:8.1f} us  conv3d {conv_ms * 1e3:7.1f} us"
                   f"  ({card})")
    return rows


def launch_times(calls, reps=20):
    """Device time per call of each kernel the calls launch (torch.profiler
    over `reps` calls), by kernel name; None without device events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    out = {e.key.split("<")[0].split("(")[0]: e.self_device_time_total
           / reps / 1e3 for e in prof.key_averages()
           if e.self_device_time_total > 0}
    return out or None


def jacres_rows(cs, timer, cases, card, sweep=False):
    """Kernel B on the five operators: its plan, its launches, the plain
    version, kernel A's jacobi + residual, and (where jacres_plan exists,
    with `sweep`) each x-run."""
    from mgtpu_torch.ops.cuda import fused3d
    planner = getattr(fused3d, "jacres_plan", None)
    rows = []
    for label, A in cases:
        sets = [cs.fields(A.grid, 1, 1 + j) for j in range(4)]
        nodes = int(np.prod(A.grid))
        name = "jacobi_residual3d"
        calls = [lambda f=f: cs.run_kernel(name, A, *f, plain=False)
                 for f in sets]
        ms, host_ms = timer(calls)
        plain_ms, _ = timer([lambda f=f: cs.run_kernel(name, A, *f,
                                                       plain=True)
                             for f in sets])

        def a_pair(f):
            x, b, d, p = f
            x1 = cs.run_kernel("stencil3d_apply.jacobi", A, x, b, d, p,
                               plain=False)
            return x1, cs.run_kernel("stencil3d_apply.residual", A, x1, b,
                                     d, p, plain=False)
        pair_ms, _ = timer([lambda f=f: a_pair(f) for f in sets])
        fbytes = cs.KERNELS[name][2] * 4 * nodes
        flops = 4 * len(A.offsets) * nodes
        bound = max(fbytes / cs.HBM_BYTES_PER_S,
                    flops / cs.FP32_FLOPS) * 1e3
        x1, r1 = calls[0]()
        xa, ra = a_pair(sets[0])
        row = dict(kernel=name, shape=label, ms=ms, bound_ms=bound,
                   plain_ms=plain_ms, host_ms=host_ms, share=bound / ms,
                   a_jacobi_residual_ms=pair_ms, sha1_x=digest(x1),
                   sha1_r=digest(r1),
                   equals_a=bool(torch.equal(x1, xa) and torch.equal(r1, ra)),
                   launch_ms=launch_times(calls), plan=None, sweep=None)
        if planner is not None:
            grid = tuple(A.grid)
            row["plan"] = planner(grid, A.boxes)._asdict()
            if sweep:
                row["sweep"] = {}
                xi = row["plan"]["xrun"] * row["plan"]["nruns"]
                for xrun in (1, 2, 3, 4, 6, 8, 11, 14, 20, 32):
                    plan = fused3d._plan_array(grid, A.boxes, -(-xi // xrun))
                    row["sweep"][f"x-run {plan[3]}"] = timer([
                        lambda f=f, plan=plan: fused3d._launch(
                            A, f[2], f[1], f[0], plan) for f in sets])[0]
        rows.append(row)
        cs.log(f"[B] {label:11s} {ms * 1e3:8.2f} us  bound "
               f"{bound * 1e3:6.2f} us  share {bound / ms:5.1%}  A jacobi + "
               f"residual {pair_ms * 1e3:7.2f} us  plain {plain_ms * 1e3:8.1f}"
               f" us  bitwise A {row['equals_a']}  launches (us) "
               f"{ {k: round(v * 1e3, 2) for k, v in (row['launch_ms'] or {}).items()} }"
               f"  plan {row['plan']}  ({card})")
        if row["sweep"]:
            cs.log(f"[B] {label:11s} sweep (us): " + ", ".join(
                f"{k} {v * 1e3:.2f}" for k, v in row["sweep"].items()))
    return rows


def cycle_rows(cs, st3, L3, M3, card):
    """One V-cycle: 3D Jacobi V(1,1), 3D SPAI V(2,2), (a) and (d)."""
    from mgtpu_torch import get_mg_param, mg_setup
    b3 = L3 @ np.random.RandomState(cs.SEED).rand(L3.shape[0])
    b3 = b3 / np.linalg.norm(b3)
    cfg, rp = get_mg_param(levels=5, dtype=np.float32)   # SPAI 1.0 V(2,2)
    runs = [("3D Jacobi V(1,1) 129^3", st3, b3),
            ("3D SPAI V(2,2) 129^3", mg_setup(L3, M3, cfg, rp), b3)]
    for key, label, make, opts, _ in cs.ANISO:
        if key not in ("a", "d"):
            continue
        M, A = make()
        cfg, rp = get_mg_param(nu_pre=1, nu_post=1, dtype=np.float32, **opts)
        st = mg_setup(A, M, cfg, rp)
        b = A @ np.random.RandomState(cs.SEED).rand(A.shape[0])
        runs.append((f"({key}) line cycle", st, b / np.linalg.norm(b)))
    rows = []
    for label, st, b in runs:
        ev_ms, host_ms = cs.vcycle_ms(st, b, card, label=label)
        busy = cs.vcycle_profile(st, b, ev_ms, card, label=label)
        rows.append(dict(cycle=label, event_ms=ev_ms, host_ms=host_ms,
                         device_ms=busy,
                         busy_share=None if busy is None else busy / ev_ms))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose mgtpu_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=None, help="JSON file to write")
    ap.add_argument("--sweep", action="store_true",
                    help="also time kernel B at x-runs of 1 to 32 planes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import mgtpu_torch
    pkg = Path(mgtpu_torch.__file__).resolve()
    if root not in pkg.parents:
        raise RuntimeError(f"mgtpu_torch came from {pkg}, not {root}")
    cs = load_smoke()
    smi, name = cs.phase_card()
    card = f"{name}, {smi.split(',')[-1].strip()}"
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()

    from mgtpu_torch import get_mg_param, mg_setup
    M3, L3 = cs.shifted_laplacian((128, 128, 128))
    cfg, rp = get_mg_param(levels=5, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    st3 = mg_setup(L3, M3, cfg, rp)
    timer = cs.Timer(reps=40)
    cases = stencil_cases(cs, st3)
    out = dict(label=args.label, root=str(root), card=smi,
               kind=name, torch=torch.__version__,
               line=line_rows(cs, timer, card),
               stencil=stencil_rows(cs, timer, cases, card),
               jacres=jacres_rows(cs, timer, cases, card, args.sweep),
               cycles=cycle_rows(cs, st3, L3, M3, card))
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        cs.log(f"[done] wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
