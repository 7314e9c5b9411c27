#!/usr/bin/env python3
"""Device times of kernels A and C on one CUDA card, at every shape of the
PERF.md kernel tables, and the event time and busy share of three cycles.

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
* one V-cycle of the 3D Jacobi V(1,1) hierarchy and of (a) and (d): CUDA
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


def stencil_rows(cs, timer, st, card):
    """Kernel A in its four modes on the 3D levels and the 129^3 Galerkin
    operator."""
    from mgtpu_torch.ops.cuda import const3d
    levels = [lv.A for lv in st.hier.levels[:-1]]
    t0 = time.perf_counter()
    g129 = cs.galerkin_stencil(256, "cuda")
    cs.log(f"[A] 129^3 Galerkin operator built in "
           f"{time.perf_counter() - t0:.1f} s")
    cases = [("129^3 nd 7", levels[0]), ("129^3 nd 27", g129),
             ("65^3 nd 27", levels[1]), ("33^3 nd 27", levels[2]),
             ("17^3 nd 27", levels[3])]
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


def cycle_rows(cs, st3, L3, card):
    """One V-cycle: 3D Jacobi V(1,1), (a) and (d)."""
    from mgtpu_torch import get_mg_param, mg_setup
    b3 = L3 @ np.random.RandomState(cs.SEED).rand(L3.shape[0])
    runs = [("3D Jacobi V(1,1) 129^3", st3, b3 / np.linalg.norm(b3))]
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
    out = dict(label=args.label, root=str(root), card=smi,
               kind=name, torch=torch.__version__,
               line=line_rows(cs, timer, card),
               stencil=stencil_rows(cs, timer, st3, card),
               cycles=cycle_rows(cs, st3, L3, card))
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        cs.log(f"[done] wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
