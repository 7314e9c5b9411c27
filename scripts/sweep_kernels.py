#!/usr/bin/env python3
"""Kernels E and F (the lexicographic Vanka and hybrid Kaczmarz sweeps) on
one CUDA card, at the shapes of chip_smoke.py's main path.

    python3 scripts/sweep_kernels.py [--out FILE.json] [--quick]

Builds E, F and the latency probe, prints ptxas's registers / spills and
the probe's ns a dependent shared-memory round (__syncwarp, __syncthreads,
cluster barriers of 2-16 blocks); then checks F on K-mg's levels (256^2,
4 levels, [4, 4] domains), K-prec's 257^2 level, a ragged 255^2 mesh and
K-c's fine level in complex128 and complex64, and every form of E (smem_b,
smem, global) on the 64^2 mixed fine level in each type, against their
plain versions (chip_smoke.py's F_TOLS / LEX_TOLS), two launches bitwise
and E's forms bitwise one another; then the device time (chip_smoke.py's
Timer) of K-mg's fine and level-1 launches, K-c's fine launch and each
form of one 64^2 lex sweep in each type, in µs a step or a cell beside
the byte bound and the chain bound (steps x the probe's round).  It runs chip_smoke.py's own
check_f / time_f / check_e / time_e.  `--quick` checks the coarsest K-mg
level and K-c only.  Exits non-zero on any mismatch, and without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def lex_tables(dt):
    """The 64^2 mixed fine level's vanka-lex tables in `dt` (complex: the
    real operator's tables in a complex type, C-lex's shapes)."""
    from mgtpu_torch.setup.smoothers import setup_vanka
    M, A, _ = cs.elasticity(2, 64, True)
    npdt = {torch.float32: np.float32, torch.float64: np.float64,
            torch.complex64: np.complex64, torch.complex128: np.complex128}
    vr = setup_vanka(A, M, 0.75, True, "vanka-lex", dtype=npdt[dt]).to(
        dt, "cuda")
    return A.shape[0], (vr.idx[0], vr.dinv[0], vr.rows_idx[0],
                        vr.rows_val[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mgtpu_torch.cycle.kaczmarz import setup_hybrid_kaczmarz
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    from mgtpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    smi, name = cs.phase_card()
    card = f"{name}, {smi.split(',')[-1].strip()}"
    cs.BUILD_LOGS.update(_build.build(("kaczmarz", "vanka", "probe")))
    cs.phase_probe(card)
    out = {"card": card, "probe_ns": dict(cs.PROBE_NS), "f": {}, "e": {}}
    row = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    st, _, _ = cs.kmg_state(card)
    levels = [lv.relax for lv in st.hier.levels[:-1]]
    it = st.config.nu_pre[0] * levels[0].num_it
    cases = [(f"K-mg level {l}", kz, dt, m)
             for l, kz in enumerate(levels)
             if not args.quick or l == len(levels) - 1
             for dt, m in ((torch.float64, 1 + l % 3),
                           (torch.float32, 3 - l % 3))]
    if not args.quick:
        cases.append(("K-prec 257^2", cs.kprec_state()[1], torch.float64, 2))
        M_r, A_r = cs.divsig((255, 255), shift=1e-4)
        ragged = setup_hybrid_kaczmarz(A_r, M_r, [4, 4], nodal_indices_of_box,
                                       0.8, 2).to(torch.float64, "cuda")
        cases += [("ragged 255^2", ragged, torch.float32, 1),
                  ("ragged 255^2", ragged, torch.float64, 3)]
    M_c, A_c = cs.helmholtz((256, 256), 0.25)
    kc = setup_hybrid_kaczmarz(A_c, M_c, [4, 4], nodal_indices_of_box, 0.8,
                               2, dtype=np.complex128).to(torch.complex128,
                                                          "cuda")
    cases += [("K-c fine", kc, dt, m) for dt in (torch.complex128,
                                                 torch.complex64)
              for m in (1, 2)]
    for label, kz, dt, m in cases:
        cs.check_f(label, kz, dt, m, 1, row, kz.arr.shape[0] + m,
                   complex_=dt.is_complex)
        cs.log(f"[kernel] F {label} {dt} m={m}: matches the plain version; "
               "a second launch is bitwise the first")
    for label, kz, dt in (("K-mg fine level", levels[0], torch.float64),
                          ("K-mg fine level", levels[0], torch.float32),
                          ("K-mg level 1", levels[1], torch.float64),
                          ("K-c fine level", kc, torch.complex128)):
        out["f"][f"{label} {dt}"] = cs.time_f(label, kz, dt, it, card)
    for dt in (torch.float32, torch.float64, torch.complex64,
               torch.complex128):
        n, tabs = lex_tables(dt)
        forms = cs.check_e(f"64^2 fine {dt}", n, tabs, row, 3,
                           complex_=dt.is_complex)
        cs.log(f"[kernel] E 64^2 fine {dt}: forms {forms} match the plain "
               "version and one another bitwise")
        out["e"][str(dt)] = cs.time_e("64^2 fine level", n, tabs, card)
    out["max_rel_err"] = row["max_rel_err"]
    out["seconds"] = time.perf_counter() - t0
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    cs.log(f"[done] {len(cases)} F cases and 4 E types; max "
           f"rel {row['max_rel_err']:.2e}; {out['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
