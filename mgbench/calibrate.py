"""Readings of the checks that decide `correct`: the program's sound runs
over many seeds (the lower readings) and its lower-precision paths put in
its place (the controls, the upper readings), at a cell's own size and
load, in one process.

    python3 mgbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        --modes sound,outer,levels --seconds 3 --out <file.jsonl>

Modes: "sound", the benchmark's run; "outer", solves with a float32 outer
iteration (`solve_mg_refined(outer_dtype=float32)`, a float32 b to the
Krylov solve); "levels", the level operators judged are the program's
bfloat16 copy of the hierarchy (`cast_hierarchy`).  Where the operator
draws nothing from the seed, one set-up serves every seed.  Needs a CUDA
device, as run.py does; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", default="sound")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    import torch
    from mgbench import loop, spec
    from mgbench.trace import Spans
    if not torch.cuda.is_available():
        print("mgbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec.benchmark()
    parts = spec.cell(bench, a.workload)
    ref = spec.reference(parts["config"]["operator"])
    first = ref.inputs(parts["config"], a.seeds[0])
    seeded = any(not loop._same(first, ref.inputs(parts["config"], s))
                 for s in a.seeds[1:])
    out = open(a.out, "a") if a.out else None
    cell = None
    for seed in a.seeds:
        for mode in a.modes.split(","):
            t0 = time.perf_counter()
            if cell is None or seeded:
                cell = loop.Cell(parts, seed, "cuda:0", Spans())
            r = loop.run(a.workload, seed, a.seconds, False, device="cuda:0",
                         bench=bench, control=None if mode == "sound"
                         else mode, cell=cell)
            row = {"workload": a.workload, "seed": seed, "mode": mode,
                   "correct": r["correct"], "attempted": r["attempted"],
                   "failed": r["failed"],
                   "iters": r["_record"]["iters"],
                   "level_gaps": r["_record"]["level_gaps"],
                   "checks": {k: c["value"] for k, c in r["checks"].items()},
                   "seconds": time.perf_counter() - t0}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        if seeded:
            cell = None
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
