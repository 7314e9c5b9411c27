"""The benchmark of mgtpu_torch.

    python3 mgbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json on the card(s) of this machine and prints,
as the last line of standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device (with --trace 1 also busy_s and window_s),
with --trace 1 breakdown, what this run compiled (build: only a
checkout's first run compiles), and last the numbers compared with their
limits (checks), which also end standard error.  Exits non-zero, printing
no result, without enough CUDA devices, or when JAX or mgtpu was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mgtpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch
    from mgbench import loop, spec
    t_import = time.perf_counter() - T_START
    bench = spec.benchmark()
    chips = int(spec.cell(bench, a.workload)["workload"]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"mgbench: {a.workload} needs {chips} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = loop.run(a.workload, a.seed, a.seconds, bool(a.trace),
                   device="cuda:0", chips=chips, t_start=T_START, bench=bench)
    rec = out.pop("_record")
    spans = {k: round(v, 3) for k, v in rec["spans"].items()
             if k.startswith("setup.")}
    iters = rec["iters"]
    print(f"mgbench: imports {t_import:.3f} s, set-up spans {spans}, "
          f"level gaps {rec['level_gaps']}, {rec['calls']} calls, "
          f"{sum(iters) / max(1, len(iters)):.4f} iterations a call",
          file=sys.stderr)
    print(f"mgbench: built {out['build']['compiled'] or 'nothing'} in "
          f"{out['build']['seconds']:.3f} s", file=sys.stderr)
    if rec["traced"]:
        from mgbench import counters
        t = rec["traced"]
        print(f"mgbench: trace {t['attempt']} complete {t['complete']}: " +
              ", ".join("{} {} counted / {} by the program / {} in the "
                        "trace".format(k, *counters.agree(t, k))
                        for k in counters.kernels()), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"mgbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
