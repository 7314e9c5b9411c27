#!/usr/bin/env python3
"""chip_smoke.py's phases 19, 20 and 21 with one card a rank: the
multi-device rows (phase 19: MS-2d, MG-2d, MG-pen, MG-3d, MG-cg, MG-bicg,
DD-par; phase 20: SY-2d, SE-2d, SY-3d, MA-sa, MA-cl, MA-fg; phase 21:
PA-sa, PA-cl, PA-K, GK-2d, SK-2d) on 1 NCCL rank and on N NCCL ranks, each
on its own card of one host, against the same contracts and the same
single-device references.

    python3 scripts/multi_card.py [--cards 4] [--phases 19 20 21]

It needs N cards (N = 4 for the pencil, SY-3d and PA-sa's halo rows) and
fails without them.  Phases 20 and 21 first set up their states on card 0
(as chip_smoke.py's phases 7 and 11-13 do, and PA-K's) and keep them in
files the ranks load.  Prints the phases' [multi] / [multi2] / [multi3]
lines (counts, true relres, ms a solve and a cycle, bytes a cycle by
collective kind, kernel D's launches, the fused and overlapped slab apply
times of every rank, PA-sa's halo bytes beside MA-sa's gathers) and, last,
one JSON object of the rows; `--out` also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--phases", type=int, nargs="+", default=[19, 20, 21],
                    choices=[19, 20, 21])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("multi_card: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < args.cards:
        print(f"multi_card: {torch.cuda.device_count()} cards, "
              f"{args.cards} asked for", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi, name = cs.phase_card()
    card = f"{name}, {smi.splitlines()[0].split(',')[-1].strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    layouts = (("1 NCCL rank", 1, ["cuda:0"], "nccl"),
               (f"{args.cards} NCCL ranks, a card each", args.cards,
                [f"cuda:{r}" for r in range(args.cards)], "nccl"))
    out = {"card": card, "cards": args.cards}
    if 19 in args.phases:
        L2 = cs.shifted_laplacian((cs.N2, cs.N2))[1]
        L3 = cs.shifted_laplacian((cs.N3, cs.N3, cs.N3))[1]
        t19 = time.perf_counter()
        out["rows"], out["launches"] = cs.phase_multi(L2, L3, card, layouts)
        out["seconds_19"] = round(time.perf_counter() - t19, 1)
    try:
        if 20 in args.phases:
            t20 = time.perf_counter()
            cs.multi2_states(card)
            torch.cuda.empty_cache()
            out["rows_20"], out["launches_20"] = cs.phase_multi2(card,
                                                                 layouts)
            out["seconds_20"] = round(time.perf_counter() - t20, 1)
        if 21 in args.phases:
            t21 = time.perf_counter()
            cs.multi3_states(card)
            torch.cuda.empty_cache()
            out["rows_21"], out["launches_21"] = cs.phase_multi3(card,
                                                                 layouts)
            out["seconds_21"] = round(time.perf_counter() - t21, 1)
    finally:
        cs.drop_handoffs()
    out["seconds"] = round(time.perf_counter() - t0, 1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=float)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
