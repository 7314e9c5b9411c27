#!/usr/bin/env python3
"""chip_smoke.py's phase 19 with one card a rank: the multi-device rows
(MS-2d, MG-2d, MG-pen, MG-3d, MG-cg, MG-bicg, DD-par) on 1 NCCL rank and
on N NCCL ranks, each on its own card of one host, against the same
contracts and the same single-device references.

    python3 scripts/multi_card.py [--cards 4]

It needs N cards (N = 4 for the pencil row) and fails without them.
Prints phase 19's [multi] lines (counts, true relres, ms a solve and a
cycle, bytes a cycle by collective kind, kernel D's launches, the fused
and overlapped slab apply times of every rank) and, last, one JSON object
of the rows; `--out` also writes it to a file.
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
    L2 = cs.shifted_laplacian((cs.N2, cs.N2))[1]
    L3 = cs.shifted_laplacian((cs.N3, cs.N3, cs.N3))[1]
    layouts = (("1 NCCL rank", 1, ["cuda:0"], "nccl"),
               (f"{args.cards} NCCL ranks, a card each", args.cards,
                [f"cuda:{r}" for r in range(args.cards)], "nccl"))
    multi, launches = cs.phase_multi(L2, L3, card, layouts)
    out = {"card": card, "cards": args.cards, "rows": multi,
           "launches": launches,
           "seconds": round(time.perf_counter() - t0, 1)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=float)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
