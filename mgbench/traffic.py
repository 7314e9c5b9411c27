"""The one traffic generator: reads a mix's parameters (traffic/<mix>.json)
and makes its pool of right-hand sides from the seed, on the device.

A mix is closed-loop: one client submits one call (a right-hand side, or a
block of `columns`) after another, cycling through `pool` calls.  Its
`rhs` names the kind of right-hand side, made by sources/<rhs>.py's
`make(mix, cfg, seed, device)`: a float64 tensor (pool, n, columns) in the
operator's order of unknowns, the same sizes for every seed.  Each mix
file names in `source` where its kind of right-hand side comes from.
"""
from __future__ import annotations

import torch

from . import spec

KEYS = {"rhs", "columns", "pool", "sample", "source"}


def check(mix: dict) -> None:
    missing = KEYS - set(mix)
    if missing:
        raise ValueError(f"traffic mix lacks {sorted(missing)}")
    for k in ("columns", "pool", "sample"):
        if int(mix[k]) < 1:
            raise ValueError(f"traffic {k} must be >= 1")


def make_pool(mix: dict, cfg: dict, seed: int, device,
              root=spec.ROOT) -> list[torch.Tensor]:
    """`pool` float64 tensors, (n,) for one column or (n, columns)."""
    check(mix)
    try:
        gen = spec.source(mix["rhs"], root)
    except KeyError:
        raise ValueError(f"unknown right-hand side kind {mix['rhs']!r}")
    m, count = int(mix["columns"]), int(mix["pool"])
    B = gen.make(mix, cfg, int(seed), torch.device(device))
    if B.dtype != torch.float64 or B.ndim != 3 or B.shape[0] != count \
            or B.shape[2] != m:
        raise ValueError(f"sources/{mix['rhs']}.py made {tuple(B.shape)} "
                         f"{B.dtype}, not ({count}, n, {m}) float64")
    return [B[i, :, 0].contiguous() if m == 1 else B[i].contiguous()
            for i in range(count)]
