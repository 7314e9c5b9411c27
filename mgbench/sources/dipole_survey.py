"""Right-hand side "dipole_survey": the current dipoles of a surface
dipole-dipole survey, as M. H. Loke's "Tutorial: 2-D and 3-D electrical
imaging surveys" lays one out: electrodes at a fixed spacing along
parallel lines on the surface, each source a current dipole +1 / -1
between two neighbouring electrodes of a line (the dipole-dipole array's
C1-C2 of length a; its n-levels place the potential dipoles, which a
forward solve of each source serves at once).

The mix gives the layout in cells of the configuration's mesh
(`electrode_spacing`, `line_spacing`, `margin`), lines along mesh axis 0
on the top face (the last plane of the slowest axis).  The seed draws
which pool x columns distinct sources of the survey fill the pool, and
their order: every seed asks the same kind and number of solves.
"""
from __future__ import annotations

import torch


def electrodes(mix: dict, cfg: dict) -> list[list[int]]:
    """Each line's electrodes as (ix, iy) node indices of the top face."""
    nx, ny = int(cfg["cells"][0]), int(cfg["cells"][1])
    a, s, m = (int(mix[k]) for k in ("electrode_spacing", "line_spacing",
                                     "margin"))
    xs = list(range(m, nx - m + 1, a))
    return [[(ix, iy) for ix in xs] for iy in range(m, ny - m + 1, s)]


def sources(mix: dict, cfg: dict) -> list[tuple[int, int]]:
    """Every source dipole of the survey: (node +1, node -1), flat indices
    in the mesh's order."""
    cells = [int(n) for n in cfg["cells"]]
    nx1, ny1 = cells[0] + 1, cells[1] + 1
    top = (cells[2]) * nx1 * ny1            # first node of the top plane
    out = []
    for line in electrodes(mix, cfg):
        for (x0, y0), (x1, y1) in zip(line[:-1], line[1:]):
            out.append((top + y0 * nx1 + x0, top + y1 * nx1 + x1))
    return out


def make(mix: dict, cfg: dict, seed: int, device) -> torch.Tensor:
    cells = [int(n) for n in cfg["cells"]]
    n = (cells[0] + 1) * (cells[1] + 1) * (cells[2] + 1)
    m, count = int(mix["columns"]), int(mix["pool"])
    src = sources(mix, cfg)
    if count * m > len(src):
        raise ValueError(f"the survey has {len(src)} source dipoles, the "
                         f"mix asks for {count * m} distinct ones")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed) % (2 ** 63))
    order = torch.randperm(len(src), generator=gen).tolist()
    pick = torch.tensor([src[j] for j in order[:count * m]],
                        device=device)              # (count * m, 2)
    k = torch.arange(count * m, device=device)
    B = torch.zeros((count, n, m), dtype=torch.float64, device=device)
    B[k // m, pick[:, 0], k % m] = 1.0
    B[k // m, pick[:, 1], k % m] = -1.0
    return B
