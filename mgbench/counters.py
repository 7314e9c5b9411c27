"""The program's counters as the benchmark reads them, and its own byte
counts of the kernels (kernels/<kernel>.py, found by file).

The kernel wrappers of `mgtpu_torch.ops.cuda` count launches in dicts; a
CUDA graph's replay adds back what its recording counted
(`mgtpu_torch.cycle.capture.Tally`).  `install_byte_counts` has each
kernels/<kernel>.py wrap its entry points so that each launch also adds
its least bytes (mgbench/bytes.py) and one call, under keys of the
benchmark's own ("mgbench.<kernel>.bytes", ".calls"), to its wrapper
module's LAUNCHES: the graphs' replays then carry them as they carry the
launches.
"""
from __future__ import annotations

from . import spec

OWN = "mgbench."
_INSTALLED: set[str] = set()


def _modules():
    from mgtpu_torch.ops.cuda import (const3d, fused3d, kaczmarz, stencil,
                                      tridiag, vanka)
    return {"const3d": const3d, "fused3d": fused3d, "stencil": stencil,
            "tridiag": tridiag, "vanka": vanka, "kaczmarz": kaczmarz}


def kernels() -> dict:
    """{kernel: its module} of every kernels/<kernel>.py."""
    return {k: spec.code("kernels", k) for k in spec.names("kernels")}


def snapshot() -> dict:
    """Every wrapper's launch count and plain-version calls, and the
    benchmark's byte and call counts: {"<module>.<key>": n}."""
    out = {}
    mods = _modules()
    for name, mod in mods.items():
        for key, v in mod.LAUNCHES.items():
            out[f"{name}.launches.{key}"] = v
        for key, v in mod.PLAIN_CALLS.items():
            out[f"{name}.plain.{key}"] = v
    stencil = mods["stencil"]
    for key, v in stencil.HALO_LAUNCHES.items():
        out[f"stencil.halo.{key}"] = v
    for key, v in stencil.BLOCK_LAUNCHES.items():
        out[f"stencil.block.{key}"] = v
    return out


def delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def launches(d: dict) -> int:
    """Hand-written kernel launches in a delta (the benchmark's keys
    aside)."""
    return sum(v for k, v in d.items()
               if ".launches." in k and OWN not in k)


def install_byte_counts() -> None:
    """Wrap the entry points of every kernels/<kernel>.py (once each)."""
    mods = _modules()
    for kernel, km in kernels().items():
        if kernel in _INSTALLED:
            continue
        counts = mods[km.MODULE].LAUNCHES

        def add(nbytes_: int, counts=counts, kernel=kernel) -> None:
            for key, v in ((f"{OWN}{kernel}.bytes", nbytes_),
                           (f"{OWN}{kernel}.calls", 1)):
                counts[key] = counts.get(key, 0) + v

        km.install(add)
        _INSTALLED.add(kernel)


def own_counts(d: dict, kernel: str) -> tuple[int, int]:
    """(bytes, calls) the benchmark counted for `kernel` in a delta."""
    m = spec.code("kernels", kernel).MODULE
    return (d.get(f"{m}.launches.{OWN}{kernel}.bytes", 0),
            d.get(f"{m}.launches.{OWN}{kernel}.calls", 0))


def agree(traced: dict, kernel: str) -> tuple[int, int, int]:
    """(launches counted by the benchmark, by the program, seen in the
    trace) of `kernel` in a traced window."""
    from .trace import kernel_us
    km = spec.code("kernels", kernel)
    d = traced["counters"]
    return (own_counts(d, kernel)[1], km.launches(d),
            kernel_us(traced, km.TRACE)[1])


def complete(traced: dict) -> bool:
    """Whether a trace shows a device kernel for every launch of each
    counted kernel that the program counted in it, and the byte counts
    cover them all."""
    return all(len(set(agree(traced, k))) == 1 for k in kernels())
