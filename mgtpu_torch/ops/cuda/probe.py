"""The latency probe of csrc/probe.cu: ns a dependent shared-memory round
under __syncwarp, __syncthreads or a cluster barrier, on the card.

`round_ns(kind, ctas, threads)` times two launches of different round
counts with CUDA events and returns the slope (the launch's fixed cost
cancels).  Kernels E and F step by these barriers: chip_smoke.py multiplies
their steps by these costs for the sweeps' dependency-chain bounds.  A
measurement tool, not a port of a TPU kernel: it has no plain version and
no launch counter.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["KINDS", "round_ns"]

KINDS = {"warp": 0, "block": 1, "cluster": 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("probe")
    fn = lib.mgt_probe
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return lib


def round_ns(kind: str, ctas: int = 1, threads: int = 32,
             rounds=(20000, 120000), reps: int = 3) -> float:
    """ns of one round on cuda:0 (the best slope of `reps` pairs)."""
    lib = _lib()
    out = torch.empty(ctas * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.mgt_probe(KINDS[kind], ctas, threads, n, out.data_ptr(),
                           stream)
        end.record()
        _build.check(lib, rc, f"probe ({kind}, {ctas} x {threads})")
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e6          # ns

    run(rounds[0])                                    # build, warm up
    best = min((run(rounds[1]) - run(rounds[0])) for _ in range(reps))
    return best / (rounds[1] - rounds[0])
