"""Start the ranks of the multi-device tier: one spawned process a rank.

mgtpu's multi-device tier runs inside one process over a device mesh; the
port's runs one process a rank under torch.distributed.  `run_ranks`
spawns them (the ``spawn`` start method: no fork of a process that holds
threads or a CUDA context), starts the process group from a ``file://``
store in a fresh temporary directory (no port, so no collision between
concurrent test workers), runs ``fn(rank, world, device, *args)`` in each,
and returns what each returned, by rank.

A hang fails, it does not wait: the process group gets `timeout`, and the
parent joins with a hard deadline, after which it kills every rank and
raises.  A rank that raises stops the run with the rank's traceback.

Each rank takes one host thread for torch on the CPU
(`torch.set_num_threads(1)`) and for numpy's BLAS (OMP_NUM_THREADS and its
kin, set while the ranks start: a rank inherits them before it imports
numpy), so that R ranks do not oversubscribe the host's cores; a rank on a
card makes it the current device (`torch.cuda.set_device`).  When any
rank runs on a card, the parent builds the CUDA kernels first, so that no
two ranks build into mgtpu_torch/_build/ at once.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch

from .comm import TRANSPORTS

__all__ = ["run_ranks"]

_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
_GRACE_S = 3.0          # how long the other ranks' reports are awaited


def _rank_main(fn, rank, world, device, backend, store, timeout_s, out,
               args):
    import torch.distributed as dist
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, devices, backend: str,
              deadline_s: float = 60.0, args: tuple = ()) -> list:
    """Run fn(rank, world, device, *args) on `world` spawned ranks and
    return their results, by rank.

    `fn` and `args` are pickled: fn is a module-level function.  `devices`
    and `backend` have no default: the caller names the card (or "cpu",
    as the tests do) and the transport.  `devices` is one device for every
    rank ("cpu", "cuda:0" for gloo ranks sharing
    a card) or a list of one device a rank (["cuda:0", "cuda:1"] for
    NCCL).  `backend` ("gloo" or "nccl") is the process group's, and what
    the ranks' RankGrid must name.  Raises TimeoutError once `deadline_s`
    seconds have passed with a rank unfinished (every rank is killed
    first), RuntimeError with the tracebacks of the ranks that failed
    (those that report within a few seconds of the first)."""
    if backend not in TRANSPORTS:
        raise ValueError(f"backend must be one of {TRANSPORTS}")
    if isinstance(devices, (str, torch.device)):
        devices = [str(devices)] * world
    devices = [str(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if any(torch.device(d).type == "cuda" for d in devices):
        from ..ops.cuda import _build
        _build.build()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mgtpu_ranks_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, devices[r], backend,
                               os.path.join(tmp, "store"), deadline_s, out,
                               args))
             for r in range(world)]
    results: dict = {}
    failed: dict = {}
    end = time.monotonic() + deadline_s
    try:
        saved = {k: os.environ.get(k) for k in _ONE_THREAD}
        os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        while len(results) + len(failed) < world:
            left = end - time.monotonic()
            if left <= 0:
                if failed:
                    break
                raise TimeoutError(
                    f"{world} ranks passed their {deadline_s:.0f} s "
                    f"deadline; finished: {sorted(results)}")
            try:
                rank, ok, value = out.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results
                        and r not in failed]
                if dead and not failed:
                    try:                 # a last message may be in flight
                        rank, ok, value = out.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                else:
                    continue
            if ok:
                results[rank] = value
                continue
            # a failed rank makes its peers fail too (their collectives
            # lose it): collect the others' reports for a moment, so that
            # the error shows the first cause whichever report came first
            failed[rank] = value
            end = min(end, time.monotonic() + _GRACE_S)
        if failed:
            raise RuntimeError("".join(
                f"rank {r} failed:\n{failed[r]}" for r in sorted(failed)))
    finally:
        # every result is in (or the run failed): nothing a rank still
        # does is needed, so its interpreter's teardown is not waited for
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
