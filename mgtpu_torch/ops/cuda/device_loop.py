"""The device-side while loop of csrc/device_loop.cu.

`build(init, body, go_init, go_body)` takes the raw graphs of two torch
recordings (`torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()`: a
loop's start and one iteration) and the 0-dim bool tensors they write,
and returns an `Executable` whose `launch()` runs, on the current stream,
the start, then the iteration while its condition holds — one graph with
a conditional WHILE node, the card's counterpart of mgtpu's
`lax.while_loop`.  cycle/capture.py's `loop` is the caller.  `census`
counts a raw graph's nodes by type; `body_takes` says whether a graph of
that census can go into the loop.

The `set_cond` kernel writes a condition tensor into the node's handle:
one after the start and one after each iteration.  It has no plain
version (the CPU runs the loop in Python).  The graph launches it on the
device, where no wrapper sees it: `ran(k)`, which the caller calls with
the iteration count it reads after each loop, adds the loop's 1 + k
launches to `LAUNCHES["set_cond"]`.

The caller launches the loop graph only while torch.profiler is off:
under its CUDA tracing the launches faulted (csrc/device_loop.cu).
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import _build

__all__ = ["LAUNCHES", "Executable", "body_takes", "build", "census", "ran"]

LAUNCHES = {"set_cond": 0}


# cudaGraphNodeType by value, and the census's last entry
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional", "type14", "type15", "host_memcpy")
BODY_NODES = {"kernel", "memcpy", "memset", "graph", "empty", "conditional"}
STAGES = ("graph", "handle", "start node", "first set_cond", "while node",
          "iteration node", "second set_cond", "instantiate")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("device_loop")
    lib.mgt_loop_build.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_void_p)] * 2 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.mgt_loop_launch.argtypes = [ctypes.c_void_p] * 2
    lib.mgt_loop_free.argtypes = [ctypes.c_void_p] * 2
    lib.mgt_graph_census.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_int]
    for fn in (lib.mgt_loop_build, lib.mgt_loop_launch, lib.mgt_loop_free,
               lib.mgt_graph_census):
        fn.restype = ctypes.c_int
    return lib


def ran(iterations: int) -> None:
    """Counts the set_cond launches of a loop that ran `iterations`
    iterations: one after the start, one after each iteration."""
    LAUNCHES["set_cond"] += 1 + iterations


def census(graph: int) -> dict:
    """{node type: count} of a raw graph, child graphs' nodes included;
    "host_memcpy" counts its copies with an operand outside device
    memory."""
    lib = _lib()
    counts = (ctypes.c_int * len(NODE_TYPES))()
    _build.check(lib, lib.mgt_graph_census(graph, counts, len(counts)),
                 "graph census")
    return {t: c for t, c in zip(NODE_TYPES, counts) if c}


def body_takes(counts: dict) -> bool:
    """Whether a graph of this `census` can go into the loop: a WHILE
    node's body, and a child-graph node, take kernel, empty, child-graph,
    conditional, memset and device-memory memcpy nodes alone — not the
    memory-allocation nodes of a library's stream-ordered workspace, nor
    host, event or host-memory copy nodes."""
    return set(counts) <= BODY_NODES


def _free(exec_: int, graph: int) -> None:
    _lib().mgt_loop_free(exec_, graph)


class Executable:
    """An instantiated loop graph; freed with the object.  It reads the
    memory of the recordings it was built from: the caller keeps their
    graphs and tensors alive as long as this."""

    def __init__(self, exec_: int, graph: int):
        self._exec = exec_
        self._free = weakref.finalize(self, _free, exec_, graph)

    def launch(self) -> None:
        lib = _lib()
        rc = lib.mgt_loop_launch(self._exec,
                                 torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, "device loop launch")


def build(init: int, body: int, go_init: torch.Tensor,
          go_body: torch.Tensor) -> Executable:
    """The loop graph of two raw graphs and their condition tensors."""
    for go in (go_init, go_body):
        if not (go.is_cuda and go.dtype == torch.bool and go.dim() == 0):
            raise ValueError("a loop's condition is a 0-dim bool CUDA "
                             f"tensor, not {go.dtype} {tuple(go.shape)} "
                             f"on {go.device}")
    lib = _lib()
    exec_, graph, stage = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    rc = lib.mgt_loop_build(init, body, go_init.data_ptr(),
                            go_body.data_ptr(), ctypes.byref(exec_),
                            ctypes.byref(graph), ctypes.byref(stage))
    if rc != 0:
        _build.check(lib, rc, f"device loop build ({STAGES[stage.value]}; "
                     f"start {census(init)}, iteration {census(body)})")
    return Executable(exec_.value, graph.value)
