"""The Krylov loops with their stop test on the card.

mgtpu runs each Krylov method as one `lax.while_loop`: no host read until
it stops.  Here a method is three functions of its state (a tuple of
tensors): `init(*args)`, `step(state)` — one iteration as the eager loop
runs it — and `go(state)`, a 0-dim bool tensor, the loop's condition.
`iterate` runs them in one of two forms:

 * The while form (cycle/capture.py `loop`), on the card wherever the
   iteration takes no host step: `init` and `go`, then `step` and `go`
   written back into the loop's buffers, recorded and joined into one
   CUDA graph whose conditional WHILE node runs `step` while `go` holds.
   A call loads its inputs, launches that graph once and reads the
   iteration count; no iteration is masked, none runs past the stop.
   While torch.profiler records (under its tracing, launches of that
   graph faulted), the same two recordings are replayed from the host,
   `go` read after each.
 * The chunked form, on the CPU, inside an outer program, and on the
   card where the iteration takes a host step (a host SuperLU coarsest)
   or its recording holds a node a WHILE body refuses: the
   first program holds `init` and the first CHUNK iterations, the second
   CHUNK more (cycle/capture.py `run`); each iteration is masked by `go`,
   so one past the stop leaves the `frozen` entries (the iterate, the
   residual history, the count and whatever `go` reads) exactly as they
   were (`torch.where`), and skips its host steps (`gate`).  The host
   reads `go` once a chunk (`spans.read`) and copies the state into the
   next program's inputs.

Both give the eager loop's iterate, count and history bit for bit.  After
the loop the solve driver's ``driver.finish`` span begins, and the count
is read.  `device_loop=False` is the eager loop, one host read an
iteration, kept for comparison.
"""
from __future__ import annotations

import torch

from .. import spans
from ..cycle.capture import gate, loop, run

CHUNK = 4       # iterations per chunked program, here and in the refined
                # solve (PERF.md's sweep of 1-16 on the H100)


def scalars(b, X, tol, max_iter):
    """init's arguments: b, X and the device scalars tol and max_iter (so
    that a new tolerance replays the recorded programs)."""
    real = torch.zeros((), dtype=b.dtype).real.dtype
    return (b, X, torch.tensor(tol, dtype=real, device=b.device),
            torch.tensor(max_iter, dtype=torch.int64, device=b.device))


def history(row0, max_iter: int):
    """A residual history of max_iter + 1 rows, row 0 `row0`, the rest 0."""
    return torch.cat([row0[None], row0.new_zeros((max_iter, row0.shape[0]))])


def rows_where(resvec, k, row):
    """resvec with row k + 1 replaced by `row`; k is a 0-dim device tensor,
    so the write needs no host read (and writes nothing past the end)."""
    at = torch.arange(resvec.shape[0], device=resvec.device) == k + 1
    return torch.where(at[:, None], row[None], resvec)


def _chunk(fns, state):
    _, step, go, frozen, chunk = fns
    for _ in range(chunk):
        g = go(state)
        with gate(g):                   # a masked iteration skips host steps
            new = step(state)
        state = tuple(torch.where(g, n, o) if i in frozen else n
                      for i, (n, o) in enumerate(zip(new, state)))
    return state + (go(state),)


def _first_program(fns, *args):
    return _chunk(fns, fns[0](*args))


def _next_program(fns, *state):
    return _chunk(fns, state)


def _start(fns, *args):
    state = fns[0](*args)
    return state + (fns[2](state),)


def _iteration(fns, args, state):
    new = fns[1](state)
    return new + (fns[2](new),)


def iterate(init, step, go, frozen, args, *, count: int,
            device_loop: bool = True, cache=None, static: tuple = ()):
    """Run init(*args), then step while go: (the final state, the count
    state[count], which init sets to 0 and step raises by one).

    `cache` = (owner, key, keep) names where the programs are kept
    (capture.run, capture.loop): `key` must determine the matvec and
    preconditioner the functions call, `static` the rest of what they
    compute beyond their tensor arguments (method, sizes).  None records
    them for this call."""
    if not device_loop:
        state = init(*args)
        while spans.read(bool, go(state)):
            state = step(state)
        spans.tail("driver.finish")
        return state, spans.read(int, state[count])
    fns = (init, step, go, frozenset(frozen), CHUNK)
    owner, key, keep = cache if cache is not None else (None, (), ())
    done = loop(owner, (key, static, "while"), _start, _iteration, fns,
                *args, count=count, keep=keep)
    if done is not None:
        state, k = done
        spans.tail("driver.finish")
        return tuple(t.clone() for t in state), k
    key = (key, static, fns[-1])
    out = run(owner, key + ("first",), _first_program, fns, *args,
              keep=keep, clone=False)
    while spans.read(bool, out[-1]):
        out = run(owner, key + ("next",), _next_program, fns, *out[:-1],
                  keep=keep, clone=False)
    spans.tail("driver.finish")
    state = tuple(t.clone() for t in out[:-1])
    return state, spans.read(int, state[count])
