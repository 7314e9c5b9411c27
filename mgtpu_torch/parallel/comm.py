"""The collectives of the multi-device tier on torch.distributed.

mgtpu runs its multi-device tier inside `shard_map` over a device mesh, with
`ppermute`, `psum`, `all_gather` and `axis_index` along named mesh axes
(mgtpu/parallel/stencil.py:151-166, sharded.py:117-207, dd/parallel.py:76-
111), or lets GSPMD insert them (grid_sharded.py).  Here each rank is one
process of a torch.distributed process group, and `RankGrid` lays the ranks
out as a 1D axis or a 2D grid (the pencil layout), with one process group per
row and per column.  Each mgtpu collective is one call here:

 * `psum`            all_reduce (sum) over every rank;
 * `all_gather`      along a rank axis, stacked in axis order;
 * `reduce_scatter`  along a rank axis: one all_to_all, then the P pieces of
                     this rank's chunk summed in rank order (the same order
                     on either transport);
 * `broadcast`       from a rank of an axis;
 * `exchange_halo`   one batch_isend_irecv each way along an axis; edge
                     ranks receive zero planes, as `ppermute` leaves them
                     (`post_halo(zeros=False)`: none, for kernel D's halo
                     form, which reads the planes where they arrive);
 * `shift`           one way along an axis (a `ppermute` by a fixed step);
 * `ring_permute`    around the ring of an axis, several steps at once
                     (the `ppermute`s of mgtpu's part_amg.py::_halo_concat).

Two transports, chosen by the caller (`transport=`, the backend of the
process group) and never switched on an error:

 * ``"nccl"``: one card a rank; tensors stay on the card and the exchange
   runs on NCCL's own stream (the compute stream waits for it).
 * ``"gloo"``: the CPU tests, and several ranks sharing one card.  gloo's
   calls take host memory, so every CUDA buffer goes through a pinned host
   copy: the copy to the host is synchronised with the compute stream
   before the send reads it, and the copy back is synchronised before the
   buffer is returned.

`sent` counts the bytes this rank puts on the wire, per collective kind,
under the ring algorithms (all_reduce 2 (P-1)/P of the tensor, all_gather
(P-1) pieces, reduce_scatter (P-1)/P, broadcast the tensor from its root,
a halo its planes): the port's replacement for mgtpu's tools/comm_volume.py,
which reads XLA's HLO.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device

__all__ = ["RankGrid", "TRANSPORTS", "rank_device"]

TRANSPORTS = ("nccl", "gloo")
KINDS = ("halo", "psum", "all_gather", "reduce_scatter", "broadcast")


def rank_device(device=None) -> torch.device:
    """The device a rank's sharded state lives on: `device` when given (the
    tests pass "cpu"), else the rank's card — the current CUDA device, which
    `launch.run_ranks` sets to cuda:{rank} under NCCL and to the one card
    when gloo ranks share it.  Raises without a card."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return torch.device("cuda", torch.cuda.current_device())


class _Halo:
    """An exchange in flight: `wait()` returns the (left, right) planes on
    the field's device (at an edge of the axis zeros, or None where the
    exchange was posted with zeros=False)."""

    def __init__(self, works, recvs, like, staged, sends):
        self._works, self._recvs, self._like = works, recvs, like
        self._staged = staged
        self._sends = sends             # alive until the sends complete

    def wait(self):
        for w in self._works:
            w.wait()
        out = []
        for t in self._recvs:
            if isinstance(t, torch.Tensor) and self._staged:
                t = t.to(self._like.device)           # synchronous copy back
            out.append(t)
        return tuple(out)


class RankGrid:
    """The ranks of the default process group as a 1D axis (`shape` =
    (P,), or None for every rank) or a 2D grid (P0, P1), rank r at
    coordinates divmod(r, P1).

    Every rank must build its RankGrid at the same point of the program:
    `dist.new_group` is collective, so each rank creates every row and
    column group in the same order.  `transport` must be the backend the
    process group was started with."""

    def __init__(self, shape, transport: str):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}")
        if not dist.is_initialized():
            raise RuntimeError("RankGrid needs an initialised process group "
                               "(launch.run_ranks starts one)")
        backend = str(dist.get_backend()).lower()
        if backend != transport:
            raise ValueError(f"transport {transport!r} asked for, the "
                             f"process group runs {backend!r}")
        world = dist.get_world_size()
        shape = (world,) if shape is None else tuple(int(s) for s in shape)
        if len(shape) not in (1, 2) or int(np.prod(shape)) != world:
            raise ValueError(f"rank grid {shape} does not hold {world} ranks")
        self.shape = shape
        self.transport = transport
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             shape))
        ranks = np.arange(world).reshape(shape)
        if len(shape) == 1:
            self._members = (tuple(range(world)),)
            self._groups = (None,)                  # the default group
        else:
            members, groups = [None, None], [None, None]
            for axis in (0, 1):
                lines = ranks.T if axis == 0 else ranks  # lines along axis
                for line in lines:
                    line = tuple(int(r) for r in line)
                    g = dist.new_group(list(line), backend=transport)
                    if self.rank in line:
                        members[axis], groups[axis] = line, g
            self._members, self._groups = tuple(members), tuple(groups)
        self.sent = dict.fromkeys(KINDS, 0)

    # -- layout ------------------------------------------------------------
    def axis_size(self, axis: int = 0) -> int:
        return self.shape[axis]

    def axis_index(self, axis: int = 0) -> int:
        return self.coords[axis]

    def reset_counts(self) -> None:
        self.sent = dict.fromkeys(KINDS, 0)

    # -- staging -----------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.transport == "gloo" and t.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous buffer the transport may read and overwrite: a
        pinned host copy of a CUDA tensor under gloo, complete before it is
        returned; else a copy on t's device."""
        if not self._staged(t):
            return t.detach().clone(memory_format=torch.contiguous_format)
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return h

    def _empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        if self._staged(like):
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device) if self._staged(like) else t

    def _count(self, kind: str, nbytes: float) -> None:
        self.sent[kind] += int(round(nbytes))

    # -- collectives -------------------------------------------------------
    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over every rank (all_reduce), on t's device."""
        buf = self._out(t)
        dist.all_reduce(buf)
        P = int(np.prod(self.shape))
        self._count("psum", 2 * (P - 1) / P * buf.nbytes)
        return self._back(buf, t)

    def all_gather(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """(P, *t.shape): t of each rank of this rank's line along `axis`,
        in axis order."""
        P = self.shape[axis]
        buf = self._out(t)
        parts = [self._empty(t.shape, t) for _ in range(P)]
        dist.all_gather(parts, buf, group=self._groups[axis])
        self._count("all_gather", (P - 1) * buf.nbytes)
        return self._back(torch.stack(parts), t)

    def reduce_scatter(self, t: torch.Tensor, axis: int = 0,
                       dim: int = 0) -> torch.Tensor:
        """Chunk k (of P along `dim`) of the sum of t over the line along
        `axis`, for the rank at index k: one all_to_all, then the P pieces
        summed in rank order."""
        P = self.shape[axis]
        dim = dim % t.ndim
        n = t.shape[dim]
        if n % P:
            raise ValueError(f"extent {n} does not split over {P} ranks")
        chunks = torch.movedim(t, dim, 0).reshape((P, n // P)
                                                  + t.shape[:dim]
                                                  + t.shape[dim + 1:])
        buf = self._out(chunks)
        recv = self._empty(buf.shape, chunks)
        dist.all_to_all_single(recv, buf, group=self._groups[axis])
        self._count("reduce_scatter", (P - 1) / P * buf.nbytes)
        recv = self._back(recv, t)
        out = recv[0]
        for k in range(1, P):
            out = out + recv[k]
        return torch.movedim(out, 0, dim).contiguous()

    def broadcast(self, t: torch.Tensor, src: int = 0,
                  axis: int | None = None) -> torch.Tensor:
        """t of the rank at index `src` of this rank's line along `axis`
        (of global rank `src` with axis None), on every rank."""
        buf = self._out(t)
        root = src if axis is None else self._members[axis][src]
        group = None if axis is None else self._groups[axis]
        dist.broadcast(buf, root, group=group)
        if self.rank == root:
            P = (int(np.prod(self.shape)) if axis is None
                 else self.shape[axis])
            self._count("broadcast", (P - 1) * buf.nbytes)
        return self._back(buf, t)

    def post_halo(self, x: torch.Tensor, axis: int = 0, width: int = 1,
                  dim: int = 0, zeros: bool = True) -> _Halo:
        """Start the halo exchange of x along `dim` over the ranks of
        `axis`: this rank's last `width` planes go to the next rank, its
        first to the previous one.  Returns the exchange in flight; its
        `wait()` gives (left, right), each `width` planes, where there is
        no neighbour zeros, or None with zeros=False (kernel D's halo form
        reads nothing there)."""
        dim = dim % x.ndim
        P, i = self.shape[axis], self.coords[axis]
        line = self._members[axis]
        group = self._groups[axis]
        if width > x.shape[dim]:
            raise ValueError(f"a halo of {width} planes from a block of "
                             f"{x.shape[dim]}")
        plane = x.shape[:dim] + (width,) + x.shape[dim + 1:]
        ops, recvs, sends = [], [], []
        for nb, lo in ((i - 1, True), (i + 1, False)):
            if not 0 <= nb < P:
                recvs.append(x.new_zeros(plane) if zeros else None)
                continue
            mine = x.narrow(dim, 0 if lo else x.shape[dim] - width, width)
            send = self._out(mine)
            recv = self._empty(plane, x)
            ops += [dist.P2POp(dist.isend, send, line[nb], group),
                    dist.P2POp(dist.irecv, recv, line[nb], group)]
            recvs.append(recv)
            sends.append(send)
            self._count("halo", send.nbytes)
        works = dist.batch_isend_irecv(ops) if ops else []
        return _Halo(works, recvs, x, self._staged(x), sends)

    def shift(self, x: torch.Tensor, axis: int = 0,
              step: int = 1) -> torch.Tensor:
        """x of the rank `step` places before this one along `axis` (each
        rank sends x to the rank `step` places after it): zeros where there
        is no such rank.  x has the same shape on every rank."""
        P, i = self.shape[axis], self.coords[axis]
        line, group = self._members[axis], self._groups[axis]
        ops, send = [], None
        if 0 <= i + step < P:
            send = self._out(x)
            ops.append(dist.P2POp(dist.isend, send, line[i + step], group))
            self._count("halo", send.nbytes)
        recv = None
        if 0 <= i - step < P:
            recv = self._empty(x.shape, x)
            ops.append(dist.P2POp(dist.irecv, recv, line[i - step], group))
        for w in (dist.batch_isend_irecv(ops) if ops else []):
            w.wait()
        return x.new_zeros(x.shape) if recv is None else self._back(recv, x)

    def ring_permute(self, bufs, steps, axis: int = 0) -> list:
        """Cyclic shifts along `axis`: bufs[j] of this rank goes to the
        rank steps[j] places after it (modulo the axis), and the list of
        what the ranks steps[j] places before it sent comes back.  bufs[j]
        has the same shape on every rank; the steps are distinct and not
        multiples of the axis size, so each peer gets at most one message
        each way.  Every step is posted in one batch_isend_irecv."""
        P, i = self.shape[axis], self.coords[axis]
        line, group = self._members[axis], self._groups[axis]
        ops, recvs, sends = [], [], []
        for buf, step in zip(bufs, steps):
            if step % P == 0:
                raise ValueError(f"a ring step of {step} on {P} ranks")
            send = self._out(buf)
            recv = self._empty(buf.shape, buf)
            ops += [dist.P2POp(dist.isend, send, line[(i + step) % P],
                               group),
                    dist.P2POp(dist.irecv, recv, line[(i - step) % P],
                               group)]
            sends.append(send)
            recvs.append(recv)
            self._count("halo", send.nbytes)
        for w in (dist.batch_isend_irecv(ops) if ops else []):
            w.wait()
        return [self._back(r, b) for r, b in zip(recvs, bufs)]

    def exchange_halo(self, x: torch.Tensor, axis: int = 0, width: int = 1,
                      dim: int = 0) -> torch.Tensor:
        """x extended along `dim` by `width` neighbour planes on each side
        (zero planes at the edges of the axis)."""
        left, right = self.post_halo(x, axis, width, dim).wait()
        return torch.cat([left, x, right], dim=dim)
