"""Collectives that autograd can differentiate through.

``torch.distributed``'s collectives are not recorded by autograd, and
``torch.distributed.nn.functional`` is deprecated in this torch.  Each
function here is a ``torch.autograd.Function`` whose backward is the
transpose of its forward, as JAX transposes ``psum``, ``all_gather``,
``psum_scatter`` and ``ppermute``:

* :func:`all_reduce_sum` ↔ all-reduce of the cotangent (every rank's output
  is the same sum, so each input's cotangent is the sum of the outputs');
* :func:`all_gather` ↔ reduce-scatter of the cotangent;
* :func:`reduce_scatter` ↔ all-gather of the cotangent;
* :class:`RingShift` (each rank sends to the next rank of the group and
  receives from the previous one) ↔ the same shift the other way round.

Gathers and scatters run along any dimension ``dim``: the tensor is moved so
that ``dim`` leads, which is the layout ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` concatenate and split along.

:func:`gather_blocks` and :func:`scatter_blocks` take a dimension split
unevenly (``mesh.split``: blocks of ``ceil(size / n)``, the last ones
shorter): a short block is padded with zeros for the transfer and the
padding dropped after, so it enters no result.  :func:`gather_joints` and
:func:`gather_channels` make a layer's activation whole along the mesh's
``graph`` or ``model`` axis.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "all_gather", "reduce_scatter", "RingShift",
           "gather_blocks", "scatter_blocks", "gather_joints",
           "gather_channels"]


def _lead(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xm = _lead(x, dim)
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xm = _lead(x, dim)
    if xm.shape[0] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of size "
                         f"{xm.shape[0]} does not split over {n} ranks")
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``psum``)."""
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks, split along ``dim`` into one block
    a rank in rank order; this rank's block (``psum_scatter(...,
    tiled=True)``)."""
    return _ReduceScatter.apply(x, dim, group)


def _padded(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to ``size``."""
    short = size - x.shape[dim]
    if not short:
        return x
    pad = list(x.shape)
    pad[dim] = short
    return torch.cat([x, x.new_zeros(pad)], dim)


def gather_blocks(x: torch.Tensor, dim: int, group,
                  size: int) -> torch.Tensor:
    """:func:`all_gather` of a dimension of ``size`` split unevenly over
    the ranks of ``group`` (``x`` is this rank's block): every block padded
    to ``ceil(size / n)`` for the transfer, the padding dropped after.  Its
    backward sums each rank's block of the cotangent over the ranks."""
    n = dist.get_world_size(group)
    block = -(-size // n)
    out = all_gather(_padded(x, dim, block), dim, group)
    return out if n * block == size else out.narrow(dim, 0, size)


def scatter_blocks(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`reduce_scatter` of ``x`` whose dimension ``dim`` is split
    unevenly over the ranks of ``group``: zeros appended up to ``n`` blocks
    of ``ceil(size / n)``, this rank's block of the sum without them."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim]
    block = -(-size // n)
    out = reduce_scatter(_padded(x, dim, n * block), dim, group)
    keep = max(min(size - me * block, block), 0)
    return out if keep == block else out.narrow(dim, 0, keep)


def gather_joints(mesh, x: torch.Tensor, v: int) -> torch.Tensor:
    """The (N, T, V, C) activation whose rank holds its joint range
    (``mesh.joints(v)``) made whole over the mesh's graph group."""
    if mesh.shape.get("graph", 1) == 1:
        return x
    return gather_blocks(x, 2, mesh.group("graph"), v)


def gather_channels(mesh, x: torch.Tensor, c: int) -> torch.Tensor:
    """The activation of ``c`` channels made whole over the mesh's model
    group when the rank holds its column range (``mesh.channels(c)``); as
    it is when it holds all ``c``."""
    if x.shape[-1] == c:
        return x
    return all_gather(x, x.dim() - 1, mesh.group("model"))


def _p2p(sends: Sequence[torch.Tensor], recvs: Sequence[torch.Tensor],
         to: int, frm: int, group) -> List:
    """Post one send of each of ``sends`` to global rank ``to`` and one
    receive into each of ``recvs`` from global rank ``frm`` (tag = position,
    so that two tensors between the same pair never cross); returns the
    requests."""
    ops = [dist.P2POp(dist.isend, t, to, group, tag=i)
           for i, t in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, frm, group, tag=i)
            for i, t in enumerate(recvs)]
    return dist.batch_isend_irecv(ops)


class RingShift:
    """One step of a ring over ``group``: each rank sends its tensors to the
    next rank and receives the previous rank's (``ppermute`` with pairs
    ``(i, i + 1 mod n)``).

    :meth:`post` posts the sends and receives and returns at once;
    :meth:`wait` waits for them and returns the received tensors, which are
    then part of the autograd graph.  A caller computes between the two, so
    that the transfer runs under its compute.  The backward pass shifts the
    cotangents of the received tensors the other way round, to the previous
    rank, and waits for them there (the backward is not overlapped).
    """

    def __init__(self, group):
        self.group = group
        n = dist.get_world_size(group)
        me = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (me + 1) % n)
        self.prev = dist.get_global_rank(group, (me - 1) % n)
        self._reqs: List = []

    def post(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Post the shift of ``tensors``; returns the receive buffers (their
        values are valid only after :meth:`wait`)."""
        if self._reqs:
            raise RuntimeError("RingShift.post: the previous shift is not "
                               "waited for")
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        self._reqs = _p2p(sends, recvs, self.next, self.prev, self.group)
        self._sent = sends          # kept alive until the sends complete
        return _Shifted.apply(self, *sends, *recvs)

    def wait(self, received: Sequence[torch.Tensor]) \
            -> Tuple[torch.Tensor, ...]:
        """Wait for the posted shift; returns ``received`` (the tensors
        :meth:`post` returned), now filled."""
        for req in self._reqs:
            req.wait()
        self._reqs, self._sent = [], None
        return tuple(received)


class _Shifted(torch.autograd.Function):
    """The receive buffers of a posted :class:`RingShift` as functions of
    the sent tensors: forward returns the buffers as they are (filled when
    the shift is waited for); backward sends each buffer's cotangent to the
    previous rank and receives the next rank's, the cotangent of the sent
    tensor."""

    @staticmethod
    def forward(ctx, shift, *tensors):
        ctx.shift = shift
        ctx.n = len(tensors) // 2
        return tuple(tensors[ctx.n:])

    @staticmethod
    def backward(ctx, *grads):
        shift = ctx.shift
        sends = [g.contiguous() for g in grads]
        back = [torch.empty_like(g) for g in sends]
        for req in _p2p(sends, back, shift.prev, shift.next, shift.group):
            req.wait()
        return (None, *back) + (None,) * ctx.n
