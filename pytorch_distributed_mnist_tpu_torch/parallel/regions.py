"""Autograd collectives over one mesh axis: the Megatron region pairs,
the sequence split and gather, and the ring hop.

Where the JAX package writes a ``shard_map`` body with ``lax.psum``,
``lax.all_gather``, ``lax.psum_scatter``, ``lax.all_to_all`` and
``lax.ppermute`` and lets JAX transpose them, each rank of the port runs
one process and gives every collective its backward by hand. Each takes
an axis record (``parallel/mesh.py::DataAxis``); an axis of one rank (or
None) makes every function the identity.

The conjugate pairs of a region that every rank of the axis computes
alike, so that the replicated leaves' gradients come out whole on every
rank (Megatron's ``f`` and ``g``):

- :func:`copy_to_region`: identity forward, all-reduce backward (the
  entry of a column-parallel matmul);
- :func:`reduce_from_region`: all-reduce forward, identity backward (the
  exit of a row-parallel matmul);
- :func:`split`: this rank's slice of a dim forward, all-gather backward;
- :func:`gather`: the ranks' slices all-gathered forward, this rank's
  slice of the gradient backward (downstream of it every rank computes
  alike).

The transposes ``lax.all_gather`` and ``lax.psum_scatter`` take when the
ranks downstream compute different things (each with its own weight
columns):

- :func:`gather_scatter`: all-gather forward, reduce-scatter backward;
- :func:`scatter_reduce`: reduce-scatter forward, all-gather backward
  (``psum_scatter``).

:func:`ppermute` is the ring hop: every rank sends to coordinate ``+shift``
and receives from ``-shift`` (``dist.batch_isend_irecv``); its backward
sends the gradient the other way. With ``wrap=False`` it is the open
chain's hop of the pipeline (``parallel/pipeline.py``): no pair wraps
round the ends. :func:`all_to_all` is
``torch.distributed.nn.functional.all_to_all_single`` on dim 0, which
carries its own gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _live(axis) -> bool:
    return axis is not None and axis.group is not None


def _rows(n: int, size: int, rank: int) -> slice:
    chunk = n // size
    return slice(rank * chunk, (rank + 1) * chunk)


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The group's ``dim`` slices of ``x``, concatenated in rank order."""
    x = x.contiguous()
    out = torch.empty(size * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.view(-1), group=group)
    return torch.cat(list(out.view((size,) + tuple(x.shape)).unbind(0)),
                     dim=dim)


def _reduce_scatter(x: torch.Tensor, group, size: int,
                    dim: int) -> torch.Tensor:
    """``x`` summed over the group, this rank's ``1/size`` of ``dim``."""
    parts = x.unflatten(dim, (size, x.shape[dim] // size)).movedim(dim, 0)
    parts = parts.contiguous()
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out.view(-1), parts.view(-1), group=group)
    return out


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromRegion(torch.autograd.Function):
    """All-reduce (sum) forward over ``group``; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    """This rank's ``1/size`` of ``dim`` forward; the gradient
    all-gathered over ``group`` backward (every rank then holds the whole
    tensor's)."""

    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        index = [slice(None)] * x.dim()
        index[dim] = _rows(x.shape[dim], size, rank)
        return x[tuple(index)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, ctx.group, ctx.size, ctx.dim),
                None, None, None, None)


class _Gather(torch.autograd.Function):
    """The group's ``dim`` slices all-gathered forward; this rank's slice
    of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        ctx.size, ctx.rank, ctx.dim = size, rank, dim
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        index = [slice(None)] * g.dim()
        index[ctx.dim] = _rows(g.shape[ctx.dim], ctx.size, ctx.rank)
        return g[tuple(index)].contiguous(), None, None, None, None


class _GatherScatter(torch.autograd.Function):
    """All-gather of ``dim`` forward; reduce-scatter of the gradient
    backward (``lax.all_gather``'s transpose)."""

    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.group, ctx.size, ctx.dim),
                None, None, None)


class _ScatterReduce(torch.autograd.Function):
    """Reduce-scatter of ``dim`` forward (``lax.psum_scatter``, tiled);
    all-gather of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _reduce_scatter(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.size, ctx.dim), None, None, None


def ring_exchange(tensors: Sequence[torch.Tensor], axis, shift: int,
                  wait: bool = True, wrap: bool = True):
    """Send each of ``tensors`` to coordinate ``rank + shift`` of
    ``axis`` and receive as many from ``rank - shift``; returns the
    received tensors (and, with ``wait=False``, the requests to wait on
    before reading them). ``wrap=False`` is the open chain: a rank whose
    partner would lie past either end sends nothing there, and a rank
    that receives nothing gets zeros (``lax.ppermute`` with the pairs
    ``(i, i + shift)`` that stay on the axis)."""
    n = axis.size
    to, frm = axis.rank + shift, axis.rank - shift
    if wrap:
        to, frm = to % n, frm % n
    ops, out = [], []
    for t in tensors:
        t = t.contiguous()
        if 0 <= to < n:
            ops.append(dist.P2POp(dist.isend, t, axis.peer(to), axis.group))
        if 0 <= frm < n:
            buf = torch.empty_like(t)
            ops.append(dist.P2POp(dist.irecv, buf, axis.peer(frm),
                                  axis.group))
        else:
            buf = torch.zeros_like(t)
        out.append(buf)
    reqs = dist.batch_isend_irecv(ops) if ops else []
    if not wait:
        return out, reqs
    for r in reqs:
        r.wait()
    return out


class _PPermute(torch.autograd.Function):
    """Every rank's tensors to coordinate ``+shift`` forward; the
    gradients to ``-shift`` backward (on the open chain too: the
    transpose of a send from ``i`` to ``i + shift`` is one back)."""

    @staticmethod
    def forward(ctx, axis, shift, wrap, *xs):
        ctx.axis, ctx.shift, ctx.wrap = axis, shift, wrap
        return tuple(ring_exchange(xs, axis, shift, wrap=wrap))

    @staticmethod
    def backward(ctx, *gs):
        back = ring_exchange([g.contiguous() for g in gs], ctx.axis,
                             -ctx.shift, wrap=ctx.wrap)
        return (None, None, None, *back)


def copy_to_region(x, axis):
    return _CopyToRegion.apply(x, axis.group) if _live(axis) else x


def reduce_from_region(x, axis):
    return _ReduceFromRegion.apply(x, axis.group) if _live(axis) else x


def split(x, axis, dim: int = 0):
    if not _live(axis):
        return x
    return _Split.apply(x, axis.group, axis.size, axis.rank, dim)


def gather(x, axis, dim: int = 0):
    if not _live(axis):
        return x
    return _Gather.apply(x, axis.group, axis.size, axis.rank, dim)


def gather_scatter(x, axis, dim: int = 0):
    if not _live(axis):
        return x
    return _GatherScatter.apply(x, axis.group, axis.size, dim)


def scatter_reduce(x, axis, dim: int = 0):
    if not _live(axis):
        return x
    return _ScatterReduce.apply(x, axis.group, axis.size, dim)


def ppermute(xs: Sequence[torch.Tensor], axis, shift: int = 1,
             wrap: bool = True):
    """The ring hop of ``xs`` (a tuple) over ``axis``, differentiable;
    ``wrap=False`` the open chain's hop (the pipeline's: the last rank's
    tensors leave the chain, the first rank receives zeros)."""
    if not _live(axis):
        # One rank: the ring hands it its own tensors, the chain nothing.
        return tuple(xs) if wrap else tuple(torch.zeros_like(x) for x in xs)
    return _PPermute.apply(axis, shift, wrap, *xs)


def all_to_all(x, axis):
    """Dim 0 of ``x`` split over the axis's ranks, slice ``j`` to rank
    ``j``, the received slices stacked in sender order (differentiable)."""
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=axis.group)
