"""Overlapped ZeRO: the bucketed reduce-scatter / all-gather weight update,
issued as the backward produces each bucket's gradients.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/zero_overlap.py``
on the flat data mesh. There the schedule the ZeRO paper ("Automatic
Cross-Replica Sharding of Weight Update in Data-Parallel Training",
arXiv:2004.13336) wants is fenced into one XLA program with
``optimization_barrier``s; here it is written with backward hooks and
asynchronous collectives (``parallel/zero.py::ZeroPlane``):

- **Same state layout as the propagation path** (``zero_state_sharding``'s
  per-leaf largest-divisible dim), so checkpoints, ``--resume`` and the
  eval pass work unchanged, and the two paths agree numerically.
- **Bucketed reduce-scatter** (:func:`bucket_plan`): gradient leaves,
  largest first, pack into byte-budgeted buckets (``--zero-bucket-mb``).
  A post-accumulate-grad hook on every param marks its gradient final;
  the moment every leaf of the next bucket is final, that bucket's
  reduce-scatter (and its unsplit leaves' all-reduce) is issued
  asynchronously, in bucket order, while the backward computes the
  rest. The step waits for them in the same order.
- **Carried all-gather** (ZeRO-3): the updated shards are all-gathered at
  the step's tail into the model's whole params, which the next step's
  forward uses; the carry is derived state, rebuilt (``stale``) when a
  checkpoint load or any outside install replaces the shards
  (:func:`make_param_gather`).

The step body is ``train/steps.py::_accum_train_step`` at any
``grad_accum`` (1 included), with the hooks armed for the last
micro-batch's backward: each rank backpropagates the per-example SUM of
its rows' losses, the reduce-scatter sums over ranks, and one division by
the global example count gives the global masked-mean gradient for any
mask.

The two-tier ``('dcn', 'ici')`` schedule (the JAX ``_dcn_bucket_plan``
and ``--zero-bucket-mb-dcn``) waits for ROADMAP Queue 1 item 16 part 6:
:func:`_tier_axes` refuses any mesh but the flat data axis.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

# The package's one bucket plan, shared with the delta publish's leaf walk.
from pytorch_distributed_mnist_tpu_torch.distrib.cas import (  # noqa: F401
    bucket_plan,
)


def _shard_dims(param_leaves, axis_size: int, axis: str) \
        -> List[Optional[int]]:
    """Per param leaf (port layout, JAX flatten order): the port-layout dim
    its ZeRO shard splits over ``axis``, or None for leaves with no
    divisible dim: exactly ``zero._zero_spec``'s choice (made in the JAX
    layout), so the overlapped path can never disagree with the
    propagation layout."""
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        P,
        port_dim,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
        _jax_shape,
        _zero_spec,
    )

    dims: List[Optional[int]] = []
    for leaf in param_leaves:
        shape = tuple(leaf.shape)
        spec = _zero_spec(_jax_shape(shape), axis_size, axis, P())
        axes = [d for d, a in enumerate(spec) if a == axis]
        dims.append(port_dim(axes[0], len(shape)) if axes else None)
    return dims


def _tier_axes(mesh, axis: str = "data"):
    """``(shard axis, outer axis, every data axis)`` of ``mesh``: on the
    flat data mesh the shard axis is the data axis and there is no outer
    tier. The two-tier ``('dcn', 'ici')`` schedule (its ``ici``
    reduce-scatter, the owner shards' ``dcn`` all-reduce in
    ``--zero-bucket-mb-dcn`` buckets) and any other mesh raise."""
    if axis != "data" or mesh.shape != {"data": mesh.data.size}:
        raise NotImplementedError(
            f"the overlapped ZeRO plane runs on the flat ('data',) mesh; the "
            f"two-tier ('dcn', 'ici') schedule and other meshes "
            f"({mesh.shape}) wait for ROADMAP Queue 1 item 16 part 6")
    return axis, None, axis


def _require_overlap(state) -> None:
    if state.zero is None or not state.zero.overlap:
        raise ValueError("the overlapped step needs a state placed with "
                         "shard_state_zero(..., overlap=True)")


def make_overlap_train_step(state, axis, grad_accum: int = 1) -> Callable:
    """``step(batch) -> MetricState``: one overlapped ZeRO step (level 1 or
    3, as the state was placed), updating ``state`` in place."""
    from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

    _require_overlap(state)
    return lambda batch: train_step(state, batch, axis, grad_accum)


def make_overlap_train_epoch(state, axis, grad_accum: int = 1) -> Callable:
    """``epoch(batches) -> MetricState``: the overlapped step over staged
    batches (``{'image': (S, B, ...), 'label': (S, B), 'mask': (S, B)}``),
    as ``train/steps.py::make_train_epoch`` runs its step (on the card,
    one captured CUDA graph replayed per batch; the carried ZeRO-3 params
    ride across the replays)."""
    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
    )

    _require_overlap(state)
    return make_train_epoch(state, axis, grad_accum=grad_accum)


def make_param_gather(state) -> Callable[[], None]:
    """``gather()``: rebuild the carried whole params from the state's
    shards (one all-gather per bucket), as after a checkpoint load."""
    return state.zero.gather_params


def make_comm_only_program(state) -> Callable[[], torch.Tensor]:
    """``comm() -> scalar``: the step's collective sequence alone (every
    bucket's reduce-scatter and unsplit all-reduce, then every bucket's
    all-gather) on the current gradient buffer and shards, with no model
    compute, folded into one scalar: what a benchmark times as the step's
    communication. It leaves the params as they were."""
    plane = state.zero

    def comm() -> torch.Tensor:
        plane.begin_backward()
        plane.armed = False
        saved = [p.detach().clone() for p in plane.params]
        plane.reduce()
        plane.gather_params()
        acc = plane.grad_flat.sum() + sum(
            f.sum() for f in plane.unsplit_flat if f.numel())
        with torch.no_grad():
            for p, s in zip(plane.params, saved):
                p.copy_(s)
        if plane.group is not None:
            dist.all_reduce(acc, group=plane.group)
        return acc

    return comm
