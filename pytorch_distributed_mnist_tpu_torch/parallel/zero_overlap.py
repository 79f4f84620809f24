"""Overlapped ZeRO: the bucketed reduce-scatter / all-gather weight update,
issued as the backward produces each bucket's gradients.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/zero_overlap.py``.
There the schedule the ZeRO paper ("Automatic
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

- **Two-tier schedule** on a ``('dcn', 'ici')`` mesh
  (``parallel/mesh.py::make_hier_mesh``), the paper's multi-pod form:
  the gradients reduce-scatter within the slice over ``ici`` (full
  gradient bytes on the fast tier), then only this rank's owner shards
  all-reduce across slices over ``dcn`` (the ranks that share its
  ``ici`` and model coordinates), in buckets of their own
  (:func:`_dcn_bucket_plan` over shard-sized views,
  ``--zero-bucket-mb-dcn``), each a view of the reduce-scattered shards;
  the optimizer updates the shard (every slice's rank ``i`` runs the
  identical update) and the shards all-gather back over ``ici`` alone.
  The DCN all-reduces are issued after every reduce-scatter is waited
  for, in DCN bucket order, on the one ordered stream of the step's
  collectives, as the JAX fence chain orders them.

Scope: the pure data-parallel mesh, flat or two-tier (:func:`_tier_axes`
refuses the others); TP and EP layouts stay on the propagation path.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
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


class _ShardView:
    """Shape and element size of one leaf's reduce-scattered shard: what
    the DCN tier moves, so its bucket plan budgets shard bytes, not
    whole-leaf bytes. It reads like a tensor to ``bucket_plan``."""

    def __init__(self, leaf, dim: Optional[int], axis_size: int) -> None:
        shape = tuple(leaf.shape)
        if dim is not None:
            shape = (shape[:dim] + (shape[dim] // axis_size,)
                     + shape[dim + 1:])
        self.shape = shape
        self.itemsize = (leaf.element_size() if hasattr(leaf, "element_size")
                         else np.dtype(getattr(leaf, "dtype",
                                               np.float32)).itemsize)

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self.itemsize


def _dcn_bucket_plan(param_leaves, dims, axis_size: int,
                     bucket_mb: float) -> List[List[int]]:
    """The DCN tier's bucket plan: :func:`bucket_plan`'s packing over
    shard-sized views (``1/axis_size`` of each split leaf, the unsplit
    ones whole), budgeted by ``--zero-bucket-mb-dcn`` independently of
    the ICI tier's whole-gradient buckets."""
    return bucket_plan([_ShardView(leaf, d, axis_size)
                        for leaf, d in zip(param_leaves, dims)], bucket_mb)


def _tier_axes(mesh, axis: str = "data"):
    """``(shard axis, outer axis, every data axis)`` of ``mesh``: on the
    flat data mesh the shard axis is the data axis and there is no outer
    tier; on the two-tier ``('dcn', 'ici')`` mesh ZeRO shards over
    ``ici`` and the owner shards cross slices over ``dcn``. The
    overlapped plane refuses the meshes the JAX one does not run on
    (TP, EP, PP)."""
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
        HIER_DATA_AXES,
    )

    shape = dict(mesh.shape)
    if axis == "data" and tuple(shape) == HIER_DATA_AXES:
        return "ici", "dcn", HIER_DATA_AXES
    if axis != "data" or shape != {"data": mesh.data.size}:
        raise NotImplementedError(
            f"the overlapped ZeRO plane runs on the pure data-parallel "
            f"mesh, flat ('data',) or two-tier ('dcn', 'ici'); the "
            f"{shape} layout stays on the propagation path")
    return axis, None, axis


def _require_overlap(state) -> None:
    if state.zero is None or not state.zero.overlap:
        raise ValueError("the overlapped step needs a state placed with "
                         "shard_state_zero(..., overlap=True)")


def _dcn_plan_of(state, bucket_mb_dcn: Optional[float]) \
        -> List[List[int]]:
    """The DCN buckets ``bucket_mb_dcn`` MiB plans over the state's plane
    (None or 0, or a flat mesh: the plan it was placed with)."""
    plane = state.zero
    if not bucket_mb_dcn or plane.outer is None:
        return plane.dcn_plan
    return _dcn_bucket_plan(plane.params, plane.dims, plane.n, bucket_mb_dcn)


def check_dcn_budget(state, bucket_mb_dcn: Optional[float]) -> None:
    """Raise unless ``bucket_mb_dcn`` plans the DCN buckets the state's
    plane runs: the plan is fixed when the state is placed
    (``shard_state_zero(bucket_mb_dcn=...)``), so a step builder or the
    ``Trainer`` given another budget refuses rather than re-plan it."""
    plan = _dcn_plan_of(state, bucket_mb_dcn)
    if plan != state.zero.dcn_plan:
        raise ValueError(
            f"bucket_mb_dcn={bucket_mb_dcn:g} plans {len(plan)} DCN "
            f"bucket(s) where the state was placed with "
            f"{len(state.zero.dcn_plan)}: pass it to "
            f"shard_state_zero(bucket_mb_dcn=...)")


def make_overlap_train_step(state, axis, grad_accum: int = 1,
                            bucket_mb_dcn: Optional[float] = None) \
        -> Callable:
    """``step(batch) -> MetricState``: one overlapped ZeRO step (level 1 or
    3, as the state was placed), updating ``state`` in place. On a
    two-tier mesh the step runs the two-tier schedule in the cross-slice
    buckets the state was placed with; ``bucket_mb_dcn``, when given,
    must plan the same ones (:func:`check_dcn_budget`; ignored on a flat
    mesh)."""
    from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

    _require_overlap(state)
    check_dcn_budget(state, bucket_mb_dcn)
    return lambda batch: train_step(state, batch, axis, grad_accum)


def make_overlap_train_epoch(state, axis, grad_accum: int = 1,
                             bucket_mb_dcn: Optional[float] = None) \
        -> Callable:
    """``epoch(batches) -> MetricState``: the overlapped step over staged
    batches (``{'image': (S, B, ...), 'label': (S, B), 'mask': (S, B)}``),
    as ``train/steps.py::make_train_epoch`` runs its step (on the card,
    one captured CUDA graph replayed per batch; the carried ZeRO-3 params
    ride across the replays). ``bucket_mb_dcn`` as in
    :func:`make_overlap_train_step`."""
    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
    )

    _require_overlap(state)
    check_dcn_budget(state, bucket_mb_dcn)
    return make_train_epoch(state, axis, grad_accum=grad_accum)


def make_param_gather(state) -> Callable[[], None]:
    """``gather()``: rebuild the carried whole params from the state's
    shards (one all-gather per bucket), as after a checkpoint load."""
    return state.zero.gather_params


def make_comm_only_program(state, bucket_mb_dcn: Optional[float] = None,
                           tier: Optional[str] = None) \
        -> Callable[[], torch.Tensor]:
    """``comm() -> scalar``: the step's collective sequence alone on the
    current gradient buffer and shards, with no model compute, folded
    into one scalar: what a benchmark times as the step's communication.
    It leaves the params as they were. That is every bucket's
    reduce-scatter and unsplit all-reduce, on a two-tier mesh the owner
    shards' DCN all-reduces (one per bucket of ``bucket_mb_dcn`` MiB, by
    default the plane's buckets; a plan of its own leaves the state's
    untouched), then every bucket's all-gather.

    ``tier`` isolates one tier of a two-tier mesh: ``'ici'`` runs only
    the intra-slice reduce-scatters and all-gathers, ``'dcn'`` only the
    cross-slice all-reduces (this rank's shard of each leaf is sliced
    out locally, a copy, then the scalar is summed over ``ici``). A
    ``tier`` on a flat mesh is an error: it has no tiers."""
    plane = state.zero
    if tier not in (None, "ici", "dcn"):
        raise ValueError(f"tier must be None, 'ici' or 'dcn', got {tier!r}")
    if tier is not None and plane.outer is None:
        raise ValueError(
            f"tier={tier!r} needs a hierarchical ('dcn', 'ici') mesh; "
            f"this flat mesh has no tiers")
    plan = _dcn_plan_of(state, bucket_mb_dcn)
    buffers = (plane._dcn_bufs if plan is plane.dcn_plan
               else plane.dcn_buffers(plan))

    def comm() -> torch.Tensor:
        plane.begin_backward()
        plane.armed = False
        saved = [p.detach().clone() for p in plane.params]
        if tier == "dcn":
            plane.local_shards()
            plane.reduce_dcn(plan, buffers)
        else:
            # The step's order of collectives: the ICI tier, the DCN
            # tier, the gather.
            plane.reduce(dcn=False)
            if tier is None:
                plane.reduce_dcn(plan, buffers)
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
