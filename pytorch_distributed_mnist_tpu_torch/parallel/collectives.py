"""Explicit collectives of data parallelism: the example count, the
gradient sum and the metric sum.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/collectives.py``,
whose shard_map step ``lax.pmean``-s the gradients of each replica's
mean loss (DDP's rule) and ``lax.psum``-s ``loss * n``, ``correct`` and
``count``, and of the gradient reduction XLA inserts into the
reference's auto data-parallel step, whose loss is one masked mean over
the global batch. Here each rank is a process with one device:

- :func:`count_all_reduce` sums the ranks' real-example counts, so each
  rank's backward pass can run on its masked loss sum over the global
  count (``train/steps.py::train_step``): the reference's global masked
  mean, whatever the padding rows of each rank.
- :class:`GradBuffer` is one flat float32 buffer that every parameter's
  ``.grad`` views, allocated once per train state. The step zeroes it
  before the backward pass (autograd then adds each gradient into its
  view in place; under gradient accumulation each micro-batch's too),
  and :func:`grad_all_reduce` sums it over the data axis in one
  collective. The buffer never moves, so a CUDA graph that captured the
  step replays onto the same addresses (``train/steps.py::EpochProgram``
  checks before each pass).
- On a mesh that shards tokens over ``seq`` the gradients sum over the
  data axis's ``sums`` (``('data', 'seq')``, ``parallel/mesh.py``) in the
  same one collective, each rank first zeroing the views of the leaves it
  holds as copies (``GradBuffer.copies``: the ViT's head on every ``seq``
  coordinate but 0), so each counts once. The example count and the
  metrics still sum over ``data`` alone.
- :func:`metric_all_reduce` sums a pass's (or, in the explicit mode, a
  step's) three metric accumulators in one collective.
- On a two-tier ``('dcn', 'ici')`` mesh the axis these run over is the
  mesh's composed data axis (``parallel/mesh.py::make_hier_mesh``): the
  gradient, count and metric sums span both tiers in one collective.
  The ZeRO plane (``parallel/zero.py``) splits them by tier:
  :func:`shard_collective` is each of its reduce-scatters, unsplit
  all-reduces and all-gathers over the shard axis (``ici``, or the flat
  data axis), :func:`dcn_all_reduce` each owner-shard all-reduce over
  ``dcn``.
- :func:`make_explicit_dp_train_step` and
  :func:`make_explicit_dp_eval_step` are the ``--trainer-mode explicit``
  steps: one eager step per batch on DDP's rule (each rank's masked-mean
  gradient, summed and divided by the axis size), whose metrics come
  back summed over the axis, as the JAX explicit step's ``pmean`` and
  ``psum`` give them.

Every collective runs on the calling thread, in the same order on every
rank. Each wrapper counts its calls in ``.launches``; a captured call is
credited once per replay (``ops/launches.py``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from pytorch_distributed_mnist_tpu_torch.ops.metrics import MetricState

_count_lock = threading.Lock()

ALIGN = 64  # elements: every gradient view starts on a 256-byte boundary


class GradBuffer:
    """One flat float32 buffer holding every gradient of ``params``; each
    parameter's ``.grad`` is its view (padded to :data:`ALIGN` elements,
    the padding zero). ``copies`` are the params whose gradients this
    rank holds as copies of another rank's (:meth:`zero_copies`).
    ``stage``, when given, is ``(axis, params)``: the pipeline's
    replicated leaves, whose gradients sum over the stage axis
    (:meth:`sum_stage`); they must lie side by side in ``params``, as the
    JAX flatten order puts the pipelined tree's ``embed`` and ``head``
    after its ``blocks``."""

    def __init__(self, params: Sequence[torch.Tensor],
                 copies: Sequence[torch.Tensor] = (),
                 stage=None) -> None:
        self.params: List[torch.Tensor] = list(params)
        ids = {id(c) for c in copies}
        self.copies = [i for i, p in enumerate(self.params) if id(p) in ids]
        offsets, total = [], 0
        for p in self.params:
            if p.dtype != torch.float32:
                raise ValueError(f"GradBuffer: a {p.dtype} parameter; the "
                                 f"train state keeps float32 params")
            offsets.append(total)
            total += -(-p.numel() // ALIGN) * ALIGN
        self.flat = torch.zeros(total, dtype=torch.float32,
                                device=self.params[0].device)
        self.views = [self.flat[o:o + p.numel()].view_as(p)
                      for o, p in zip(offsets, self.params)]
        self.stage = None
        if stage is not None:
            axis, leaves = stage
            ids = {id(p) for p in leaves}
            rows = [i for i, p in enumerate(self.params) if id(p) in ids]
            if len(rows) != len(ids) or rows != list(range(rows[0],
                                                           rows[-1] + 1)):
                raise ValueError("GradBuffer: the stage-summed params are "
                                 "not one run of the buffer's params")
            end = offsets[rows[-1]] + -(-self.params[rows[-1]].numel()
                                        // ALIGN) * ALIGN
            self.stage = (axis, self.flat[offsets[rows[0]]:end])
        self.zero_()

    def zero_(self) -> None:
        """Zero every gradient, each parameter's ``.grad`` bound to its
        view (rebinding any that something else replaced)."""
        for p, view in zip(self.params, self.views):
            if p.grad is not view:
                p.grad = view
        self.flat.zero_()

    @torch.no_grad()
    def zero_copies(self) -> None:
        """Zero the copied gradients before a sum over the ranks that
        hold them: the rank that does not zero them counts them once."""
        for i in self.copies:
            self.views[i].zero_()

    @torch.no_grad()
    def sum_stage(self) -> None:
        """Sum the replicated leaves' gradients over the stage axis, each
        copy counted once (zeroed first): one all-reduce of their run of
        the buffer. Nothing without a ``stage``."""
        if self.stage is None:
            return
        self.zero_copies()
        axis, run = self.stage
        dist.all_reduce(run, group=axis.group)

    def check(self) -> None:
        """Raise unless every ``.grad`` is still its view: autograd added
        the backward pass's gradients in place."""
        for i, (p, view) in enumerate(zip(self.params, self.views)):
            if p.grad is not view:
                raise RuntimeError(
                    f"parameter {i}'s gradient left the flat all-reduce "
                    f"buffer during backward; the gradient mean would miss "
                    f"it")


def grad_copies(model) -> list:
    """The params whose gradients ``model`` holds as copies of another
    rank's (its ``grad_copies()``; none for a model without one)."""
    copies = getattr(model, "grad_copies", None)
    return list(copies()) if copies is not None else []


def grad_stage(model):
    """``(stage axis, params)`` of ``model``'s leaves whose gradients sum
    over a pipeline's stage axis (its ``grad_stage()``), or None: no
    such leaves, or a stage axis of one rank."""
    stage = getattr(model, "grad_stage", None)
    return stage() if stage is not None else None


def grad_buffer(state) -> GradBuffer:
    """The train state's :class:`GradBuffer`, made at its first use."""
    if state.grad_buffer is None:
        state.grad_buffer = GradBuffer(state.optimizer.params,
                                       grad_copies(state.model),
                                       grad_stage(state.model))
    return state.grad_buffer


def grad_axis(axis):
    """The axis the gradients sum over: ``axis.sums`` when the mesh shards
    tokens, else ``axis`` (None: no axis)."""
    return None if axis is None else (getattr(axis, "sums", None) or axis)


@torch.no_grad()
def count_all_reduce(count: torch.Tensor, axis) -> torch.Tensor:
    """``count`` (this rank's real examples, a float32 device scalar)
    summed over ``axis`` (a ``parallel/mesh.py::DataAxis`` that reduces),
    in place: one all-reduce of 4 bytes. Counts are whole numbers far
    below 2**24, so the sum is exact in any order."""
    dist.all_reduce(count, group=axis.group)
    with _count_lock:
        count_all_reduce.launches += 1
    return count


count_all_reduce.launches = 0


def grad_all_reduce(grads: GradBuffer, axis) -> None:
    """Sum every gradient over ``axis`` (a ``parallel/mesh.py::DataAxis``;
    over its ``sums`` when it has one, the copied gradients zeroed
    first): one all-reduce of the flat buffer, after the pipeline's
    replicated leaves are summed over its stage axis
    (:meth:`GradBuffer.sum_stage`). An axis that does not reduce sums
    nothing. The caller chose the loss's divisor so that the sum is the
    gradient it wants (the global count's, or the axis size's under
    DDP's rule). A world of one sums one rank: exact."""
    grads.check()
    grads.sum_stage()
    over = grad_axis(axis)
    if over is None or not over.reduces:
        return
    if over is not axis:
        grads.zero_copies()
    dist.all_reduce(grads.flat, group=over.group)
    with _count_lock:
        grad_all_reduce.launches += 1


grad_all_reduce.launches = 0


@torch.no_grad()
def metric_all_reduce(ms: MetricState, axis) -> MetricState:
    """``ms`` summed over ``axis``: the three accumulators stacked into
    one all-reduce. An axis that does not reduce (no process group, or
    None) returns ``ms`` as it is."""
    if axis is None or not axis.reduces:
        return ms
    packed = torch.stack(list(ms))
    dist.all_reduce(packed, group=axis.group)
    with _count_lock:
        metric_all_reduce.launches += 1
    return MetricState(*packed.unbind())


metric_all_reduce.launches = 0


_SHARD_OPS = ("reduce_scatter", "all_reduce", "all_gather")


def shard_collective(op: str, out: torch.Tensor, inp, group,
                     async_op: bool = False):
    """One collective of the ZeRO plane over its shard axis's ``group``:
    ``reduce_scatter`` of ``inp`` into ``out``, ``all_reduce`` of ``out``
    in place, or ``all_gather`` of ``inp`` into ``out``. Returns the work
    handle (None unless ``async_op``). Counted per call in ``launches``
    and per op in ``route_launches``."""
    if op == "reduce_scatter":
        work = dist.reduce_scatter_tensor(out, inp, group=group,
                                          async_op=async_op)
    elif op == "all_gather":
        work = dist.all_gather_into_tensor(out, inp, group=group,
                                           async_op=async_op)
    elif op == "all_reduce":
        work = dist.all_reduce(out, group=group, async_op=async_op)
    else:
        raise ValueError(f"unknown shard collective {op!r} "
                         f"({', '.join(_SHARD_OPS)})")
    with _count_lock:
        shard_collective.launches += 1
        shard_collective.route_launches[op] += 1
    return work


shard_collective.launches = 0
shard_collective.route_launches = dict.fromkeys(_SHARD_OPS, 0)


def dcn_all_reduce(t: torch.Tensor, axis, async_op: bool = False):
    """``t`` summed in place over ``axis`` (the two-tier mesh's ``dcn``
    axis: the ranks of this rank's ``ici`` and model coordinates, one per
    slice), the cross-slice tier of the ZeRO plane. Returns the work
    handle (None unless ``async_op``); counted per call in
    ``launches``."""
    work = dist.all_reduce(t, group=axis.group, async_op=async_op)
    with _count_lock:
        dcn_all_reduce.launches += 1
    return work


dcn_all_reduce.launches = 0


def make_explicit_dp_train_step(state, axis) \
        -> Callable[[Dict[str, torch.Tensor]], MetricState]:
    """``step(batch) -> MetricState``: one eager train step of ``state`` on
    this rank's local ``batch`` on DDP's rule, as the JAX explicit step's
    ``pmean`` of each replica's mean-loss gradient: forward, this rank's
    masked mean, backward, the gradient sum over ``axis``
    (:func:`grad_all_reduce`) divided by the axis size, the optimizer
    step; its metrics summed over ``axis`` (:func:`metric_all_reduce`).
    Where every rank's batch holds as many real examples (every train
    batch but a padded tail's), the parameters move as under the stepwise
    mode's steps."""
    from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

    def step(batch):
        return metric_all_reduce(
            train_step(state, batch, axis, replica_mean=True), axis)

    return step


def make_explicit_dp_eval_step(state, axis) \
        -> Callable[[Dict[str, torch.Tensor]], MetricState]:
    """``step(batch) -> MetricState``: the forward-only sibling, its masked
    metrics summed over ``axis``."""
    from pytorch_distributed_mnist_tpu_torch.train.steps import eval_step

    def step(batch):
        return metric_all_reduce(eval_step(state, batch), axis)

    return step
