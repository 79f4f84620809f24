"""Train and eval steps, and the epoch programs built on them.

Counterpart of ``pytorch_distributed_mnist_tpu/train/steps.py``. The
reference's per-batch sequence — forward, mean cross-entropy, backward,
optimizer step, metric accumulation — runs as queued device work with no
``.item()``: the metrics stay on the device until the pass ends. Given a
data axis that reduces (``parallel/mesh.py::DataAxis``, a world of
processes), the train step takes the reference's one masked mean over
the global batch: each rank backpropagates its masked loss sum over the
global count of real examples (one all-reduce of the counts, before the
backward pass), and the gradients are summed over the axis between the
backward pass and the optimizer step (``parallel/collectives.py``): the
update the reference's auto data-parallel step gets from the all-reduce
XLA inserts, for any padding of any rank.

Gradient accumulation (``--grad-accum N``) is the reference's
``make_accum_train_step_fn``: the local batch splits into N micro-batches
along dim 0; each backpropagates its per-example loss sum into the one
flat gradient buffer against the same params; then one gradient sum over
the axis, one division by the count of real examples over every
micro-batch and rank, and one optimizer step.

The reference's scanned epoch (``lax.scan`` of the step over an epoch
staged on the device, one program per epoch) is :class:`EpochProgram`
here: on the card, one step captured as a CUDA graph and replayed once
per batch, its batch read from the staged epoch at a tick counter held on
the device; on the CPU the same step body in a Python loop.
:func:`make_train_epoch`, :func:`make_train_epoch_indexed` and
:func:`make_eval_epoch` build it, as the reference's ``_make_epoch``
builds its three; on a data axis that reduces, the captured step holds
the count and gradient all-reduces too, and under accumulation the whole
accumulated step is what is captured.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable, Dict, List, Optional

import torch

from pytorch_distributed_mnist_tpu_torch.models.convert import state_leaves
from pytorch_distributed_mnist_tpu_torch.ops.launches import CapturedLaunches
from pytorch_distributed_mnist_tpu_torch.ops.loss import (
    cross_entropy,
    example_count,
    masked_mean,
    per_example_loss,
)
from pytorch_distributed_mnist_tpu_torch.ops.metrics import (
    MetricState,
    accumulate_metrics,
    metrics_init,
    metrics_update,
    metrics_zero_,
)
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    count_all_reduce,
    grad_all_reduce,
    grad_axis,
    grad_buffer,
)
from pytorch_distributed_mnist_tpu_torch.utils import debug_nans
from pytorch_distributed_mnist_tpu_torch.utils.profiling import compile_log

# Ticks of an epoch program's first passes run eagerly, as real steps,
# before its graph is captured: every kernel has then launched (and its
# module loaded) and every lazily built table exists. The train step's
# first step builds Adam's leaf table; the eval step has no such state.
TRAIN_WARMUP_TICKS = 2
EVAL_WARMUP_TICKS = 1


def make_forward_program(model: torch.nn.Module):
    """``forward(params, images) -> logits``: the one inference forward,
    shared by :func:`eval_step` and the serving engine
    (``serve/engine.py``), so evaluation and serving cannot disagree on
    the forward's math or dtype policy. Params are an argument (a dict
    named as the model names them), so the engine can swap checkpoints
    without rebuilding anything."""

    def forward(params, images):
        return torch.func.functional_call(model, params, (images,),
                                          strict=True)

    return forward


def _forward_with_aux(model: torch.nn.Module, images: torch.Tensor,
                      aux_weight: float):
    """Training forward returning ``(logits, aux)``: ``aux`` is the sum of
    the ``aux_loss`` entries the model sowed (the MoE router's
    load-balance term, ``models/moe.py``), or 0.0 when ``aux_weight`` is
    0, in which case nothing is asked of the model. The port of the
    reference's ``_forward_with_aux``: a model sows by returning
    ``(logits, {path: value})`` when called with ``intermediates=True``
    (one that takes no such argument sows nothing).

    Only entries whose path holds ``aux_loss`` join the objective; any
    other sown value raises, so a diagnostic can never join the loss. The
    statistic cannot see the validity mask: train batches are whole (the
    loader drops the ragged tail)."""
    if not aux_weight:
        return model(images), 0.0
    if "intermediates" not in inspect.signature(model.forward).parameters:
        return model(images), torch.zeros((), device=images.device)
    logits, sown = model(images, intermediates=True)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    for path, leaf in sown.items():
        if "aux_loss" not in path:
            raise ValueError(
                f"aux_weight is set but the model sowed a non-aux_loss "
                f"intermediate at {path!r}; only 'aux_loss' entries may "
                f"join the training objective")
        aux = aux + torch.sum(leaf)
    return logits, aux


def train_step(state, batch: Dict[str, torch.Tensor], axis=None,
               accum: int = 1, replica_mean: bool = False,
               aux_weight: float = 0.0) -> MetricState:
    """One optimizer step on one batch (on the state's device); updates
    ``state`` in place and returns this batch's metrics, still on the
    device. On an ``axis`` that reduces, ``batch`` is this rank's local
    batch, and the optimizer steps on the gradient of one masked mean
    over the global batch: this rank's masked loss sum over the global
    count (:func:`count_all_reduce`), summed over the axis in one
    all-reduce of the state's flat gradient buffer. ``replica_mean``
    takes DDP's rule instead (the explicit mode's): each rank's masked
    mean, summed and divided by the axis size. ``accum > 1`` splits the
    batch into that many micro-batches (:func:`_accum_train_step`). The
    objective is the cross-entropy plus ``aux_weight`` times the model's
    sown aux loss (:func:`_forward_with_aux`); the metrics report the
    cross-entropy alone, and stay this rank's.

    A ZeRO-placed state (``state.zero``, ``parallel/zero.py``) reduces
    through its plane instead of the all-reduce: the reduce-scatter into
    this rank's shards, the optimizer on the shards, the all-gather. The
    overlapped plane (``parallel/zero_overlap.py``) takes the
    micro-batched body at any ``accum``, its hooks armed for the last
    backward."""
    if accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {accum}")
    zero = state.zero
    if accum > 1 or (zero is not None and zero.overlap):
        return _accum_train_step(state, batch, axis, accum, aux_weight)
    images, labels = batch["image"], batch["label"]
    mask = batch.get("mask")
    if zero is not None:
        zero.before_forward()
    logits, aux = _forward_with_aux(state.model, images, aux_weight)
    reduce = axis is not None and axis.reduces
    # The gradients may sum over a wider axis than the count (data x seq
    # when the tokens shard over seq).
    over = grad_axis(axis)
    if not (over is not None and over.reduces) and zero is None:
        loss = cross_entropy(logits, labels, mask)
        state.optimizer.zero_grad(set_to_none=True)
        (loss + aux_weight * aux if aux_weight else loss).backward()
    else:
        grads = grad_buffer(state)
        grads.zero_()
        per_ex = per_example_loss(logits, labels)
        if replica_mean:
            loss = masked_mean(per_ex, mask)
            loss.backward()
        else:
            # The global count is known before the forward: its
            # all-reduce needs nothing of this step's work. In a world of
            # one this is ``masked_mean``'s expression, bit for bit.
            total = example_count(labels, mask)
            if reduce:
                count_all_reduce(total, axis)
            if mask is None:
                num, loss = per_ex.sum(), per_ex.mean()
            else:
                # One masked sum: the metrics' loss is masked_mean's
                # expression from it.
                live = mask.float()
                num = (per_ex * live).sum()
                loss = num / torch.clamp(live.sum(), min=1.0)
            objective = num / torch.clamp(total, min=1.0)
            if aux_weight:
                # aux is the global batch's (its sums all-reduced with an
                # identity backward): each rank backpropagates it whole
                # through its own rows, and the gradient sum over the
                # axis is its gradient.
                objective = objective + aux_weight * aux
            objective.backward()
        if zero is not None:
            zero.step(state.optimizer)
            state.step.add_(1)
            return metrics_update(metrics_init(logits.device),
                                  loss.detach(), logits.detach(), labels,
                                  mask)
        grad_all_reduce(grads, axis)
        if replica_mean:
            grads.flat.div_(axis.size)
    state.optimizer.step()
    state.step.add_(1)
    return metrics_update(metrics_init(logits.device), loss.detach(),
                          logits.detach(), labels, mask)


def _accum_train_step(state, batch: Dict[str, torch.Tensor], axis,
                      accum: int, aux_weight: float = 0.0) -> MetricState:
    """:func:`train_step` over ``accum`` micro-batches, in the order of
    the reference's ``make_accum_train_step_fn``: per micro-batch of
    ``n`` real examples, the backward pass of its masked mean times ``n``
    (its per-example loss sum) plus ``aux_weight * aux * n`` adds into the
    flat gradient buffer against the same params, and its metrics fold
    in with ``loss_sum / max(n, 1)``; then the sum over the axis, one
    division by the real examples over every micro-batch and rank, and
    one optimizer step. On an axis that reduces, the aux term's ``n`` is
    the micro-batch's count over the axis (the reference's micro-batch
    is the global one). A ZeRO-placed state's plane is armed before the
    last backward: the overlapped plane issues its reduce-scatters from
    that backward's hooks."""
    images, labels = batch["image"], batch["label"]
    mask = batch.get("mask")
    b = labels.shape[0]
    if b % accum:
        raise ValueError(f"global batch {b} not divisible by --grad-accum "
                         f"{accum}")
    reduce = axis is not None and axis.reduces
    over = grad_axis(axis)
    zero = state.zero
    total = example_count(labels, mask)
    if reduce:
        count_all_reduce(total, axis)
    if zero is not None:
        zero.before_forward()
    grads = grad_buffer(state)
    grads.zero_()
    metrics = metrics_init(labels.device)
    micro = b // accum
    for k in range(accum):
        rows = slice(k * micro, (k + 1) * micro)
        mb_labels = labels[rows]
        mb_mask = None if mask is None else mask[rows]
        logits, aux = _forward_with_aux(state.model, images[rows],
                                        aux_weight)
        n = example_count(mb_labels, mb_mask)
        loss_sum = cross_entropy(logits, mb_labels, mb_mask) * n
        objective = loss_sum
        if aux_weight:
            n_aux = count_all_reduce(n.clone(), axis) if reduce else n
            objective = loss_sum + aux_weight * aux * n_aux
        if zero is not None and k == accum - 1:
            zero.begin_backward()  # the overlapped plane's hooks
        objective.backward()
        grads.check()
        loss_mean = loss_sum.detach() / torch.clamp(n, min=1.0)
        metrics = metrics_update(metrics, loss_mean, logits.detach(),
                                 mb_labels, mb_mask)
    if zero is not None:
        zero.step(state.optimizer, divisor=total)
        state.step.add_(1)
        return metrics
    if over is not None and over.reduces:
        grad_all_reduce(grads, axis)
    grads.flat.div_(torch.clamp(total, min=1.0))
    state.optimizer.step()
    state.step.add_(1)
    return metrics


@torch.no_grad()
def eval_step(state, batch: Dict[str, torch.Tensor]) -> MetricState:
    """Forward, loss and metrics with no gradient; the batch's mask keeps
    padded rows out of the counts."""
    mask = batch.get("mask")
    forward = make_forward_program(state.model)
    logits = forward(dict(state.model.named_parameters()), batch["image"])
    loss = cross_entropy(logits, batch["label"], mask)
    return metrics_update(metrics_init(logits.device), loss, logits,
                          batch["label"], mask)


class EpochProgram:
    """One epoch of train (or eval) steps over batches staged on the
    device: the reference's scanned epoch.

    A pass zeroes the device tick and the metric accumulator, then runs
    one step per tick: the step reads its batch at the tick (``(S, B,
    ...)`` staged arrays, or rows ``idx[tick]`` of a dataset resident on
    the device), folds its metrics into the accumulator in place and
    advances the tick, all on the device. On the card the first
    ``warmup`` ticks of the first passes run eagerly, on a side stream;
    the next tick is captured as a CUDA graph (``torch.cuda.graph``,
    torch's default capture checks) and the graph is replayed for every
    later tick of this and each later pass. Capture runs nothing, so no
    batch is trained twice. On the CPU every tick runs the step body
    eagerly; there is no graph.

    The graph holds the addresses of the train state's tensors, the
    staged arrays, the tick and the accumulator, recorded at capture:
    a later pass whose state or arrays were rebound raises, and never
    replays stale addresses. The state is updated in place (the
    optimizer's step, the learning rate's ``fill_``, checkpoint loads'
    ``copy_``), and the caller refills the same staged arrays between
    passes. A failed capture or replay raises: there is no fallback.

    On a data ``axis`` that reduces, the train step's count and gradient
    all-reduces run in the warm-up ticks first (NCCL's communicator
    exists before the capture) and are captured with the rest of the
    step; the state's flat gradient buffer (made in a warm-up tick, under
    accumulation too) is one of the recorded addresses. ``accum`` is the
    train step's micro-batch count: the graph holds all of them.

    The kernel wrappers' and the collectives' launch counts stay exact
    across replays (``ops/launches.py``). ``capture_s`` is the capture's
    wall time and ``replays`` the replays so far."""

    def __init__(self, state, train: bool, indexed: bool,
                 warmup: int, axis=None, accum: int = 1,
                 aux_weight: float = 0.0) -> None:
        self.state = state
        self.aux_weight = aux_weight
        self.train = train
        self.indexed = indexed
        self.warmup = warmup
        self.axis = axis
        self.accum = accum
        self.device = state.step.device
        self._tick = torch.zeros((), dtype=torch.int64, device=self.device)
        self._acc = metrics_init(self.device)
        self._source: Dict[str, torch.Tensor] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._bound: Optional[List[int]] = None
        self._eager_ticks = 0
        self.launches = CapturedLaunches()
        self.capture_s: Optional[float] = None
        self.replays = 0

    def _batch(self) -> Dict[str, torch.Tensor]:
        """The batch at the device tick (``_take_batch`` in the
        reference, for the indexed epoch)."""
        src, tick = self._source, self._tick.view(1)
        if self.indexed:
            idx = src["idx"].index_select(0, tick)[0]
            return {"image": src["image"].index_select(0, idx),
                    "label": src["label"].index_select(0, idx),
                    "mask": src["mask"].index_select(0, tick)[0]}
        return {key: src[key].index_select(0, tick)[0]
                for key in ("image", "label", "mask")}

    def _body(self) -> None:
        if self.train:
            metrics = train_step(self.state, self._batch(), self.axis,
                                 self.accum, aux_weight=self.aux_weight)
        else:
            metrics = eval_step(self.state, self._batch())
        accumulate_metrics(self._acc, metrics)
        with torch.no_grad():
            self._tick.add_(1)

    def _pointers(self) -> List[int]:
        tensors = [t for _, t in state_leaves(self.state)]
        tensors += [self._source[k] for k in sorted(self._source)]
        if self.state.grad_buffer is not None:
            tensors.append(self.state.grad_buffer.flat)
        return [t.data_ptr() for t in tensors + [self._tick, *self._acc]]

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with self.launches.capturing(), torch.cuda.graph(graph):
            self._body()
        self._graph = graph
        self._bound = self._pointers()
        self.capture_s = time.perf_counter() - t0
        compile_log.record_capture(
            "train_step" if self.train else "eval_step", self.capture_s)

    def run(self, source: Dict[str, torch.Tensor]) -> MetricState:
        """One pass over ``source`` (on the state's device); returns the
        pass's metrics, still on the device."""
        self._source = source
        steps = int(source["mask"].shape[0])
        if self._graph is not None and self._pointers() != self._bound:
            raise RuntimeError(
                "the train state or the staged epoch was rebound since its "
                "CUDA graph was captured; update tensors in place (copy_, "
                "fill_) instead")
        metrics_zero_(self._acc)
        with torch.no_grad():
            self._tick.zero_()
        if self.device.type != "cuda":
            for _ in range(steps):
                self._body()
            return MetricState(*(t.clone() for t in self._acc))
        eager = 0
        if self._graph is None:
            eager = min(steps, max(0, self.warmup - self._eager_ticks))
        if eager:
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(eager):
                    self._body()
            current.wait_stream(side)
            self._eager_ticks += eager
        replays = steps - eager
        if replays and self._graph is None:
            self._capture()
        for _ in range(replays):
            self._graph.replay()
        self.launches.credit(replays)
        self.replays += replays
        return MetricState(*(t.clone() for t in self._acc))

    def rerun_checked(self) -> None:
        """Run the last pass again, every tick eagerly (no graph) under
        ``--debug-nans``'s ``NanCheckMode``: it raises
        ``FloatingPointError`` at the first op that makes a NaN.
        The caller restores the state the pass started from first."""
        metrics_zero_(self._acc)
        with torch.no_grad():
            self._tick.zero_()
        with debug_nans.NanCheckMode():
            for _ in range(int(self._source["mask"].shape[0])):
                self._body()


def _make_epoch(state, train: bool, indexed: bool, axis=None,
                accum: int = 1, aux_weight: float = 0.0) \
        -> Callable[..., MetricState]:
    """The one factory behind the three ``make_*_epoch*`` functions, as
    the reference's ``_make_epoch``: ``train`` picks the train or the eval
    step, ``indexed`` where a tick's batch comes from, ``axis`` the data
    axis of the train step's gradient reduction, ``accum`` its
    micro-batches. The returned function carries its
    :class:`EpochProgram` as ``.program``."""
    program = EpochProgram(
        state, train=train, indexed=indexed,
        warmup=TRAIN_WARMUP_TICKS if train else EVAL_WARMUP_TICKS,
        axis=axis, accum=accum, aux_weight=aux_weight)
    if indexed:
        def epoch(data, ticks):
            return program.run({**data, **ticks})
    else:
        def epoch(batches):
            return program.run(batches)
    epoch.program = program
    return epoch


def make_train_epoch(state, axis=None, grad_accum: int = 1,
                     aux_weight: float = 0.0) -> Callable[..., MetricState]:
    """``epoch(batches) -> MetricState``: one train step per batch of
    ``batches`` (``{'image': (S, B, ...), 'label': (S, B), 'mask': (S,
    B)}`` on the state's device), updating ``state`` in place, with the
    global masked mean over ``axis`` when it reduces and ``grad_accum``
    micro-batches a step. Pass the same tensors, refilled, every epoch.
    The metrics are this rank's."""
    return _make_epoch(state, train=True, indexed=False, axis=axis,
                       accum=grad_accum, aux_weight=aux_weight)


def make_train_epoch_indexed(state, axis=None, grad_accum: int = 1,
                             aux_weight: float = 0.0) \
        -> Callable[..., MetricState]:
    """``epoch(data, ticks) -> MetricState``: as :func:`make_train_epoch`,
    each batch gathered on the device from the resident dataset ``data``
    (``{'image': (N, ...), 'label': (N,)}``) at the rows ``ticks['idx']``
    (``(S, B)`` int64), with ``ticks['mask']`` (``(S, B)``): the dataset
    crosses to the device once per run, and an epoch's upload is its
    index matrix."""
    return _make_epoch(state, train=True, indexed=True, axis=axis,
                       accum=grad_accum, aux_weight=aux_weight)


def make_eval_epoch(state) -> Callable[..., MetricState]:
    """``epoch(batches) -> MetricState``: one eval step per staged batch,
    the mask keeping padded rows out of the counts. The eval set never
    reshuffles, so the caller stages it once and passes it every pass."""
    return _make_epoch(state, train=False, indexed=False)
