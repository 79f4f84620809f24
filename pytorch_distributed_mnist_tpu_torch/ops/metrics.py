"""On-device metric accumulators and the host-side meters.

Counterpart of ``pytorch_distributed_mnist_tpu/ops/metrics.py``. A
:class:`MetricState` is three float32 scalars on the device, updated per
batch with no host sync and folded in place into one accumulator per
pass (:func:`accumulate_metrics`); ``Average``/``Accuracy`` read it once
per pass.
``Average`` prints 6 decimals, ``Accuracy`` a percentage with 2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MetricState(NamedTuple):
    """Weighted loss sum, correct count, example count (float32 scalars)."""

    loss_sum: torch.Tensor
    correct: torch.Tensor
    count: torch.Tensor


def metrics_init(device) -> MetricState:
    def zero():
        return torch.zeros((), dtype=torch.float32, device=device)

    return MetricState(zero(), zero(), zero())


@torch.no_grad()
def metrics_update(state: MetricState, loss: torch.Tensor,
                   logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> MetricState:
    """Fold one batch in. ``loss`` is the batch's (masked) mean, weighted
    back by the number of real examples; ``mask`` keeps padded eval rows
    out of all three counters."""
    hit = (logits.argmax(dim=-1) == labels).float()
    if mask is None:
        n = torch.full((), labels.shape[0], dtype=torch.float32,
                       device=logits.device)
    else:
        mask = mask.float()
        n = mask.sum()
        hit = hit * mask
    return MetricState(loss_sum=state.loss_sum + loss.float() * n,
                       correct=state.correct + hit.sum(),
                       count=state.count + n)


@torch.no_grad()
def accumulate_metrics(acc: MetricState, m: MetricState) -> MetricState:
    """Fold one step's metrics into the accumulator ``acc`` in place and
    return it: the reference's ``accumulate_metrics``
    (``train/steps.py``), the one reduction of every train and eval
    loop. In place, because a captured CUDA graph must add into the same
    three device tensors on every replay; zero ``acc``
    (:func:`metrics_zero_`) once per pass."""
    for total, part in zip(acc, m):
        total.add_(part)
    return acc


@torch.no_grad()
def metrics_zero_(acc: MetricState) -> MetricState:
    """Reset an accumulator to zero in place, for the next pass."""
    for total in acc:
        total.zero_()
    return acc


class Average:
    """Running weighted mean; ``str`` gives 6 decimals."""

    def __init__(self) -> None:
        self.sum = 0.0
        self.count = 0

    @property
    def average(self) -> float:
        if self.count == 0:
            return 0.0
        return self.sum / self.count

    def update(self, value: float, number: int = 1) -> None:
        self.sum += float(value) * number
        self.count += number

    def __str__(self) -> str:
        return f"{self.average:.6f}"


class Accuracy:
    """Accuracy meter; ``str`` gives a percentage with 2 decimals."""

    def __init__(self) -> None:
        self.correct = 0
        self.count = 0

    @property
    def accuracy(self) -> float:
        if self.count == 0:
            return 0.0
        return self.correct / self.count

    def update(self, correct: int, count: int) -> None:
        self.correct += int(correct)
        self.count += int(count)

    def __str__(self) -> str:
        return f"{self.accuracy * 100:.2f}%"
