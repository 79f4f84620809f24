"""Training engine.

Counterpart of ``pytorch_distributed_mnist_tpu/train/trainer.py``'s
stepwise mode: ``train()`` and ``evaluate()`` each run one pass and return
``(Average, Accuracy)`` meters. Every step's metrics stay on the device
and fold into one accumulator; the pass reads it back once, its only host
sync. The eval batches never reshuffle, so they are moved to the device
once and reused every pass.

On the card the trainer makes cuDNN deterministic (no benchmark search),
so a resumed run repeats the uninterrupted one, and under float32 compute
it turns TF32 off for convolutions and matrix products, so that float32
means float32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from pytorch_distributed_mnist_tpu_torch.data.loader import (
    MNISTDataLoader,
    to_device,
)
from pytorch_distributed_mnist_tpu_torch.ops.metrics import (
    Accuracy,
    Average,
    MetricState,
    metrics_merge,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    eval_step,
    train_step,
)

MODES = ("stepwise",)


def _meters(ms: Optional[MetricState]) -> Tuple[Average, Accuracy]:
    """One device-to-host read: fold a MetricState into the meters.
    ``None`` (no batches) gives empty meters."""
    loss, acc = Average(), Accuracy()
    count = 0 if ms is None else int(ms.count)
    if count:
        loss.update(float(ms.loss_sum) / count, count)
        acc.update(int(ms.correct), count)
    return loss, acc


class Trainer:
    """Runs train and eval passes of per-batch steps on one device."""

    def __init__(self, state, train_loader: MNISTDataLoader,
                 test_loader: MNISTDataLoader, device: torch.device,
                 mode: str = "stepwise") -> None:
        if mode not in MODES:
            raise ValueError(f"trainer mode {mode!r} is not ported yet "
                             f"(ported: {', '.join(MODES)})")
        self.state = state
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.device = device
        self.mode = mode
        self._eval_batches: Optional[List[dict]] = None
        if device.type == "cuda":
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            if getattr(state.model, "compute_dtype", None) == torch.float32:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False

    def train(self) -> Tuple[Average, Accuracy]:
        """One training epoch over the loader's current shuffle."""
        self.state.model.train()
        ms = None
        for batch in self.train_loader:
            m = train_step(self.state, to_device(batch, self.device))
            ms = m if ms is None else metrics_merge(ms, m)
        return _meters(ms)

    def evaluate(self) -> Tuple[Average, Accuracy]:
        """One evaluation pass: no gradient, no state update."""
        self.state.model.eval()
        if self._eval_batches is None:
            self._eval_batches = [to_device(batch, self.device)
                                  for batch in self.test_loader]
        ms = None
        for batch in self._eval_batches:
            m = eval_step(self.state, batch)
            ms = m if ms is None else metrics_merge(ms, m)
        return _meters(ms)
