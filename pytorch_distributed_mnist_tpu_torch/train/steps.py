"""Train and eval steps.

Counterpart of ``pytorch_distributed_mnist_tpu/train/steps.py``'s
single-device path. The reference's per-batch sequence — forward, mean
cross-entropy, backward, optimizer step, metric accumulation — runs as
queued device work with no ``.item()``: the metrics stay on the device
until the pass ends. Gradient accumulation and whole-epoch programs (the
reference's ``lax.scan``; a captured CUDA graph here) are later work.
"""

from __future__ import annotations

from typing import Dict

import torch

from pytorch_distributed_mnist_tpu_torch.ops.loss import cross_entropy
from pytorch_distributed_mnist_tpu_torch.ops.metrics import (
    MetricState,
    metrics_init,
    metrics_update,
)


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


def train_step(state, batch: Dict[str, torch.Tensor]) -> MetricState:
    """One optimizer step on one batch (on the state's device); updates
    ``state`` in place and returns this batch's metrics, still on the
    device."""
    images, labels = batch["image"], batch["label"]
    mask = batch.get("mask")
    logits = state.model(images)
    loss = cross_entropy(logits, labels, mask)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step.add_(1)
    return metrics_update(metrics_init(logits.device), loss.detach(),
                          logits.detach(), labels, mask)


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
