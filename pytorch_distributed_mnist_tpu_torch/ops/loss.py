"""Loss functions: softmax cross-entropy over integer labels, mean-reduced.

Counterpart of ``pytorch_distributed_mnist_tpu/ops/loss.py``.
``set_loss_impl`` keeps the reference's flag names: ``xla`` is the plain
tensor path here (the reference leaves it to XLA), ``fused`` the CUDA
kernels of ``ops/xent.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

_IMPL = "xla"


def cross_entropy_per_example(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy, shape ``(B,)``, in float32
    whatever the model's compute dtype. Clamped at 0 with
    ``torch.maximum``, whose gradient at the tie is 0.5 like the
    reference's ``max(x, 0)`` (``clamp`` would give 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    return torch.maximum(logz - picked,
                         torch.zeros((), device=logits.device))


def set_loss_impl(name: str) -> None:
    """Select the cross-entropy implementation: ``xla`` (default, plain
    torch ops) or ``fused`` (the CUDA kernels, ``ops/xent.py``)."""
    if name not in ("xla", "fused"):
        raise ValueError(f"unknown loss impl {name!r}")
    global _IMPL
    _IMPL = name


def get_loss_impl() -> str:
    return _IMPL


def masked_mean(per_ex: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean (or masked mean) over per-example losses — the one place the
    reduction's semantics live, shared by both impls. Padded examples (0
    in ``mask``) contribute nothing."""
    if mask is None:
        return per_ex.mean()
    mask = mask.float()
    return (per_ex * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def example_count(labels: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The batch's real examples as a float32 device scalar: the mask's
    sum, or every row without one."""
    if mask is None:
        return torch.full((), float(labels.shape[0]), dtype=torch.float32,
                          device=labels.device)
    return mask.float().sum()


def per_example_loss(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy by the selected impl (``set_loss_impl``)."""
    if _IMPL == "fused":
        from pytorch_distributed_mnist_tpu_torch.ops.xent import (
            fused_cross_entropy_per_example,
        )

        return fused_cross_entropy_per_example(logits, labels)
    return cross_entropy_per_example(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy; with ``mask`` (0/1 per example) a
    masked mean, so padded eval rows contribute nothing."""
    return masked_mean(per_example_loss(logits, labels), mask)
