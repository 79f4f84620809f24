"""Reference-parity linear model: flatten the 28x28 image to 784 features
and apply one dense 784->10 projection.

Counterpart of ``pytorch_distributed_mnist_tpu/models/linear.py``.
``compute_dtype`` defaults to bfloat16 with float32 params and logits;
``matmul`` is the pluggable contraction the int8 serving plane replaces
(the reference's ``dot_general`` field).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from pytorch_distributed_mnist_tpu_torch.models.registry import register_model


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with the kernel kept ``(in, out)`` —
    the reference's Dense layout and the ``(K, N)`` operand the int8
    matmul takes. Inputs, kernel and bias are cast to ``compute_dtype``
    first, as flax's Dense promotes them; ``matmul(x, kernel, out_dtype)``
    replaces the plain product when given."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 matmul: Optional[Callable] = None) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.compute_dtype = compute_dtype
        self.matmul = matmul

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ kernel`` in the compute dtype, without the bias."""
        cd = self.compute_dtype
        x, kernel = x.to(cd), self.kernel.to(cd)
        if self.matmul is None:
            return torch.matmul(x, kernel)
        return self.matmul(x, kernel, cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.product(x) + self.bias.to(self.compute_dtype)


@register_model("linear")
class LinearNet(nn.Module):
    """Flatten -> Dense(num_classes)."""

    def __init__(self, num_classes: int = 10,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 matmul: Optional[Callable] = None) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc = Dense(784, num_classes, compute_dtype, matmul)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        return self.fc(x).float()
