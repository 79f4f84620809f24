"""Small convnet: conv3x3(32) -> conv3x3(64) -> maxpool2 -> dense(128) ->
dense(10).

Counterpart of ``pytorch_distributed_mnist_tpu/models/cnn.py``. Its public
layout is the reference's: NHWC input (``(B, 28, 28, 1)``, ``(B, 28, 28)``
or ``(B, 784)``), flattened in NHWC order before ``fc1``, so params carried
over from the JAX package (``models/convert.py``) give the same logits.
Inside, the convolutions run NCHW through ``F.conv2d`` (cuDNN on the card,
as XLA runs them in the reference). ``compute_dtype`` defaults to
bfloat16, with float32 params and logits; ``matmul`` is the pluggable
Dense contraction the int8 serving plane replaces.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_mnist_tpu_torch.models.linear import Dense
from pytorch_distributed_mnist_tpu_torch.models.registry import register_model


@register_model("cnn")
class ConvNet(nn.Module):
    def __init__(self, num_classes: int = 10,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 matmul: Optional[Callable] = None) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.fc1 = Dense(14 * 14 * 64, 128, compute_dtype, matmul)
        self.fc2 = Dense(128, num_classes, compute_dtype, matmul)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        # Bias added after the convolution, in the compute dtype, as
        # flax's Conv does (a fused bias would round once less in bf16).
        cd = self.compute_dtype
        y = F.conv2d(x, conv.weight.to(cd), padding=1)
        return y + conv.bias.to(cd)[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.reshape(x.shape[0], 28, 28, 1)
        elif x.dim() == 3:
            x = x[..., None]
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self._conv(self.conv1, x))
        x = F.relu(self._conv(self.conv2, x))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = F.relu(self.fc1(x))
        return self.fc2(x).float()
