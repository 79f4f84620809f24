"""The cnn configuration's plain reference: its forward pass in float32
torch operations, with no kernel, graph or batching of the port.

The layers follow ``configs/cnn.json``: a 3x3 convolution of
``conv1_channels`` and one of ``conv2_channels``, each padded by
``conv_padding`` and followed by a ReLU, a 2x2 max-pool, a flatten in
NHWC order, a ReLU Dense of ``fc1_out`` and a Dense to ``num_classes``.
Dense kernels are ``(in, out)``. ``cast`` is applied to both operands of
every product: the identity for the reference, a rounding to a lower
precision for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaves(config: dict, traffic: dict):
    """``(name, shape, init)`` of every weight, in the port's names."""
    k, c0 = config["conv_kernel"], config["in_channels"]
    c1, c2 = config["conv1_channels"], config["conv2_channels"]
    f_in, f_out = config["fc1_in"], config["fc1_out"]
    n = config["num_classes"]
    return [("conv1.weight", (c1, c0, k, k), f"lecun:{c0 * k * k}"),
            ("conv1.bias", (c1,), "zeros"),
            ("conv2.weight", (c2, c1, k, k), f"lecun:{c1 * k * k}"),
            ("conv2.bias", (c2,), "zeros"),
            ("fc1.kernel", (f_in, f_out), f"lecun:{f_in}"),
            ("fc1.bias", (f_out,), "zeros"),
            ("fc2.kernel", (f_out, n), f"lecun:{f_out}"),
            ("fc2.bias", (n,), "zeros")]


def forward(params: dict, images: torch.Tensor, config: dict, traffic: dict,
            cast=lambda t: t) -> torch.Tensor:
    """float32 logits ``(B, num_classes)`` of ``images`` ``(B, 28, 28, 1)``."""
    pad = config["conv_padding"]
    x = images.permute(0, 3, 1, 2)
    for conv in ("conv1", "conv2"):
        x = F.conv2d(cast(x), cast(params[f"{conv}.weight"]), padding=pad)
        x = F.relu(x + params[f"{conv}.bias"][None, :, None, None])
    x = F.max_pool2d(x, config["pool"], config["pool"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(cast(x) @ cast(params["fc1.kernel"]) + params["fc1.bias"])
    return cast(x) @ cast(params["fc2.kernel"]) + params["fc2.bias"]
