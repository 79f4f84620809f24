"""The cnn's model FLOPs per image (a multiply-add is two), from its
configuration: the two convolutions at full resolution (``conv_padding``
keeps it), fc1 and fc2. Bias adds, ReLUs and the pool are not counted."""

from __future__ import annotations


def forward_flops(config: dict, traffic: dict) -> int:
    side, k = config["image_side"], config["conv_kernel"]
    c0, c1, c2 = (config["in_channels"], config["conv1_channels"],
                  config["conv2_channels"])
    pixels = side * side
    convs = 2 * pixels * k * k * (c0 * c1 + c1 * c2)
    fcs = 2 * (config["fc1_in"] * config["fc1_out"]
               + config["fc1_out"] * config["num_classes"])
    return convs + fcs
