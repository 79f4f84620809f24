"""The ViT's model FLOPs per image (a multiply-add is two), from its
configuration and the cell's ``patch_size``: the patch embedding, per
block the qkv, attention (``q k^T`` and ``p v``), output and MLP
products, and the head. LayerNorms, softmax, GELU and residual adds are
not counted."""

from __future__ import annotations


def tokens(config: dict, traffic: dict) -> int:
    return (config["image_side"] // traffic["patch_size"]) ** 2


def forward_flops(config: dict, traffic: dict) -> int:
    t, e = tokens(config, traffic), config["embed_dim"]
    pp = traffic["patch_size"] ** 2 * config["in_channels"]
    hid, heads, d = config["mlp_hidden"], config["num_heads"], config["head_dim"]
    block = (2 * t * e * 3 * e            # qkv
             + 2 * 2 * heads * t * t * d  # q k^T and p v
             + 2 * t * e * e              # proj
             + 2 * 2 * t * e * hid)       # mlp1 and mlp2
    return (2 * t * pp * e + config["depth"] * block
            + 2 * e * config["num_classes"])
