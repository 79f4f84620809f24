"""The head-major, depth-stacked ViT layout: ``split_vit_params_tp`` and
``merge_vit_params_tp``.

The port's own copy of those two functions of
``pytorch_distributed_mnist_tpu/parallel/pipeline_tp.py`` (with
``split_vit_params`` / ``merge_vit_params`` of ``parallel/pipeline_vit.py``
folded in): pure reshapes between the standard ViT params and the
``{embed, blocks, head}`` tree whose blocks leaves carry a leading
``(depth,)`` dim and whose attention kernels are head-major, qkv
``(depth, C, 3, H, D)`` and proj ``(depth, H, D, C)``, so that a rule can
split whole heads (``parallel/tensor.py::overlap_tp_rules``). The
overlapped TP schedule (``--tp-overlap``) trains on that tree. The rest
of the JAX module (the pipeline x TP stage body) waits for ROADMAP
Queue 1 item 16 part 5.

Params are ``{port name: tensor or array}``: the standard names are the
model's (``block0.attn.qkv.kernel``, ``pos_embed``, ``ln_f.weight``), the
split names the tree's keys joined by dots (``blocks.attn.qkv.kernel``,
``embed.pos_embed``, ``head.ln_f.weight``).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

__all__ = ["split_vit_params_tp", "merge_vit_params_tp"]

_BLOCK = re.compile(r"block(\d+)\.(.+)")
# Standard name -> split name, for the leaves outside the blocks.
_OUTER = {"embed.kernel": "embed.embed.kernel",
          "embed.bias": "embed.embed.bias",
          "pos_embed": "embed.pos_embed",
          "ln_f.weight": "head.ln_f.weight",
          "ln_f.bias": "head.ln_f.bias",
          "head.kernel": "head.head.kernel",
          "head.bias": "head.head.bias"}


def _stack(values):
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return np.stack(values)


def split_vit_params_tp(params: Dict, num_heads: int) -> Dict:
    """Standard ViT params -> the head-major split tree. Same
    ``{embed, blocks, head}`` grouping as the pipeline layout (a leading
    ``(depth,)`` dim on every blocks leaf), with qkv kernel ``(depth, C,
    3C)`` -> ``(depth, C, 3, H, D)``, its bias likewise, and proj kernel
    ``(depth, C, C)`` -> ``(depth, H, D, C)``. Pure reshapes: bitwise
    inverse via :func:`merge_vit_params_tp`."""
    per_block: Dict[int, Dict[str, object]] = {}
    out = {}
    for name, value in params.items():
        m = _BLOCK.fullmatch(name)
        if m:
            per_block.setdefault(int(m.group(1)), {})[m.group(2)] = value
        elif name in _OUTER:
            out[_OUTER[name]] = value
        else:
            raise ValueError(f"not a ViT param: {name!r}")
    depth = len(per_block)
    if not depth or sorted(per_block) != list(range(depth)):
        # A blockless tree (another model family) names the real problem.
        raise ValueError(f"params have no block* layers to split (keys: "
                         f"{sorted(params)})")
    for leaf in per_block[0]:
        out["blocks." + leaf] = _stack([per_block[i][leaf]
                                        for i in range(depth)])
    qkv_k = out["blocks.attn.qkv.kernel"]
    _, c, three_c = qkv_k.shape
    h = num_heads
    d = c // h
    assert three_c == 3 * c, (tuple(qkv_k.shape), c)
    out["blocks.attn.qkv.kernel"] = qkv_k.reshape(depth, c, 3, h, d)
    out["blocks.attn.qkv.bias"] = out["blocks.attn.qkv.bias"].reshape(
        depth, 3, h, d)
    out["blocks.attn.proj.kernel"] = out["blocks.attn.proj.kernel"].reshape(
        depth, h, d, c)
    return out


def merge_vit_params_tp(split_tp: Dict) -> Dict:
    """The head-major split tree -> standard ViT params (exact inverse of
    :func:`split_vit_params_tp`)."""
    qkv_k = split_tp["blocks.attn.qkv.kernel"]
    depth, c, three, h, d = qkv_k.shape
    blocks = {n[len("blocks."):]: v for n, v in split_tp.items()
              if n.startswith("blocks.")}
    blocks["attn.qkv.kernel"] = qkv_k.reshape(depth, c, three * h * d)
    blocks["attn.qkv.bias"] = blocks["attn.qkv.bias"].reshape(
        depth, three * h * d)
    blocks["attn.proj.kernel"] = blocks["attn.proj.kernel"].reshape(
        depth, h * d, c)
    inner = {v: k for k, v in _OUTER.items()}
    out = {inner[n]: v for n, v in split_tp.items() if n in inner}
    for i in range(depth):
        for leaf, value in blocks.items():
            out[f"block{i}.{leaf}"] = value[i]
    return out
