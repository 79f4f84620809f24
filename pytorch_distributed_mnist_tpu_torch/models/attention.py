"""Patch transformer (ViT) with a pluggable attention function.

Counterpart of ``pytorch_distributed_mnist_tpu/models/attention.py``:
patchify -> embed (+ pos_embed) -> pre-LN transformer blocks -> LayerNorm
-> mean over tokens -> head. The token count is (28/patch)^2, 49 at the
default patch 4.

The dtype policy is the other models': bfloat16 compute with float32
params and logits. The reference's flax defaults are kept where torch's
differ: LayerNorm takes its statistics in float32 with ``eps = 1e-6``
(torch's default is 1e-5), and GELU is the tanh form (``F.gelu`` defaults
to the exact erf).

``attention_fn`` is any ``(q, k, v) -> o`` on ``(B, T, H, D)``; the default
is dense ``ops.attention.full_attention``, and ``--attention flash`` passes
``ops.flash.flash_attention``. ``matmul`` goes to every Dense, as in
``cnn``.

``remat`` is the reference's ``nn.remat(TransformerBlock)``: with
gradients enabled each block runs under ``torch.utils.checkpoint``
(non-reentrant), which keeps only the block's input and runs its forward
again in the backward pass. The RNG state is not preserved: the model
draws no randomness, and reading the CUDA generator would not belong in
a captured graph. Parameter names do not change, so checkpoints load
between remat and non-remat models both ways.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pytorch_distributed_mnist_tpu_torch.models.linear import Dense
from pytorch_distributed_mnist_tpu_torch.models.registry import register_model
from pytorch_distributed_mnist_tpu_torch.ops.attention import full_attention

IMAGE_SIDE = 28


def patchify(x: torch.Tensor, patch_size: int,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """(B, 784) / (B, 28, 28) / (B, 28, 28, C) -> (B, T, p*p*C) patches,
    in the reference's order: (B, gh, p, gw, p, C) -> (B, gh, gw, p, p, C)."""
    if x.dim() == 2:
        x = x.reshape(x.shape[0], IMAGE_SIDE, IMAGE_SIDE, 1)
    elif x.dim() == 3:
        x = x[..., None]
    x = x.to(compute_dtype)
    p = patch_size
    b, hh, ww, ch = x.shape
    gh, gw = hh // p, ww // p
    x = x.reshape(b, gh, p, gw, p, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * ch)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=compute_dtype)``: mean and variance in
    float32 (``E[x^2] - E[x]^2``, clipped at 0), ``eps = 1e-6``, the
    scale folded into the reciprocal square root, the result cast to the
    compute dtype. The scale is ``weight`` here and ``scale`` in a JAX
    checkpoint (``models/convert.py``)."""

    def __init__(self, features: int, compute_dtype: torch.dtype,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = compute_dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class MultiHeadSelfAttention(nn.Module):
    """QKV projection -> pluggable core attention -> output projection."""

    def __init__(self, dim: int, num_heads: int,
                 attention_fn: Optional[Callable],
                 compute_dtype: torch.dtype,
                 matmul: Optional[Callable]) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} not divisible by heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.compute_dtype = compute_dtype
        self.qkv = Dense(dim, 3 * dim, compute_dtype, matmul)
        self.proj = Dense(dim, dim, compute_dtype, matmul)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, t, 3, h, c // h)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attend = self.attention_fn or full_attention
        o = attend(q, k, v)  # (B, T, H, D)
        return self.proj(o.reshape(b, t, c).to(self.compute_dtype))


class TransformerBlock(nn.Module):
    """Pre-LN block: LN -> MHSA -> residual; LN -> MLP (tanh GELU) ->
    residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 attention_fn: Optional[Callable],
                 compute_dtype: torch.dtype,
                 matmul: Optional[Callable]) -> None:
        super().__init__()
        self.ln1 = LayerNorm(dim, compute_dtype)
        self.attn = MultiHeadSelfAttention(dim, num_heads, attention_fn,
                                           compute_dtype, matmul)
        self.ln2 = LayerNorm(dim, compute_dtype)
        self.mlp1 = Dense(dim, mlp_ratio * dim, compute_dtype, matmul)
        self.mlp2 = Dense(mlp_ratio * dim, dim, compute_dtype, matmul)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.mlp1(self.ln2(x)), approximate="tanh")
        return x + self.mlp2(y)


@register_model("vit")
class VisionTransformer(nn.Module):
    """Small ViT: patchify -> embed (+pos) -> blocks -> LN -> mean-pool ->
    head. Params are named as the reference's tree nests them
    (``block0.attn.qkv.kernel``, ``pos_embed``, ``ln_f.weight``)."""

    def __init__(self, num_classes: int = 10, patch_size: int = 4,
                 embed_dim: int = 64, depth: int = 2, num_heads: int = 4,
                 mlp_ratio: int = 4, attention_fn: Optional[Callable] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 matmul: Optional[Callable] = None,
                 remat: bool = False) -> None:
        super().__init__()
        if patch_size < 1 or IMAGE_SIDE % patch_size:
            raise ValueError(f"patch size {patch_size} does not divide "
                             f"{IMAGE_SIDE}")
        self.patch_size = patch_size
        self.compute_dtype = compute_dtype
        self.depth = depth
        self.remat = remat
        tokens = (IMAGE_SIDE // patch_size) ** 2
        self.embed = Dense(patch_size * patch_size, embed_dim, compute_dtype,
                           matmul)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, embed_dim))
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_ratio, attention_fn, compute_dtype,
                matmul))
        self.ln_f = LayerNorm(embed_dim, compute_dtype)
        self.head = Dense(embed_dim, num_classes, compute_dtype, matmul)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embed(patchify(x, self.patch_size, self.compute_dtype))
        x = x + self.pos_embed.to(self.compute_dtype)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x)
        x = self.ln_f(x).mean(dim=1)
        return self.head(x).float()
