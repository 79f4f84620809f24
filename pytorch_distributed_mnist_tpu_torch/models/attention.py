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

``mesh`` (a ``parallel/mesh.py`` mesh) places the model over its
``model`` and ``seq`` axes, with the same param tree and leaf names:

- **tensor parallelism** (a ``model`` axis of tp ranks): the blocks are
  Megatron's. ``qkv`` and ``mlp1`` are column parallel (their input goes
  through ``copy_to_region``: identity forward, all-reduce backward) and
  ``proj`` and ``mlp2`` row parallel (their partial products go through
  ``reduce_from_region``: all-reduce forward, identity backward; their
  biases are added once, after it). Each rank holds ``H/tp`` whole heads
  of ``qkv`` (``parallel/tensor.py::vit_tp_rules`` places it head-aligned)
  and the matching rows of ``proj``, and a ``1/tp`` slice of the MLP's
  hidden dim; attention runs on its local heads. The partial products
  are summed in float32.
- **sequence parallelism** (a ``seq`` axis of sp ranks): each rank holds
  ``T/sp`` tokens through the whole block stack (its patches and its
  slice of ``pos_embed``; LayerNorm and MLP are per token), and the
  ``attention_fn`` is ring or Ulysses attention over the axis
  (``parallel/ring.py``, ``parallel/ulysses.py``). The mean pool is this
  rank's token sum (float32) all-reduced over ``seq`` with an identity
  backward, over T. Every ``seq`` rank then computes the same head on the
  same pooled rows, so the head's gradients are copies over ``seq``
  (:meth:`VisionTransformer.grad_copies`) while every other leaf's are
  partial sums.

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
from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
    copy_to_region,
    reduce_from_region,
)

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
        return layer_norm(x, self.weight, self.bias, self.compute_dtype,
                          self.eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               compute_dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """:class:`LayerNorm`'s arithmetic on given params."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((xf - mean) * mul + bias).to(compute_dtype)


def _row_parallel(layer: Dense, x: torch.Tensor, axis) -> torch.Tensor:
    """A row-parallel Dense: this rank's partial product, summed over the
    model ``axis`` in float32, then the bias (once)."""
    cd = layer.compute_dtype
    part = layer.product(x)
    return (reduce_from_region(part.float(), axis).to(cd)
            + layer.bias.to(cd))


class MultiHeadSelfAttention(nn.Module):
    """QKV projection -> pluggable core attention -> output projection.
    On a ``model`` axis (``model_axis``) the ``qkv`` kernel holds this
    rank's heads and ``proj`` their rows: the heads are counted from the
    kernel's width."""

    def __init__(self, dim: int, num_heads: int,
                 attention_fn: Optional[Callable],
                 compute_dtype: torch.dtype,
                 matmul: Optional[Callable], model_axis=None) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} not divisible by heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.compute_dtype = compute_dtype
        self.model_axis = model_axis
        self.qkv = Dense(dim, 3 * dim, compute_dtype, matmul)
        self.proj = Dense(dim, dim, compute_dtype, matmul)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        d = c // self.num_heads
        h = self.qkv.kernel.shape[1] // (3 * d)  # this rank's heads
        qkv = self.qkv(copy_to_region(x, self.model_axis))
        qkv = qkv.reshape(b, t, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attend = self.attention_fn or full_attention
        o = attend(q, k, v)  # (B, T, H, D)
        o = o.reshape(b, t, h * d).to(self.compute_dtype)
        if self.model_axis is not None and self.model_axis.reduces:
            return _row_parallel(self.proj, o, self.model_axis)
        return self.proj(o)


class TransformerBlock(nn.Module):
    """Pre-LN block: LN -> MHSA -> residual; LN -> MLP (tanh GELU) ->
    residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 attention_fn: Optional[Callable],
                 compute_dtype: torch.dtype,
                 matmul: Optional[Callable], model_axis=None) -> None:
        super().__init__()
        self.model_axis = model_axis
        self.ln1 = LayerNorm(dim, compute_dtype)
        self.attn = MultiHeadSelfAttention(dim, num_heads, attention_fn,
                                           compute_dtype, matmul,
                                           model_axis)
        self.ln2 = LayerNorm(dim, compute_dtype)
        self.mlp1 = Dense(dim, mlp_ratio * dim, compute_dtype, matmul)
        self.mlp2 = Dense(mlp_ratio * dim, dim, compute_dtype, matmul)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        y = self.mlp1(copy_to_region(self.ln2(x), self.model_axis))
        y = F.gelu(y, approximate="tanh")
        if self.model_axis is not None and self.model_axis.reduces:
            return x + _row_parallel(self.mlp2, y, self.model_axis)
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
                 remat: bool = False, mesh=None) -> None:
        super().__init__()
        if patch_size < 1 or IMAGE_SIDE % patch_size:
            raise ValueError(f"patch size {patch_size} does not divide "
                             f"{IMAGE_SIDE}")
        self.patch_size = patch_size
        self.compute_dtype = compute_dtype
        self.depth = depth
        self.remat = remat
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.mlp_ratio = mlp_ratio
        self.attention_fn = attention_fn
        model_axis = None if mesh is None else mesh.model
        self.seq_axis = None if mesh is None else mesh.seq
        tokens = (IMAGE_SIDE // patch_size) ** 2
        self.tokens = tokens
        if self.seq_axis is not None and tokens % self.seq_axis.size:
            raise ValueError(f"{tokens} tokens not divisible by the seq "
                             f"axis of {self.seq_axis.size}")
        self.embed = Dense(patch_size * patch_size, embed_dim, compute_dtype,
                           matmul)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, embed_dim))
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_ratio, attention_fn, compute_dtype,
                matmul, model_axis))
        self.ln_f = LayerNorm(embed_dim, compute_dtype)
        self.head = Dense(embed_dim, num_classes, compute_dtype, matmul)

    def _seq_live(self) -> bool:
        return self.seq_axis is not None and self.seq_axis.reduces

    def grad_copies(self):
        """The params whose gradients this rank holds as copies of
        another rank's (the head's, after the pool, on every ``seq``
        coordinate but 0): a gradient sum over ``seq`` counts them once
        (``parallel/collectives.py::GradBuffer``)."""
        if self._seq_live() and self.seq_axis.rank != 0:
            return [self.head.kernel, self.head.bias]
        return []

    def embed_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Images -> this rank's embedded tokens ``(B, T or T/sp, C)``:
        patchify, embed, add ``pos_embed``."""
        x = patchify(x, self.patch_size, self.compute_dtype)
        pos = self.pos_embed
        if self._seq_live():
            tl = self.tokens // self.seq_axis.size
            rows = slice(self.seq_axis.rank * tl,
                         (self.seq_axis.rank + 1) * tl)
            x, pos = x[:, rows], pos[:, rows]
        return self.embed(x) + pos.to(self.compute_dtype)

    def pool_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens -> float32 logits: LayerNorm, mean over the tokens,
        head."""
        x = self.ln_f(x)
        if self._seq_live():
            pooled = reduce_from_region(x.float().sum(dim=1), self.seq_axis)
            x = (pooled / self.tokens).to(self.compute_dtype)
        else:
            x = x.mean(dim=1)
        return self.head(x).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(x)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x)
        return self.pool_logits(x)
