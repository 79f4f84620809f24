"""The split ViT tree as a module, computed by the ViT's own modules.

The pipelined ViT (``parallel/pipeline_vit.py``, ``parallel/pipeline_tp.py``)
and the overlapped-TP ViT (``parallel/tensor.py``) keep their params as the
JAX split tree: ``{embed: {embed, pos_embed}, blocks: <one block tree,
leaves stacked to a leading (depth,) dim>, head: {ln_f, head}}``, its
attention leaves head-major under TP (qkv ``(C, 3, H, D)``, proj ``(H, D,
C)``). :class:`SplitTree` holds that tree as its params.

:class:`ViTParts` computes on it with the modules of
``models/attention.py``, through ``torch.func.functional_call``: a ViT of
no blocks and one ``TransformerBlock``, built on the meta device (they
hold no numbers), take the split leaves as their params. The embedding
is the model's ``embed_tokens``, the head its ``pool_logits``, a block the
model's block (Megatron's on a ``model`` axis), so the schedules run the
model's arithmetic and not a copy of it. The head-major leaves enter
flattened back to the model's Dense layout, ``(C, 3*Hl*D)`` and ``(Hl*D,
C)``: the head-aligned layout the model's attention takes, which counts
its heads from the kernel's width.
"""

from __future__ import annotations

from typing import Dict

import torch

from pytorch_distributed_mnist_tpu_torch.models.convert import (
    _HWIO_TO_OIHW,
    _OIHW_TO_HWIO,
)

__all__ = ["SplitTree", "ViTParts"]

# Split name -> the ViT's name, for the leaves outside the blocks.
_ENDS = {"embed.embed.kernel": "embed.kernel",
         "embed.embed.bias": "embed.bias",
         "embed.pos_embed": "pos_embed",
         "head.ln_f.weight": "ln_f.weight",
         "head.ln_f.bias": "ln_f.bias",
         "head.head.kernel": "head.kernel",
         "head.head.bias": "head.bias"}
# Head-major block leaves -> the model's Dense layout (no-ops on the
# flat leaves of the plain split tree).
_DENSE_LAYOUT = {"attn.qkv.kernel": lambda v: v.flatten(1),
                 "attn.qkv.bias": lambda v: v.flatten(),
                 "attn.proj.kernel": lambda v: v.flatten(0, -2)}


class SplitTree(torch.nn.Module):
    """A module holding a split ViT tree as its params, named as the tree
    nests them (``blocks.attn.qkv.kernel``, ``embed.pos_embed``). Its
    checkpoint leaves hang straight off ``params``, as the JAX split
    state's do (``param_root``). A 4-D leaf (the head-major qkv bias and
    proj kernel under TP) is kept in the port's 4-D layout, the JAX one
    transposed as a conv kernel is (``models/convert.py``), so the
    checkpoint and placement layers carry it as they carry every 4-D
    leaf; :meth:`split_params` gives the tree in the JAX layout."""

    param_root = ""

    def __init__(self, split: Dict) -> None:
        super().__init__()
        for name, value in split.items():
            *path, leaf = name.split(".")
            module = self
            for key in path:
                if not hasattr(module, key):
                    module.add_module(key, torch.nn.Module())
                module = getattr(module, key)
            value = torch.as_tensor(value, dtype=torch.float32)
            if value.dim() == 4:
                value = value.permute(_HWIO_TO_OIHW)
            module.register_parameter(leaf, torch.nn.Parameter(
                value.contiguous().clone()))

    def split_params(self) -> Dict[str, torch.Tensor]:
        """``{split name: param}`` in the JAX layout (views of the live
        params)."""
        return {n: p.permute(_OIHW_TO_HWIO) if p.dim() == 4 else p
                for n, p in self.named_parameters()}


class _Method(torch.nn.Module):
    """A method of ``model`` as a module's forward: what
    ``functional_call`` runs."""

    def __init__(self, model: torch.nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, method: str, *args):
        return getattr(self.model, method)(*args)


class ViTParts:
    """The embedding, a block and the head of a ``models/attention.py``
    ViT like ``model`` (its widths, attention, compute dtype and matmul;
    no sequence axis), run on split-tree leaves. ``model_axis`` makes the
    block Megatron's over that axis."""

    def __init__(self, model, model_axis=None) -> None:
        from pytorch_distributed_mnist_tpu_torch.models.attention import (
            TransformerBlock,
            VisionTransformer,
        )

        matmul = model.head.matmul
        with torch.device("meta"):
            ends = VisionTransformer(
                num_classes=model.head.kernel.shape[1],
                patch_size=model.patch_size, embed_dim=model.embed_dim,
                depth=0, num_heads=model.num_heads,
                mlp_ratio=model.mlp_ratio, attention_fn=model.attention_fn,
                compute_dtype=model.compute_dtype, matmul=matmul)
            self._block = TransformerBlock(
                model.embed_dim, model.num_heads, model.mlp_ratio,
                model.attention_fn, model.compute_dtype, matmul, model_axis)
        self._ends = _Method(ends)

    def _call(self, method: str, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        leaves = {"model." + _ENDS[n]: v for n, v in params.items()
                  if n in _ENDS}
        return torch.func.functional_call(self._ends, leaves, (method, x))

    def embed(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        """Images -> embedded tokens, from the ``embed.`` leaves of
        ``params`` (split names)."""
        return self._call("embed_tokens", params, x)

    def head(self, params: Dict[str, torch.Tensor],
             h: torch.Tensor) -> torch.Tensor:
        """Tokens -> float32 logits, from the ``head.`` leaves."""
        return self._call("pool_logits", params, h)

    def block(self, bp: Dict[str, torch.Tensor],
              h: torch.Tensor) -> torch.Tensor:
        """One block on its leaves ``bp`` (named under ``blocks.``, JAX
        layout; this rank's heads and MLP slice under TP)."""
        leaves = {n: _DENSE_LAYOUT.get(n, lambda v: v)(v)
                  for n, v in bp.items()}
        return torch.func.functional_call(self._block, leaves, (h,))
