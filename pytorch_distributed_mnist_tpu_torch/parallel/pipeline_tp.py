"""Pipeline x tensor parallelism: Megatron blocks inside the GPipe body,
on the head-major, depth-stacked ViT layout.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/pipeline_tp.py``.
The stage body of the pipeline (``parallel/pipeline_vit.py``) runs the
model's own Megatron ``TransformerBlock`` (``models/attention.py`` on a
``model`` axis, driven on the split leaves by
``parallel/split_tree.py::ViTParts``) over a ``('data', 'stage',
'model')`` mesh; the tick loop and its hops are the pipeline's, unchanged.

Layout: the Megatron rule on the flat ``(C, 3C)`` qkv kernel is not
head-aligned (the 3C dim unpacks as (3, H, D)), so here the attention
kernels are head-major, qkv ``(C, 3, H, D)`` and proj ``(H, D, C)``, and
split on H: each model rank owns ``H/tp`` whole heads, attention runs on
them locally, and only the proj and mlp2 partial sums cross the axis (one
all-reduce each). :func:`split_vit_params_tp` and
:func:`merge_vit_params_tp` are pure reshapes of the standard params
(through ``pipeline_vit.split_vit_params``); the overlapped TP schedule
(``--tp-overlap``, ``parallel/tensor.py``) trains on the same tree.

Params are ``{port name: tensor or array}``, the split names the tree's
keys joined by dots (``blocks.attn.qkv.kernel``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
    PipelinedViT,
    _init_state,
    _model_params,
    merge_vit_params,
    place_state,
    split_vit_params,
)
from pytorch_distributed_mnist_tpu_torch.parallel.split_tree import ViTParts

__all__ = [
    "split_vit_params_tp",
    "merge_vit_params_tp",
    "block_param_specs",
    "PipelinedTPViT",
    "make_pipelined_tp_vit_apply",
    "pipelined_tp_state_sharding",
    "create_pipelined_tp_vit_state",
]


def split_vit_params_tp(params: Dict, num_heads: int) -> Dict:
    """Standard ViT params -> the head-major split tree. Same
    ``{embed, blocks, head}`` grouping as the pipeline layout (a leading
    ``(depth,)`` dim on every blocks leaf), with qkv kernel ``(depth, C,
    3C)`` -> ``(depth, C, 3, H, D)``, its bias likewise, and proj kernel
    ``(depth, C, C)`` -> ``(depth, H, D, C)``. Pure reshapes: bitwise
    inverse via :func:`merge_vit_params_tp`."""
    out = split_vit_params(params)
    qkv_k = out["blocks.attn.qkv.kernel"]
    depth, c, three_c = qkv_k.shape
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
    out = dict(split_tp)
    qkv_k = out["blocks.attn.qkv.kernel"]
    depth, c, three, h, d = qkv_k.shape
    out["blocks.attn.qkv.kernel"] = qkv_k.reshape(depth, c, three * h * d)
    out["blocks.attn.qkv.bias"] = out["blocks.attn.qkv.bias"].reshape(
        depth, three * h * d)
    out["blocks.attn.proj.kernel"] = out["blocks.attn.proj.kernel"].reshape(
        depth, h * d, c)
    return merge_vit_params(out)


def _block_rules(stage_axis: str, tp_axis: str):
    """Spec per blocks leaf (JAX layout), keyed by its last two path keys:
    the stage dim first; ``model`` on the head dim (attention) or the MLP
    hidden dim, the Megatron column -> row split."""
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import P

    return {
        ("qkv", "kernel"): P(stage_axis, None, None, tp_axis, None),
        ("qkv", "bias"): P(stage_axis, None, tp_axis, None),
        ("proj", "kernel"): P(stage_axis, tp_axis, None, None),
        ("mlp1", "kernel"): P(stage_axis, None, tp_axis),
        ("mlp1", "bias"): P(stage_axis, tp_axis),
        ("mlp2", "kernel"): P(stage_axis, tp_axis, None),
    }


def block_param_specs(blocks: Dict, stage_axis: str, tp_axis: str) -> Dict:
    """``{name: P}`` for the (stacked) blocks leaves ``blocks`` (named by
    their dotted paths): every leaf gets the stage dim; the Megatron-split
    leaves add the model axis."""
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import P

    rules = _block_rules(stage_axis, tp_axis)
    return {name: rules.get(tuple(name.split(".")[-2:]), P(stage_axis))
            for name in blocks}


class PipelinedTPViT(PipelinedViT):
    """:class:`parallel.pipeline_vit.PipelinedViT` on the head-major
    split tree, its stage body the model's Megatron block over
    ``tp_axis`` (``ViTParts(model, model_axis)``); the blocks' leaves are
    whole until placed, then this rank's stage rows and model slices."""

    def __init__(self, split: Dict, *, tp_axis: str = "model",
                 num_heads: int, **kwargs) -> None:
        super().__init__(split, **kwargs)
        self.tp_axis = tp_axis
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.mesh.axis(self.tp_axis)
        heads = self.blocks.attn.qkv.kernel.shape[3]
        if axis.size > 1 and heads == self.num_heads:
            raise RuntimeError(
                "the PP x TP ViT's blocks are whole: place the state "
                "(create_pipelined_tp_vit_state) before its forward")
        return super().forward(x)


def make_pipelined_tp_vit_apply(model, mesh, *, stage_axis: str = "stage",
                                tp_axis: str = "model",
                                data_axis: Optional[str] = "data",
                                num_microbatches: Optional[int] = None) \
        -> PipelinedTPViT:
    """The PP x TP ViT of ``model`` on ``mesh``: a
    :class:`PipelinedTPViT` over the head-major split tree of the model's
    params, whole until :func:`create_pipelined_tp_vit_state` places it.
    Refuses the shapes the JAX apply refuses, in its words."""
    n_stages = mesh.axis(stage_axis).size
    tp = mesh.axis(tp_axis).size
    if model.depth % n_stages:
        raise ValueError(
            f"vit depth {model.depth} not divisible by {n_stages} pipeline "
            f"stages")
    if model.num_heads % tp:
        raise ValueError(
            f"vit heads {model.num_heads} not divisible by "
            f"--tensor-parallel {tp}")
    hidden = model.embed_dim * model.mlp_ratio
    if hidden % tp:
        raise ValueError(
            f"vit MLP hidden dim {hidden} not divisible by "
            f"--tensor-parallel {tp}")
    return PipelinedTPViT(
        split_vit_params_tp(_model_params(model), model.num_heads),
        tp_axis=tp_axis, num_heads=model.num_heads,
        parts=ViTParts(model, mesh.axis(tp_axis)), depth=model.depth,
        remat=model.remat, mesh=mesh, axis=stage_axis, data_axis=data_axis,
        num_microbatches=num_microbatches)


def pipelined_tp_state_sharding(state, mesh, stage_axis: str = "stage",
                                tp_axis: str = "model") -> Dict:
    """``{leaf name: P}`` of a PP x TP train state: blocks leaves get the
    stage dim 0 plus their Megatron model-axis dims, everything else
    replicates. Adam's moments mirror the param tree, so one rule pass
    covers them."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_leaves,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        P,
        _path_keys,
    )

    del mesh  # the specs name axes; placements bind them to the mesh
    rules = _block_rules(stage_axis, tp_axis)
    out = {}
    for name, t in state_leaves(state):
        keys = _path_keys(name)
        if "blocks" in keys and t.dim() >= 1:
            out[name] = rules.get(tuple(keys[-2:]), P(stage_axis))
        else:
            out[name] = P()
    return out


def create_pipelined_tp_vit_state(model, seed: int, mesh, device, *,
                                  stage_axis: str = "stage",
                                  tp_axis: str = "model",
                                  data_axis: Optional[str] = "data",
                                  num_microbatches: Optional[int] = None,
                                  lr: float = 1e-3, optimizer: str = "adam",
                                  momentum: float = 0.9,
                                  weight_decay: float = 1e-4,
                                  place: bool = True):
    """``(state, sharding)`` for the PP x TP ViT, the same pair as
    ``pipeline_vit.create_pipelined_vit_state``; ``place=False`` returns
    it whole, for a caller that composes ZeRO on top or resumes first."""
    state = _init_state(
        model, seed, lambda m: make_pipelined_tp_vit_apply(
            m, mesh, stage_axis=stage_axis, tp_axis=tp_axis,
            data_axis=data_axis, num_microbatches=num_microbatches),
        device, lr, optimizer, momentum, weight_decay)
    sharding = pipelined_tp_state_sharding(state, mesh, stage_axis, tp_axis)
    if place:
        place_state(state, mesh, sharding)
    return state, sharding
