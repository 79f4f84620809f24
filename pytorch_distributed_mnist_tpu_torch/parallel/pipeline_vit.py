"""Pipeline-parallel ViT: embed -> pipelined transformer blocks -> head.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/pipeline_vit.py``:
the GPipe tick loop of ``parallel/pipeline.py`` on the ViT. The
shape-ragged ends, the patch embedding ((B, 28, 28, 1) -> (B, T, C)) and
the pooling head ((B, T, C) -> (B, 10)), run replicated over the
``stage`` axis; the ``depth`` transformer blocks are what the pipeline
carries: stage ``s`` holds blocks ``[s*k, (s+1)*k)`` (``k = depth / S``)
as one stacked tree and applies them in order.

Param layout: a pipelined train state holds the ViT params regrouped as
the JAX one does,

    {embed: {embed, pos_embed}, blocks: <one block tree, leaves with a
     leading (depth,) dim>, head: {ln_f, head}}

so the pipeline's rule is one statement: every ``blocks`` leaf is
``P('stage')`` on dim 0, and Adam's moments follow through their paths.
Params are ``{port name: tensor or array}``: the standard names are the
model's (``block0.attn.qkv.kernel``, ``pos_embed``, ``ln_f.weight``), the
split names the tree's keys joined by dots (``blocks.attn.qkv.kernel``,
``embed.pos_embed``, ``head.ln_f.weight``). :func:`split_vit_params` and
:func:`merge_vit_params` are pure stacks and unstacks, bitwise inverse.

:class:`PipelinedViT` is the port's ``apply_fn``: a module holding the
split tree (``parallel/split_tree.py::SplitTree``), whose forward runs
the embed, the pipeline and the head, each the model's own module on the
split leaves (``split_tree.ViTParts``). Every stage rank applies the embed and the head,
but only stage 0's embedding enters the pipe and every rank's head sees
the same summed outputs, so the embed's gradients are partial sums over
``stage`` and the head's are copies: the train step sums the replicated
leaves' gradients over ``stage`` once per step, each copy counted once
(:meth:`PipelinedViT.grad_stage`, ``parallel/collectives.py``), and the
blocks' gradients stay on their stage.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.parallel.split_tree import (
    SplitTree,
    ViTParts,
)

__all__ = [
    "split_vit_params",
    "merge_vit_params",
    "PipelinedViT",
    "make_pipelined_vit_apply",
    "make_stage_forward_fns",
    "pipeline_stage_rules",
    "pipelined_state_sharding",
    "create_pipelined_vit_state",
    "split_stage_params",
    "place_state",
]

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


def split_vit_params(params: Dict) -> Dict:
    """Standard ViT params -> the pipelined ``{embed, blocks, head}``
    tree, every blocks leaf stacked to a leading ``(depth,)`` dim."""
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
        raise ValueError(f"params have no block* layers to pipeline (keys: "
                         f"{sorted(params)})")
    for leaf in per_block[0]:
        out["blocks." + leaf] = _stack([per_block[i][leaf]
                                        for i in range(depth)])
    return out


def merge_vit_params(split: Dict) -> Dict:
    """The pipelined tree -> standard ViT params (exact inverse of
    :func:`split_vit_params`)."""
    blocks = {n[len("blocks."):]: v for n, v in split.items()
              if n.startswith("blocks.")}
    depth = next(iter(blocks.values())).shape[0]
    inner = {v: k for k, v in _OUTER.items()}
    out = {inner[n]: v for n, v in split.items() if n in inner}
    for i in range(depth):
        for leaf, value in blocks.items():
            out[f"block{i}.{leaf}"] = value[i]
    return out


class PipelinedViT(SplitTree):
    """The ViT on the GPipe schedule over ``mesh``'s ``axis``: the
    embed, then :func:`parallel.pipeline.pipeline_apply` of the stacked
    blocks (each under ``torch.utils.checkpoint`` when ``remat``), then
    the head. The blocks leaves are whole ``(depth, ...)`` until the
    state is placed (this rank then takes its stage's rows of them) or
    this rank's ``(depth / S, ...)`` after."""

    def __init__(self, split: Dict, *, parts: ViTParts, depth: int,
                 remat: bool, mesh, axis: str = "stage",
                 data_axis: Optional[str] = None,
                 num_microbatches: Optional[int] = None) -> None:
        super().__init__(split)
        self.parts = parts
        self.depth = depth
        self.remat = remat
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        self.num_microbatches = num_microbatches
        self.n_stages = mesh.axis(axis).size

    def _stage(self):
        return self.mesh.axis(self.axis)

    def _ends(self) -> List[torch.Tensor]:
        return [p for n, p in self.named_parameters()
                if n.startswith(("embed.", "head."))]

    def grad_copies(self) -> List[torch.Tensor]:
        """The head's params on every stage rank but 0: each stage rank
        computes the same head on the same outputs, so its gradients
        there are copies of stage 0's."""
        st = self._stage()
        if st.reduces and st.rank != 0:
            return [p for n, p in self.named_parameters()
                    if n.startswith("head.")]
        return []

    def grad_stage(self):
        """``(stage axis, params)``: the replicated leaves (embed and
        head), whose gradients sum over the stage axis (the embed's are
        stage 0's alone, zeros elsewhere; the head's copies are zeroed
        first, :meth:`grad_copies`). None on a stage axis of one rank."""
        st = self._stage()
        return (st, self._ends()) if st.reduces else None

    def _stage_fn(self, stage_blocks: Dict[str, torch.Tensor],
                  h: torch.Tensor) -> torch.Tensor:
        from torch.utils.checkpoint import checkpoint

        k = next(iter(stage_blocks.values())).shape[0]

        def block(hh, i):
            return self.parts.block(
                {n: a[i] for n, a in stage_blocks.items()}, hh)

        for i in range(k):
            if self.remat and torch.is_grad_enabled():
                # Per-block activations recompute in the backward pass,
                # so a stage holds one block's instead of k.
                h = checkpoint(block, h, i, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = block(h, i)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from pytorch_distributed_mnist_tpu_torch.parallel.pipeline import (
            pipeline_apply,
        )

        params = self.split_params()
        h = self.parts.embed(params, x)
        k = self.depth // self.n_stages
        # Whole (depth, ...) leaves -> (S, k, ...), this rank's (k, ...)
        # -> (1, k, ...): pipeline_apply takes this stage's row of either.
        staged = {n[len("blocks."):]: p.reshape((-1, k) + tuple(p.shape[1:]))
                  for n, p in params.items() if n.startswith("blocks.")}
        h = pipeline_apply(self._stage_fn, staged, h, mesh=self.mesh,
                           axis=self.axis,
                           num_microbatches=self.num_microbatches,
                           data_axis=self.data_axis)
        return self.parts.head(params, h)


def _model_params(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach() for n, p in model.named_parameters()}


def make_pipelined_vit_apply(model, mesh, *, axis: str = "stage",
                             data_axis: Optional[str] = None,
                             num_microbatches: Optional[int] = None) \
        -> PipelinedViT:
    """The pipelined ViT of ``model`` (a ``models/attention.py`` ViT) on
    ``mesh``: a :class:`PipelinedViT` over the split tree of the model's
    params, whole until :func:`create_pipelined_vit_state` (or
    :func:`place_state`) places it. Refuses a depth the stages do not
    divide, in the JAX words."""
    n_stages = mesh.axis(axis).size
    if model.depth % n_stages:
        raise ValueError(
            f"vit depth {model.depth} not divisible by {n_stages} pipeline "
            f"stages")
    return PipelinedViT(
        split_vit_params(_model_params(model)), parts=ViTParts(model),
        depth=model.depth, remat=model.remat, mesh=mesh, axis=axis,
        data_axis=data_axis, num_microbatches=num_microbatches)


def pipeline_stage_rules(axis: str = "stage"):
    """Callable rule table (``parallel/tensor.py::leaf_spec`` takes
    callables): every leaf under ``blocks`` is ``P(axis)`` on dim 0, the
    stacked depth dim, which is the stage seam; everything else
    replicated. Item 12's serve registry reads it."""
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        P,
        _path_keys,
    )

    def rules(path: str):
        return P(axis) if "blocks" in _path_keys(path) else P()

    return rules


def split_stage_params(split: Dict, n_stages: int) -> List[Dict]:
    """Pipelined ``{embed, blocks, head}`` params -> per-stage trees.

    Stage ``s`` gets blocks ``[s*k, (s+1)*k)`` (``k = depth / S``, the
    boundaries the training pipeline's stage placement cuts); stage 0
    also carries ``embed`` and the last stage ``head``. Pure dim-0
    slicing, on tensors and arrays alike."""
    blocks = {n: v for n, v in split.items() if n.startswith("blocks.")}
    depth = next(iter(blocks.values())).shape[0]
    if n_stages < 1 or depth % n_stages:
        raise ValueError(
            f"vit depth {depth} not divisible by {n_stages} pipeline "
            f"stages")
    k = depth // n_stages
    stages = []
    for s in range(n_stages):
        tree = {n: v[s * k:(s + 1) * k] for n, v in blocks.items()}
        if s == 0:
            tree.update({n: v for n, v in split.items()
                         if n.startswith("embed.")})
        if s == n_stages - 1:
            tree.update({n: v for n, v in split.items()
                         if n.startswith("head.")})
        stages.append(tree)
    return stages


def make_stage_forward_fns(model, n_stages: int) -> List[Callable]:
    """Per-stage inference forwards: ``[forward_s(stage_params, x) -> y]``
    over :func:`split_stage_params`'s trees (tensors in the JAX layout).
    Stage 0 maps images to embedded tokens and applies its blocks, middle
    stages are block stacks ((B, T, C) in and out), the last closes with
    LayerNorm, the mean pool, the head and float32 logits: the modules
    and order of :class:`PipelinedViT`, so chaining the S forwards is the
    trained pipeline's math, with no remat."""
    if model.depth % n_stages:
        raise ValueError(
            f"vit depth {model.depth} not divisible by {n_stages} "
            f"pipeline stages")
    parts = ViTParts(model)

    def make_forward(s: int):
        def forward(stage_params, x):
            h = x
            if s == 0:
                h = parts.embed(stage_params, h)
            blocks = {n[len("blocks."):]: a for n, a in stage_params.items()
                      if n.startswith("blocks.")}
            for i in range(next(iter(blocks.values())).shape[0]):
                h = parts.block({n: a[i] for n, a in blocks.items()}, h)
            if s == n_stages - 1:
                h = parts.head(stage_params, h)
            return h

        return forward

    return [make_forward(s) for s in range(n_stages)]


def pipelined_state_sharding(state, mesh, axis: str = "stage"):
    """``{leaf name: P}`` of a pipelined train state: ``blocks`` leaves
    ``P(axis)`` on dim 0, the rest replicated. Adam's ``mu``/``nu``
    mirror the param tree, so the same path test covers them."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_leaves,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        P,
        _path_keys,
    )

    del mesh  # the specs name axes; placements bind them to the mesh
    return {name: P(axis) if "blocks" in _path_keys(name) and t.dim() >= 1
            else P() for name, t in state_leaves(state)}


def place_state(state, mesh, sharding) -> None:
    """Place a whole train state per a ``{leaf name: P}`` tree: every
    split leaf keeps only this rank's slice (``state.placements``)."""
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        P,
        shard_state,
    )

    shard_state(state, mesh, lambda path: sharding.get(path, P()))


def _init_state(model, seed: int, apply, device, lr: float, optimizer: str,
                momentum: float, weight_decay: float):
    """``model`` initialised as ``train/state.py::create_train_state``
    does (a pipelined run starts where the unpipelined one does), then
    the train state of ``apply(model)``, its optimizer over the split
    tree in the JAX flatten order."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        jax_param_order,
    )
    from pytorch_distributed_mnist_tpu_torch.models.registry import (
        lecun_normal_init,
    )
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )

    lecun_normal_init(model, seed, jax_param_order(
        name for name, _ in model.named_parameters()))
    return create_train_state(apply(model), seed, device, lr=lr,
                              optimizer=optimizer, momentum=momentum,
                              weight_decay=weight_decay, init=False)


def create_pipelined_vit_state(model, seed: int, mesh, device, *,
                               axis: str = "stage",
                               data_axis: Optional[str] = None,
                               num_microbatches: Optional[int] = None,
                               lr: float = 1e-3, optimizer: str = "adam",
                               momentum: float = 0.9,
                               weight_decay: float = 1e-4,
                               place: bool = True):
    """``(state, sharding)``: a train state whose params are the pipelined
    tree and whose model runs the GPipe schedule, a drop-in for
    ``create_train_state`` that the usual train and eval steps run as
    they are. ``place=False`` returns the state whole (the sharding still
    computed): a caller that composes another layout on top (ZeRO's
    moments) or resumes first places it once, onto the composed
    layout."""
    state = _init_state(
        model, seed, lambda m: make_pipelined_vit_apply(
            m, mesh, axis=axis, data_axis=data_axis,
            num_microbatches=num_microbatches),
        device, lr, optimizer, momentum, weight_decay)
    sharding = pipelined_state_sharding(state, mesh, axis)
    if place:
        place_state(state, mesh, sharding)
    return state, sharding
