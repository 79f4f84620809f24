"""Tensor parallelism: rule tables, per-leaf placement of a train state
over a process mesh, and the overlapped (collective-matmul) TP schedule.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/tensor.py``.
There a small table of path-suffix rules becomes a ``NamedSharding``
pytree and GSPMD places every leaf; here the same table resolves, per
leaf of the port's train state (named as the JAX leaves are,
``models/convert.py::state_leaves``), to a :class:`P` (which dim splits
over which mesh axis, in the JAX layout) and then to a :class:`Placement`:
the dim in the port's layout, this rank's slice of it, and the process
group that gathers it back. The checkpoint layer and the optimizer read
the placements in place of ``NamedSharding``.

Rule matching is by the LAST TWO keys of a leaf's path (e.g. ``('qkv',
'kernel')``). Optimizer moments are full param-tree replicas, so their
paths end with the same two keys: one table places params and both
moments alike. Leaves no rule matches stay replicated (``P()``).

**Megatron TP** (``vit_tp_rules``): ``qkv`` and ``mlp1`` split their
output dim over ``model`` (column parallel), ``proj`` and ``mlp2`` their
input dim (row parallel); the ViT's blocks write the collectives out
(``models/attention.py``). The JAX rule ``P(None, 'model')`` on ``qkv``
splits its ``3C`` output dim into contiguous pieces, but the model reads
that dim as ``(3, H, D)``, so a contiguous piece is not whole heads (at
tp = 2 rank 0 would hold all of q and half of k). The port computes in
the head-aligned layout: the rule carries ``blocks=3`` (the dim is three
equal blocks, q, k and v, each split alike), so rank r holds its heads'
columns of each. The contiguous JAX slices appear only where placements
meet the outside: the whole leaf a gather makes (npz, the delta
manifest) is the JAX leaf, and a sharded ``.ckpt/`` directory's files
hold the JAX slices (``train/checkpoint.py`` gathers such a leaf over
``model`` and writes the contiguous piece), so either package resumes
the other's directory. The JAX ``make_tp_train_step`` and
``make_tp_eval_step`` forward the TP layout to the usual steps; here the
usual steps (``train/steps.py``) run on the placed state as they are.

**Collective-matmul overlap** (``--tp-overlap``): :func:`allgather_matmul`
writes the gather of a sequence shard in front of a column-parallel
matmul as ``tp - 1`` ring hops, each followed by the matmul of the row
block in hand; row blocks of a matmul are independent, so the result
equals gather-then-matmul. On NCCL hop ``k + 1`` is issued before block
``k``'s matmul so the two can overlap (on gloo only the order matters).
:func:`make_overlap_tp_vit_apply` embeds it in a sequence-sharded
Megatron ViT (the residual stream holds ``T/tp`` tokens between blocks;
each row-parallel product reduce-scatters back to the token shard) on
the head-major, depth-stacked layout of ``parallel/pipeline_tp.py``; its
checkpoint is that split tree, as the JAX one's is.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_mnist_tpu_torch.parallel.split_tree import (
    SplitTree,
    ViTParts,
)

Rules = Union[Dict[Tuple[str, str], "P"], Callable[[str], "P"]]


class P(tuple):
    """A partition spec: per dim of a leaf in the JAX layout, the mesh
    axis it splits over, or None (``jax.sharding.PartitionSpec``'s
    shape: ``P('expert', None, None)``; ``P()`` is replicated).
    ``blocks > 1`` says the split dim is that many equal blocks, each
    split alike (the port's head-aligned ``qkv``); it does not take part
    in equality, so the spec compares equal to the JAX one."""

    def __new__(cls, *entries, blocks: int = 1):
        spec = super().__new__(cls, entries)
        spec.blocks = blocks
        return spec

    def __repr__(self) -> str:
        extra = f", blocks={self.blocks}" if self.blocks != 1 else ""
        return f"P{tuple(self)!r}"[:-1] + extra + ")"


_KEY = re.compile(r"\['([^']*)'\]|\.([A-Za-z_]\w*)|\[\d+\]")


def _path_keys(path: str) -> Tuple[str, ...]:
    """The named keys of a JAX leaf name, outermost first: dict keys and
    attribute names; sequence indices are skipped, as the JAX
    ``_path_keys`` skips ``SequenceKey``s.
    ``['opt_state'].inner_state[0].mu['params']['moe']['w1']`` ->
    ``('opt_state', 'inner_state', 'mu', 'params', 'moe', 'w1')``."""
    return tuple(a or b for a, b in _KEY.findall(path) if a or b)


def leaf_spec(path: str, rules: Optional[Rules]) -> P:
    """The spec of one leaf: its last two path keys looked up in
    ``rules`` (default ``P()``), or ``rules(path)`` when ``rules`` is a
    callable."""
    if not rules:
        return P()
    if callable(rules):
        return rules(path)
    keys = _path_keys(path)
    return rules.get(tuple(keys[-2:]), P())


def state_shardings(state, mesh, rules: Optional[Rules]) -> Dict[str, P]:
    """``{leaf name: P}`` for every leaf of ``state`` (params and
    optimizer moments alike): the ``NamedSharding`` tree's counterpart.
    Step counters, hyperparams and unmatched leaves get ``P()``."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_leaves,
    )

    del mesh  # the specs name axes; placements bind them to the mesh
    return {name: leaf_spec(name, rules) for name, _ in state_leaves(state)}


def port_dim(jax_dim: int, ndim: int) -> int:
    """The port-layout dim of a JAX-layout dim: 4-D leaves are conv
    kernels, HWIO in JAX and OIHW here; the rest keep their layout."""
    if ndim != 4:
        return jax_dim
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        _HWIO_TO_OIHW,
    )

    return _HWIO_TO_OIHW.index(jax_dim)


@dataclass(frozen=True)
class Placement:
    """Where one leaf lives: split over mesh axis ``axis`` (``size``
    ranks, this rank at ``index``, collectives over ``group``, None for a
    one-rank axis) along ``dim`` of the port's layout (``spec`` says the
    same in the JAX layout). ``shape`` is the whole leaf's port-layout
    shape. ``writes`` marks the rank that writes this slice into a
    sharded checkpoint directory (coordinate 0 on every other axis).
    ``blocks > 1``: the dim is that many equal blocks and this rank holds
    its ``1/size`` of each, side by side (the head-aligned ``qkv``); the
    slice a sharded directory holds is then the contiguous one
    (:meth:`contiguous`)."""

    spec: P
    axis: str
    dim: int
    size: int
    index: int
    group: Optional[dist.ProcessGroup]
    shape: Tuple[int, ...]
    writes: bool = True
    blocks: int = 1

    @property
    def chunk(self) -> int:
        return self.shape[self.dim] // self.size

    def _split(self, full):
        """The whole leaf's dim viewed ``(blocks, size, piece)``."""
        per = self.shape[self.dim] // (self.blocks * self.size)
        dims = (self.blocks, self.size, per)
        if isinstance(full, torch.Tensor):
            return full.unflatten(self.dim, dims)
        shape = list(np.shape(full))
        shape[self.dim:self.dim + 1] = dims
        return np.asarray(full).reshape(shape)

    def local(self, full):
        """This rank's slice of a whole leaf (a tensor or an array in the
        port's layout), contiguous."""
        if self.blocks == 1:
            return self.contiguous(full)
        mine = self._split(full)
        if isinstance(full, torch.Tensor):
            return mine.select(self.dim + 1, self.index).flatten(
                self.dim, self.dim + 1).contiguous()
        mine = np.take(mine, self.index, axis=self.dim + 1)
        shape = list(mine.shape)
        shape[self.dim:self.dim + 2] = [shape[self.dim] * shape[self.dim + 1]]
        return np.ascontiguousarray(mine.reshape(shape))

    def contiguous(self, full):
        """Coordinate ``index``'s contiguous ``1/size`` of the dim: the
        JAX layout's slice (the same as :meth:`local` unless
        ``blocks > 1``)."""
        start = self.index * self.chunk
        if isinstance(full, torch.Tensor):
            return full.narrow(self.dim, start, self.chunk).contiguous()
        region = [slice(None)] * np.ndim(full)
        region[self.dim] = slice(start, start + self.chunk)
        return np.ascontiguousarray(np.asarray(full)[tuple(region)])

    @torch.no_grad()
    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slice (a collective over
        ``group``: every rank of the axis calls it)."""
        if self.group is None:
            return shard
        flat = shard.detach().contiguous().view(-1)
        out = torch.empty(self.size * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=self.group)
        parts = list(out.view(self.size, *shard.shape))
        if self.blocks == 1:
            return torch.cat(parts, dim=self.dim)
        parts = [p.unflatten(self.dim, (self.blocks, -1)) for p in parts]
        return torch.stack(parts, dim=self.dim + 1).flatten(
            self.dim, self.dim + 2)

    def region(self) -> Tuple[Tuple[int, ...], List[int], List[int]]:
        """``(whole shape, start, stop)`` in the JAX layout of the
        contiguous slice at this rank's coordinate: what its file in a
        sharded directory holds."""
        whole = jax_shape(self.shape)
        start, stop = [0] * len(whole), list(whole)
        jax_dim = [d for d, a in enumerate(self.spec) if a is not None][0]
        start[jax_dim] = self.index * self.chunk
        stop[jax_dim] = (self.index + 1) * self.chunk
        return whole, start, stop


@dataclass(frozen=True)
class Placements:
    """A leaf split over several mesh axes, one dim each (the pipeline's
    stage dim with the Megatron model dim, or with ZeRO's data dim):
    ``parts`` are single-axis :class:`Placement` records applied in
    order, each on the slice the one before leaves. It reads like one
    :class:`Placement`: ``spec`` and ``shape`` are the whole leaf's,
    :meth:`local` and :meth:`gather` compose the parts', and ``writes``
    marks coordinate 0 on every mesh axis the leaf does not split."""

    parts: Tuple[Placement, ...]
    writes: bool = True
    blocks: int = 1

    @property
    def spec(self) -> P:
        entries = [None] * len(self.parts[0].spec)
        for part in self.parts:
            for d, a in enumerate(part.spec):
                if a is not None:
                    entries[d] = a
        return P(*entries)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.parts[0].shape

    @property
    def index(self) -> str:
        return "_".join(str(p.index) for p in self.parts)

    def local(self, full):
        for part in self.parts:
            full = part.local(full)
        return full

    def contiguous(self, full):
        for part in self.parts:
            full = part.contiguous(full)
        return full

    @torch.no_grad()
    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        for part in reversed(self.parts):
            shard = part.gather(shard)
        return shard

    def region(self) -> Tuple[Tuple[int, ...], List[int], List[int]]:
        whole = jax_shape(self.shape)
        start, stop = [0] * len(whole), list(whole)
        for part in self.parts:
            _, lo, hi = part.region()
            for d, a in enumerate(part.spec):
                if a is not None:
                    start[d], stop[d] = lo[d], hi[d]
        return whole, start, stop


def jax_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A port-layout shape in the JAX layout (OIHW -> HWIO)."""
    if len(shape) != 4:
        return tuple(shape)
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        _OIHW_TO_HWIO,
    )

    return tuple(shape[i] for i in _OIHW_TO_HWIO)


def placement_of(spec: P, shape: Tuple[int, ...], mesh) -> \
        Optional[Union[Placement, Placements]]:
    """The :class:`Placement` a spec gives a leaf of port-layout ``shape``
    on ``mesh``, or None when it is replicated; a spec that splits
    several dims, each over its own axis, gives :class:`Placements`."""
    axes = [(d, a) for d, a in enumerate(spec) if a is not None]
    if not axes:
        return None
    names = {a for _, a in axes}
    if len(names) < len(axes):
        raise ValueError(f"spec {spec!r} names a mesh axis twice")
    blocks = getattr(spec, "blocks", 1)
    if blocks != 1 and len(axes) > 1:
        raise NotImplementedError(
            f"spec {spec!r}: a block-aligned split composes with no other "
            f"axis")
    writes = all(mesh.axis(a).rank == 0 for a in mesh.shape
                 if a not in names)
    parts = []
    shape = tuple(shape)
    for jax_dim, name in axes:
        axis = mesh.axis(name)
        dim = port_dim(jax_dim, len(shape))
        if shape[dim] % axis.size:
            raise ValueError(f"dim {dim} of shape {shape} is not divisible "
                             f"by mesh axis {name!r} of size {axis.size}")
        if shape[dim] % (axis.size * blocks):
            raise ValueError(f"dim {dim} of shape {shape} is not {blocks} "
                             f"block(s) divisible by mesh axis {name!r} of "
                             f"size {axis.size}")
        entries = [a if d == jax_dim else None for d, a in enumerate(spec)]
        parts.append(Placement(
            spec=P(*entries, blocks=blocks), axis=name, dim=dim,
            size=axis.size, index=axis.rank, group=axis.group, shape=shape,
            writes=writes, blocks=blocks))
        shape = shape[:dim] + (shape[dim] // axis.size,) + shape[dim + 1:]
    return parts[0] if len(parts) == 1 else Placements(tuple(parts), writes)


@torch.no_grad()
def place_leaf(t: torch.Tensor, placement: Placement) -> None:
    """Replace ``t``'s data (in place of the tensor object, so the
    optimizer's and the model's references hold) by this rank's slice."""
    t.data = placement.local(t.data)


def shard_state(state, mesh, rules: Rules):
    """Place a whole train state onto ``mesh`` per the rule table: every
    ruled leaf keeps only this rank's slice. Returns ``(state,
    placements)``; the placements are also kept on the state
    (``state.placements``), where the checkpoint layer finds them.
    Params and moments must be whole (before the first step: the flat
    gradient buffer and the fused optimizer's table are made later)."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_leaves,
    )

    specs = state_shardings(state, mesh, rules)
    placements: Dict[str, Placement] = {}
    for name, t in state_leaves(state):
        pl = placement_of(specs[name], tuple(t.shape), mesh)
        if pl is not None:
            place_leaf(t, pl)
            placements[name] = pl
    state.placements = {**(state.placements or {}), **placements}
    return state, placements


# -- Megatron TP --------------------------------------------------------------

def vit_tp_rules(axis: str = "model") -> Dict[Tuple[str, str], P]:
    """Megatron column -> row rules for the ViT's blocks
    (``models/attention.py``): ``qkv``/``mlp1`` split their OUTPUT dim
    (column parallel: activations come out head/feature-split),
    ``proj``/``mlp2`` their INPUT dim (row parallel: the partial sums are
    all-reduced). ``qkv``'s split is head-aligned (``blocks=3``)."""
    return {
        ("qkv", "kernel"): P(None, axis, blocks=3),
        ("qkv", "bias"): P(axis, blocks=3),
        ("proj", "kernel"): P(axis, None),
        ("mlp1", "kernel"): P(None, axis),
        ("mlp1", "bias"): P(axis),
        ("mlp2", "kernel"): P(axis, None),
    }


# -- Collective-matmul overlap (--tp-overlap) --------------------------------

class _AllgatherMatmul(torch.autograd.Function):
    """``gather(x) @ w`` as ring hops, each followed by one row block's
    matmul; the backward is the gather-then-matmul one (the weight's
    gradient from the gathered ``x`` in one product, the input's a
    reduce-scatter of ``g @ w^T``)."""

    @staticmethod
    def forward(ctx, x, w, axis):
        from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
            ring_exchange,
        )

        n, me = axis.size, axis.rank
        b, tl, c = x.shape
        w2 = w.reshape(c, -1)
        chunks, pieces = [None] * n, [None] * n
        chunk = x.contiguous()
        for step in range(n):
            src = (me + step) % n
            reqs = None
            if step + 1 < n:
                # This rank sends to its predecessor and receives from its
                # successor: after s hops it holds the shard of (me + s).
                # The hop is issued before this block's matmul.
                (nxt,), reqs = ring_exchange([chunk], axis, -1, wait=False)
            chunks[src] = chunk
            pieces[src] = chunk.reshape(-1, c).mm(w2).reshape(b, tl, -1)
            if reqs is not None:
                for r in reqs:
                    r.wait()
                chunk = nxt
        x_full = torch.cat(chunks, dim=1)
        ctx.save_for_backward(x_full, w)
        ctx.axis = axis
        return torch.cat(pieces, dim=1).reshape(
            (b, n * tl) + tuple(w.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
            _reduce_scatter,
        )

        x_full, w = ctx.saved_tensors
        axis = ctx.axis
        b, t, c = x_full.shape
        w2 = w.reshape(c, -1)
        g2 = g.reshape(b * t, -1)
        dw = x_full.reshape(b * t, c).t().mm(g2).reshape(w.shape)
        dx = g2.mm(w2.t()).reshape(b, t, c)
        return _reduce_scatter(dx, axis.group, axis.size, 1), dw, None


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis) -> torch.Tensor:
    """Overlapped ``gather(x) @ w``: ``x`` is this rank's sequence shard
    ``(B, T/tp, C)`` over ``axis``, ``w`` a local weight whose first dim
    contracts with ``x``'s last. Returns ``(B, T, *w.shape[1:])``: the
    same value as ``tensordot(gather(x, dim=1), w, 1)``, the gather
    decomposed into ``tp - 1`` ring hops and the matmul into one row
    block per shard, each hop issued before the block in hand is
    multiplied."""
    if axis is None or axis.group is None:
        return torch.tensordot(x, w, dims=([x.dim() - 1], [0]))
    return _AllgatherMatmul.apply(x, w, axis)


def overlap_tp_rules(axis: str = "model") -> Dict[Tuple[str, str], P]:
    """Suffix rules for the head-major DEPTH-STACKED layout
    (``parallel/pipeline_tp.py::split_vit_params_tp``): every blocks leaf
    carries a leading ``(depth,)`` dim, attention is head-major (qkv
    ``(depth, C, 3, H, D)``, proj ``(depth, H, D, C)``), and ``axis``
    lands on the head dim or the MLP hidden dim: contiguous splits that
    are whole heads."""
    return {
        ("qkv", "kernel"): P(None, None, None, axis, None),
        ("qkv", "bias"): P(None, None, axis, None),
        ("proj", "kernel"): P(None, axis, None, None),
        ("mlp1", "kernel"): P(None, None, axis),
        ("mlp1", "bias"): P(None, axis),
        ("mlp2", "kernel"): P(None, axis, None),
    }


def overlap_block_apply(bp: Dict[str, torch.Tensor], h: torch.Tensor, *,
                        tp_axis, compute_dtype,
                        attention_fn: Optional[Callable] = None):
    """One transformer block on a SEQUENCE-SHARDED residual stream.

    ``h`` is this rank's ``(B, T/tp, C)`` token shard; ``bp`` this
    block's params by their split-tree names under ``blocks.`` (this
    rank's heads of qkv/proj, its slice of the MLP hidden dim). LayerNorm
    runs on the token shard, each column-parallel matmul gathers the
    sequence through :func:`allgather_matmul`, attention runs on the full
    sequence with the local heads, and each row-parallel product
    reduce-scatters straight back to the token shard. The leaves every
    rank holds whole but applies to its own tokens only (the LayerNorms,
    the proj and mlp2 biases) enter through ``copy_to_region``, so their
    gradients come out whole on every rank."""
    import torch.nn.functional as F

    from pytorch_distributed_mnist_tpu_torch.models.attention import (
        layer_norm,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.attention import (
        full_attention,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
        copy_to_region,
        scatter_reduce,
    )

    cd = compute_dtype

    def whole(name):
        return copy_to_region(bp[name], tp_axis)

    x = h
    y = layer_norm(x, whole("ln1.weight"), whole("ln1.bias"), cd)
    wqkv = bp["attn.qkv.kernel"].to(cd)             # (C, 3, Hl, D)
    qkv = allgather_matmul(y.to(cd), wqkv, tp_axis) \
        + bp["attn.qkv.bias"].to(cd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o = (attention_fn or full_attention)(q, k, v)   # (B, T, Hl, D)
    part = torch.einsum("bthd,hdc->btc", o.to(cd),
                        bp["attn.proj.kernel"].to(cd))
    part = scatter_reduce(part.float(), tp_axis, dim=1).to(cd)
    x = x + part + whole("attn.proj.bias").to(cd)

    y = layer_norm(x, whole("ln2.weight"), whole("ln2.bias"), cd)
    u = allgather_matmul(y.to(cd), bp["mlp1.kernel"].to(cd), tp_axis) \
        + bp["mlp1.bias"].to(cd)
    u = F.gelu(u, approximate="tanh")               # (B, T, 4C/tp)
    v2 = torch.matmul(u, bp["mlp2.kernel"].to(cd))  # partial (B, T, C)
    v2 = scatter_reduce(v2.float(), tp_axis, dim=1).to(cd)
    return x + v2 + whole("mlp2.bias").to(cd)


class OverlapTPViT(SplitTree):
    """The ViT on the overlapped-TP schedule, its params the head-major
    split tree (``parallel/pipeline_tp.py``) held as
    ``parallel/split_tree.py::SplitTree`` holds a split tree. The embed
    runs replicated over ``model``, the blocks on this rank's ``T/tp``
    tokens (entered by ``split``, whose gradient is all-gathered back),
    and the final LayerNorm and head on the gathered sequence
    (``gather``: every rank computes them alike); the embed and the head
    are the model's own (``parts``, a ``split_tree.ViTParts``)."""

    def __init__(self, split: Dict[str, torch.Tensor], *, parts: ViTParts,
                 depth: int, compute_dtype: torch.dtype,
                 attention_fn: Optional[Callable], remat: bool,
                 tp_axis) -> None:
        super().__init__(split)
        self.parts = parts
        self.depth = depth
        self.compute_dtype = compute_dtype
        self.attention_fn = attention_fn
        self.remat = remat
        self.tp_axis = tp_axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from torch.utils.checkpoint import checkpoint

        from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
            gather,
            split,
        )

        cd = self.compute_dtype
        params = self.split_params()
        h = split(self.parts.embed(params, x), self.tp_axis, dim=1)
        blocks = {n[len("blocks."):]: p for n, p in params.items()
                  if n.startswith("blocks.")}

        def block(hh, i):
            return overlap_block_apply(
                {n: p[i] for n, p in blocks.items()}, hh,
                tp_axis=self.tp_axis, compute_dtype=cd,
                attention_fn=self.attention_fn)

        for i in range(self.depth):
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(block, h, i, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = block(h, i)
        return self.parts.head(params, gather(h, self.tp_axis, dim=1))


def make_overlap_tp_vit_apply(model, mesh, *, tp_axis: str = "model",
                              data_axis: Optional[str] = "data") \
        -> OverlapTPViT:
    """The overlapped-TP ViT of ``model`` (a ``models/attention.py``
    ViT) on ``mesh``: an :class:`OverlapTPViT` over the split tree of the
    model's params, whole until :func:`create_overlap_tp_vit_state` (or
    ``shard_state`` with :func:`overlap_tp_rules`) places it. Refuses the
    shapes the JAX apply refuses."""
    from pytorch_distributed_mnist_tpu_torch.models.attention import (
        IMAGE_SIDE,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_tp import (
        split_vit_params_tp,
    )

    axis = mesh.axis(tp_axis)
    if data_axis is not None:
        mesh.axis(data_axis)
    tp = axis.size
    tokens = (IMAGE_SIDE // model.patch_size) ** 2
    if model.num_heads % tp:
        raise ValueError(
            f"vit heads {model.num_heads} not divisible by "
            f"--tensor-parallel {tp}")
    hidden = model.embed_dim * model.mlp_ratio
    if hidden % tp:
        raise ValueError(
            f"vit MLP hidden dim {hidden} not divisible by "
            f"--tensor-parallel {tp}")
    if tokens % tp:
        raise ValueError(
            f"vit token count {tokens} not divisible by --tensor-parallel "
            f"{tp}; the overlapped schedule shards the sequence")
    params = {n: p.detach() for n, p in model.named_parameters()}
    return OverlapTPViT(
        split_vit_params_tp(params, model.num_heads), parts=ViTParts(model),
        depth=model.depth, compute_dtype=model.compute_dtype,
        attention_fn=model.attention_fn, remat=model.remat, tp_axis=axis)


def create_overlap_tp_vit_state(model, seed: int, mesh, device, *,
                                tp_axis: str = "model",
                                data_axis: Optional[str] = "data",
                                lr: float = 1e-3, optimizer: str = "adam",
                                momentum: float = 0.9,
                                weight_decay: float = 1e-4,
                                place: bool = True):
    """``(state, placements)`` of the overlapped-TP ViT: ``model``
    initialised as ``train/state.py::create_train_state`` does (so the
    overlapped run starts where the unoverlapped one does), split
    head-major (bitwise-bijective with the standard tree through
    ``pipeline_tp.merge_vit_params_tp``), then each leaf placed per
    :func:`overlap_tp_rules`; the optimizer runs over the split tree in
    the JAX flatten order."""
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
    ovl = make_overlap_tp_vit_apply(model, mesh, tp_axis=tp_axis,
                                    data_axis=data_axis)
    state = create_train_state(ovl, seed, device, lr=lr,
                               optimizer=optimizer, momentum=momentum,
                               weight_decay=weight_decay, init=False)
    if not place:
        return state, {}
    return shard_state(state, mesh, overlap_tp_rules(tp_axis))
