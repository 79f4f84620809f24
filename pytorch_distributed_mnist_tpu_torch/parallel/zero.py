"""ZeRO-1 and ZeRO-3: optimizer-state (and param) sharding over the data
axis.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/zero.py``. There
ZeRO is a ``PartitionSpec`` change and XLA's sharding propagation turns
the gradient all-reduce into a reduce-scatter into the moment shards plus
an all-gather of the updated params. Here the same layout
(:func:`zero_state_sharding`: per leaf, the largest dim divisible by the
axis size, ties to the lowest index, chosen in the JAX layout) is placed
by :func:`shard_state_zero`, and :class:`ZeroPlane` writes the
communication out:

- the backward fills the flat gradient buffer (``parallel/collectives.py
  ::GradBuffer``). A leaf split along dim 0 lies rank-major already
  (rank ``r``'s slice is a contiguous run of its gradient), so it is
  reduce-scattered straight from its view into this rank's contiguous
  gradient shard. A bucket's leaves split along another dim are packed
  rank-major into the bucket's one packing buffer and reduce-scattered
  together; its leaves that no dim splits are all-reduced;
- the optimizer steps on contiguous tensors only: this rank's param
  shards (one flat buffer, a view per leaf) and the unsplit leaves whole.
  With ``adam_pallas`` that is one launch of the fused Adam kernel (K2)
  per step over every shard, as long as the leaves number at most
  ``ops/adam.py::MAX_LEAVES``;
- the updated shards are all-gathered: a dim-0 leaf's straight into its
  param, the packed leaves into the packing buffer (free again once the
  reduce-scatter is waited for) and unpacked from there.

Per rank, the plane adds to the model's params (P floats) and the moments
(2P/n with Adam over n ranks): the gradient buffer (P), this rank's param
and gradient shards (2P/n) and the packing buffers (the leaves split off
dim 0, whole). Every leaf of the cnn splits along dim 0, so there the
total is 2P + 4P/n against unsharded Adam's 4P.

``level=1`` shards the moments: the whole params stay in the model (the
state's params leaves), and the step slices this rank's shards out of
them before the update (the JAX body's ``dynamic_slice``). ``level=3``
shards the params too: the state's params leaves ARE the shards, and the
model's whole params are a workspace all-gathered from them before each
forward (and before each eval pass, ``train/trainer.py``).

The per-leaf record the checkpoint layer reads is a
``parallel/tensor.py::Placement`` (``state.placements``): a checkpoint
saved here holds whole leaves (npz) or the shards' slices (``.ckpt``),
and loads in any world and in the JAX package.
"""

from __future__ import annotations

import functools
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    P,
    Placement,
    _path_keys,
    leaf_spec,
    placement_of,
    port_dim,
)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    jax_shape as _jax_shape,
)

# The per-param optimizer trees ZeRO claims in the JAX layout: Adam's
# moments. (At level 3 the port's plane also splits every other per-param
# optimizer leaf, SGD's trace, beside its param: an update is elementwise.)
_MOMENT_KEYS = ("mu", "nu")


def _is_moment_path(path: str) -> bool:
    return any(k in _MOMENT_KEYS for k in _path_keys(path))


def _is_param_path(path: str) -> bool:
    keys = _path_keys(path)
    return bool(keys) and keys[0] == "params"


def _zero_spec(shape: Tuple[int, ...], axis_size: int, axis: str,
               base: P) -> P:
    """Shard the largest dimension divisible by ``axis_size`` that ``base``
    leaves unsharded; return ``base`` unchanged if none qualifies.

    Equal-size ties break to the LOWEST dim index, explicitly: the dim
    choice decides the shard layout (and the overlapped path's bucket
    contents), so it must be stable across runs and hosts. ``shape`` is
    the JAX layout's (HWIO convolutions), so a port shard names the same
    slice of a leaf as the JAX one."""
    entries = list(base) + [None] * (len(shape) - len(base))
    candidates = [
        d for d in range(len(shape))
        if entries[d] is None and shape[d] >= axis_size
        and shape[d] % axis_size == 0
    ]
    if not candidates:
        return base
    best = min(candidates, key=lambda d: (-shape[d], d))
    entries[best] = axis
    return P(*entries)



def zero_state_sharding(state, mesh, data_axis: str = "data",
                        rules=None, level: int = 1,
                        base_sharding: Optional[Dict[str, P]] = None) \
        -> Dict[str, P]:
    """``{leaf name: P}`` for a train state with ZeRO-style sharding.

    ``level=1``: Adam ``mu``/``nu`` sharded over ``data_axis``, params
    replicated. ``level=3``: params sharded the same way too.
    ``rules`` is a rule table (``parallel/expert.py::moe_ep_rules``,
    ``parallel/tensor.py::vit_tp_rules``);
    leaves it matches keep its layout everywhere (params AND moments),
    and ZeRO applies to the remaining leaves only. ``base_sharding`` (a
    ``{name: P}`` base layout) adds ``data_axis`` to the claimed moment
    leaves on their largest still-unsharded divisible dim; it excludes
    ``rules`` and ``level=3``."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_leaves,
    )

    if level not in (1, 3):
        raise ValueError(f"zero level must be 1 or 3, got {level}")
    if rules and base_sharding is not None:
        raise ValueError("pass rules or base_sharding, not both")
    if level == 3 and base_sharding is not None:
        raise ValueError(
            "level=3 does not compose with base_sharding: the base "
            "layout owns the param placement; use level=1")
    axis_size = mesh.axis(data_axis).size
    out: Dict[str, P] = {}
    for name, t in state_leaves(state):
        shape = _jax_shape(tuple(t.shape))
        if base_sharding is not None:
            base = base_sharding.get(name, P())
            out[name] = (_zero_spec(shape, axis_size, data_axis, base)
                         if _is_moment_path(name) else base)
            continue
        base = leaf_spec(name, rules)
        claimed = _is_moment_path(name) or (level == 3
                                            and _is_param_path(name))
        if not claimed or base != P():
            out[name] = base  # unclaimed, or a ruled leaf: keep its layout
        else:
            out[name] = _zero_spec(shape, axis_size, data_axis, base)
    return out


def zero1_state_sharding(state, mesh, data_axis: str = "data", rules=None):
    """ZeRO-1 sharding (:func:`zero_state_sharding`, level 1)."""
    return zero_state_sharding(state, mesh, data_axis, rules, level=1)


def _rebuild_optimizer(old, tensors: Sequence[torch.Tensor]):
    """An optimizer of ``old``'s kind over ``tensors`` (each a param or
    its shard), with ``old``'s counts and hyperparameters; the per-param
    state is copied by the caller."""
    from pytorch_distributed_mnist_tpu_torch.train.state import OptaxSGD

    if isinstance(old, OptaxSGD):
        new = OptaxSGD(tensors, momentum=old.momentum,
                       weight_decay=old.weight_decay)
    else:
        new = type(old)(tensors)
    with torch.no_grad():
        new.count.copy_(old.count)
        for k, v in old.hyperparams.items():
            new.hyperparams[k].copy_(v)
    return new


class _Bucket:
    """One communication group: its sharded leaves (a contiguous range of
    the shard buffers, the packed ones first) and its unsplit leaves.
    ``packed`` are the sharded leaves split off dim 0, which go through
    the packing buffer; ``direct`` the dim-0 ones, which do not."""

    def __init__(self, packed: List[int], direct: List[int],
                 unsplit: List[int], start: int, offsets: Dict[int, int],
                 packed_size: int, size: int) -> None:
        self.packed = packed
        self.direct = direct
        self.sharded = packed + direct
        self.unsplit = unsplit
        self.start = start
        self.offsets = offsets  # leaf -> offset inside the bucket's shard
        self.packed_size = packed_size  # packed shard elements per rank
        self.size = size  # shard elements per rank


class ZeroPlane:
    """The ZeRO data plane of one train state on data axis ``axis``.

    ``dims[i]`` is the port-layout dim leaf ``i`` (of the params in the
    JAX flatten order) splits over the axis, or None; ``plan`` groups the
    leaves into buckets (:func:`distrib.cas.bucket_plan`; the
    propagation path has one). ``overlap`` issues each bucket's
    reduce-scatter from a backward hook as soon as its gradients exist
    (``parallel/zero_overlap.py``)."""

    def __init__(self, state, axis, level: int, dims: List[Optional[int]],
                 plan: List[List[int]], overlap: bool = False) -> None:
        from pytorch_distributed_mnist_tpu_torch.models.convert import (
            jax_param_order,
        )
        from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
            GradBuffer,
            grad_copies,
            grad_stage,
        )

        if level not in (1, 3):
            raise ValueError(f"zero level must be 1 or 3, got {level}")
        self.axis = axis
        self.level = level
        self.overlap = overlap
        self.group = axis.group
        self.n = axis.size
        self.rank = axis.rank
        named = dict(state.model.named_parameters())
        self.names = jax_param_order(named)
        self.params = [named[n] for n in self.names]
        self.dims = list(dims)
        device = self.params[0].device
        self.buckets: List[_Bucket] = []
        total = 0
        for leaves in plan:
            packed = [i for i in leaves if self.dims[i] not in (None, 0)]
            direct = [i for i in leaves if self.dims[i] == 0]
            unsplit = [i for i in leaves if self.dims[i] is None]
            offsets, size = {}, 0
            for i in packed + direct:
                offsets[i] = size
                size += self.params[i].numel() // self.n
            packed_size = sum(self.params[i].numel() // self.n
                              for i in packed)
            self.buckets.append(_Bucket(packed, direct, unsplit, total,
                                        offsets, packed_size, size))
            total += size
        self.shard_flat = torch.zeros(total, dtype=torch.float32,
                                      device=device)
        self.grad_flat = torch.zeros(total, dtype=torch.float32,
                                     device=device)
        # Rank-major packing, per bucket: the reduce-scatter's input, then
        # the all-gather's output.
        self.packing = [torch.zeros(self.n * b.packed_size,
                                    dtype=torch.float32, device=device)
                        for b in self.buckets]
        self.unsplit_flat = [
            torch.zeros(sum(self.params[i].numel() for i in b.unsplit),
                        dtype=torch.float32, device=device)
            for b in self.buckets]
        self.shards: Dict[int, torch.Tensor] = {}
        self.grad_shards: Dict[int, torch.Tensor] = {}
        for b in self.buckets:
            for i in b.sharded:
                lo = b.start + b.offsets[i]
                shape = self._shard_shape(i)
                n = self.params[i].numel() // self.n
                self.shards[i] = self.shard_flat[lo:lo + n].view(shape)
                self.grad_shards[i] = self.grad_flat[lo:lo + n].view(shape)
        self.grads = GradBuffer(self.params, grad_copies(state.model),
                                grad_stage(state.model))
        state.grad_buffer = self.grads
        # A seq axis whose ranks hold partial gradients (the tokens shard
        # over it): summed over it before the data-axis plane runs.
        self.seq = None
        # The optimizer's tensors: this rank's shard of each split leaf,
        # the whole param of each unsplit one.
        self.update = [self.shards.get(i, p)
                       for i, p in enumerate(self.params)]
        self._handles: List = []
        self._next = 0
        self._ready: List[bool] = [False] * len(self.params)
        self.armed = False
        # True while the level-3 workspace may not equal the shards.
        self.stale = True
        if overlap:
            # The hooks live on the params, where the garbage collector
            # cannot see them: a strong reference back to the plane would
            # keep it, and every buffer it holds, alive for good.
            plane = weakref.ref(self)

            def hook(_p, i):
                alive = plane()
                if alive is not None:
                    alive._on_grad(i)

            for i, p in enumerate(self.params):
                p.register_post_accumulate_grad_hook(
                    functools.partial(hook, i=i))

    # -- layout ---------------------------------------------------------------

    def _shard_shape(self, i: int) -> Tuple[int, ...]:
        shape = list(self.params[i].shape)
        shape[self.dims[i]] //= self.n
        return tuple(shape)

    def _rank_major(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """A whole leaf (param or gradient) viewed ``(n, *shard shape)``:
        row ``r`` is rank ``r``'s slice."""
        d = self.dims[i]
        return t.unflatten(d, (self.n, t.shape[d] // self.n)).movedim(d, 0)

    def _packed_rows(self, k: int, i: int):
        """Packed leaf ``i``'s rows of bucket ``k``'s packing buffer,
        viewed ``(n, *shard shape)``."""
        b = self.buckets[k]
        n_el = self.params[i].numel() // self.n
        rows = self.packing[k].view(self.n, b.packed_size)[
            :, b.offsets[i]:b.offsets[i] + n_el]
        return rows.view((self.n,) + self._shard_shape(i))

    # -- collectives -----------------------------------------------------------

    @torch.no_grad()
    def _issue_reduce(self, k: int) -> None:
        """Pack bucket ``k``'s gradients and start its reduce-scatter and
        its unsplit leaves' all-reduce (asynchronous under overlap)."""
        b = self.buckets[k]
        views = self.grads.views
        for i in b.packed:
            self._packed_rows(k, i).copy_(self._rank_major(views[i], i))
        out = self.grad_flat[b.start:b.start + b.packed_size]
        unsplit = self.unsplit_flat[k]
        if b.unsplit:
            torch.cat([views[i].reshape(-1) for i in b.unsplit], out=unsplit)
        if self.group is None:
            out.copy_(self.packing[k])
            for i in b.direct:
                self.grad_shards[i].copy_(views[i])
            return
        if b.packed:
            self._handles.append(dist.reduce_scatter_tensor(
                out, self.packing[k], group=self.group,
                async_op=self.overlap))
        for i in b.direct:
            self._handles.append(dist.reduce_scatter_tensor(
                self.grad_shards[i].view(-1), views[i].view(-1),
                group=self.group, async_op=self.overlap))
        if b.unsplit:
            self._handles.append(dist.all_reduce(
                unsplit, group=self.group, async_op=self.overlap))

    def _on_grad(self, i: int) -> None:
        """Backward hook (overlap): leaf ``i``'s gradient is final; issue
        every bucket, in bucket order, whose gradients all are."""
        if not self.armed:
            return
        self._ready[i] = True
        while self._next < len(self.buckets):
            b = self.buckets[self._next]
            if not all(self._ready[j] for j in b.sharded + b.unsplit):
                break
            self._issue_reduce(self._next)
            self._next += 1

    def begin_backward(self) -> None:
        """Arm the hooks for the backward pass whose gradients are final
        (the last micro-batch's)."""
        self._ready = [False] * len(self.params)
        self._next = 0
        self.armed = self.overlap

    @torch.no_grad()
    def reduce(self, divisor: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None) -> None:
        """Finish the gradient reduction: issue the buckets the hooks did
        not, wait for every bucket in order, then divide (or scale) the
        reduced gradients and unpack the unsplit ones."""
        self.armed = False
        self.grads.check()
        self.grads.sum_stage()
        if self.seq is not None and self.seq.group is not None:
            self.grads.zero_copies()
            dist.all_reduce(self.grads.flat, group=self.seq.group)
        while self._next < len(self.buckets):
            self._issue_reduce(self._next)
            self._next += 1
        for h in self._handles:
            if h is not None:
                h.wait()
        self._handles = []
        self._next = 0
        factor = None
        if divisor is not None:
            factor = 1.0 / torch.clamp(divisor, min=1.0)
        elif scale is not None:
            factor = scale
        if factor is not None:
            self.grad_flat.mul_(factor)
        for k, b in enumerate(self.buckets):
            if not b.unsplit:
                continue
            flat = self.unsplit_flat[k]
            if factor is not None:
                flat.mul_(factor)
            off = 0
            for i in b.unsplit:
                n = self.params[i].numel()
                self.grads.views[i].copy_(flat[off:off + n].view_as(
                    self.params[i]))
                off += n

    @torch.no_grad()
    def gather_params(self) -> None:
        """All-gather every bucket's shards into the whole params: the
        dim-0 leaves straight into their params, the packed ones into the
        packing buffer, then unpacked (bucket order; asynchronous under
        overlap, all waited). The packing buffer is free here: every
        reduce-scatter was waited for before the update."""
        handles: Dict[int, List] = {}
        for k, b in enumerate(self.buckets):
            src = self.shard_flat[b.start:b.start + b.packed_size]
            if self.group is None:
                self.packing[k].copy_(src)
                for i in b.direct:
                    self.params[i].copy_(self.shards[i])
                continue
            handles[k] = [dist.all_gather_into_tensor(
                self.params[i].view(-1), self.shards[i].view(-1),
                group=self.group, async_op=self.overlap)
                for i in b.direct]
            if b.packed:
                handles[k].append(dist.all_gather_into_tensor(
                    self.packing[k], src, group=self.group,
                    async_op=self.overlap))
        for k, b in enumerate(self.buckets):
            for h in handles.get(k, []):
                if h is not None:
                    h.wait()
            for i in b.packed:
                self._rank_major(self.params[i], i).copy_(
                    self._packed_rows(k, i))
        self.stale = False

    @torch.no_grad()
    def slice_params(self) -> None:
        """Level 1: this rank's shards, sliced out of the whole params."""
        for i, s in self.shards.items():
            s.copy_(self._rank_major(self.params[i], i)[self.rank])

    # -- the step --------------------------------------------------------------

    def before_forward(self) -> None:
        """Level 3 without overlap gathers the params before each forward;
        the overlapped path carries them from the last step's tail."""
        if self.level == 3 and (not self.overlap or self.stale):
            self.gather_params()

    def step(self, optimizer, divisor: Optional[torch.Tensor] = None,
             scale: Optional[torch.Tensor] = None) -> None:
        """After the backward: reduce, update the shards (and the unsplit
        leaves), then all-gather the params (level 1, and the overlapped
        level 3's carry)."""
        self.reduce(divisor, scale)
        if self.level == 1:
            self.slice_params()
        for i, g in self.grad_shards.items():
            self.shards[i].grad = g
        optimizer.step()
        if self.level == 1 or self.overlap:
            self.gather_params()
        else:
            self.stale = True


def shard_state_zero(state, mesh, data_axis: str = "data", rules=None,
                     level: int = 1, base_sharding=None,
                     bucket_mb: Optional[float] = None,
                     overlap: bool = False):
    """Place a whole train state onto ``mesh`` with ZeRO-``level``
    sharding; returns ``(state, {leaf name: P})``. Ruled leaves
    (``rules``, e.g. the EP table) are placed by their rule first; the
    rest by :func:`zero_state_sharding` through a :class:`ZeroPlane`
    over the ``data_axis`` axis (``state.zero``), whose optimizer replaces
    the state's, carrying its counts, hyperparameters and moments. With
    ``bucket_mb`` the leaves group into the overlapped path's buckets,
    else into one.

    ``base_sharding`` (the pipeline's ``{leaf name: P}``,
    ``parallel/pipeline_vit.py``) is placed first, and each moment then
    splits over ``data_axis`` too, on the dim :func:`zero_state_sharding`
    adds: a stage-split block moment becomes stage x data (and stage x
    model x data under PP x TP), an embed or head moment data alone. The
    plane works on each rank's base slices (the data dim is never one
    the base splits)."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        jax_leaf_name,
        jax_param_order,
        jax_param_path,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        shard_state,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.zero_overlap import (
        _shard_dims,
        bucket_plan,
    )

    if state.zero is not None:
        raise ValueError("the state is already ZeRO-placed")
    if overlap:
        from pytorch_distributed_mnist_tpu_torch.parallel.zero_overlap import (
            _tier_axes,
        )

        _tier_axes(mesh, data_axis)
    sharding = zero_state_sharding(state, mesh, data_axis, rules, level,
                                   base_sharding)
    if rules:
        shard_state(state, mesh, rules)
    if base_sharding is not None:
        shard_state(state, mesh, lambda path: base_sharding.get(path, P()))
    axis = mesh.axis(data_axis)
    old = state.optimizer
    named = dict(state.model.named_parameters())
    names = jax_param_order(named)
    root = getattr(state.model, "param_root", "['params']")
    axis_size = axis.size
    # A leaf splits when ZeRO claims its moments (or, at level 3, the
    # param itself) and no rule owns its layout.
    claims = level == 3 or any(_is_moment_path(path)
                               for path, _ in old.inner_leaves())
    prefixes = [path for path, v in old.inner_leaves()
                if isinstance(v, list)]
    if base_sharding is not None:
        # The data dim ZeRO added to each leaf's first moment.
        dims = []
        for n in names:
            spec = sharding[prefixes[0] + jax_param_path(n, root)] \
                if claims else P()
            found = [d for d, a in enumerate(spec) if a == data_axis]
            dims.append(port_dim(found[0], named[n].dim()) if found
                        else None)
    else:
        dims = [d if claims and leaf_spec(jax_leaf_name(n, root),
                                          rules) == P()
                else None for n, d in zip(names, _shard_dims(
                    [named[n] for n in names], axis_size, data_axis))]
    plan = (bucket_plan([named[n] for n in names], bucket_mb)
            if bucket_mb else [list(range(len(names)))])
    plane = ZeroPlane(state, axis, level, dims, plan, overlap=overlap)
    plane.seq = getattr(mesh, "seq", None)
    new = _rebuild_optimizer(old, plane.update)
    with torch.no_grad():
        for (_, ov), (_, nv) in zip(old.inner_leaves(), new.inner_leaves()):
            if isinstance(ov, list):
                for i, (o, t) in enumerate(zip(ov, nv)):
                    t.copy_(plane._rank_major(o, i)[plane.rank]
                            if i in plane.shards else o)
            else:
                nv.copy_(ov)
    plane.slice_params()
    state.optimizer = new
    state.zero = plane
    # The checkpoint layer's record: every split leaf's moments (and at
    # level 3 the param) with this rank's slice.
    placements: Dict[str, Placement] = {}
    prefixes = [path for path, v in new.inner_leaves()
                if isinstance(v, list)]
    base = state.placements or {}
    for i, n in enumerate(names):
        if plane.dims[i] is None:
            continue
        leaf_names = [prefix + jax_param_path(n, root) for prefix in prefixes]
        if level == 3:
            leaf_names.append(jax_leaf_name(n, root))
        local = tuple(plane.params[i].shape)
        for leaf in leaf_names:
            if base_sharding is None:
                spec = _zero_spec(_jax_shape(local), axis_size, data_axis,
                                  P())
                placements[leaf] = placement_of(spec, local, mesh)
            else:
                # The whole leaf, split over the base axes and data.
                whole = base[leaf].shape if leaf in base else local
                placements[leaf] = placement_of(sharding[leaf], whole, mesh)
    state.placements = {**(state.placements or {}), **placements}
    plane.gather_params()
    return state, sharding


def shard_state_zero1(state, mesh, data_axis: str = "data", rules=None):
    """ZeRO-1 placement (:func:`shard_state_zero`, level 1)."""
    return shard_state_zero(state, mesh, data_axis, rules, level=1)
