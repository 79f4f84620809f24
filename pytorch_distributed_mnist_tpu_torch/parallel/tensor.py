"""Rule tables: per-leaf placement of a train state over a process mesh.

Counterpart of the rule-table half of
``pytorch_distributed_mnist_tpu/parallel/tensor.py`` (``_path_keys``,
``leaf_spec``, ``state_shardings``, ``shard_state``). There a small table
of path-suffix rules becomes a ``NamedSharding`` pytree and GSPMD places
every leaf; here the same table resolves, per leaf of the port's train
state (named as the JAX leaves are, ``models/convert.py::state_leaves``),
to a :class:`P` (which dim splits over which mesh axis, in the JAX
layout) and then to a :class:`Placement`: the dim in the port's layout,
this rank's slice of it, and the process group that gathers it back. The
checkpoint layer and the optimizer read the placements in place of
``NamedSharding``.

Rule matching is by the LAST TWO keys of a leaf's path (e.g. ``('moe',
'w1')``). Optimizer moments are full param-tree replicas, so their paths
end with the same two keys: one table places params and both moments
alike. Leaves no rule matches stay replicated (``P()``).

The tensor-parallel table (``vit_tp_rules``) and the overlapped TP
schedule wait for ROADMAP Queue 1 item 16 part 3.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Rules = Union[Dict[Tuple[str, str], "P"], Callable[[str], "P"]]


class P(tuple):
    """A partition spec: per dim of a leaf in the JAX layout, the mesh
    axis it splits over, or None (``jax.sharding.PartitionSpec``'s
    shape: ``P('expert', None, None)``; ``P()`` is replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


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
    sharded checkpoint directory (coordinate 0 on every other axis)."""

    spec: P
    axis: str
    dim: int
    size: int
    index: int
    group: Optional[dist.ProcessGroup]
    shape: Tuple[int, ...]
    writes: bool = True

    @property
    def chunk(self) -> int:
        return self.shape[self.dim] // self.size

    def local(self, full):
        """This rank's slice of a whole leaf (a tensor or an array in the
        port's layout), contiguous."""
        start = self.index * self.chunk
        if isinstance(full, torch.Tensor):
            return full.narrow(self.dim, start, self.chunk).contiguous()
        region = [slice(None)] * np.ndim(full)
        region[self.dim] = slice(start, start + self.chunk)
        return np.ascontiguousarray(np.asarray(full)[tuple(region)])

    def region(self) -> Tuple[slice, ...]:
        """This rank's slice, as index slices of the whole port-layout
        leaf."""
        region = [slice(0, n) for n in self.shape]
        start = self.index * self.chunk
        region[self.dim] = slice(start, start + self.chunk)
        return tuple(region)

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
        return torch.cat(list(out.view(self.size, *shard.shape)),
                         dim=self.dim)


def placement_of(spec: P, shape: Tuple[int, ...], mesh) -> \
        Optional[Placement]:
    """The :class:`Placement` a spec gives a leaf of port-layout ``shape``
    on ``mesh``, or None when it is replicated. A spec may split one dim
    over one axis (all this slice's layouts do)."""
    axes = [(d, a) for d, a in enumerate(spec) if a is not None]
    if not axes:
        return None
    if len(axes) > 1:
        raise NotImplementedError(
            f"spec {spec!r} splits {len(axes)} dims; the port places a leaf "
            f"over one mesh axis (more waits for ROADMAP Queue 1 item 16)")
    jax_dim, name = axes[0]
    axis = mesh.axis(name)
    others = [mesh.axis(a) for a in mesh.shape if a != name]
    dim = port_dim(jax_dim, len(shape))
    if shape[dim] % axis.size:
        raise ValueError(f"dim {dim} of shape {shape} is not divisible by "
                         f"mesh axis {name!r} of size {axis.size}")
    return Placement(spec=P(*spec), axis=name, dim=dim, size=axis.size,
                     index=axis.rank, group=axis.group, shape=tuple(shape),
                     writes=all(o.rank == 0 for o in others))


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
