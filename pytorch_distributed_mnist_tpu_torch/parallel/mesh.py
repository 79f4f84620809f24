"""Process meshes: the 1-D ``('data',)`` axis and the N-D meshes of the
JAX package's ``parallel/mesh.py::make_mesh``.

There a mesh is an array of devices with named axes; data parallelism is
``Mesh(devices, ('data',))``, expert parallelism ``make_mesh(('data',
'expert'), shape=(n // ep, ep))``, tensor and sequence parallelism
``make_mesh(('data', 'model', 'seq'), shape=(n // (tp * sp), tp, sp))``
and pipeline parallelism ``make_mesh(('data', 'stage'), shape=(n // pp,
pp))`` or, with tensor parallelism, ``make_mesh(('data', 'stage',
'model'), shape=(n // (pp * tp), pp, tp))``, the devices laid out
row-major (on the 3-D mesh device ``i`` sits at data ``i // (tp * sp)``,
model ``(i // sp) % tp``, seq ``i % sp``). Here every
process drives one device, so an axis is a small record: how many ranks
it spans, this process's coordinate on it, its device, the global ranks
along it and the process group its collectives run over.

- :class:`DataAxis` is the 1-D mesh, and also each axis of an N-D one.
- :class:`GridMesh` is an N-D mesh: this rank's :class:`DataAxis` on
  every named axis (the ranks that share its coordinates on every other
  axis), each over a subgroup made with ``dist.new_group``. Every rank
  makes every subgroup, in the same order, as ``new_group`` requires.
  :func:`ExpertMesh` builds the ``('data', 'expert')`` one from its two
  axes.

On a mesh with a ``seq`` axis the tokens shard over it, so the gradients
of every leaf a rank computes from its own tokens are partial sums over
``seq``: the data axis then carries ``sums``, the ``('data', 'seq')``
axis the train step's gradient all-reduce runs over
(``parallel/collectives.py::grad_all_reduce``). The example count and the
metrics sum over ``data`` alone.

On a mesh with a ``stage`` axis the ranks of one data coordinate (every
stage, and every model rank under PP x TP) hold the same rows, as the
JAX package's ``data_replica_coords`` groups them: the loader shards over
``data`` alone.

The two-tier ``('dcn', 'ici')`` mesh raises: it waits for ROADMAP Queue 1
item 16 part 6. Every mesh is on the card unless ``device`` says
otherwise: with none given, it resolves ``cuda`` and raises when no card
is visible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
)
from pytorch_distributed_mnist_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
# The axis layouts the JAX CLI builds, in its axis order.
_LAYOUTS = ((DATA_AXIS,), (DATA_AXIS, EXPERT_AXIS),
            (DATA_AXIS, MODEL_AXIS, SEQ_AXIS), (DATA_AXIS, STAGE_AXIS),
            (DATA_AXIS, STAGE_AXIS, MODEL_AXIS))


@dataclass(frozen=True)
class DataAxis:
    """One mesh axis of ``size`` ranks, seen from coordinate ``rank`` on
    ``device``. ``group`` is the process group of its collectives, or
    None when it runs none (a single process, or a subgroup of one
    rank). ``name`` is the axis's name in the mesh; ``ranks`` the global
    ranks along it, by coordinate (empty: the coordinates are the global
    ranks). ``sums``, when set, is the wider axis the gradients sum over
    (``('data', 'seq')`` on a mesh that shards tokens)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup]
    name: str = DATA_AXIS
    ranks: Tuple[int, ...] = ()
    sums: Optional["DataAxis"] = None

    @property
    def reduces(self) -> bool:
        """True when steps on this axis run collectives."""
        return self.group is not None

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as the JAX CLI prints a mesh."""
        return {self.name: self.size}

    @property
    def data(self) -> "DataAxis":
        """The axis the batch shards over and the gradients reduce over:
        this one."""
        return self

    @property
    def expert(self) -> Optional["DataAxis"]:
        """No expert axis on a 1-D mesh."""
        return None

    @property
    def model(self) -> Optional["DataAxis"]:
        return None

    @property
    def seq(self) -> Optional["DataAxis"]:
        return None

    @property
    def stage(self) -> Optional["DataAxis"]:
        return None

    def axis(self, name: str) -> "DataAxis":
        if name != self.name:
            raise KeyError(f"mesh {self.shape} has no axis {name!r}")
        return self

    def peer(self, coord: int) -> int:
        """The global rank at coordinate ``coord`` of this axis (what a
        point-to-point op names)."""
        return self.ranks[coord] if self.ranks else coord


@dataclass(frozen=True)
class GridMesh:
    """An N-D mesh of ``size`` ranks: ``axes`` are this rank's axes, in
    the mesh's order. The batch shards over ``data`` (the ranks of one
    data coordinate hold the same rows) and the example count and the
    metrics sum over it; a rule table splits leaves over the others."""

    size: int
    rank: int
    device: torch.device
    axes: Tuple[DataAxis, ...]

    @property
    def reduces(self) -> bool:
        return any(a.reduces for a in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return {a.name: a.size for a in self.axes}

    def axis(self, name: str) -> DataAxis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"mesh {self.shape} has no axis {name!r}")

    def _get(self, name: str) -> Optional[DataAxis]:
        return next((a for a in self.axes if a.name == name), None)

    @property
    def data(self) -> DataAxis:
        return self.axis(DATA_AXIS)

    @property
    def expert(self) -> Optional[DataAxis]:
        return self._get(EXPERT_AXIS)

    @property
    def model(self) -> Optional[DataAxis]:
        return self._get(MODEL_AXIS)

    @property
    def seq(self) -> Optional[DataAxis]:
        return self._get(SEQ_AXIS)

    @property
    def stage(self) -> Optional[DataAxis]:
        return self._get(STAGE_AXIS)


def ExpertMesh(size: int, rank: int, device: torch.device, data: DataAxis,
               expert: DataAxis) -> GridMesh:
    """The ``('data', 'expert')`` mesh of ``size`` ranks from its two
    axes."""
    return GridMesh(size, rank, device, (data, expert))


def _coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(c) for c in np.unravel_index(rank, tuple(shape)))


def _ranks_along(shape: Sequence[int], fixed: Dict[int, int],
                 free: Sequence[int]) -> Tuple[int, ...]:
    """The global ranks whose coordinates equal ``fixed`` on its dims,
    ordered row-major over the ``free`` dims."""
    grid = np.arange(int(np.prod(shape))).reshape(tuple(shape))
    index = tuple(fixed.get(d, slice(None)) for d in range(len(shape)))
    sub = grid[index]
    # ``sub``'s dims are the free dims in mesh order.
    return tuple(int(r) for r in sub.reshape(-1))


def _subgroups(shape: Sequence[int], spans: Sequence[Tuple[int, ...]]):
    """For each span (a tuple of mesh dims), every subgroup of the ranks
    that vary along those dims only, made on every rank in one order
    (span by span, each span's groups in row-major order of the other
    dims; spans of one rank make none); returns this rank's
    ``(ranks, group)`` per span."""
    me = process_index()
    mine = []
    for span in spans:
        others = [d for d in range(len(shape)) if d not in span]
        width = int(np.prod([shape[d] for d in span]))
        found = None
        for fixed_coords in np.ndindex(*[shape[d] for d in others]):
            ranks = _ranks_along(shape, dict(zip(others, fixed_coords)),
                                 span)
            group = (dist.new_group(list(ranks))
                     if width > 1 and dist.is_initialized() else None)
            if me in ranks:
                found = (ranks, group)
        mine.append(found)
    return mine


def _grid(axes: Tuple[str, ...], shape: Tuple[int, ...],
          device: torch.device) -> GridMesh:
    """The N-D mesh of ``axes`` over ``shape``: one subgroup per axis
    (and the ``('data', 'seq')`` one when ``seq`` spans ranks)."""
    n = process_count()
    me = process_index()
    coords = _coords(me, shape)
    spans = [(d,) for d in range(len(axes))]
    seq = axes.index(SEQ_AXIS) if SEQ_AXIS in axes else None
    wide = seq is not None and shape[seq] > 1
    if wide:
        spans.append((axes.index(DATA_AXIS), seq))
    found = _subgroups(shape, spans)
    records = []
    for d, name in enumerate(axes):
        ranks, group = found[d]
        records.append(DataAxis(shape[d], coords[d], device, group, name,
                                ranks))
    if wide:
        ranks, group = found[-1]
        d_data = axes.index(DATA_AXIS)
        sums = DataAxis(shape[d_data] * shape[seq], ranks.index(me), device,
                        group, f"{DATA_AXIS}+{SEQ_AXIS}", ranks)
        data = records[d_data]
        records[d_data] = DataAxis(data.size, data.rank, device, data.group,
                                   DATA_AXIS, data.ranks, sums)
    return GridMesh(size=n, rank=me, device=device, axes=tuple(records))


def make_mesh(axes: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None,
              device: Optional[torch.device] = None):
    """The mesh over every process of the world (the process group's
    world, or this process alone when there is none), with this process
    on ``device`` (None: the card, ``utils/device.py::resolve_device``,
    which raises when none is visible): the data axis, or with
    ``axes=('data', 'expert')`` and ``shape=(n // ep, ep)`` the expert
    mesh, with ``axes=('data', 'model', 'seq')`` and ``shape=(n // (tp *
    sp), tp, sp)`` the tensor and sequence mesh, with ``axes=('data',
    'stage')`` and ``shape=(n // pp, pp)`` the pipeline mesh, or with
    ``axes=('data', 'stage', 'model')`` and ``shape=(n // (pp * tp), pp,
    tp)`` the pipeline x tensor mesh."""
    device = resolve_device("cuda") if device is None else device
    n = process_count()
    axes = tuple(axes)
    if axes not in _LAYOUTS:
        raise NotImplementedError(
            f"mesh axes {axes}: the port has the ('data',) axis and the "
            f"('data', 'expert'), ('data', 'model', 'seq'), ('data', "
            f"'stage') and ('data', 'stage', 'model') meshes; the two-tier "
            f"('dcn', 'ici') axes wait for ROADMAP Queue 1 item 16 part 6")
    if axes != (DATA_AXIS,):
        if shape is None or len(shape) != len(axes) \
                or int(np.prod(shape)) != n or min(shape) < 1:
            raise ValueError(f"mesh shape {None if shape is None else tuple(shape)} "
                             f"!= device count {n} for axes {axes}")
        return _grid(axes, tuple(int(s) for s in shape), device)
    if shape is not None and tuple(shape) != (n,):
        raise NotImplementedError(
            f"mesh shape {tuple(shape)} over {n} process(es): the data axis "
            f"spans every process, one device each; other shapes wait for "
            f"ROADMAP Queue 1 item 16")
    group = dist.group.WORLD if dist.is_initialized() else None
    return DataAxis(size=n, rank=process_index(), device=device,
                    group=group)
