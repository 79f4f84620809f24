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

The two-tier ``('dcn', 'ici', *extra)`` mesh of the JAX package's
``make_hier_mesh`` is :func:`make_hier_mesh`: ``dcn`` indexes the slice
(the slow tier between hosts or pods), ``ici`` the data position inside
it, and together they are the data axis. Its ``data`` is one composed
:class:`DataAxis` over the ``(dcn, ici)`` span (size ``dcn * ici``,
coordinate ``d * ici + i``, one subgroup per fixed model coordinate), so
the loader, the steps and the collectives follow the mesh through
``mesh.data`` without knowing about tiers; ZeRO addresses ``ici`` and
``dcn`` by name (``parallel/zero.py``). Model axes (``model``, ``seq``,
``expert``) nest inside one slice. A CUDA device carries no slice stamp,
so the slice count comes from ``--dcn-slices`` or ``TPUMNIST_DCN_SLICES``
and a slice is a contiguous block of the rank order (with a launcher's
node-major rank order, the nodes). Every mesh is on the card unless
``device`` says otherwise: with none given, it resolves ``cuda`` and
raises when no card is visible.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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
DCN_AXIS = "dcn"
ICI_AXIS = "ici"
# The two tiers of a hierarchical mesh, leading (data-major): together
# they are the data axis; model axes follow.
HIER_DATA_AXES: Tuple[str, str] = (DCN_AXIS, ICI_AXIS)
# Emulated slice map: N contiguous equal blocks of the device order.
DCN_SLICES_ENV = "TPUMNIST_DCN_SLICES"
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
    metrics sum over it; a rule table splits leaves over the others.
    ``composed``, on a two-tier mesh, is the data axis made of the
    ``('dcn', 'ici')`` pair: ``data`` (and ``axis('data')``) return it."""

    size: int
    rank: int
    device: torch.device
    axes: Tuple[DataAxis, ...]
    composed: Optional[DataAxis] = None

    @property
    def reduces(self) -> bool:
        return any(a.reduces for a in self.axes) or (
            self.composed is not None and self.composed.reduces)

    @property
    def shape(self) -> Dict[str, int]:
        return {a.name: a.size for a in self.axes}

    def axis(self, name: str) -> DataAxis:
        if name == DATA_AXIS and self.composed is not None:
            return self.composed
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
    """The N-D mesh of ``axes`` over ``shape``: one subgroup per axis,
    the composed ``('dcn', 'ici')`` data axis's on a two-tier mesh, and
    the data x ``seq`` one when ``seq`` spans ranks."""
    n = process_count()
    me = process_index()
    coords = _coords(me, shape)
    hier = tuple(axes[:2]) == HIER_DATA_AXES
    data_dims = (0, 1) if hier else (axes.index(DATA_AXIS),)
    spans = [(d,) for d in range(len(axes))]
    if hier:
        spans.append(data_dims)
    seq = axes.index(SEQ_AXIS) if SEQ_AXIS in axes else None
    wide = seq is not None and shape[seq] > 1
    if wide:
        spans.append(data_dims + (seq,))
    found = _subgroups(shape, spans)
    records = [DataAxis(shape[d], coords[d], device, found[d][1], name,
                        found[d][0]) for d, name in enumerate(axes)]
    sums = None
    if wide:
        ranks, group = found[-1]
        sums = DataAxis(len(ranks), ranks.index(me), device, group,
                        f"{DATA_AXIS}+{SEQ_AXIS}", ranks)
    if hier:
        ranks, group = found[len(axes)]
        composed = DataAxis(len(ranks), ranks.index(me), device, group,
                            DATA_AXIS, ranks, sums)
        return GridMesh(size=n, rank=me, device=device, axes=tuple(records),
                        composed=composed)
    d = data_dims[0]
    data = records[d]
    records[d] = DataAxis(data.size, data.rank, device, data.group,
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
    if tuple(axes[:2]) == HIER_DATA_AXES:
        raise ValueError(
            f"mesh axes {axes}: the two-tier ('dcn', 'ici') mesh is built "
            f"by make_hier_mesh(dcn_slices, extra_axes, extra_shape), which "
            f"checks the slice topology")
    if axes not in _LAYOUTS:
        raise NotImplementedError(
            f"mesh axes {axes}: the port has the ('data',) axis and the "
            f"('data', 'expert'), ('data', 'model', 'seq'), ('data', "
            f"'stage') and ('data', 'stage', 'model') meshes, and the "
            f"two-tier ones of make_hier_mesh")
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


def device_slice_index(device) -> Optional[int]:
    """The device's real slice assignment (the JAX runtimes of multi-slice
    TPUs stamp ``slice_index``), or None when it carries none. A CUDA
    device (``torch.device``) carries none, so the port's slices are the
    emulated map's."""
    idx = getattr(device, "slice_index", None)
    return int(idx) if isinstance(idx, (int, np.integer)) else None


def _env_slices() -> Optional[int]:
    """``TPUMNIST_DCN_SLICES`` as an integer, None when unset."""
    env = os.environ.get(DCN_SLICES_ENV, "")
    if not env:
        return None
    try:
        return int(env)
    except ValueError:
        raise ValueError(
            f"{DCN_SLICES_ENV}={env!r} is not an integer slice count") \
            from None


def _world_devices() -> list:
    """Stand-ins for the world's devices, one per process in rank order
    (none carries a slice stamp)."""
    return list(range(process_count()))


def infer_dcn_slices(devices: Optional[Sequence] = None) -> int:
    """How many DCN slices this world spans: the ``TPUMNIST_DCN_SLICES``
    emulation env when set, else the count of distinct real
    ``slice_index`` stamps of ``devices`` (default: the world's, which
    carry none), else 1 (a flat single-slice world)."""
    env = _env_slices()
    if env is not None:
        return env
    devs = list(devices) if devices is not None else _world_devices()
    real = {device_slice_index(d) for d in devs}
    if None in real or len(real) < 2:
        return 1
    return len(real)


def _emulated_slice(position: int, world: int, dcn_slices: int) -> int:
    """The emulated map's block rule (:func:`device_slice_map`): position
    ``position`` of a ``world`` cut into ``dcn_slices`` contiguous equal
    blocks. :func:`make_hier_mesh`'s row-major layout puts rank ``r`` in
    the same slice, ``r // per_slice``."""
    return position // (world // dcn_slices)


def _slice_blocks(devices: Sequence, dcn_slices: int) -> list:
    """Order ``devices`` slice-major and validate the slice topology
    (pure: drivable with fake device objects). With real ``slice_index``
    stamps the devices are grouped by slice (equal sizes required, slice
    count must match); without them the given order is the emulated map:
    ``dcn_slices`` contiguous equal blocks."""
    devices = list(devices)
    n = len(devices)
    if dcn_slices < 1:
        raise ValueError(f"dcn_slices must be >= 1, got {dcn_slices}")
    if n % dcn_slices:
        raise ValueError(
            f"{n} device(s) do not split into {dcn_slices} equal DCN "
            f"slices")
    per = n // dcn_slices
    real = [device_slice_index(d) for d in devices]
    if all(r is not None for r in real) and len(set(real)) > 1:
        groups: dict = {}
        for d, r in zip(devices, real):
            groups.setdefault(r, []).append(d)
        if len(groups) != dcn_slices:
            raise ValueError(
                f"devices report {len(groups)} distinct slice_index "
                f"value(s), not the requested {dcn_slices} DCN slices")
        bad = {k: len(v) for k, v in groups.items() if len(v) != per}
        if bad:
            raise ValueError(
                f"unequal slice sizes (expected {per} chips/slice, got "
                f"{bad}): every DCN slice must contribute the same chip "
                f"count")
        return [d for k in sorted(groups) for d in groups[k]]
    return devices


def validate_dcn_slices(dcn_slices: int,
                        devices: Optional[Sequence] = None) -> None:
    """Raise ``ValueError`` unless ``devices`` (default: the world's, one
    per process) can form ``dcn_slices`` equal slices: the checks
    :func:`make_hier_mesh` runs, so the CLI can refuse a flag (or fall
    back to the flat mesh after an elastic rebuild) before anything is
    built."""
    _slice_blocks(list(devices) if devices is not None else _world_devices(),
                  dcn_slices)


def make_hier_mesh(dcn_slices: Optional[int] = None,
                   extra_axes: Tuple[str, ...] = (),
                   extra_shape: Tuple[int, ...] = (),
                   device: Optional[torch.device] = None) -> GridMesh:
    """The data-major two-tier ``('dcn', 'ici', *extra_axes)`` mesh over
    every process of the world, this process on ``device`` (None: the
    card, raising when none is visible).

    ``dcn`` indexes the slice, ``ici`` the data position inside it; the
    mesh's ``data`` is the composed pair. ``extra_axes``/``extra_shape``
    append model axes (``model``/``seq``/``expert``), which nest inside
    one slice: their width must divide the ranks of a slice, so no
    model-parallel group straddles the slow tier. Ranks are laid out
    row-major (rank ``r`` sits at slice ``r // per_slice``), the
    emulated slice map's blocks.

    ``dcn_slices=None`` resolves through :func:`infer_dcn_slices` and
    refuses a flat world: build a flat mesh with :func:`make_mesh`."""
    device = resolve_device("cuda") if device is None else device
    devs = _world_devices()
    if dcn_slices is None:
        dcn_slices = infer_dcn_slices(devs)
        if dcn_slices < 2:
            raise ValueError(
                f"no DCN slice topology: devices carry no slice_index "
                f"and {DCN_SLICES_ENV} is unset — pass dcn_slices "
                f"explicitly (or build a flat make_mesh)")
    extra_axes, extra_shape = tuple(extra_axes), tuple(extra_shape)
    if len(extra_axes) != len(extra_shape):
        raise ValueError(
            f"extra_axes {extra_axes} and extra_shape {extra_shape} "
            f"must pair up")
    for ax in extra_axes:
        if ax in HIER_DATA_AXES + (DATA_AXIS,):
            raise ValueError(
                f"extra axis {ax!r} collides with the hierarchical "
                f"data axes {HIER_DATA_AXES}")
    ordered = _slice_blocks(devs, dcn_slices)
    per_slice = len(ordered) // dcn_slices
    model = int(np.prod(extra_shape, dtype=np.int64)) if extra_shape else 1
    if model < 1 or per_slice % model:
        raise ValueError(
            f"model axes {dict(zip(extra_axes, extra_shape))} (width "
            f"{model}) would straddle the DCN boundary: each slice has "
            f"{per_slice} chip(s), and model-parallel groups must nest "
            f"inside one slice's ICI domain")
    shape = (dcn_slices, per_slice // model) + tuple(
        int(s) for s in extra_shape)
    return _grid(HIER_DATA_AXES + extra_axes, shape, device)


def is_hier_mesh(mesh) -> bool:
    """Whether ``mesh`` is a two-tier ``('dcn', 'ici', ...)`` mesh."""
    return tuple(getattr(mesh, "shape", {}))[:2] == HIER_DATA_AXES


def resolve_data_axis(mesh, axis="data"):
    """The axis (a name, or the composed pair of names) batch rows shard
    over: ``axis`` as it is, except that ``'data'`` on a two-tier mesh is
    the ``('dcn', 'ici')`` pair."""
    if mesh is not None and axis == DATA_AXIS and is_hier_mesh(mesh):
        return HIER_DATA_AXES
    return axis


def data_replica_coords(mesh):
    """``(num_replicas, rank)`` of this process on the mesh's data axis,
    for the host-side batch sharder: the processes that share a data
    coordinate feed identical rows. A port mesh is one process per
    device, so this is ``mesh.data``'s size and coordinate; on a two-tier
    mesh the composed ``(dcn, ici)`` axis's, ``d * ici + i``, as the JAX
    ``data_replica_coords`` collapses the leading pair."""
    return mesh.data.size, mesh.data.rank


def device_slice_map(devices: Sequence) -> Optional[List[int]]:
    """Per-device slice of ``devices`` (any subset of the local devices),
    or None when no slice topology exists: the emulated
    ``TPUMNIST_DCN_SLICES`` map, ``N`` contiguous equal blocks of the
    local device order (``utils/device.py::local_devices``), as the JAX
    package's emulated map cuts the world's device ids. A device's
    position in that order is its card index; the CPU's slots are one
    device repeated, so there a device's position in ``devices`` stands
    for it. Serving orders its mesh groups slice-major with this
    (``serve/programs.py::partition_groups``) and flags the groups that
    straddle slices.

    The JAX package reads real ``slice_index`` stamps first; a CUDA
    device carries none, so that branch has no counterpart here."""
    from pytorch_distributed_mnist_tpu_torch.utils.device import (
        local_devices,
    )

    devs = [resolve_device(d) for d in devices]
    if not devs:
        return None
    try:
        n_slices = _env_slices()
    except ValueError:
        return None
    world = len(local_devices(devs[0].type))
    if n_slices is None or n_slices < 2 or world % n_slices:
        return None
    return [_emulated_slice(d.index if d.index is not None else i, world,
                            n_slices) for i, d in enumerate(devs)]
