"""Process meshes: the 1-D ``('data',)`` axis and the 2-D ``('data',
'expert')`` mesh of the JAX package's ``parallel/mesh.py::make_mesh``.

There a mesh is an array of devices with named axes; data parallelism is
``Mesh(devices, ('data',))`` and expert parallelism ``make_mesh(('data',
'expert'), shape=(n // ep, ep))``, the devices laid out row-major
(device ``i`` at data coordinate ``i // ep``, expert coordinate ``i %
ep``). Here every process drives one device, so an axis is a small
record: how many ranks it spans, this process's coordinate on it, its
device and the process group its collectives run over.

- :class:`DataAxis` is the 1-D mesh, and also each axis of the 2-D one.
- :class:`ExpertMesh` is the 2-D mesh: this rank's :class:`DataAxis` on
  ``data`` (the ranks that share its expert coordinate) and on
  ``expert`` (the ranks that share its data coordinate), each over a
  subgroup made with ``dist.new_group``. Every rank makes every subgroup,
  in the same order, as ``new_group`` requires.

Any other axis or shape (model, sequence, pipeline, the two-tier
``('dcn', 'ici')`` mesh) raises: those wait for ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
)

DATA_AXIS = "data"
EXPERT_AXIS = "expert"


@dataclass(frozen=True)
class DataAxis:
    """One mesh axis of ``size`` ranks, seen from coordinate ``rank`` on
    ``device``. ``group`` is the process group of its collectives, or
    None when it runs none (a single process, or a subgroup of one
    rank). ``name`` is the axis's name in the mesh."""

    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup]
    name: str = DATA_AXIS

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

    def axis(self, name: str) -> "DataAxis":
        if name != self.name:
            raise KeyError(f"mesh {self.shape} has no axis {name!r}")
        return self


@dataclass(frozen=True)
class ExpertMesh:
    """The ``('data', 'expert')`` mesh of ``size`` ranks: ``data`` and
    ``expert`` are this rank's two axes. The batch shards over ``data``
    (ranks of one expert group hold the same rows), every gradient and
    metric sums over ``data``, and the expert weights split over
    ``expert``."""

    size: int
    rank: int
    device: torch.device
    data: DataAxis
    expert: DataAxis

    @property
    def reduces(self) -> bool:
        return self.data.reduces or self.expert.reduces

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data.size, EXPERT_AXIS: self.expert.size}

    def axis(self, name: str) -> DataAxis:
        if name == DATA_AXIS:
            return self.data
        if name == EXPERT_AXIS:
            return self.expert
        raise KeyError(f"mesh {self.shape} has no axis {name!r}")


Mesh = Union[DataAxis, ExpertMesh]


def _subgroups(n: int, ep: int):
    """Every data subgroup (ranks ``e, e + ep, ...``) then every expert
    subgroup (ranks ``d * ep .. d * ep + ep - 1``), made on every rank in
    this order; returns this rank's two."""
    me = process_index()
    mine = {}
    for e in range(ep):
        ranks = list(range(e, n, ep))
        group = dist.new_group(ranks)
        if me in ranks:
            mine[DATA_AXIS] = group
    for d in range(n // ep):
        ranks = list(range(d * ep, (d + 1) * ep))
        group = dist.new_group(ranks)
        if me in ranks:
            mine[EXPERT_AXIS] = group
    return mine[DATA_AXIS], mine[EXPERT_AXIS]


def make_mesh(axes: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None,
              device: torch.device = torch.device("cpu")) -> Mesh:
    """The mesh over every process of the world (the process group's
    world, or this process alone when there is none), with this process
    on ``device``: the data axis, or with ``axes=('data', 'expert')`` and
    ``shape=(n // ep, ep)`` the expert mesh."""
    n = process_count()
    axes = tuple(axes)
    if axes == (DATA_AXIS, EXPERT_AXIS):
        if shape is None or len(shape) != 2 or shape[0] * shape[1] != n \
                or min(shape) < 1:
            raise ValueError(f"mesh shape {None if shape is None else tuple(shape)} "
                             f"!= device count {n} for axes {axes}")
        ep = int(shape[1])
        me = process_index()
        groups = ((None, None) if not dist.is_initialized()
                  else _subgroups(n, ep))
        data_group = groups[0] if n // ep > 1 else None
        expert_group = groups[1] if ep > 1 else None
        return ExpertMesh(
            size=n, rank=me, device=device,
            data=DataAxis(n // ep, me // ep, device, data_group, DATA_AXIS),
            expert=DataAxis(ep, me % ep, device, expert_group, EXPERT_AXIS))
    if axes != (DATA_AXIS,):
        raise NotImplementedError(
            f"mesh axes {axes}: the port has the ('data',) axis and the "
            f"('data', 'expert') mesh; model, sequence, pipeline and "
            f"two-tier axes wait for ROADMAP Queue 1 item 16")
    if shape is not None and tuple(shape) != (n,):
        raise NotImplementedError(
            f"mesh shape {tuple(shape)} over {n} process(es): the data axis "
            f"spans every process, one device each; other shapes wait for "
            f"ROADMAP Queue 1 item 16")
    group = dist.group.WORLD if dist.is_initialized() else None
    return DataAxis(size=n, rank=process_index(), device=device,
                    group=group)
