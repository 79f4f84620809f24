"""The data axis: the 1-D ``('data',)`` case of the JAX package's
``parallel/mesh.py::make_mesh``.

There a mesh is an array of devices with named axes; data parallelism is
``Mesh(devices, ('data',))``. Here every process drives one device, so
the data axis is a small record: how many ranks it spans, this process's
rank, its device and the process group its collectives run over. Any
other axis or shape (model, sequence, expert, pipeline, the two-tier
``('dcn', 'ici')`` mesh) raises: those wait for ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
)

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataAxis:
    """The ``('data',)`` axis of ``size`` ranks, seen from rank ``rank``
    on ``device``. ``group`` is the process group of its collectives, or
    None for a single process with no group, which runs none."""

    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup]

    @property
    def reduces(self) -> bool:
        """True when steps on this axis run collectives."""
        return self.group is not None

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as the JAX CLI prints a mesh."""
        return {DATA_AXIS: self.size}


def make_mesh(axes: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None,
              device: torch.device = torch.device("cpu")) -> DataAxis:
    """The data axis over every process of the world (the process group's
    world, or this process alone when there is none), with this process on
    ``device``."""
    if tuple(axes) != (DATA_AXIS,):
        raise NotImplementedError(
            f"mesh axes {tuple(axes)}: the port has the 1-D ('data',) axis "
            f"only; model, sequence, expert, pipeline and two-tier axes "
            f"wait for ROADMAP Queue 1 item 16")
    n = process_count()
    if shape is not None and tuple(shape) != (n,):
        raise NotImplementedError(
            f"mesh shape {tuple(shape)} over {n} process(es): the data axis "
            f"spans every process, one device each; other shapes wait for "
            f"ROADMAP Queue 1 item 16")
    group = dist.group.WORLD if dist.is_initialized() else None
    return DataAxis(size=n, rank=process_index(), device=device,
                    group=group)
