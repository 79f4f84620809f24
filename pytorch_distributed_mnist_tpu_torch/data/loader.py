"""Batch loading for one process's shard.

Counterpart of ``pytorch_distributed_mnist_tpu/data/loader.py``'s
``MNISTDataLoader`` without its device-array assembly: the loader yields
numpy batches of this process's shard (``epoch_ticks`` + ``host_batch``,
the same index space as the reference's) or a whole epoch stacked
(``stacked_epoch``, the scan trainer's), and :func:`to_device` moves one
batch to the card from pinned host memory. Train batches drop the ragged
tail (``drop_last``); eval batches pad it by wrapping and mask the padding
out.

``batch_size`` is the global batch: each of ``num_replicas`` processes
takes ``batch_size / num_replicas`` rows a step (``local_batch_size``),
from its disjoint sampler shard. The train loader shards by default; the
eval loader shards when asked (``shard=True``, the CLI's choice in a world
of more than one), its wrap padding masked so every example counts once.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.data.sampler import (
    DistributedShardSampler,
)


class MNISTDataLoader:
    """Iterates ``{"image", "label", "mask"}`` numpy batches over this
    process's shard."""

    def __init__(
        self,
        images: np.ndarray,  # float32 (N, 28, 28, 1), already normalized
        labels: np.ndarray,  # int (N,)
        batch_size: int,
        train: bool = True,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 0,
        shard: Optional[bool] = None,
        drop_last: Optional[bool] = None,
    ) -> None:
        if batch_size % num_replicas != 0:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"{num_replicas} processes"
            )
        self.images = images
        self.labels = np.asarray(labels, np.int64)  # torch's index type
        self.global_batch_size = batch_size
        self.local_batch_size = batch_size // num_replicas
        self.train = train
        # The JAX loader's default: shard train, replicate eval unless
        # asked (the CLI shards eval in a world of more than one).
        shard = train if shard is None else shard
        self.drop_last = train if drop_last is None else drop_last
        self.sampler = DistributedShardSampler(
            dataset_len=images.shape[0],
            num_replicas=num_replicas if shard else 1,
            rank=rank if shard else 0, shuffle=train, seed=seed)

    def set_sample_epoch(self, epoch: int) -> None:
        """Reseed this epoch's shuffle (the reference's name)."""
        self.sampler.set_epoch(epoch)

    @property
    def steps_per_epoch(self) -> int:
        n = len(self.sampler)
        return (n // self.local_batch_size if self.drop_last
                else -(-n // self.local_batch_size))

    def epoch_ticks(self, epoch: Optional[int] = None):
        """``(steps, batch)`` index matrix and 0/1 validity mask of an
        epoch; a ragged tail (eval) wraps from the front and is masked."""
        idx, valid = self.sampler.indices_and_mask(epoch)
        steps = self.steps_per_epoch
        need = steps * self.local_batch_size
        mask = np.ones(need, np.float32)
        mask[: min(idx.size, need)] = valid[:need]
        if need > idx.size:
            mask[idx.size:] = 0.0
            idx = np.concatenate([idx, idx[: need - idx.size]])
        shape = (steps, self.local_batch_size)
        return idx[:need].reshape(shape), mask.reshape(shape)

    def host_batch(self, row: np.ndarray, mrow: np.ndarray) \
            -> Dict[str, np.ndarray]:
        """One batch's host rows for an ``epoch_ticks`` row."""
        return {"image": self.images[row], "label": self.labels[row],
                "mask": mrow}

    def stacked_epoch(self, epoch: Optional[int] = None,
                      out: Optional[Dict[str, np.ndarray]] = None) \
            -> Dict[str, np.ndarray]:
        """The whole epoch as ``{'image': (S, B, ...), 'label': (S, B),
        'mask': (S, B)}``, the batches of ``__iter__`` stacked: what the
        scan trainer stages on the device. ``epoch`` gathers that epoch's
        shuffle without touching the sampler, so a thread can gather the
        next epoch while this one trains. ``out`` (arrays of those shapes
        and dtypes, such as pinned host buffers) receives the gather and
        is returned."""
        m, mask = self.epoch_ticks(epoch)
        flat = m.reshape(-1)
        if out is None:
            return {"image": self.images[flat].reshape(
                        m.shape + self.images.shape[1:]),
                    "label": self.labels[flat].reshape(m.shape),
                    "mask": mask}
        # The sampler's indices are in range; mode="clip" lets np.take
        # write straight into ``out`` (mode="raise" buffers a copy).
        np.take(self.images, flat, axis=0, mode="clip",
                out=out["image"].reshape((-1,) + self.images.shape[1:]))
        np.take(self.labels, flat, mode="clip", out=out["label"].reshape(-1))
        out["mask"][...] = mask
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        m, mask = self.epoch_ticks()
        for row, mrow in zip(m, mask):
            yield self.host_batch(row, mrow)

    def __len__(self) -> int:
        return self.steps_per_epoch


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``. For the card each array is
    copied into pinned host memory and sent with ``non_blocking=True``, so
    the copy is queued on the current stream behind the previous step's
    work instead of stalling the host."""
    out = {}
    for key, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out
