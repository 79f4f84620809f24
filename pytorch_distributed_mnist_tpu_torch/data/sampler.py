"""Distributed shard sampler.

A copy of ``pytorch_distributed_mnist_tpu/data/sampler.py`` (host-only
numpy index arithmetic; the port imports nothing of the JAX package).
Each of ``num_replicas`` participants gets a disjoint shard, padded by
wrapping from the front so every replica sees the same number of samples;
``set_epoch(epoch)`` reshuffles with ``default_rng(seed + epoch)``, so a
seed and an epoch give the same indices in both packages. Torch's
``DistributedSampler`` orders differently and is not used.
"""

from __future__ import annotations

import numpy as np


class DistributedShardSampler:
    """Disjoint per-replica index shards with epoch-seeded reshuffle."""

    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)  # ceil
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for ``epoch``."""
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        """This replica's index shard for the current epoch."""
        return self.indices_and_mask()[0]

    def indices_and_mask(self, epoch: int | None = None):
        """(indices, valid) for this replica; ``valid`` is 0.0 on pad
        entries (wrap-padding when the dataset size is not divisible by
        ``num_replicas``). ``epoch`` overrides ``self.epoch`` without
        mutating it."""
        if epoch is None:
            epoch = self.epoch
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        valid = np.ones(self.dataset_len, np.float32)
        if self.drop_last:
            order = order[: self.total_size]
            valid = valid[: self.total_size]
        elif self.total_size > self.dataset_len:
            pad = self.total_size - self.dataset_len
            order = np.concatenate([order, order[:pad]])
            valid = np.concatenate([valid, np.zeros(pad, np.float32)])
        sl = slice(self.rank, self.total_size, self.num_replicas)
        return order[sl], valid[sl]

    def __len__(self) -> int:
        return self.num_samples
