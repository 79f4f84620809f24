"""The port's sampler and loader (``data/sampler.py``, ``data/loader.py``)
against the JAX package's, index for index: every seed and epoch gives
the same shuffle, train drops the ragged tail, eval pads and masks it."""

import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.loader import (
    MNISTDataLoader as JaxLoader,
)
from pytorch_distributed_mnist_tpu.data.sampler import (
    DistributedShardSampler as JaxSampler,
)
from pytorch_distributed_mnist_tpu_torch.data.loader import (
    MNISTDataLoader,
    to_device,
)
from pytorch_distributed_mnist_tpu_torch.data.mnist import (
    load_dataset,
    normalize_images,
    synthetic_dataset,
    write_idx,
)
from pytorch_distributed_mnist_tpu_torch.data.sampler import (
    DistributedShardSampler,
)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n,replicas", [(101, 1), (101, 4), (96, 3)])
def test_sampler_equals_jax_for_every_rank_seed_and_epoch(n, replicas,
                                                          shuffle, drop_last):
    for rank in range(replicas):
        for seed in (0, 5):
            ours = DistributedShardSampler(n, replicas, rank, shuffle, seed,
                                           drop_last)
            ref = JaxSampler(n, replicas, rank, shuffle, seed, drop_last)
            assert len(ours) == len(ref)
            for epoch in (0, 1, 7):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                idx, valid = ours.indices_and_mask()
                want_idx, want_valid = ref.indices_and_mask()
                np.testing.assert_array_equal(idx, want_idx)
                np.testing.assert_array_equal(valid, want_valid)
                np.testing.assert_array_equal(ours.indices_and_mask(epoch + 1)[0],
                                              ref.indices_and_mask(epoch + 1)[0])


def test_sampler_refuses_a_rank_outside_the_world():
    with pytest.raises(ValueError, match="out of range"):
        DistributedShardSampler(10, num_replicas=2, rank=2)


def _data(n, seed=0):
    images, labels = synthetic_dataset(n, seed=seed)
    return normalize_images(images), labels


@pytest.mark.parametrize("batch", [16, 7])
@pytest.mark.parametrize("train", [True, False])
def test_loader_batches_equal_jax_index_for_index(train, batch):
    images, labels = _data(50)
    ours = MNISTDataLoader(images, labels, batch_size=batch, train=train,
                           seed=3)
    ref = JaxLoader(images, labels, batch_size=batch, train=train, seed=3)
    assert len(ours) == len(ref) == ref.steps_per_epoch
    for epoch in (0, 1):
        ours.set_sample_epoch(epoch)
        ref.set_sample_epoch(epoch)
        idx, mask = ours.epoch_ticks()
        want_idx, want_mask = ref.epoch_ticks()
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(mask, want_mask)
        got = list(ours)
        want = list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a["image"].tobytes() == b["image"].tobytes()
            np.testing.assert_array_equal(a["label"], b["label"])
            np.testing.assert_array_equal(a["mask"], b["mask"])
    if train:
        assert len(ours) == 50 // batch  # the ragged tail is dropped
    else:
        # Eval pads the tail by wrapping and masks the padding out.
        _, mask = ours.epoch_ticks()
        assert mask.sum() == 50 and mask.size == len(ours) * batch


def test_to_device_gives_torch_dtypes():
    images, labels = _data(8)
    loader = MNISTDataLoader(images, labels, batch_size=4, train=False)
    batch = to_device(next(iter(loader)), torch.device("cpu"))
    assert batch["image"].dtype == torch.float32
    assert batch["image"].shape == (4, 28, 28, 1)
    assert batch["label"].dtype == torch.int64  # torch's index type
    assert batch["mask"].dtype == torch.float32


def test_load_dataset_reads_idx_files_and_falls_back(tmp_path):
    from pytorch_distributed_mnist_tpu.data import mnist as ref

    images, labels = synthetic_dataset(6, seed=2)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    write_idx(str(raw / "train-images-idx3-ubyte"), images)
    write_idx(str(raw / "train-labels-idx1-ubyte"), labels)
    got = load_dataset(str(tmp_path), "mnist", train=True)
    want = ref.load_dataset(str(tmp_path), "mnist", train=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # The test split is missing: synthesized from its own seed, as the
    # reference does, or refused.
    got = load_dataset(str(tmp_path), "mnist", train=False,
                       synthetic_test_size=5, seed=1)
    want = ref.load_dataset(str(tmp_path), "mnist", train=False,
                            synthetic_test_size=5, seed=1)
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(FileNotFoundError):
        load_dataset(str(tmp_path), "mnist", train=False,
                     synthesize_if_missing=False)
