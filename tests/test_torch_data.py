"""The port's MNIST data IO (``data/mnist.py``) against the JAX
package's: the IDX format both ways, the seeded synthetic dataset and the
reference normalize, all bitwise."""

import gzip
import shutil

import numpy as np
import pytest

from pytorch_distributed_mnist_tpu.data import mnist as ref
from pytorch_distributed_mnist_tpu_torch.data import mnist as port

pytestmark = pytest.mark.serve


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_dataset_and_normalize_bitwise(seed):
    images, labels = port.synthetic_dataset(40, seed=seed)
    want_images, want_labels = ref.synthetic_dataset(40, seed=seed)
    assert images.dtype == np.uint8 and images.shape == (40, 28, 28)
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(labels, want_labels)
    got = port.normalize_images(images)
    assert got.dtype == np.float32 and got.shape == (40, 28, 28, 1)
    assert got.tobytes() == ref.normalize_images(images).tobytes()


@pytest.mark.parametrize("gz", [False, True])
def test_idx_round_trips_across_packages(tmp_path, gz):
    images, _ = port.synthetic_dataset(5, seed=1)
    path = str(tmp_path / ("images.idx" + (".gz" if gz else "")))
    if gz:
        ref.write_idx(path[:-3], images)
        with open(path[:-3], "rb") as src, gzip.open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)
    else:
        port.write_idx(path, images)
        np.testing.assert_array_equal(ref.parse_idx(path), images)
    np.testing.assert_array_equal(port.parse_idx(path), images)


def test_parse_idx_refuses_other_files(tmp_path):
    bad = tmp_path / "bad.idx"
    bad.write_bytes(b"\x01\x02\x03\x04rest")
    with pytest.raises(ValueError, match="not an IDX file"):
        port.parse_idx(str(bad))
