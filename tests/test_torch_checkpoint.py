"""The port's checkpoint IO (``train/checkpoint.py``) against JAX
checkpoints of format version 1."""

import os

import jax
import numpy as np
import pytest

from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import create_train_state
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port

pytestmark = pytest.mark.serve


@pytest.fixture(scope="module")
def jax_state():
    return create_train_state(jax_get_model("cnn"), jax.random.key(0))


def test_jax_checkpoint_loads_with_equal_params_and_epoch(tmp_path,
                                                          jax_state):
    path = jax_ckpt.save_checkpoint(jax_state, epoch=2, best_acc=0.5,
                                    is_best=False, directory=str(tmp_path))
    flat, epoch = port.load_params(path)
    assert epoch == 2  # meta stores the resume epoch, 3
    assert port._read_meta(path)["epoch"] == 3
    # Only the ['params'] leaves; opt_state and step are ignored.
    assert all(k.startswith("['params']['params']") for k in flat)
    assert len(flat) == 8
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        {"params": jax_state.params})
    for key_path, leaf in leaves:
        np.testing.assert_array_equal(flat[jax.tree_util.keystr(key_path)],
                                      np.asarray(leaf))
    params = params_from_jax("cnn", flat)
    assert params["fc1.kernel"].shape == (12544, 128)


def test_port_writer_round_trips_and_publishes_atomically(tmp_path):
    params = init_params("linear", 1)
    path = port.save_params_checkpoint(params_to_jax(params), epoch=4,
                                       directory=str(tmp_path))
    assert os.path.basename(path) == "checkpoint_4.npz"
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_4.npz"]  # no .tmp
    flat, epoch = port.load_params(path)
    assert epoch == 4
    back = params_from_jax("linear", flat)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    meta = port._read_meta(path)
    assert meta["format_version"] == 1 and meta["epoch"] == 5
    # The JAX reader's view of the same file agrees.
    jmeta, arrays = jax_ckpt.read_checkpoint_arrays(path)
    assert jmeta["leaf_names"] == meta["leaf_names"]
    assert len(arrays) == len(params)


def test_latest_checkpoint_picks_the_highest_epoch(tmp_path):
    assert port.latest_checkpoint(str(tmp_path / "missing")) is None
    assert port.latest_checkpoint(str(tmp_path)) is None
    flat = params_to_jax(init_params("linear", 0))
    for epoch in (2, 10, 9):
        port.save_params_checkpoint(flat, epoch=epoch,
                                    directory=str(tmp_path))
    (tmp_path / "checkpoint_11.npz.tmp").write_bytes(b"half")
    (tmp_path / "model_best.npz").write_bytes(b"")
    want = str(tmp_path / "checkpoint_10.npz")
    assert port.latest_checkpoint(str(tmp_path)) == want
    assert jax_ckpt.latest_checkpoint(str(tmp_path)) == want
    assert [e for e, _ in port._epoch_checkpoints(str(tmp_path))] == \
        [2, 9, 10]


def test_other_format_versions_and_damaged_files_are_refused(tmp_path):
    flat = params_to_jax(init_params("linear", 0))
    path = port.save_params_checkpoint(flat, epoch=0,
                                       directory=str(tmp_path))
    meta, arrays = port.read_checkpoint_arrays(path)
    assert meta["format_version"] == 1 and len(arrays) == 2  # fc kernel, bias
    bad = tmp_path / "checkpoint_1.npz"
    bad.write_bytes(b"not a zip")
    with pytest.raises(Exception) as info:
        port.load_params(str(bad))
    assert port.is_corrupt_checkpoint_error(info.value)
