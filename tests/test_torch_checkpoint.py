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


# -- full train states (params, optimizer state, step) ----------------------

def _port_state(model="cnn", optimizer="adam_pallas", seed=0):
    import torch

    from pytorch_distributed_mnist_tpu_torch.models import (
        get_model as port_get_model,
    )
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state as port_create_train_state,
    )

    return port_create_train_state(port_get_model(model), seed,
                                   torch.device("cpu"), optimizer=optimizer)


def _port_step(state, n=2):
    """One optimizer step of the port on a tiny synthetic batch, so every
    moment, count and the step are nonzero."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.data.mnist import (
        normalize_images,
        synthetic_dataset,
    )
    from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

    images, labels = synthetic_dataset(n, seed=9)
    train_step(state, {"image": torch.from_numpy(normalize_images(images)),
                       "label": torch.from_numpy(labels.astype(np.int64)),
                       "mask": torch.ones(n)})


@pytest.mark.parametrize("model,optimizer", [("cnn", "adam_pallas"),
                                             ("linear", "adam"),
                                             ("linear", "sgd")])
def test_port_leaf_order_is_the_jax_flatten_order(model, optimizer):
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_leaves,
    )

    jstate = create_train_state(jax_get_model(model), jax.random.key(0),
                                optimizer=optimizer)
    want = [(name, np.shape(leaf)) for name, leaf in
            jax_ckpt._leaves_with_names(jax_ckpt._state_tree(jstate))]
    got = [(name, tuple(t.shape)) for name, t in
           state_leaves(_port_state(model, optimizer))]
    assert [n for n, _ in got] == [n for n, _ in want]
    if model == "cnn":
        assert len(got) == 32  # 8 params, 8 mu, 8 nu, 5 hypers, 2 counts, step


def test_port_full_state_checkpoint_loads_in_jax(tmp_path):
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_to_jax,
    )

    state = _port_state()
    _port_step(state)
    state.step.fill_(5)
    state.with_learning_rate(3e-4)
    path = port.save_checkpoint(state, epoch=3, best_acc=0.25, is_best=True,
                                directory=str(tmp_path))
    template = create_train_state(jax_get_model("cnn"), jax.random.key(1),
                                  optimizer="adam_pallas")
    restored, epoch, best = jax_ckpt.load_checkpoint(path, template)
    assert (epoch, best) == (4, 0.25)
    got = dict(jax_ckpt._leaves_with_names(jax_ckpt._state_tree(restored)))
    want = state_to_jax(state)
    assert len(want) == len(got) == 32
    for name, arr in want:
        leaf = np.asarray(got[name])
        assert leaf.dtype == arr.dtype, name
        np.testing.assert_array_equal(leaf, arr, err_msg=name)
    assert float(restored.opt_state.hyperparams["learning_rate"]) == \
        np.float32(3e-4)
    assert int(restored.step) == 5
    assert int(restored.opt_state.inner_state[0].count) == 1
    # model_best is a byte copy of the epoch's file.
    with open(path, "rb") as a, open(tmp_path / "model_best.npz", "rb") as b:
        assert a.read() == b.read()


def test_jax_full_state_checkpoint_resumes_in_port(tmp_path):
    import jax.numpy as jnp
    import torch

    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_to_jax,
    )

    jstate = create_train_state(jax_get_model("cnn"), jax.random.key(2),
                                optimizer="adam_pallas")
    adam = jstate.opt_state.inner_state[0]
    adam = adam._replace(
        count=jnp.asarray(4, jnp.int32),
        mu=jax.tree_util.tree_map(lambda p: p * 0.1, jstate.params),
        nu=jax.tree_util.tree_map(lambda p: p * p * 0.01, jstate.params))
    hyper = dict(jstate.opt_state.hyperparams)
    hyper["learning_rate"] = jnp.asarray(2e-4, jnp.float32)
    jstate = jstate.replace(
        step=jnp.asarray(7, jnp.int32),
        opt_state=jstate.opt_state._replace(
            count=jnp.asarray(4, jnp.int32), hyperparams=hyper,
            inner_state=(adam,) + tuple(jstate.opt_state.inner_state[1:])))
    path = jax_ckpt.save_checkpoint(jstate, epoch=1, best_acc=0.5,
                                    is_best=False, directory=str(tmp_path))
    state = _port_state(seed=3)
    _, start_epoch, best = port.load_checkpoint(path, state)
    assert (start_epoch, best) == (2, 0.5)
    want = dict(jax_ckpt._leaves_with_names(jax_ckpt._state_tree(jstate)))
    for name, arr in state_to_jax(state):
        np.testing.assert_array_equal(arr, np.asarray(want[name]),
                                      err_msg=name)
    conv1 = dict(state.model.named_parameters())["conv1.weight"]
    np.testing.assert_array_equal(
        state.optimizer.state[conv1]["mu"].numpy(),
        np.asarray(adam.mu["params"]["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    assert int(state.step) == 7 and state.learning_rate == np.float32(2e-4)
    # And it trains on from there: the counts advance from the file's.
    _port_step(state)
    assert int(state.step) == 8
    assert int(state.optimizer.inner_count) == 5
    assert torch.all(torch.isfinite(conv1))


def test_mismatched_checkpoint_is_refused_untouched(tmp_path):
    path = port.save_checkpoint(_port_state("linear"), epoch=0, best_acc=0.0,
                                is_best=False, directory=str(tmp_path))
    state = _port_state("cnn")
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    with pytest.raises(ValueError, match="mismatch") as info:
        port.load_checkpoint(path, state)
    assert not port.is_corrupt_checkpoint_error(info.value)
    for n, p in state.model.named_parameters():
        assert np.array_equal(p.detach().numpy(), before[n].numpy())
    sgd = _port_state("linear", "sgd")
    with pytest.raises(ValueError, match="mismatch"):
        port.load_checkpoint(path, sgd)


def test_keep_last_window_and_model_best(tmp_path):
    state = _port_state("linear")
    best_epoch = None
    for epoch, is_best in enumerate([True, False, True, False]):
        port.save_checkpoint(state, epoch=epoch, best_acc=0.1 * epoch,
                             is_best=is_best, directory=str(tmp_path),
                             keep_last=1)
        if is_best:
            best_epoch = epoch
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint_2.npz", "checkpoint_3.npz", "model_best.npz"]
    assert port._read_meta(str(tmp_path / "model_best.npz"))["epoch"] == \
        best_epoch + 1
    # The window is the JAX package's: keyed to the latest published epoch.
    for epoch in (0, 5, 9):
        (tmp_path / f"checkpoint_{epoch}.npz").write_bytes(b"x")
    twin = tmp_path / "twin"
    twin.mkdir()
    for name in os.listdir(tmp_path):
        if name.startswith("checkpoint_"):
            (twin / name).write_bytes(b"x")
    port.prune_checkpoints(str(tmp_path), 3)
    jax_ckpt.prune_checkpoints(str(twin), 3)
    assert sorted(n for n in os.listdir(tmp_path) if n != "twin") == \
        sorted(os.listdir(twin)) + ["model_best.npz"]


def test_resume_auto_quarantines_a_corrupt_latest_file(tmp_path, capsys):
    import argparse

    from pytorch_distributed_mnist_tpu_torch import cli

    state = _port_state("linear")
    _port_step(state)
    port.save_checkpoint(state, epoch=0, best_acc=0.5, is_best=False,
                         directory=str(tmp_path))
    (tmp_path / "checkpoint_1.npz").write_bytes(b"torn write")
    args = argparse.Namespace(resume="auto", checkpoint_dir=str(tmp_path))
    fresh = _port_state("linear", seed=5)
    resumed, start_epoch, best, path = cli._resume(args, fresh)
    assert path == str(tmp_path / "checkpoint_0.npz")
    assert (start_epoch, best) == (1, 0.5)
    assert int(resumed.step) == 1
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_0.npz",
                                            "checkpoint_1.npz.corrupt"]
    assert "quarantined corrupt checkpoint" in capsys.readouterr().out
    # An empty directory trains fresh.
    empty = argparse.Namespace(resume="auto",
                               checkpoint_dir=str(tmp_path / "none"))
    assert cli._resume(empty, fresh)[1:] == (0, 0.0, "")
