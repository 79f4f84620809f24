"""The port's checkpoint watcher (``serve/reload.py``) against the JAX
watcher's retry rules: a sharded directory read through a stale NFS view
(``missing shards``) is absence, not damage, so the same path is retried
at the next poll. Twin of
``tests/test_serve_reload.py::test_stale_nfs_missing_shards_retries``."""

import pytest
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.serve import engine as engine_mod
from pytorch_distributed_mnist_tpu_torch.serve.reload import CheckpointWatcher
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)

pytestmark = pytest.mark.serve


class _Installs:
    def __init__(self):
        self.epochs = []

    def __call__(self, params, epoch, path):
        self.epochs.append(epoch)
        return True


def _publish(directory, epoch, layout):
    state = create_train_state(get_model("linear",
                                         compute_dtype=torch.float32),
                               seed=10, device=torch.device("cpu"))
    return port_ckpt.save_checkpoint(state, epoch=epoch, best_acc=0.0,
                                     is_best=False, directory=str(directory),
                                     layout=layout)


@pytest.mark.parametrize("layout", ["npz", "sharded"])
def test_stale_nfs_missing_shards_retries(tmp_path, monkeypatch, layout):
    _publish(tmp_path, 0, layout)
    installs = _Installs()
    watcher = CheckpointWatcher(str(tmp_path), "linear", installs)
    calls = {"n": 0}
    real_load = engine_mod.load_params_for_serving

    def stale_then_ok(path, template):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError(
                f"{path}: leaf params is missing shards (0/10 elements "
                f"present) — incomplete save?")
        return real_load(path, template)

    monkeypatch.setattr(engine_mod, "load_params_for_serving", stale_then_ok)
    polls = (watcher.poll_once(), watcher.poll_once())
    assert polls == (False, True)  # same path, next poll: the view settled
    assert calls["n"] == 2
    assert installs.epochs == [0]


def test_a_shape_mismatch_stays_permanent(tmp_path, monkeypatch):
    """The retry is for the missing-shards view only: any other
    ``ValueError`` (here another model's checkpoint) is permanent for its
    file, as before."""
    _publish(tmp_path, 0, "npz")
    installs = _Installs()
    watcher = CheckpointWatcher(str(tmp_path), "cnn", installs)
    assert (watcher.poll_once(), watcher.poll_once()) == (False, False)
    assert installs.epochs == []
