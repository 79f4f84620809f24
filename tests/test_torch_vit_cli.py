"""Two synthetic epochs of ``vit --attention flash`` through both command
lines from one npz, on the CPU. The JAX side runs its Pallas kernels in
interpret mode and takes most of a minute, so this file holds that one
run and what reads its checkpoints (``--dist loadfile`` runs it beside
the other files)."""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.cli import build_parser as jax_parser
from pytorch_distributed_mnist_tpu.cli import run as jax_run
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.ops import loss as jax_loss
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import TrainState as JaxState
from pytorch_distributed_mnist_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from pytorch_distributed_mnist_tpu_torch.cli import build_parser, run
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.ops import loss as port_loss
from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")

_COMMON = ["--dataset", "synthetic", "--model", "vit", "--attention", "flash",
           "--dtype", "f32", "--loss", "fused", "--optimizer", "adam_pallas",
           "--batch-size", "64", "--synthetic-train-size", "512",
           "--synthetic-test-size", "200", "--epochs", "2", "--seed", "0"]


@pytest.fixture
def fused_loss():
    """Both packages' loss switch is process-global: put back afterwards."""
    try:
        yield
    finally:
        jax_loss.set_loss_impl("xla")
        port_loss.set_loss_impl("xla")


def _port_state():
    return create_train_state(
        get_model("vit", compute_dtype=torch.float32,
                  attention_fn=flash_attention),
        seed=3, device=CPU, optimizer="adam_pallas")


def test_two_vit_flash_epochs_match_jax_cli_from_one_npz(tmp_path,
                                                          fused_loss):
    # One shared starting point: the port's fresh state, written as a
    # checkpoint whose meta epoch is 0, so both CLIs start at epoch 0.
    shared = port_ckpt.save_checkpoint(_port_state(), epoch=-1, best_acc=0.0,
                                       is_best=False,
                                       directory=str(tmp_path / "init"))
    want = jax_run(jax_parser().parse_args(_COMMON + [
        "--resume", shared, "--checkpoint-dir", str(tmp_path / "jax"),
        "--trainer-mode", "stepwise", "--no-precompile"]))
    port_dir = tmp_path / "port"
    got = run(build_parser().parse_args(_COMMON + [
        "--resume", shared, "--checkpoint-dir", str(port_dir),
        "--device", "cpu"]))
    assert got["epochs_run"] == want["epochs_run"] == 2
    # float32 on both sides, but the JAX side shards each batch over 8
    # virtual CPU devices and sums in another order; over 16 Adam steps
    # the losses drift apart to rtol 1e-4, and accuracy agrees to one
    # example.
    for a, b in zip(got["history"], want["history"]):
        assert a["epoch"] == b["epoch"]
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(a["test_loss"], b["test_loss"], rtol=1e-4)
        assert abs(a["train_acc"] - b["train_acc"]) <= 1 / 512
        assert abs(a["test_acc"] - b["test_acc"]) <= 1 / 200

    # Each package's last 101-leaf checkpoint loads in the other's
    # template (the JAX one with a jitted init, as create_train_state
    # builds it otherwise).
    for side in ("port", "jax"):
        _, leaves = port_ckpt.read_checkpoint_arrays(
            str(tmp_path / side / "checkpoint_1.npz"))
        assert len(leaves) == 101, side
    jmodel = jax_get_model("vit")
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  np.zeros((1, 28, 28, 1), np.float32))
    tx = jax_make_optimizer(1e-3, "adam_pallas", 0.9, 1e-4)
    jstate = JaxState(step=np.zeros((), np.int32), params=params,
                      opt_state=tx.init(params), apply_fn=jmodel.apply,
                      tx=tx)
    _, epoch, _ = jax_ckpt.load_checkpoint(
        str(port_dir / "checkpoint_1.npz"), jstate)
    assert epoch == 2
    _, epoch, _ = port_ckpt.load_checkpoint(
        str(tmp_path / "jax" / "checkpoint_1.npz"), _port_state())
    assert epoch == 2

    # Resume inside the port repeats epoch 1 bit for bit.
    resumed = run(build_parser().parse_args(_COMMON + [
        "--resume", str(port_dir / "checkpoint_0.npz"), "--checkpoint-dir",
        str(tmp_path / "resumed"), "--device", "cpu"]))
    assert resumed["start_epoch"] == 1 and resumed["epochs_run"] == 1
    a, b = got["history"][1], resumed["history"][0]
    for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
        assert a[key] == b[key], key
    _, leaves_a = port_ckpt.read_checkpoint_arrays(
        str(port_dir / "checkpoint_1.npz"))
    _, leaves_b = port_ckpt.read_checkpoint_arrays(
        str(tmp_path / "resumed" / "checkpoint_1.npz"))
    assert list(leaves_a) == list(leaves_b)
    for name in leaves_a:
        np.testing.assert_array_equal(leaves_a[name], leaves_b[name])
