"""Gradient accumulation in the port (``--grad-accum N``,
``train/steps.py::train_step`` with ``accum``), on the CPU against the
JAX package's ``make_accum_train_step_fn`` (through ``make_train_step``)
and ``make_train_epoch(grad_accum=N)``.

Both sides start from one npz and take one global batch whose masks hold
zeros on both sides of every micro-batch boundary: the per-example sums
and the one division by the real count must give the full batch's
gradient for any mask. ``sgd``'s step is linear in the gradient, so its
params hold the gradient itself to the bound; float32 on both sides, the
gradients summed in another order: atol 1e-6, as the JAX package's own
bound for the auto step. Also: scan against stepwise bit for bit, a
2-rank world, and the JAX CLI's refusals.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import (
    normalize_images,
    synthetic_dataset,
)
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_epoch as jax_make_train_epoch,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.data.loader import MNISTDataLoader
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    make_train_epoch,
    train_step,
)
from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 32
# Masked rows around the micro-batch boundaries of N = 2 (16) and N = 4
# (8, 16, 24), and the last row.
MASKED = (7, 8, 15, 16, 23, 31)


def _mask(steps=None):
    mask = np.ones(BATCH, np.float32)
    mask[list(MASKED)] = 0.0
    return mask if steps is None else np.tile(mask, (steps, 1))


def _images(n, seed=11):
    images, labels = synthetic_dataset(n, seed=seed)
    return normalize_images(images), labels.astype(np.int64)


def _jax_state(model, tmp_path):
    """A JAX sgd state and the npz it was saved to."""
    jstate = jax_create_train_state(
        jax_get_model(model, compute_dtype=jnp.float32), jax.random.key(0),
        optimizer="sgd")
    path = jax_ckpt.save_checkpoint(jstate, epoch=-1, best_acc=0.0,
                                    is_best=False,
                                    directory=str(tmp_path / model))
    return jstate, path


def _port_state(model, path):
    state = create_train_state(get_model(model, compute_dtype=torch.float32),
                               3, CPU, optimizer="sgd")
    port_ckpt.load_checkpoint(path, state)
    return state


def _assert_params_close(state, jparams, atol):
    want = dict(jax_ckpt._leaves_with_names({"params": jparams}))
    got = {k: v for k, v in port_ckpt.state_to_jax(state)
           if k.startswith("['params']")}
    assert got.keys() == want.keys()
    for name, value in got.items():
        np.testing.assert_allclose(value, np.asarray(want[name]), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("model", ["linear", "cnn"])
@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_matches_jax(model, accum, tmp_path):
    images, labels = _images(BATCH)
    jstate, path = _jax_state(model, tmp_path)
    jstate, jm = jax_make_train_step(grad_accum=accum)(jstate, {
        "image": jnp.asarray(images), "label": jnp.asarray(labels, jnp.int32),
        "mask": jnp.asarray(_mask())})
    state = _port_state(model, path)
    ms = train_step(state, {"image": torch.from_numpy(images),
                            "label": torch.from_numpy(labels),
                            "mask": torch.from_numpy(_mask())}, accum=accum)
    _assert_params_close(state, jstate.params, atol=1e-6)
    # The counts exactly; the loss sum (per micro-batch means weighted
    # back by their counts) to float32 rounding of another order.
    assert (float(ms.correct), float(ms.count)) == \
        (float(jm.correct), float(jm.count)) == (float(ms.correct), 26.0)
    np.testing.assert_allclose(float(ms.loss_sum), float(jm.loss_sum),
                               rtol=1e-5)


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_scan_epoch_matches_jax_make_train_epoch(accum,
                                                             tmp_path):
    steps = 3
    images, labels = _images(steps * BATCH, seed=12)
    staged = {"image": images.reshape((steps, BATCH) + images.shape[1:]),
              "label": labels.reshape(steps, BATCH), "mask": _mask(steps)}
    jstate, path = _jax_state("linear", tmp_path)
    jstate, jm = jax_make_train_epoch(grad_accum=accum)(jstate, {
        **{k: jnp.asarray(v) for k, v in staged.items()},
        "label": jnp.asarray(staged["label"], jnp.int32)})
    state = _port_state("linear", path)
    epoch = make_train_epoch(state, grad_accum=accum)
    assert epoch.program.accum == accum
    ms = epoch({k: torch.from_numpy(v) for k, v in staged.items()})
    # Three sgd steps at the bound of one (the momentum carries each
    # step's rounding into the next, far below 1e-6 here).
    _assert_params_close(state, jstate.params, atol=1e-6)
    assert float(ms.count) == float(jm.count) == steps * 26.0
    assert float(ms.correct) == float(jm.correct)
    np.testing.assert_allclose(float(ms.loss_sum), float(jm.loss_sum),
                               rtol=1e-5)
    assert int(state.step) == steps


def test_full_masks_take_the_full_batch_step():
    # N micro-batches of full masks against one step on the whole batch:
    # the same gradient summed in another order (the JAX package's test
    # of the same property holds its params at rtol 1e-5, atol 1e-7;
    # sgd here, so the params hold the gradient's rounding alone).
    images, labels = _images(BATCH, seed=13)
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels), "mask": torch.ones(BATCH)}

    def state():
        return create_train_state(
            get_model("linear", compute_dtype=torch.float32), 1, CPU,
            optimizer="sgd")

    full, accumulated = state(), state()
    m_full = train_step(full, batch)
    m_acc = train_step(accumulated, batch, accum=4)
    for a, b in zip(accumulated.model.parameters(), full.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-7)
    assert float(m_acc.count) == float(m_full.count) == BATCH
    np.testing.assert_allclose(float(m_acc.loss_sum), float(m_full.loss_sum),
                               rtol=1e-6)
    # Every gradient stayed a view of the one buffer the micro-batches
    # added into.
    flat = accumulated.grad_buffer.flat
    for p in accumulated.model.parameters():
        assert p.grad.untyped_storage().data_ptr() \
            == flat.untyped_storage().data_ptr()


def test_an_indivisible_batch_raises_the_jax_text():
    images, labels = _images(30)
    state = create_train_state(get_model("linear"), 1, CPU)
    with pytest.raises(ValueError, match="not divisible by --grad-accum 4"):
        train_step(state, {"image": torch.from_numpy(images),
                           "label": torch.from_numpy(labels)}, accum=4)


_CLI = ["--dataset", "synthetic", "--model", "linear", "--dtype", "f32",
        "--synthetic-train-size", "256", "--synthetic-test-size", "96",
        "--batch-size", "64", "--epochs", "2", "--seed", "0",
        "--device", "cpu"]


def _lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith("Epoch: ")]


def test_scan_and_stepwise_print_the_same_lines_under_accumulation(
        tmp_path, capsys):
    lines, leaves = {}, {}
    for mode in ("scan", "stepwise"):
        summary = cli.run(cli.build_parser().parse_args(
            _CLI + ["--grad-accum", "4", "--trainer-mode", mode,
                    "--checkpoint-dir", str(tmp_path / mode)]))
        assert summary["epochs_run"] == 2
        lines[mode] = _lines(capsys.readouterr().out)
        leaves[mode] = port_ckpt.read_checkpoint_arrays(
            str(tmp_path / mode / "checkpoint_1.npz"))[1]
    assert len(lines["scan"]) == 2 and lines["scan"] == lines["stepwise"]
    for name, value in leaves["scan"].items():
        np.testing.assert_array_equal(value, leaves["stepwise"][name],
                                      err_msg=name)


def test_a_world_of_2_accumulates_the_global_masked_mean(tmp_path):
    # 47 images over 2 ranks: the sampler pads to 48 with one masked row,
    # rank 1's last, inside the last kept batch (global 24, 12 a rank, 6
    # a micro-batch). One process with no axis trains on the same global
    # batches without accumulation: the global masked mean.
    flags = ["--dataset", "synthetic", "--model", "linear", "--dtype", "f32",
             "--optimizer", "sgd", "--synthetic-train-size", "47",
             "--synthetic-test-size", "32", "--batch-size", "24",
             "--epochs", "1", "--seed", "5", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
         "--spawn", "2", "--grad-accum", "2", *flags, "--checkpoint-dir",
         str(tmp_path / "two")], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                                        OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    images, labels = synthetic_dataset(47, seed=5)
    ranks = [MNISTDataLoader(normalize_images(images), labels, 24,
                             num_replicas=2, rank=r, seed=5).stacked_epoch(0)
             for r in range(2)]
    staged = {k: np.concatenate([r[k] for r in ranks], axis=1)
              for k in ("image", "label", "mask")}
    assert staged["mask"].shape == (2, 24) and staged["mask"][-1, -1] == 0.0
    state = create_train_state(get_model("linear", compute_dtype=torch.float32),
                               5, CPU, optimizer="sgd")
    make_train_epoch(state)({k: torch.from_numpy(v)
                             for k, v in staged.items()})
    got = port_ckpt.read_checkpoint_arrays(
        str(tmp_path / "two" / "checkpoint_0.npz"))[1]
    # float32, sgd, the same gradient summed in another order: atol 1e-6.
    for name, value in port_ckpt.state_to_jax(state):
        if name.startswith("['params']"):
            np.testing.assert_allclose(got[name], value, rtol=0, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("flags, message", [
    (["--grad-accum", "0"], "--grad-accum must be >= 1, got 0"),
    (["--grad-accum", "2", "--trainer-mode", "explicit"],
     "--grad-accum does not compose with --trainer-mode explicit; use scan "
     "or stepwise"),
    (["--grad-accum", "3"], "--grad-accum 3 must divide --batch-size 64"),
])
def test_grad_accum_refusals_carry_the_jax_text(flags, message, tmp_path):
    with pytest.raises(SystemExit) as info:
        cli.run(cli.build_parser().parse_args(
            _CLI + flags + ["--checkpoint-dir", str(tmp_path)]))
    assert str(info.value.code) == message


def test_a_world_refuses_a_grad_accum_that_splits_no_rank_evenly(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
         "--spawn", "2", "--grad-accum", "8", *_CLI, "--batch-size", "24",
         "--checkpoint-dir", str(tmp_path)], capture_output=True,
        text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode != 0
    # 8 divides the global batch of 24, not a rank's 12.
    assert ("--grad-accum 8 must divide the per-process batch (12: "
            "--batch-size 24 over 2 processes)") in proc.stdout + proc.stderr


def test_the_trainer_refuses_accumulation_in_the_explicit_mode():
    with pytest.raises(ValueError, match="does not compose"):
        Trainer(None, None, None, CPU, mode="explicit", grad_accum=2)
    # A count below 1 is the step's to refuse.
    with pytest.raises(ValueError, match=">= 1"):
        train_step(None, {}, accum=0)
