"""The port's training path (``train/``, ``cli.py``) against the JAX
package's, on the CPU: one ``cnn`` step and one ``vit --attention flash``
step from one shared checkpoint, two synthetic epochs of ``linear``
through both command lines (stepwise, and both CLIs' default scan mode),
and the port's own bit-exact resume. (The ViT's two CLI epochs are in
``test_torch_vit_cli.py``, the scan mode's own tests in
``test_torch_scan.py``.)

Both sides compute in float32 here (``--dtype f32``); the JAX kernels run
in Pallas interpret mode. Each tolerance is stated where it is used.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.cli import build_parser as jax_parser
from pytorch_distributed_mnist_tpu.cli import run as jax_run
from pytorch_distributed_mnist_tpu.data.mnist import (
    normalize_images,
    synthetic_dataset,
)
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.ops import loss as jax_loss
from pytorch_distributed_mnist_tpu.ops.pallas.flash import (
    flash_attention as jax_flash_attention,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import TrainState as JaxState
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from pytorch_distributed_mnist_tpu_torch.cli import build_parser, run
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    jax_param_path,
    key_path,
)
from pytorch_distributed_mnist_tpu_torch.ops import loss as port_loss
from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture
def fused_loss():
    """Both packages' loss switch on ``fused``, put back afterwards (it is
    process-global in each)."""
    jax_loss.set_loss_impl("fused")
    port_loss.set_loss_impl("fused")
    try:
        yield
    finally:
        jax_loss.set_loss_impl("xla")
        port_loss.set_loss_impl("xla")


def _layer_leaf(tree, port_name):
    """The leaf of a flax ``{'params': {...}}`` tree for a port name."""
    node = tree
    for key in key_path(jax_param_path(port_name)):
        node = node[key]
    return np.asarray(node)


def _port_layout(arr):
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr


def test_one_cnn_step_matches_jax_from_one_checkpoint(tmp_path, fused_loss):
    jstate = jax_create_train_state(
        jax_get_model("cnn", compute_dtype=jnp.float32), jax.random.key(0),
        optimizer="adam_pallas")
    path = jax_ckpt.save_checkpoint(jstate, epoch=-1, best_acc=0.0,
                                    is_best=False, directory=str(tmp_path))
    state = create_train_state(get_model("cnn", compute_dtype=torch.float32),
                               seed=1, device=CPU, optimizer="adam_pallas")
    port_ckpt.load_checkpoint(path, state)

    images, labels = synthetic_dataset(8, seed=4)
    x = normalize_images(images)
    y = labels.astype(np.int32)
    mask = np.ones(8, np.float32)

    def loss_fn(params):
        logits = jstate.apply_fn(params, jnp.asarray(x), train=True)
        return jax_loss.cross_entropy(logits, jnp.asarray(y),
                                      jnp.asarray(mask)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jstate.params)
    jnew = jstate.apply_gradients(jgrads)

    model, opt = state.model, state.optimizer
    logits = model(torch.from_numpy(x))
    loss = port_loss.cross_entropy(logits, torch.from_numpy(y).long(),
                                   torch.from_numpy(mask))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()

    # float32 on both sides; convolutions and products sum in another
    # order in XLA and in PyTorch.
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    inner = jnew.opt_state.inner_state[0]
    for name, p in model.named_parameters():
        g_want = _port_layout(_layer_leaf(jgrads, name))
        g = grads[name].numpy()
        scale = np.abs(g_want).max()
        np.testing.assert_allclose(g, g_want, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
        mu = opt.state[p]["mu"].numpy()
        nu = opt.state[p]["nu"].numpy()
        np.testing.assert_allclose(
            mu, _port_layout(_layer_leaf(inner.mu, name)), rtol=1e-4,
            atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(
            nu, _port_layout(_layer_leaf(inner.nu, name)), rtol=2e-4,
            atol=1e-10 * scale ** 2, err_msg=name)
        # Adam's first step is -lr * g / (|g| + eps), about -lr * sign(g):
        # its slope in g is lr * eps / g**2, so where |g| is small the two
        # sides' summation-order noise in g moves the step (and where |g|
        # is at that noise, flips its sign: params ~2 lr apart). Elements
        # with |g| < 1e-5 are masked out; elsewhere the params agree to
        # an ulp or two.
        live = np.abs(g_want) >= 1e-5
        assert live.mean() > 0.5, name
        np.testing.assert_allclose(
            p.detach().numpy()[live],
            _port_layout(_layer_leaf(jnew.params, name))[live],
            rtol=1e-6, atol=1e-9, err_msg=name)
    assert int(state.step) == 0  # the step counter is the train loop's
    assert int(opt.count) == int(jnew.opt_state.count) == 1
    assert int(opt.inner_count) == int(inner.count) == 1


def test_one_vit_flash_step_matches_jax_from_one_checkpoint(tmp_path,
                                                          fused_loss):
    # The JAX state as create_train_state builds it, with the init jitted
    # (the ViT's eager init dispatches op by op: 9 s against 2 s).
    jmodel = jax_get_model("vit", compute_dtype=jnp.float32,
                           attention_fn=jax_flash_attention)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 28, 28, 1), jnp.float32))
    tx = jax_make_optimizer(1e-3, "adam_pallas", 0.9, 1e-4)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), apply_fn=jmodel.apply,
                      tx=tx)
    path = jax_ckpt.save_checkpoint(jstate, epoch=-1, best_acc=0.0,
                                    is_best=False, directory=str(tmp_path))
    state = create_train_state(
        get_model("vit", compute_dtype=torch.float32,
                  attention_fn=flash_attention),
        seed=1, device=CPU, optimizer="adam_pallas")
    port_ckpt.load_checkpoint(path, state)

    images, labels = synthetic_dataset(8, seed=5)
    x = normalize_images(images)
    y = labels.astype(np.int32)
    mask = np.ones(8, np.float32)

    @jax.jit
    def grad_fn(params):
        def loss_fn(params):
            logits = jstate.apply_fn(params, jnp.asarray(x), train=True)
            return jax_loss.cross_entropy(logits, jnp.asarray(y),
                                          jnp.asarray(mask)), logits

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jloss, jlogits), jgrads = grad_fn(jstate.params)
    jnew = jstate.apply_gradients(jgrads)

    model, opt = state.model, state.optimizer
    logits = model(torch.from_numpy(x))
    loss = port_loss.cross_entropy(logits, torch.from_numpy(y).long(),
                                   torch.from_numpy(mask))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()

    # float32 on both sides; the products sum in another order in XLA and
    # in PyTorch.
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    inner = jnew.opt_state.inner_state[0]
    for name, p in model.named_parameters():
        g_want = _layer_leaf(jgrads, name)
        scale = np.abs(g_want).max()
        np.testing.assert_allclose(grads[name].numpy(), g_want, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(
            opt.state[p]["mu"].numpy(), _layer_leaf(inner.mu, name),
            rtol=1e-4, atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(
            opt.state[p]["nu"].numpy(), _layer_leaf(inner.nu, name),
            rtol=2e-4, atol=1e-10 * scale ** 2, err_msg=name)
        # As in the cnn step: where |g| is at the summation-order noise,
        # Adam's first step (about -lr * sign(g)) may differ; elsewhere the
        # params agree to an ulp or two.
        live = np.abs(g_want) >= 1e-5
        assert live.mean() > 0.5, name
        np.testing.assert_allclose(
            p.detach().numpy()[live], _layer_leaf(jnew.params, name)[live],
            rtol=1e-6, atol=1e-9, err_msg=name)
    assert int(opt.count) == int(jnew.opt_state.count) == 1


_COMMON = ["--dataset", "synthetic", "--model", "linear", "--dtype", "f32",
           "--loss", "fused", "--optimizer", "adam_pallas",
           "--batch-size", "64", "--synthetic-train-size", "512",
           "--synthetic-test-size", "200", "--epochs", "2", "--seed", "0",
           "--trainer-mode", "stepwise"]


def test_two_linear_epochs_match_jax_cli_from_one_npz(tmp_path, fused_loss):
    # One shared starting point: the port's fresh state, written as a
    # checkpoint whose meta epoch is 0, so both CLIs start at epoch 0.
    state = create_train_state(get_model("linear", compute_dtype=torch.float32),
                               seed=3, device=CPU, optimizer="adam_pallas")
    shared = port_ckpt.save_checkpoint(state, epoch=-1, best_acc=0.0,
                                       is_best=False,
                                       directory=str(tmp_path / "init"))
    want = jax_run(jax_parser().parse_args(_COMMON + [
        "--resume", shared, "--checkpoint-dir", str(tmp_path / "jax"),
        "--no-precompile"]))
    got = run(build_parser().parse_args(_COMMON + [
        "--resume", shared, "--checkpoint-dir", str(tmp_path / "port"),
        "--device", "cpu"]))
    assert got["epochs_run"] == want["epochs_run"] == 2
    # float32 on both sides, but the JAX side shards each batch over 8
    # virtual CPU devices and sums in another order: the losses agree to
    # rtol 1e-4 and accuracy to one example.
    for a, b in zip(got["history"], want["history"]):
        assert a["epoch"] == b["epoch"]
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(a["test_loss"], b["test_loss"], rtol=1e-4)
        assert abs(a["train_acc"] - b["train_acc"]) <= 1 / 512
        assert abs(a["test_acc"] - b["test_acc"]) <= 1 / 200
    # Each package's last checkpoint loads in the other's template.
    _, epoch, _ = jax_ckpt.load_checkpoint(
        str(tmp_path / "port" / "checkpoint_1.npz"),
        jax_create_train_state(jax_get_model("linear"), jax.random.key(0),
                               optimizer="adam_pallas"))
    assert epoch == 2
    _, epoch, _ = port_ckpt.load_checkpoint(
        str(tmp_path / "jax" / "checkpoint_1.npz"), state)
    assert epoch == 2


def test_two_linear_epochs_in_scan_mode_match_the_jax_cli_default(
        tmp_path, fused_loss):
    # Both CLIs' bare command: --trainer-mode scan (the JAX scanned epoch,
    # the port's epoch program), from one shared npz.
    common = [a for a in _COMMON if a not in ("--trainer-mode", "stepwise")]
    state = create_train_state(get_model("linear", compute_dtype=torch.float32),
                               seed=3, device=CPU, optimizer="adam_pallas")
    shared = port_ckpt.save_checkpoint(state, epoch=-1, best_acc=0.0,
                                       is_best=False,
                                       directory=str(tmp_path / "init"))
    want = jax_run(jax_parser().parse_args(common + [
        "--resume", shared, "--checkpoint-dir", str(tmp_path / "jax"),
        "--no-precompile"]))
    got = run(build_parser().parse_args(common + [
        "--resume", shared, "--checkpoint-dir", str(tmp_path / "port"),
        "--device", "cpu"]))
    assert got["epochs_run"] == want["epochs_run"] == 2
    assert got["staging"]["stages"] == 2  # the scan trainer's stages
    # test_two_linear_epochs_match_jax_cli_from_one_npz's tolerances: the
    # JAX side shards each batch over 8 virtual CPU devices and sums in
    # another order.
    for a, b in zip(got["history"], want["history"]):
        assert a["epoch"] == b["epoch"]
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(a["test_loss"], b["test_loss"], rtol=1e-4)
        assert abs(a["train_acc"] - b["train_acc"]) <= 1 / 512
        assert abs(a["test_acc"] - b["test_acc"]) <= 1 / 200


def test_port_resume_repeats_the_uninterrupted_run_bit_exactly(tmp_path,
                                                               capsys):
    common = ["--dataset", "synthetic", "--model", "linear",
              "--loss", "fused", "--optimizer", "adam_pallas",
              "--batch-size", "64", "--synthetic-train-size", "512",
              "--synthetic-test-size", "200", "--epochs", "2", "--seed", "0",
              "--device", "cpu"]
    try:
        full = run(build_parser().parse_args(
            common + ["--checkpoint-dir", str(tmp_path / "a")]))
        lines_full = [ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("Epoch: 1/")]
        resumed = run(build_parser().parse_args(common + [
            "--checkpoint-dir", str(tmp_path / "b"),
            "--resume", str(tmp_path / "a" / "checkpoint_0.npz")]))
        out = capsys.readouterr().out
    finally:
        port_loss.set_loss_impl("xla")
    assert "=> loaded checkpoint" in out
    assert resumed["start_epoch"] == 1 and resumed["epochs_run"] == 1
    assert [ln for ln in out.splitlines() if ln.startswith("Epoch: 1/")] \
        == lines_full
    a, b = full["history"][1], resumed["history"][0]
    for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
        assert a[key] == b[key], key
    meta_a, leaves_a = port_ckpt.read_checkpoint_arrays(
        str(tmp_path / "a" / "checkpoint_1.npz"))
    meta_b, leaves_b = port_ckpt.read_checkpoint_arrays(
        str(tmp_path / "b" / "checkpoint_1.npz"))
    assert list(leaves_a) == list(leaves_b)
    for name in leaves_a:
        np.testing.assert_array_equal(leaves_a[name], leaves_b[name])
    assert jax_param_path("fc.kernel") in "".join(leaves_a)


def test_eval_only_prints_one_test_line(tmp_path, capsys):
    common = ["--dataset", "synthetic", "--model", "linear",
              "--batch-size", "64", "--synthetic-train-size", "256",
              "--synthetic-test-size", "100", "--seed", "0",
              "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    run(build_parser().parse_args(common + ["--epochs", "1"]))
    capsys.readouterr()
    summary = run(build_parser().parse_args(
        common + ["-e", "--resume", str(tmp_path / "model_best.npz")]))
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if ln.startswith("Test Loss: ")] \
        and "Epoch:" not in out
    assert summary["epochs_run"] == 0 and 0.0 <= summary["test_acc"] <= 1.0
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_0.npz",
                                            "model_best.npz"]


@pytest.mark.parametrize("mode", ["explicit"])
def test_unported_trainer_modes_exit_2(mode, tmp_path, capsys):
    # Every trainer mode of the JAX CLI is ported now: explicit trains (its
    # epoch lines against stepwise's: tests/test_torch_distributed.py),
    # and refuses --epoch-gather device with the JAX CLI's message.
    summary = run(build_parser().parse_args([
        "--trainer-mode", mode, "--model", "linear", "--dataset",
        "synthetic", "--synthetic-train-size", "128",
        "--synthetic-test-size", "64", "--batch-size", "64", "--epochs", "1",
        "--device", "cpu", "--checkpoint-dir", str(tmp_path)]))
    assert summary["epochs_run"] == 1
    assert "Epoch: 0/1" in capsys.readouterr().out
    with pytest.raises(SystemExit) as info:
        run(build_parser().parse_args([
            "--trainer-mode", mode, "--epoch-gather", "device", "--device",
            "cpu", "--checkpoint-dir", str(tmp_path)]))
    assert str(info.value.code).startswith(
        "--epoch-gather device requires --trainer-mode scan")


@pytest.mark.parametrize("flag", [["--zero-bucket-mb-dcn", "1"],
                                  ["--zero-bucket-mb-dcn=2"],
                                  ["--dcn-slices", "2"]])
def test_flags_of_later_slices_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as info:
        build_parser().parse_args(flag)
    assert info.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_training_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run(build_parser().parse_args(["--model", "linear",
                                       "--checkpoint-dir", str(tmp_path)]))


@pytest.mark.parametrize("flags, message", [
    (["--model", "cnn", "--attention", "flash"],
     "--attention flash not supported: model 'cnn' does not accept an "
     "attention_fn"),
    (["--model", "linear", "--patch-size", "7"],
     "--patch-size only applies to models with patches; 'linear' does not "
     "accept one"),
    (["--model", "vit", "--patch-size", "5"],
     "--patch-size 5: 28 must divide evenly into patches"),
])
def test_model_flags_the_model_does_not_take_exit(flags, message, tmp_path):
    # The JAX CLI's refusals, before any device or data is touched.
    with pytest.raises(SystemExit) as info:
        run(build_parser().parse_args(flags + [
            "--device", "cpu", "--checkpoint-dir", str(tmp_path)]))
    assert str(info.value.code).startswith(message)

