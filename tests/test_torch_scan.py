"""The port's scan trainer mode (``train/steps.py::EpochProgram``,
``train/trainer.py``, ``cli.py``) on the CPU, where each epoch program
runs its step body in a loop over the epoch staged on the device (on the
card it replays one captured CUDA graph; ``tests/test_torch_cuda.py``).

- One scan epoch against JAX ``make_train_epoch`` on the same staged
  batches, from one npz, for ``linear`` and the flash ViT at depth 1
  (float32 both sides; the JAX kernels in Pallas interpret mode), within
  ``tests/test_train_steps.py::test_scan_epoch_matches_stepwise``'s
  tolerances.
- Within the port, bit for bit: scan against stepwise, device gather
  against host gather, prefetch on against off, a resumed scan run
  against the uninterrupted one.
"""

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
from pytorch_distributed_mnist_tpu.ops import loss as jax_loss
from pytorch_distributed_mnist_tpu.ops.pallas.flash import (
    flash_attention as jax_flash_attention,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import TrainState as JaxState
from pytorch_distributed_mnist_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_epoch as jax_make_train_epoch,
)
from pytorch_distributed_mnist_tpu_torch.cli import build_parser, run
from pytorch_distributed_mnist_tpu_torch.data.loader import MNISTDataLoader
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    jax_param_path,
    key_path,
)
from pytorch_distributed_mnist_tpu_torch.ops import launches
from pytorch_distributed_mnist_tpu_torch.ops import loss as port_loss
from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    make_eval_epoch,
    make_train_epoch,
)
from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer
from pytorch_distributed_mnist_tpu_torch.utils.profiling import StagingLog

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


def _leaf(tree, port_name):
    node = tree
    for key in key_path(jax_param_path(port_name)):
        node = node[key]
    return np.asarray(node)


def _staged(steps: int, batch: int, seed: int) -> dict:
    images, labels = synthetic_dataset(steps * batch, seed=seed)
    return {"image": normalize_images(images).reshape(steps, batch, 28, 28,
                                                      1),
            "label": labels.astype(np.int64).reshape(steps, batch),
            "mask": np.ones((steps, batch), np.float32)}


_MODELS = {
    "linear": ({}, {}),
    "vit_flash_depth1": ({"attention_fn": flash_attention, "depth": 1},
                         {"attention_fn": jax_flash_attention, "depth": 1}),
}


@pytest.mark.parametrize("model", list(_MODELS))
def test_scan_epoch_matches_jax_make_train_epoch(model, tmp_path,
                                                fused_loss):
    port_kw, jax_kw = _MODELS[model]
    name = "linear" if model == "linear" else "vit"
    state = create_train_state(
        get_model(name, compute_dtype=torch.float32, **port_kw), seed=3,
        device=CPU, optimizer="adam_pallas")
    shared = port_ckpt.save_checkpoint(state, epoch=-1, best_acc=0.0,
                                       is_best=False,
                                       directory=str(tmp_path))
    jmodel = jax_get_model(name, compute_dtype=jnp.float32, **jax_kw)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 28, 28, 1), jnp.float32))
    tx = jax_make_optimizer(1e-3, "adam_pallas", 0.9, 1e-4)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), apply_fn=jmodel.apply,
                      tx=tx)
    jstate, _, _ = jax_ckpt.load_checkpoint(shared, jstate)

    batches = _staged(steps=4, batch=32, seed=7)
    jstate, jms = jax_make_train_epoch()(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()})
    ms = make_train_epoch(state)(
        {k: torch.from_numpy(v) for k, v in batches.items()})

    # test_scan_epoch_matches_stepwise's tolerances: params atol 1e-6,
    # loss_sum rtol 1e-5. float32 on both sides; XLA and PyTorch sum the
    # products in another order, and Adam's normalised step keeps that
    # noise far below lr. One slice is held apart: the attention's key
    # bias (qkv.bias[dim:2 dim]) adds q.b_k to every score of a row, which
    # the softmax cancels, so its exact gradient is 0 and each side's is
    # rounding noise that Adam turns into steps of about +-lr. There the
    # sides agree only to 2 lr a step.
    noise = {"block0.attn.qkv.bias": slice(64, 128)} if name == "vit" else {}
    for pname, p in state.model.named_parameters():
        got, want = p.detach().numpy(), _leaf(jstate.params, pname)
        keep = np.ones(got.shape, bool)
        if pname in noise:
            keep[noise[pname]] = False
            assert np.abs(got - want)[~keep].max() <= 2 * 1e-3 * 4, pname
        np.testing.assert_allclose(got[keep], want[keep], atol=1e-6,
                                   err_msg=pname)
    np.testing.assert_allclose(float(ms.loss_sum), float(jms.loss_sum),
                               rtol=1e-5)
    assert float(ms.count) == float(jms.count) == 4 * 32
    assert float(ms.correct) == float(jms.correct)
    assert int(state.step) == int(jstate.step) == 4
    assert int(state.optimizer.count) == int(jstate.opt_state.count) == 4


def _cli(tmp_path, tag, extra, model="linear"):
    return run(build_parser().parse_args([
        "--dataset", "synthetic", "--model", model, "--loss", "fused",
        "--optimizer", "adam_pallas", "--batch-size", "64",
        "--synthetic-train-size", "256", "--synthetic-test-size", "96",
        "--seed", "0", "--epochs", "2", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / tag)] + extra))


def _same_checkpoints(a, b):
    _, leaves_a = port_ckpt.read_checkpoint_arrays(str(a))
    _, leaves_b = port_ckpt.read_checkpoint_arrays(str(b))
    assert list(leaves_a) == list(leaves_b)
    for name in leaves_a:
        np.testing.assert_array_equal(leaves_a[name], leaves_b[name],
                                      err_msg=name)


@pytest.mark.parametrize("model", ["linear", "vit"])
def test_scan_equals_stepwise_bit_for_bit(model, tmp_path, fused_loss):
    extra = ["--attention", "flash"] if model == "vit" else []
    scan = _cli(tmp_path, "scan", extra, model)  # the default mode
    step = _cli(tmp_path, "step", extra + ["--trainer-mode", "stepwise"],
                model)
    for a, b in zip(scan["history"], step["history"]):
        for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
            assert a[key] == b[key], key
    _same_checkpoints(tmp_path / "scan" / "checkpoint_1.npz",
                      tmp_path / "step" / "checkpoint_1.npz")
    assert scan["staging"]["stages"] == 2
    # The per-batch feeder stages each of 2 x 4 train batches.
    assert step["staging"]["stages"] == 8


def test_device_gather_equals_host_gather_bit_for_bit(tmp_path, fused_loss):
    # tests/test_device_gather.py's run (linear, batch 64, 256 train and a
    # ragged 96 test images, 2 epochs) on the port.
    host = _cli(tmp_path, "h", [])
    dev = _cli(tmp_path, "d", ["--epoch-gather", "device"])
    drop = ("images_per_sec",)
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in dev["history"]] == \
        [{k: v for k, v in r.items() if k not in drop}
         for r in host["history"]]
    assert dev["best_acc"] == host["best_acc"]
    _same_checkpoints(tmp_path / "h" / "checkpoint_1.npz",
                      tmp_path / "d" / "checkpoint_1.npz")
    assert dev["staging"]["stages"] == 0  # nothing gathered on the host


def test_epoch_gather_device_needs_scan(tmp_path):
    with pytest.raises(SystemExit) as info:
        run(build_parser().parse_args([
            "--trainer-mode", "stepwise", "--epoch-gather", "device",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path)]))
    assert str(info.value.code).startswith(
        "--epoch-gather device requires --trainer-mode scan")
    with pytest.raises(ValueError, match="scan-mode path"):
        Trainer(None, None, None, CPU, mode="stepwise",
                epoch_gather="device")


def _loaders(train_size=256, test_size=100, batch=64):
    images, labels = synthetic_dataset(train_size + test_size, seed=11)
    x = normalize_images(images)
    return (MNISTDataLoader(x[:train_size], labels[:train_size], batch,
                            train=True, seed=0),
            MNISTDataLoader(x[train_size:], labels[train_size:], batch,
                            train=False, seed=0))


def _state():
    return create_train_state(get_model("linear"), seed=5, device=CPU,
                              optimizer="adam_pallas")


def test_scan_eval_counts_each_test_sample_once():
    train, test = _loaders(test_size=100)  # 2 batches of 64, 28 padded
    scan = Trainer(_state(), train, test, CPU, mode="scan")
    step = Trainer(_state(), train, test, CPU, mode="stepwise")
    for _ in range(2):  # the staged eval set is reused
        loss, acc = scan.evaluate()
        assert loss.count == acc.count == 100
        want_loss, want_acc = step.evaluate()
        assert (loss.average, acc.correct) == (want_loss.average,
                                               want_acc.correct)
    # The eval program does not train.
    ms = make_eval_epoch(scan.state)(scan._eval_staged)
    assert float(ms.count) == 100 and int(scan.state.step) == 0


@pytest.mark.parametrize("prefetch", [True, False])
def test_prefetch_on_and_off_give_the_same_trajectory(prefetch):
    train, test = _loaders()
    ref = Trainer(_state(), train, test, CPU, mode="stepwise")
    log = StagingLog()
    trainer = Trainer(_state(), train, test, CPU, mode="scan",
                      staging_log=log)
    trainer.prefetch_enabled = prefetch
    try:
        for epoch in range(3):
            train.set_sample_epoch(epoch)
            got = trainer.train()
            want = ref.train()
            assert (got[0].average, got[1].correct) == \
                (want[0].average, want[1].correct)
    finally:
        trainer.close()
    assert trainer._prefetch is None
    for (name, a), b in zip(trainer.state.model.named_parameters(),
                            ref.state.model.parameters()):
        assert torch.equal(a, b), name
    summary = log.summary()
    assert summary["stages"] == 3 and summary["images"] == 3 * 256
    assert summary["pipelined_stages"] == (2 if prefetch else 0)


def test_a_prefetch_of_another_epoch_is_not_used():
    # The caller jumps epochs: the staged gather is dropped, not trained.
    train, test = _loaders()
    ref = Trainer(_state(), train, test, CPU, mode="stepwise")
    trainer = Trainer(_state(), train, test, CPU, mode="scan")
    try:
        trainer.train()  # prefetches epoch 1
        train.set_sample_epoch(5)
        got = trainer.train()
    finally:
        trainer.close()
    train.set_sample_epoch(0)
    ref.train()
    train.set_sample_epoch(5)
    want = ref.train()
    assert (got[0].average, got[1].correct) == (want[0].average,
                                                want[1].correct)


def test_scan_resume_repeats_the_uninterrupted_run_bit_for_bit(tmp_path,
                                                               fused_loss):
    full = _cli(tmp_path, "a", [])
    resumed = _cli(tmp_path, "b", [
        "--resume", str(tmp_path / "a" / "checkpoint_0.npz")])
    assert resumed["start_epoch"] == 1 and resumed["epochs_run"] == 1
    a, b = full["history"][1], resumed["history"][0]
    for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
        assert a[key] == b[key], key
    _same_checkpoints(tmp_path / "a" / "checkpoint_1.npz",
                      tmp_path / "b" / "checkpoint_1.npz")


def test_stacked_epoch_stacks_the_loader_batches():
    train, test = _loaders(test_size=100)
    for loader in (train, test):
        loader.set_sample_epoch(2)
        batches = list(loader)
        stacked = loader.stacked_epoch()
        for key in ("image", "label", "mask"):
            np.testing.assert_array_equal(
                stacked[key], np.stack([b[key] for b in batches]))
        # The pure form: another epoch, the sampler untouched; and the
        # same values gathered into given arrays.
        other = loader.stacked_epoch(3)
        assert loader.sampler.epoch == 2
        out = {k: np.empty_like(v) for k, v in other.items()}
        assert loader.stacked_epoch(3, out=out) is out
        for key in other:
            np.testing.assert_array_equal(out[key], other[key])


def test_captured_launches_are_credited_per_replay(monkeypatch):
    from pytorch_distributed_mnist_tpu_torch.ops import flash, xent

    monkeypatch.setattr(xent.xent_fwd, "launches", 5)
    monkeypatch.setattr(flash.flash_fwd, "launches", 0)
    monkeypatch.setattr(flash.flash_fwd, "route_launches",
                        {"tensor": 1, "tf32x3": 0, "cuda_core": 0})
    captured = launches.CapturedLaunches()
    with captured.capturing():  # what a capture's wrappers count
        xent.xent_fwd.launches += 2
        flash.flash_fwd.launches += 1
        flash.flash_fwd.route_launches["tensor"] += 1
    # The capture launched nothing: the counts are as before it.
    assert xent.xent_fwd.launches == 5 and flash.flash_fwd.launches == 0
    assert captured.per_replay == {
        ("ops.xent", "xent_fwd", "launches"): 2,
        ("ops.flash", "flash_fwd", "launches"): 1,
        ("ops.flash", "flash_fwd", "tensor"): 1}
    captured.credit(3)
    assert xent.xent_fwd.launches == 11 and flash.flash_fwd.launches == 3
    assert flash.flash_fwd.route_launches["tensor"] == 4


def test_an_epoch_program_refuses_a_rebound_state():
    # On the card the check runs before every replayed pass; here the
    # recorded pointers are taken as a capture would take them.
    train, _ = _loaders()
    state = _state()
    epoch = make_train_epoch(state)
    batches = {k: torch.from_numpy(v) for k, v in train.stacked_epoch().items()}
    epoch(batches)
    program = epoch.program
    program._graph, program._bound = object(), program._pointers()
    with torch.no_grad():
        p = next(state.model.parameters())
        p.data = p.data.clone()
    with pytest.raises(RuntimeError, match="rebound"):
        epoch(batches)
    program._bound = program._pointers()
    with pytest.raises(RuntimeError, match="rebound"):
        epoch({k: v.clone() for k, v in batches.items()})


def test_staging_log_summary():
    log = StagingLog()
    assert log.summary()["overlap_fraction"] == 0.0
    log.record_stage(host_ms=30.0, h2d_ms=10.0, images=1000, pipelined=True)
    log.record_wait(10.0)
    s = log.summary()
    assert s["stages"] == s["pipelined_stages"] == 1
    assert s["overlap_fraction"] == 0.75
    assert s["feed_images_per_sec"] == 25000.0
