"""``--remat`` in the port (``models/attention.py``: each transformer block
under ``torch.utils.checkpoint``) on the CPU: against the port without
remat bit for bit (the recompute runs the same operations on the same
inputs), against the JAX package's ``remat=True`` step, across
checkpoints both ways, with the flash forward's extra launch per block,
and the JAX CLI's refusal."""

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
from pytorch_distributed_mnist_tpu.train.state import TrainState as JaxState
from pytorch_distributed_mnist_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.ops import flash
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    make_train_epoch,
    train_step,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")
STEPS, BATCH = 2, 16


def _staged(seed=21):
    images, labels = synthetic_dataset(STEPS * BATCH, seed=seed)
    mask = np.ones((STEPS, BATCH), np.float32)
    mask[1, 3] = 0.0
    return {"image": torch.from_numpy(normalize_images(images).reshape(
                (STEPS, BATCH, 28, 28, 1))),
            "label": torch.from_numpy(labels.astype(np.int64).reshape(
                STEPS, BATCH)),
            "mask": torch.from_numpy(mask)}


def _state(remat, attention="dense", optimizer="adam", depth=2):
    kwargs = {"attention_fn": flash.flash_attention} \
        if attention == "flash" else {}
    return create_train_state(get_model("vit", depth=depth, remat=remat,
                                        **kwargs), 5, CPU,
                              optimizer=optimizer)


def _params(state) -> list:
    return [p.detach().clone() for p in state.model.parameters()]


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("mode", ["scan", "stepwise"])
def test_remat_trains_bit_for_bit_as_without(attention, mode):
    staged = _staged()
    results = {}
    for remat in (False, True):
        state = _state(remat, attention)
        if mode == "scan":
            ms = make_train_epoch(state, grad_accum=2)(staged)
        else:
            for s in range(STEPS):
                ms = train_step(state, {k: t[s] for k, t in staged.items()})
        results[remat] = ([float(t) for t in ms], _params(state))
    assert results[True][0] == results[False][0]
    for a, b in zip(results[True][1], results[False][1]):
        assert torch.equal(a, b)


def test_remat_runs_one_more_flash_forward_per_block(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd_plain, bwd_plain = flash.flash_fwd_plain, flash.flash_bwd_plain

    def fwd(q, k, v, *, causal=False, scale=None, route=None):
        calls["fwd"] += 1
        return fwd_plain(q, k, v, causal=causal, scale=scale)

    def bwd(q, k, v, o, lse, do, *, causal=False, scale=None, route=None):
        calls["bwd"] += 1
        return bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale)

    monkeypatch.setattr(flash, "flash_fwd", fwd)
    monkeypatch.setattr(flash, "flash_bwd", bwd)
    batch = {k: t[0] for k, t in _staged().items()}
    for remat, want in ((False, {"fwd": 2, "bwd": 2}),
                        (True, {"fwd": 4, "bwd": 2})):
        state = _state(remat, "flash")
        calls.update(fwd=0, bwd=0)
        train_step(state, batch)
        assert calls == want, remat
        # No gradient, no checkpoint: one forward a block.
        calls.update(fwd=0, bwd=0)
        with torch.no_grad():
            state.model(batch["image"])
        assert calls == {"fwd": 2, "bwd": 0}


def test_remat_step_matches_the_jax_remat_step(tmp_path):
    # One sgd step of the float32 ViT (depth 2, dense attention) with
    # remat on both sides, from one npz. float32; the products sum in
    # another order in XLA and in PyTorch (the forward's logits agree to
    # 1e-5, tests/test_torch_vit.py), and sgd's step is linear in the
    # gradient: params within atol 1e-6.
    model = jax_get_model("vit", compute_dtype=jnp.float32, remat=True)
    params = jax.jit(model.init)(jax.random.key(0),
                                 jnp.zeros((1, 28, 28, 1), jnp.float32))
    tx = jax_make_optimizer(1e-3, "sgd", 0.9, 1e-4)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    path = jax_ckpt.save_checkpoint(jstate, epoch=-1, best_acc=0.0,
                                    is_best=False, directory=str(tmp_path))
    batch = {k: t[1] for k, t in _staged(seed=22).items()}
    jstate, jm = jax_make_train_step()(jstate, {
        "image": jnp.asarray(batch["image"].numpy()),
        "label": jnp.asarray(batch["label"].numpy(), jnp.int32),
        "mask": jnp.asarray(batch["mask"].numpy())})
    state = create_train_state(
        get_model("vit", compute_dtype=torch.float32, remat=True), 3, CPU,
        optimizer="sgd")
    port_ckpt.load_checkpoint(path, state)
    ms = train_step(state, batch)
    want = dict(jax_ckpt._leaves_with_names({"params": jstate.params}))
    got = {k: v for k, v in port_ckpt.state_to_jax(state)
           if k.startswith("['params']")}
    assert got.keys() == want.keys() and len(got) == 31
    for name, value in got.items():
        np.testing.assert_allclose(value, np.asarray(want[name]), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert float(ms.count) == float(jm.count) == BATCH - 1
    np.testing.assert_allclose(float(ms.loss_sum), float(jm.loss_sum),
                               rtol=1e-5)


@pytest.mark.parametrize("saved_remat", [False, True])
def test_checkpoints_load_between_remat_and_plain_models(saved_remat,
                                                         tmp_path):
    saver = _state(saved_remat, optimizer="adam_pallas")
    train_step(saver, {k: t[0] for k, t in _staged().items()})
    path = port_ckpt.save_checkpoint(saver, epoch=0, best_acc=0.0,
                                     is_best=False, directory=str(tmp_path))
    loader = _state(not saved_remat, optimizer="adam_pallas")
    _, epoch, _ = port_ckpt.load_checkpoint(path, loader)
    assert epoch == 1
    for (name, a), b in zip(loader.model.named_parameters(),
                            saver.model.parameters()):
        assert torch.equal(a, b), name
    # The JAX ViT, with and without its remat, reads the same file.
    for jax_remat in (False, True):
        model = jax_get_model("vit", remat=jax_remat)
        params = jax.jit(model.init)(jax.random.key(0),
                                     jnp.zeros((1, 28, 28, 1), jnp.float32))
        tx = jax_make_optimizer(1e-3, "adam_pallas", 0.9, 1e-4)
        jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), apply_fn=model.apply,
                          tx=tx)
        _, jepoch, _ = jax_ckpt.load_checkpoint(path, jstate)
        assert jepoch == 1


def test_the_cli_trains_with_remat_as_without(tmp_path, capsys):
    flags = ["--model", "vit", "--attention", "flash", "--dataset",
             "synthetic", "--synthetic-train-size", "128",
             "--synthetic-test-size", "32", "--batch-size", "32",
             "--epochs", "1", "--seed", "0", "--device", "cpu"]
    lines = {}
    for tag, extra in (("plain", []), ("remat", ["--remat"])):
        cli.run(cli.build_parser().parse_args(
            flags + extra + ["--checkpoint-dir", str(tmp_path / tag)]))
        lines[tag] = [ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("Epoch: ")]
    assert len(lines["plain"]) == 1 and lines["remat"] == lines["plain"]


@pytest.mark.parametrize("model", ["cnn", "linear"])
def test_remat_on_a_model_without_blocks_exits_with_the_jax_text(model,
                                                                  tmp_path):
    with pytest.raises(SystemExit) as info:
        cli.run(cli.build_parser().parse_args([
            "--model", model, "--remat", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path)]))
    assert str(info.value.code) == (
        f"--remat only applies to block-structured models; {model!r} does "
        f"not accept it")
