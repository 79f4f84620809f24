"""Data parallelism over processes in the port (``parallel/``, the sharded
loader, the gradient mean in the train step, the metric sum, rank-0
checkpoints, ``--spawn`` and ``--trainer-mode explicit``), on the CPU in
gloo worlds of 2 and 3 processes.

- The port's 2-rank step against JAX ``make_train_step`` on a 2-device
  ``('data',)`` mesh and ``make_explicit_dp_train_step``, from one npz and
  one global batch, for ``linear`` and ``cnn``: on full masks, and on the
  padded last batch of an epoch whose rank 1 holds a masked row (the
  global masked mean against DDP's per-replica mean); and a CLI world of
  2 over such a batch against one process training on the global
  batches.
- A world of 2 against a world of 1: through the CLI for ``linear`` and
  ``cnn``, and four scan steps of the flash ViT at depth 1.
- Sharded eval at N = 2 and 3 on a test set no N divides.
- The loader's shards against the JAX loader's; the launcher, the CLI's
  refusals and the environment detection; rank-0 checkpoints that resume
  across worlds and in the JAX package.

Every test that starts processes bounds its wait (``WORLD_TIMEOUT``).
Each tolerance is stated where it is used.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from pytorch_distributed_mnist_tpu.data.loader import (
    MNISTDataLoader as JaxLoader,
)
from pytorch_distributed_mnist_tpu.data.mnist import (
    normalize_images,
    synthetic_dataset,
)
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.parallel.collectives import (
    make_explicit_dp_train_step as jax_explicit_step,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.data.loader import MNISTDataLoader
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.ops import loss as port_loss
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import make_train_epoch
from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer
from pytorch_distributed_mnist_tpu_torch.utils import logging as port_logging

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120  # seconds any one world of processes may take

# One rank of a world started by _world: ``python -c _RANK coordinator n
# rank dir`` runs the job in ``dir/job.json`` and writes its results there.
_RANK = r"""
import json, sys
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
from pytorch_distributed_mnist_tpu_torch.ops.loss import set_loss_impl
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    make_explicit_dp_train_step, metric_all_reduce)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as ck
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    make_train_epoch, train_step)
from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer
from pytorch_distributed_mnist_tpu_torch.data.loader import MNISTDataLoader

torch.set_num_threads(1)
coordinator, n, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
job = json.load(open(f"{out}/job.json"))
cpu = torch.device("cpu")
distributed.initialize_distributed(coordinator, n, rank, cpu)
axis = make_mesh(device=cpu)
set_loss_impl(job.get("loss", "xla"))
results = {}

def state_of(name, init=None, optimizer="adam", **kw):
    if kw.pop("flash", False):
        kw["attention_fn"] = flash_attention
    st = create_train_state(get_model(name, compute_dtype=torch.float32, **kw),
                            3, cpu, optimizer=optimizer)
    if init:
        ck.load_checkpoint(init, st)
    return st

def save(st, tag):
    ck._write_npz(state_to_jax(st), epoch=0, best_acc=0.0,
                  directory=f"{out}/{tag}_rank{rank}")

data = np.load(job["data"]) if "data" in job else None
if job["kind"] == "step":  # one train step on this rank's rows
    b = data["image"].shape[0] // n
    rows = slice(rank * b, (rank + 1) * b)
    batch = {"image": torch.from_numpy(data["image"][rows]),
             "label": torch.from_numpy(data["label"][rows]).long(),
             "mask": torch.ones(b)}
    for name, (init, optimizer) in job["models"].items():
        st = state_of(name, init, optimizer)
        ms = metric_all_reduce(train_step(st, batch, axis), axis)
        save(st, name)
        results[name] = [float(t) for t in ms]
elif job["kind"] == "masked_step":  # one step on this rank's masked rows
    b = data["image"].shape[0] // n
    rows = slice(rank * b, (rank + 1) * b)
    batch = {k: torch.from_numpy(data[k][rows])
             for k in ("image", "label", "mask")}
    for tag, (name, init, optimizer, explicit) in job["models"].items():
        st = state_of(name, init, optimizer)
        if explicit:
            ms = make_explicit_dp_train_step(st, axis)(batch)
        else:
            ms = metric_all_reduce(train_step(st, batch, axis), axis)
        save(st, tag)
        results[tag] = [float(t) for t in ms]
elif job["kind"] == "epoch":  # a scan epoch over this rank's columns
    b = data["image"].shape[1] // n
    staged = {"image": torch.from_numpy(data["image"][:, rank * b:(rank + 1) * b]),
              "label": torch.from_numpy(data["label"][:, rank * b:(rank + 1) * b]),
              "mask": torch.from_numpy(data["mask"][:, rank * b:(rank + 1) * b])}
    st = state_of(job["model"], job["init"], "adam_pallas", **job["kwargs"])
    ms = metric_all_reduce(make_train_epoch(st, axis)(staged), axis)
    save(st, job["model"])
    results[job["model"]] = [float(t) for t in ms]
elif job["kind"] == "eval":  # the sharded eval pass of each mode
    test = MNISTDataLoader(data["image"], data["label"], job["batch"],
                           train=False, num_replicas=n, rank=rank,
                           shard=True)
    for mode in ("scan", "stepwise", "explicit"):
        trainer = Trainer(state_of("linear"), test, test, cpu, mode=mode,
                          axis=axis)
        loss, acc = trainer.evaluate()
        results[mode] = [loss.sum, acc.correct, acc.count]
json.dump(results, open(f"{out}/rank{rank}.json", "w"))
distributed.teardown()
"""


@pytest.fixture(autouse=True)
def _one_thread_per_rank(monkeypatch):
    """Processes this file starts use one CPU thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _world(job: dict, n: int, out) -> list:
    """Run ``job`` in a gloo world of ``n`` processes; returns each rank's
    results (``rank{r}.json``)."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    port = launcher.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, f"127.0.0.1:{port}", str(n), str(r),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} (rc {p.returncode}):\n{text}"
    results = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _leaves(path) -> dict:
    return port_ckpt.read_checkpoint_arrays(str(path))[1]


def _params(leaves: dict) -> dict:
    return {k: v for k, v in leaves.items() if k.startswith("['params']")}


# -- the 2-rank step against the JAX package's data-parallel steps ---------

# The optimizer each model's step is compared under. linear takes the
# JAX test's own ``adam``. The cnn takes ``sgd``: Adam's first step,
# -lr * g / (|g| + eps), turns the relative rounding noise of a gradient
# element near 0 into a move of up to lr (one of the cnn's 1.6 M elements
# lands 3.6e-6 apart under adam), where sgd's step is linear in g and
# holds the gradient mean itself to the bound.
DP_STEP_OPTIMIZERS = {"linear": "adam", "cnn": "sgd"}


@pytest.fixture(scope="module")
def dp_step(tmp_path_factory):
    """One train step of ``linear`` and ``cnn`` (float32, the plain loss,
    ``DP_STEP_OPTIMIZERS``) in a 2-rank gloo world of the port, from JAX
    states saved as npz, on one global batch of 64 split 32 + 32."""
    root = tmp_path_factory.mktemp("dp_step")
    images, labels = synthetic_dataset(64, seed=7)
    batch = {"image": normalize_images(images),
             "label": labels.astype(np.int32)}
    np.savez(root / "batch.npz", **batch)
    inits = {}
    for name, optimizer in DP_STEP_OPTIMIZERS.items():
        jstate = jax_create_train_state(
            jax_get_model(name, compute_dtype=jnp.float32), jax.random.key(0),
            optimizer=optimizer)
        inits[name] = (jax_ckpt.save_checkpoint(
            jstate, epoch=-1, best_acc=0.0, is_best=False,
            directory=str(root / f"init_{name}")), optimizer)
    results = _world({"kind": "step", "models": inits,
                      "data": str(root / "batch.npz")}, 2, root / "world")
    return root, batch, results


@pytest.mark.parametrize("model", ["linear", "cnn"])
@pytest.mark.parametrize("reference, atol", [
    ("make_train_step", 1e-6), ("make_explicit_dp_train_step", 1e-5)])
def test_two_rank_step_matches_jax_data_parallel_step(dp_step, model,
                                                      reference, atol):
    root, batch, results = dp_step
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    sharded = NamedSharding(mesh, PartitionSpec("data"))
    gbatch = {k: jax.device_put(v, sharded) for k, v in
              {**batch, "mask": np.ones(64, np.float32)}.items()}
    step = (jax_make_train_step(mesh) if reference == "make_train_step"
            else jax_explicit_step(mesh))
    jstate = jax_create_train_state(
        jax_get_model(model, compute_dtype=jnp.float32), jax.random.key(0),
        optimizer=DP_STEP_OPTIMIZERS[model])
    jstate, jm = step(jstate, gbatch)
    want = dict(jax_ckpt._leaves_with_names({"params": jstate.params}))

    rank0 = _leaves(root / "world" / f"{model}_rank0" / "checkpoint_0.npz")
    rank1 = _leaves(root / "world" / f"{model}_rank1" / "checkpoint_0.npz")
    # The replicas take the same update, bit for bit.
    for name in rank0:
        np.testing.assert_array_equal(rank0[name], rank1[name], err_msg=name)
    # The JAX package's own bounds for the same property
    # (tests/test_train_steps.py: 1e-6 for the auto step against one
    # device, 1e-5 for the explicit step): float32 on both sides, the
    # gradients summed in another order by XLA and by PyTorch.
    got = _params(rank0)
    assert got.keys() == want.keys()
    for name, value in got.items():
        np.testing.assert_allclose(value, np.asarray(want[name]), rtol=0,
                                   atol=atol, err_msg=name)
    # The metrics, summed over the two ranks: the counts exactly, the
    # loss sum to float32 rounding of a different summation order.
    loss_sum, correct, count = results[0][model]
    assert results[1][model] == results[0][model]
    assert (correct, count) == (float(jm.correct), float(jm.count)) \
        == (correct, 64.0)
    np.testing.assert_allclose(loss_sum, float(jm.loss_sum), rtol=1e-5)


# -- the global masked mean over a padded batch ------------------------------

# 65 images over 2 ranks: the sampler pads the epoch to 66 with one
# masked row, the last of rank 1's shard; at a global batch of 22 (11 a
# rank) it lies in epoch 0's last kept batch.
F1_IMAGES, F1_SEED, F1_BATCH = 65, 7, 22


def _rank_batches(epoch: int = 0):
    """Each rank's ``(S, 11)`` batches of epoch ``epoch`` from the port's
    loader (the CLI's shards of ``synthetic_dataset(65, seed=7)``),
    stacked as the 22-row global batches: rank 0's rows, then rank 1's."""
    images, labels = synthetic_dataset(F1_IMAGES, seed=F1_SEED)
    ranks = [MNISTDataLoader(normalize_images(images), labels, F1_BATCH,
                             train=True, num_replicas=2, rank=r,
                             seed=F1_SEED).stacked_epoch(epoch)
             for r in range(2)]
    return {k: np.concatenate([r[k] for r in ranks], axis=1)
            for k in ("image", "label", "mask")}


@pytest.fixture(scope="module")
def padded_step(tmp_path_factory):
    """One sgd step of ``linear`` and ``cnn`` (float32, the plain loss) in a
    2-rank gloo world on epoch 0's last kept global batch, in the stepwise
    rule (``train_step``) and the explicit one, from JAX states saved as
    npz."""
    root = tmp_path_factory.mktemp("padded_step")
    staged = _rank_batches()
    batch = {"image": staged["image"][-1],
             "label": staged["label"][-1].astype(np.int64),
             "mask": staged["mask"][-1]}
    np.savez(root / "batch.npz", **batch)
    models = {}
    for name in ("linear", "cnn"):
        jstate = jax_create_train_state(
            jax_get_model(name, compute_dtype=jnp.float32), jax.random.key(0),
            optimizer="sgd")
        init = jax_ckpt.save_checkpoint(
            jstate, epoch=-1, best_acc=0.0, is_best=False,
            directory=str(root / f"init_{name}"))
        for explicit in (False, True):
            models[f"{name}_{int(explicit)}"] = (name, init, "sgd", explicit)
    results = _world({"kind": "masked_step", "models": models,
                      "data": str(root / "batch.npz")}, 2, root / "world")
    return root, batch, results


def test_the_padded_batch_holds_a_masked_row_of_rank_1(padded_step):
    _, batch, _ = padded_step
    assert batch["mask"][:11].all()
    assert list(batch["mask"][11:]).count(0.0) == 1


@pytest.mark.parametrize("model", ["linear", "cnn"])
@pytest.mark.parametrize("reference, atol", [
    ("make_train_step", 1e-6), ("make_explicit_dp_train_step", 1e-5)])
def test_two_rank_step_on_a_padded_batch_matches_jax(padded_step, model,
                                                     reference, atol):
    root, batch, results = padded_step
    explicit = reference == "make_explicit_dp_train_step"
    tag = f"{model}_{int(explicit)}"
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    sharded = NamedSharding(mesh, PartitionSpec("data"))
    gbatch = {k: jax.device_put(v, sharded) for k, v in
              {**batch, "label": batch["label"].astype(np.int32)}.items()}
    step = jax_explicit_step(mesh) if explicit else jax_make_train_step(mesh)
    jstate = jax_create_train_state(
        jax_get_model(model, compute_dtype=jnp.float32), jax.random.key(0),
        optimizer="sgd")
    jstate, jm = step(jstate, gbatch)
    want = dict(jax_ckpt._leaves_with_names({"params": jstate.params}))
    rank0 = _leaves(root / "world" / f"{tag}_rank0" / "checkpoint_0.npz")
    rank1 = _leaves(root / "world" / f"{tag}_rank1" / "checkpoint_0.npz")
    for name in rank0:
        np.testing.assert_array_equal(rank0[name], rank1[name], err_msg=name)
    # The bounds of the full-mask test above: the JAX package's own for
    # the auto step (1e-6) and the explicit step (1e-5), float32 on both
    # sides, the gradients summed in another order. sgd's step is linear
    # in the gradient, so the bound holds the gradient's rule itself: the
    # global masked mean (21 real rows) for the auto step, the mean of
    # the ranks' masked means (11 and 10 rows) for the explicit one.
    got = _params(rank0)
    assert got.keys() == want.keys()
    for name, value in got.items():
        np.testing.assert_allclose(value, np.asarray(want[name]), rtol=0,
                                   atol=atol, err_msg=name)
    loss_sum, correct, count = results[0][tag]
    assert results[1][tag] == results[0][tag]
    assert (correct, count) == (float(jm.correct), float(jm.count)) \
        == (correct, 21.0)
    np.testing.assert_allclose(loss_sum, float(jm.loss_sum), rtol=1e-5)


def test_a_cli_world_of_2_over_a_padded_batch_takes_the_global_mean(
        tmp_path):
    # --spawn 2 trains one epoch of 3 steps whose last batch holds rank
    # 1's masked row; one process with no axis trains on the same global
    # batches (each rank's rows, concatenated, masks and all): the global
    # masked mean by construction.
    _cli(["--spawn", "2", "--model", "linear", "--dataset", "synthetic",
          "--synthetic-train-size", str(F1_IMAGES),
          "--synthetic-test-size", "32", "--batch-size", str(F1_BATCH),
          "--seed", str(F1_SEED), "--dtype", "f32", "--optimizer", "sgd",
          "--epochs", "1", "--device", "cpu", "--checkpoint-dir",
          str(tmp_path / "two")])
    staged = _rank_batches()
    assert staged["mask"].shape == (3, F1_BATCH)
    assert staged["mask"].sum() == F1_IMAGES  # 66 rows, 1 masked
    state = create_train_state(
        get_model("linear", compute_dtype=torch.float32), F1_SEED, CPU,
        optimizer="sgd")
    make_train_epoch(state)({k: torch.from_numpy(v)
                             for k, v in staged.items()})
    got = _params(_leaves(tmp_path / "two" / "checkpoint_0.npz"))
    want = dict(port_ckpt.state_to_jax(state))
    # The bound of make_train_step above: float32, sgd, the same global
    # masked mean's gradient summed in another order.
    for name, value in got.items():
        np.testing.assert_allclose(value, want[name], rtol=0, atol=1e-6,
                                   err_msg=name)


# -- sharded eval ------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_sharded_eval_counts_every_example_once(n, tmp_path):
    images, labels = synthetic_dataset(101, seed=9)  # no n divides 101
    data = {"image": normalize_images(images),
            "label": labels.astype(np.int64)}
    np.savez(tmp_path / "test.npz", **data)
    results = _world({"kind": "eval", "data": str(tmp_path / "test.npz"),
                      "batch": 12}, n, tmp_path / "world")
    test = MNISTDataLoader(data["image"], data["label"], 12, train=False)
    state = create_train_state(get_model("linear", compute_dtype=torch.float32),
                               3, CPU, optimizer="adam")
    loss, acc = Trainer(state, test, test, CPU, mode="stepwise").evaluate()
    for rank in results:
        assert rank == results[0]  # every rank reads the world's sums
        for mode, (loss_sum, correct, count) in rank.items():
            assert (count, correct) == (101, acc.correct), mode
            # The batch means of other batches, summed in another order.
            np.testing.assert_allclose(loss_sum, loss.sum, rtol=1e-5,
                                       err_msg=mode)


# -- a world of 2 against a world of 1 ---------------------------------------

def _vit_epoch(tmp_path):
    from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention

    images, labels = synthetic_dataset(4 * 32, seed=7)
    staged = {"image": normalize_images(images).reshape(4, 32, 28, 28, 1),
              "label": labels.astype(np.int64).reshape(4, 32),
              "mask": np.ones((4, 32), np.float32)}
    np.savez(tmp_path / "epoch.npz", **staged)
    one = create_train_state(
        get_model("vit", compute_dtype=torch.float32, depth=1,
                  attention_fn=flash_attention), 3, CPU,
        optimizer="adam_pallas")
    init = port_ckpt.save_checkpoint(one, epoch=-1, best_acc=0.0,
                                     is_best=False,
                                     directory=str(tmp_path / "init"))
    return one, staged, init


def test_four_vit_scan_steps_in_a_world_of_2_match_one_process(tmp_path):
    port_loss.set_loss_impl("fused")
    try:
        one, staged, init = _vit_epoch(tmp_path)
        ms = make_train_epoch(one)({k: torch.from_numpy(v)
                                    for k, v in staged.items()})
    finally:
        port_loss.set_loss_impl("xla")
    results = _world({"kind": "epoch", "model": "vit", "init": init,
                      "kwargs": {"depth": 1, "flash": True},
                      "loss": "fused", "data": str(tmp_path / "epoch.npz")},
                     2, tmp_path / "world")
    got = _params(_leaves(tmp_path / "world" / "vit_rank0" /
                          "checkpoint_0.npz"))
    want = dict(port_ckpt.state_to_jax(one))
    # Queue 3's pinned rule: the key bias (qkv.bias[64:128]) has an exact
    # gradient of 0, so each side's is rounding noise that Adam turns
    # into steps of about +-lr: within 2 lr a step. Every other parameter
    # within atol 1e-6: float32, the gradient of 2 x 16 rows averaged
    # against the gradient of 32, and Adam's normalised step far below lr.
    key_bias = "['params']['params']['block0']['attn']['qkv']['bias']"
    for name, value in got.items():
        keep = np.ones(value.shape, bool)
        if name == key_bias:
            keep[64:128] = False
            assert np.abs(value - want[name])[~keep].max() <= 2 * 1e-3 * 4
        np.testing.assert_allclose(value[keep], want[name][keep], rtol=0,
                                   atol=1e-6, err_msg=name)
    loss_sum, correct, count = results[0]["vit"]
    assert (correct, count) == (float(ms.correct), float(ms.count)) \
        == (correct, 128.0)
    np.testing.assert_allclose(loss_sum, float(ms.loss_sum), rtol=1e-5)


_CLI = ["--dataset", "synthetic", "--dtype", "f32", "--loss", "fused",
        "--optimizer", "adam_pallas", "--batch-size", "64",
        "--synthetic-train-size", "256", "--synthetic-test-size", "101",
        "--seed", "0", "--device", "cpu"]


def _cli(argv: list, timeout: float = WORLD_TIMEOUT) -> str:
    """``python -m pytorch_distributed_mnist_tpu_torch argv``; its output
    (rank 0's under ``--spawn``), asserting exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _epoch_numbers(out: str) -> list:
    """The numbers of each ``Epoch:`` line (epoch, lr, losses, accs)."""
    import re

    return [[float(x) for x in re.findall(r"-?\d+\.?\d*", ln)]
            for ln in out.splitlines() if ln.startswith("Epoch: ")]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """``linear`` for 2 epochs of 4 steps in a 2-rank gloo world through
    ``--spawn 2`` (the bare command, scan mode) and in one process:
    ``(root, world-2 output, one-process output)``."""
    root = tmp_path_factory.mktemp("world2")
    flags = _CLI + ["--model", "linear", "--epochs", "2"]
    two = _cli(["--spawn", "2", *flags, "--checkpoint-dir",
                str(root / "two")])
    one = _cli([*flags, "--checkpoint-dir", str(root / "one")])
    return root, two, one


def test_spawn_2_prints_rank_0s_lines_and_the_devices_line(world2):
    _, two, one = world2
    assert "devices: 2 (cpu), processes: 2, mesh: {'data': 2}" in two
    assert "devices: 1 (cpu), processes: 1, mesh: {'data': 1}" in one
    # Rank 1 prints nothing: two epoch lines, one throughput line.
    assert len(_epoch_numbers(two)) == 2
    assert two.count("throughput: ") == 1
    assert "=> " not in two


def test_spawn_2_writes_one_checkpoint_per_epoch_stamped_2x2(world2):
    root, _, _ = world2
    assert sorted(os.listdir(root / "two")) == [
        "checkpoint_0.npz", "checkpoint_1.npz", "model_best.npz"]
    for name in os.listdir(root / "two"):
        meta, _ = port_ckpt.read_checkpoint_arrays(str(root / "two" / name))
        assert meta["world"] == {"processes": 2, "devices": 2}
    meta, _ = port_ckpt.read_checkpoint_arrays(
        str(root / "one" / "checkpoint_1.npz"))
    assert meta["world"] == {"processes": 1, "devices": 1}


def _world_vs_one(root, two: str, one: str, steps: int,
                  last: str = "checkpoint_1.npz") -> None:
    """The world-2 run's last checkpoint and epoch lines against the
    one-process run's. float32 on both sides; the 2 ranks' mean of
    32-row mean gradients against one 64-row mean is rounding in another
    order, which Adam's normalised step keeps far below lr: params within
    atol 1e-6. Where an element's gradient is itself near 0, its rounding
    noise is most of it, and Adam's step -lr * m / (sqrt(v) + eps) turns
    that into a move of up to lr (Queue 3's key-bias rule): at most 1 in
    10^5 elements may lie beyond 1e-6 (the cnn's 1.6 M leave room for 16),
    each within 2 lr a step."""
    a = _params(_leaves(root / "two" / last))
    b = _params(_leaves(root / "one" / last))
    diff = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in a])
    assert (diff > 1e-6).sum() <= diff.size // 10 ** 5, np.sort(diff)[-20:]
    assert diff.max() <= 2 * 1e-3 * steps
    # The lines' numbers: epoch and lr exactly; the losses (6 decimals)
    # within 1e-5 of each other; the accuracies (2 decimals) within one
    # example of 256 or 101.
    for x, y in zip(_epoch_numbers(two), _epoch_numbers(one), strict=True):
        assert x[:3] == y[:3]
        np.testing.assert_allclose([x[3], x[5]], [y[3], y[5]], rtol=0,
                                   atol=1e-5)
        assert abs(x[4] - y[4]) <= 100 / 256 and abs(x[6] - y[6]) <= 100 / 101


def test_world_of_2_matches_one_process_linear(world2):
    _world_vs_one(*world2, steps=8)


def test_world_of_2_matches_one_process_cnn(tmp_path):
    flags = _CLI + ["--model", "cnn", "--epochs", "1"]
    two = _cli(["--spawn", "2", *flags, "--checkpoint-dir",
                str(tmp_path / "two"), "--trainer-mode", "stepwise"])
    one = _cli([*flags, "--checkpoint-dir", str(tmp_path / "one"),
                "--trainer-mode", "stepwise"])
    _world_vs_one(tmp_path, two, one, steps=4, last="checkpoint_0.npz")


def test_explicit_mode_prints_stepwises_epoch_lines_in_a_world_of_2(
        world2, tmp_path):
    flags = _CLI + ["--model", "linear", "--epochs", "2", "--spawn", "2"]
    lines = {}
    for mode in ("stepwise", "explicit"):
        out = _cli([*flags, "--trainer-mode", mode, "--checkpoint-dir",
                    str(tmp_path / mode)])
        lines[mode] = [ln for ln in out.splitlines()
                       if ln.startswith("Epoch: ")]
    assert lines["explicit"] == lines["stepwise"]
    # ... and the scan run's: the same updates, summed once per pass.
    assert lines["stepwise"] == [ln for ln in world2[1].splitlines()
                                 if ln.startswith("Epoch: ")]


def test_explicit_mode_prints_stepwises_epoch_lines_in_one_process(
        tmp_path, capsys):
    flags = _CLI + ["--model", "linear", "--epochs", "2"]
    lines = {}
    for mode in ("stepwise", "explicit"):
        cli.run(cli.build_parser().parse_args(
            flags + ["--trainer-mode", mode, "--checkpoint-dir",
                     str(tmp_path / mode)]))
        lines[mode] = [ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("Epoch: ")]
    port_loss.set_loss_impl("xla")
    assert len(lines["explicit"]) == 2
    assert lines["explicit"] == lines["stepwise"]


# -- checkpoints across worlds ---------------------------------------------

def test_a_world_2_checkpoint_resumes_in_one_process_and_in_jax(world2):
    root, two, _ = world2
    path = str(root / "two" / "checkpoint_0.npz")
    state = create_train_state(get_model("linear", compute_dtype=torch.float32),
                               1, CPU, optimizer="adam_pallas")
    _, epoch, _ = port_ckpt.load_checkpoint(path, state)
    assert epoch == 1
    _, epoch, _ = jax_ckpt.load_checkpoint(path, jax_create_train_state(
        jax_get_model("linear"), jax.random.key(0), optimizer="adam_pallas"))
    assert epoch == 1
    # The world-2 run resumed from its epoch 0 in one process repeats its
    # epoch 1 within the world-vs-one bounds, and resumed in a world of 2
    # repeats it exactly.
    flags = _CLI + ["--model", "linear", "--epochs", "2", "--resume", path]
    resumed_one = _cli([*flags, "--checkpoint-dir", str(root / "r1")])
    resumed_two = _cli([*flags, "--spawn", "2", "--checkpoint-dir",
                        str(root / "r2")])
    want = [ln for ln in two.splitlines() if ln.startswith("Epoch: 1/")]
    assert [ln for ln in resumed_two.splitlines()
            if ln.startswith("Epoch: 1/")] == want
    assert "=> loaded checkpoint" in resumed_two
    x, y = _epoch_numbers(resumed_one)[0], _epoch_numbers("\n".join(want))[0]
    np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)


def test_a_one_process_checkpoint_resumes_in_a_world_of_2(world2):
    root, _, one = world2
    out = _cli(_CLI + ["--model", "linear", "--epochs", "2", "--spawn", "2",
                       "--resume", "auto", "--checkpoint-dir",
                       str(root / "auto")])
    assert "no checkpoint in" in out  # --resume auto on an empty dir
    os.makedirs(root / "from_one")
    import shutil

    shutil.copyfile(root / "one" / "checkpoint_0.npz",
                    root / "from_one" / "checkpoint_0.npz")
    out = _cli(_CLI + ["--model", "linear", "--epochs", "2", "--spawn", "2",
                       "--resume", "auto", "--checkpoint-dir",
                       str(root / "from_one")])
    assert "=> loaded checkpoint" in out
    got = _epoch_numbers(out)
    assert len(got) == 1 and got[0][0] == 1
    np.testing.assert_allclose(got[0], _epoch_numbers(one)[1], rtol=0,
                               atol=1e-5)
    meta, _ = port_ckpt.read_checkpoint_arrays(
        str(root / "from_one" / "checkpoint_1.npz"))
    assert meta["world"] == {"processes": 2, "devices": 2}


# -- the loader's shards -------------------------------------------------

def _data(n=103):
    images, labels = synthetic_dataset(n, seed=2)
    return normalize_images(images), labels


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("n", [2, 3])
def test_rank_indices_equal_the_jax_loaders(train, n):
    x, y = _data()
    for rank in range(n):
        ours = MNISTDataLoader(x, y, 12, train=train, num_replicas=n,
                               rank=rank, seed=4, shard=True)
        ref = JaxLoader(x, y, 12, train=train, num_replicas=n, rank=rank,
                        seed=4, shard=True)
        for epoch in (0, 3):
            idx, mask = ours.epoch_ticks(epoch)
            want_idx, want_mask = ref.epoch_ticks(epoch)
            np.testing.assert_array_equal(idx, want_idx)
            np.testing.assert_array_equal(mask, want_mask)
        assert ours.local_batch_size == ref.local_batch_size == 12 // n
        assert ours.global_batch_size == 12
        assert len(ours) == len(ref)


def test_train_shards_are_disjoint_and_cover_the_data():
    x, y = _data(96)
    seen = []
    for rank in range(3):
        loader = MNISTDataLoader(x, y, 12, train=True, num_replicas=3,
                                 rank=rank, seed=1)
        loader.set_sample_epoch(2)
        idx, mask = loader.epoch_ticks()
        assert idx.shape == (8, 4) and mask.all()
        seen.append(set(idx.ravel().tolist()))
    assert not (seen[0] & seen[1] or seen[0] & seen[2] or seen[1] & seen[2])
    assert set().union(*seen) == set(range(96))


def test_eval_is_replicated_unless_sharded():
    x, y = _data()
    loader = MNISTDataLoader(x, y, 12, train=False, num_replicas=2, rank=1)
    idx, _ = loader.epoch_ticks()
    assert len(loader.sampler) == 103 and idx.shape == (18, 6)


def test_an_indivisible_batch_raises_the_jax_text():
    x, y = _data()
    with pytest.raises(ValueError) as ours:
        MNISTDataLoader(x, y, 10, num_replicas=3)
    with pytest.raises(ValueError) as ref:
        JaxLoader(x, y, 10, num_replicas=3)
    assert str(ours.value) == str(ref.value)


# -- the launcher, the CLI's refusals, the environment --------------------

def test_strip_spawn_flag():
    assert launcher.strip_spawn_flag(["--spawn", "4", "--epochs", "2"]) == [
        "--epochs", "2"]
    assert launcher.strip_spawn_flag(["--spawn=4", "--epochs", "2"]) == [
        "--epochs", "2"]
    assert launcher.strip_spawn_flag(["--epochs", "2"]) == ["--epochs", "2"]


def test_strip_flags_drops_each_flag_with_its_values():
    argv = ["--device", "cuda", "--spawn=2", "--epochs", "3", "--device=cpu",
            "--model", "cnn"]
    assert launcher.strip_flags(argv, {"--spawn": 1, "--device": 1}) == [
        "--epochs", "3", "--model", "cnn"]


def test_spawn_1_exits_with_the_jax_message():
    with pytest.raises(SystemExit) as info:
        cli.main(["--spawn", "1"])
    assert "at least 2 processes" in str(info.value.code)


def test_spawn_with_a_coordinator_exits_with_the_jax_message():
    with pytest.raises(SystemExit) as info:
        cli.main(["--spawn", "2", "--coordinator", "127.0.0.1:1234"])
    assert "cannot combine" in str(info.value.code)


def test_spawn_on_one_card_exits_2_with_the_one_card_per_rank_message(
        monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(launcher, "spawn_local", None)  # never reached
    with pytest.raises(SystemExit) as info:
        cli.main(["--spawn", "2", "--model", "linear"])
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert "NCCL needs one card per rank and 1 card(s) are visible" in err
    assert "--device cpu runs a gloo world" in err


def test_spawned_ranks_take_one_card_each():
    assert [launcher.child_device("cuda", r) for r in range(3)] == [
        "cuda:0", "cuda:1", "cuda:2"]
    assert launcher.child_device("cpu", 1) == "cpu"


def test_a_signal_killed_rank_exits_128_plus_the_signal(tmp_path,
                                                        monkeypatch):
    (tmp_path / "killed_rank.py").write_text(
        "import os, signal, sys\n"
        "if sys.argv[sys.argv.index('--process-id') + 1] == '1':\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "import time; time.sleep(60)\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setattr(launcher, "PACKAGE", "killed_rank")
    # Rank 1 dies by SIGKILL; rank 0, left waiting, is stopped.
    assert launcher.spawn_local(2, [], device="cpu", timeout=60) == 128 + 9


_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "SLURM_NTASKS",
             "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


def test_env_detection_nothing(monkeypatch):
    for var in _ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert not distributed._multiprocess_env_detected()


@pytest.mark.parametrize("env, expect", [
    ({"MASTER_ADDR": "10.0.0.2", "WORLD_SIZE": "4"}, True),
    ({"MASTER_ADDR": "10.0.0.2", "WORLD_SIZE": "1"}, False),
    ({"WORLD_SIZE": "4"}, False),
    ({"SLURM_NTASKS": "4"}, True),
    ({"SLURM_NTASKS": "1"}, False),
    ({"SLURM_NTASKS": "garbage"}, False),
    ({"OMPI_COMM_WORLD_SIZE": "2"}, True),
    ({"PMI_SIZE": "3"}, True),
])
def test_env_detection(monkeypatch, env, expect):
    for var in _ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert distributed._multiprocess_env_detected() is expect


def test_env_world_reads_the_launchers_rank(monkeypatch):
    for var in _ENV_VARS + ("MASTER_PORT", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed._env_world()
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    assert distributed._env_world() == ("10.0.0.2:29500", 4, 2)


def test_one_process_without_flags_makes_no_group():
    distributed.initialize_distributed(device=CPU)
    assert not torch.distributed.is_initialized()
    assert distributed.runtime_info()["mode"] == "single"
    axis = make_mesh(device=CPU)
    assert (axis.size, axis.rank, axis.reduces) == (1, 0, False)
    distributed.teardown()


def test_the_mesh_refuses_other_axes():
    """The two-tier meshes are built by ``make_hier_mesh`` (make_mesh
    points there); the ('data', 'model', 'seq') mesh and the pipeline's
    ('data', 'stage') mesh are the port's too."""
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
        make_hier_mesh,
    )

    mesh = make_mesh(("data", "stage"), (1, 1), device=CPU)
    assert mesh.shape == {"data": 1, "stage": 1}
    assert mesh.stage.size == 1 and mesh.model is None
    with pytest.raises(ValueError, match="make_hier_mesh"):
        make_mesh(("dcn", "ici"), (1, 1), device=CPU)
    hier = make_hier_mesh(1, device=CPU)
    assert hier.shape == {"dcn": 1, "ici": 1} and not hier.reduces
    assert (hier.data.size, hier.data.rank) == (1, 0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        make_mesh(("data",), (2,), device=CPU)
    mesh = make_mesh(("data", "model", "seq"), (1, 1, 1), device=CPU)
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1}
    assert not mesh.reduces and mesh.data.sums is None


def test_the_mesh_and_the_rendezvous_default_to_the_card():
    """F8: with no device, ``make_mesh`` and ``initialize_distributed``
    ask for the card, as every entry point of the port does, and raise
    where none is visible; the CPU is asked for by name."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh(("data", "stage"), (1, 1))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        distributed.initialize_distributed()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        distributed.initialize_distributed(
            "127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()
    assert make_mesh(device=CPU).device == CPU


def test_log0_prints_nothing_on_rank_1(monkeypatch, capsys):
    monkeypatch.setattr(port_logging, "process_index", lambda: 1)
    port_logging.log0("hello")
    assert capsys.readouterr().out == ""
    port_logging.log0("hello", all_ranks=True)
    assert capsys.readouterr().out == "hello\n"
    monkeypatch.setattr(port_logging, "process_index", lambda: 0)
    port_logging.log0("hello")
    assert capsys.readouterr().out == "hello\n"


# -- a world of one: the group path against no group ------------------------

@pytest.fixture
def world_of_one():
    """This process as a gloo world of one (the explicit rendezvous), torn
    down afterwards."""
    distributed.initialize_distributed(
        f"127.0.0.1:{launcher.free_port()}", 1, 0, CPU)
    try:
        yield make_mesh(device=CPU)
    finally:
        distributed.teardown()
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_trains_bit_for_bit_as_no_group(world_of_one):
    from pytorch_distributed_mnist_tpu_torch.parallel import collectives

    axis = world_of_one
    assert (axis.size, axis.rank, axis.reduces) == (1, 0, True)
    images, labels = synthetic_dataset(4 * 32, seed=3)
    staged = {"image": torch.from_numpy(
                  normalize_images(images).reshape(4, 32, 28, 28, 1)),
              "label": torch.from_numpy(labels.astype(np.int64)
                                        .reshape(4, 32)),
              "mask": torch.ones(4, 32)}

    def state():
        return create_train_state(get_model("cnn"), 5, CPU,
                                  optimizer="adam_pallas")

    alone, grouped = state(), state()
    grads_before = collectives.grad_all_reduce.launches
    metrics_before = collectives.metric_all_reduce.launches
    want = make_train_epoch(alone)(staged)
    epoch = make_train_epoch(grouped, axis)
    got = collectives.metric_all_reduce(epoch(staged), axis)
    # One rank's sum divided by 1: the same bits as the path with no group.
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (name, a), b in zip(grouped.model.named_parameters(),
                            alone.model.parameters()):
        assert torch.equal(a, b), name
    assert collectives.grad_all_reduce.launches - grads_before == 4
    assert collectives.metric_all_reduce.launches - metrics_before == 1
    # Every gradient is a view of the one flat buffer the all-reduce sums.
    flat = grouped.grad_buffer.flat
    for p in grouped.model.parameters():
        assert p.grad.untyped_storage().data_ptr() \
            == flat.untyped_storage().data_ptr()
    assert alone.grad_buffer is None  # no group, no buffer
    # A graph recorded the buffer's address: a new buffer raises before
    # a replay (on the CPU the check is taken as a capture would take it).
    program = epoch.program
    program._graph, program._bound = object(), program._pointers()
    grouped.grad_buffer = collectives.GradBuffer(grouped.optimizer.params)
    with pytest.raises(RuntimeError, match="rebound"):
        epoch(staged)


def test_a_gradient_outside_the_buffer_raises(world_of_one):
    from pytorch_distributed_mnist_tpu_torch.parallel import collectives

    state = create_train_state(get_model("linear"), 5, CPU)
    grads = collectives.grad_buffer(state)
    p = state.optimizer.params[0]
    p.grad = torch.zeros_like(p)  # rebound behind the buffer's back
    with pytest.raises(RuntimeError, match="left the flat all-reduce"):
        collectives.grad_all_reduce(grads, world_of_one)
    grads.zero_()  # the next step binds it back
    assert p.grad is grads.views[0]
