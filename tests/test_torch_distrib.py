"""The port's delta distribution format (``distrib/cas.py``,
``distrib/publish.py``) against the JAX package's, on the CPU: the copied
chunk planner, one train state's manifest (the same leaf records and
chunk digests in both packages), each package loading and resuming from
the other's manifest bit for bit, chunk sharing between adjacent
publishes, the GC window and a torn manifest. Mirrors the format tests of
``tests/test_distrib_delta.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.distrib import cas as jax_cas
from pytorch_distributed_mnist_tpu.distrib import publish as jax_publish
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.parallel.zero_overlap import (
    bucket_plan as jax_bucket_plan,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.distrib import cas, publish
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)

pytestmark = pytest.mark.distrib
torch.set_num_threads(2)
CPU = torch.device("cpu")


def _jax_state(model: str, seed: int = 0):
    return jax_create_train_state(
        jax_get_model(model, compute_dtype=jnp.float32),
        jax.random.key(seed))


def _port_state(model: str, seed: int = 3):
    return create_train_state(get_model(model, compute_dtype=torch.float32),
                              seed=seed, device=CPU)


def _port_twin(jstate, model: str, tmp_path):
    """The port's train state holding ``jstate``'s values (through the
    JAX package's npz, which the port loads bit for bit)."""
    path = jax_ckpt.save_checkpoint(jstate, epoch=0, best_acc=0.0,
                                    is_best=False,
                                    directory=str(tmp_path / "twin"),
                                    process_index=0)
    state = _port_state(model)
    port_ckpt.load_checkpoint(path, state)
    return state


def _perturbed_named(named, delta: float):
    """``named`` with its smallest params leaf shifted by ``delta``."""
    params = [i for i, (n, _) in enumerate(named)
              if n.startswith("['params']")]
    small = min(params, key=lambda i: named[i][1].size)
    out = list(named)
    out[small] = (out[small][0], (out[small][1] + np.float32(delta))
                  .astype(out[small][1].dtype))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_copied_planner_and_chunker_equal_jax(seed):
    rng = np.random.default_rng(seed)
    leaves = [np.zeros(tuple(rng.integers(1, 40, size=rng.integers(0, 4))),
                       dtype=rng.choice([np.float32, np.int32, np.float16]))
              for _ in range(int(rng.integers(1, 25)))]
    for mb in (0.001, 0.004, 1.0):
        assert cas.bucket_plan(leaves, mb) == jax_bucket_plan(leaves, mb)
        assert cas.plan_order(leaves, mb) == jax_cas.plan_order(leaves, mb)
    data = rng.integers(0, 256, size=int(rng.integers(0, 5000)),
                        dtype=np.uint8).tobytes()
    for budget in (1, 7, 1024, 1 << 20):
        assert cas.chunk_leaf(data, budget) == jax_cas.chunk_leaf(data,
                                                                  budget)
    with pytest.raises(ValueError):
        cas.bucket_plan(leaves, 0)


@pytest.mark.parametrize("model", ["linear", "cnn"])
def test_one_state_publishes_the_same_leaves_and_digests(tmp_path, model):
    jstate = _jax_state(model)
    state = _port_twin(jstate, model, tmp_path)
    want = jax_publish.publish_state(jstate, epoch=3, best_acc=0.25,
                                     directory=str(tmp_path / "jax"),
                                     chunk_mb=0.25, process_index=0)
    got = publish.publish_state(state, epoch=3, best_acc=0.25,
                                directory=str(tmp_path / "port"),
                                chunk_mb=0.25)
    jm, pm = jax_cas.read_manifest(want), cas.read_manifest(got)
    assert pm["leaves"] == jm["leaves"]  # names, shapes, dtypes, digests
    for key in ("epoch", "best_acc", "leaf_names", "format_version",
                "chunk_mb"):
        assert pm[key] == jm[key], key
    assert pm["world"] == {"processes": 1, "devices": 1}
    assert cas.ChunkStore(str(tmp_path / "port")).digests() == \
        jax_cas.ChunkStore(str(tmp_path / "jax")).digests()


def test_each_package_loads_the_other_s_manifest_bit_for_bit(tmp_path):
    jstate = _jax_state("cnn", seed=4)
    jpath = jax_publish.publish_state(jstate, epoch=1, best_acc=0.5,
                                      directory=str(tmp_path / "jax"),
                                      process_index=0)
    state = _port_state("cnn")
    _, epoch, best = port_ckpt.load_checkpoint(jpath, state)
    assert (epoch, best) == (2, 0.5)
    want = dict(jax_ckpt._leaves_with_names(jax_ckpt._state_tree(jstate)))
    for name, arr in state_to_jax(state):
        np.testing.assert_array_equal(arr, np.asarray(want[name]),
                                      err_msg=name)
    other = _port_state("cnn", seed=5)
    ppath = port_ckpt.save_checkpoint(other, epoch=6, best_acc=0.75,
                                      is_best=True,
                                      directory=str(tmp_path / "port"),
                                      publish="delta", chunk_mb=0.5)
    assert os.path.basename(ppath) == "checkpoint_6.manifest"
    assert os.path.isfile(tmp_path / "port" / "model_best.manifest")
    restored, epoch, best = jax_ckpt.load_checkpoint(ppath,
                                                     _jax_state("cnn", 9))
    assert (epoch, best) == (7, 0.75)
    got = dict(jax_ckpt._leaves_with_names(jax_ckpt._state_tree(restored)))
    for name, arr in state_to_jax(other):
        np.testing.assert_array_equal(np.asarray(got[name]), arr,
                                      err_msg=name)


_CLI = ["--dataset", "synthetic", "--model", "linear", "--batch-size", "64",
        "--synthetic-train-size", "256", "--synthetic-test-size", "128",
        "--epochs", "2", "--seed", "0", "--trainer-mode", "stepwise",
        "--dtype", "f32"]


def test_each_package_resumes_from_the_other_s_manifest(tmp_path, capsys):
    # The port's CLI publishes 2 epochs as manifests; the JAX CLI resumes
    # from epoch 0's and trains epoch 1; the port resumes from the JAX
    # run's manifest of epoch 1 and evaluates it.
    cli.run(cli.build_parser().parse_args(_CLI + [
        "--device", "cpu", "--publish", "delta", "--chunk-mb", "0.01",
        "--checkpoint-dir", str(tmp_path / "port")]))
    port_lines = [ln for ln in capsys.readouterr().out.splitlines()
                  if ln.startswith("Epoch: ")]
    from pytorch_distributed_mnist_tpu.cli import build_parser as jax_parser
    from pytorch_distributed_mnist_tpu.cli import run as jax_run

    want = jax_run(jax_parser().parse_args(_CLI + [
        "--resume", str(tmp_path / "port" / "checkpoint_0.manifest"),
        "--checkpoint-dir", str(tmp_path / "jax"), "--publish", "delta",
        "--no-precompile"]))
    assert want["start_epoch"] == 1 and want["epochs_run"] == 1
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("Epoch: ")]
    # float32 on both sides; the JAX side sums each batch over 8 virtual
    # devices in another order (test_torch_train's tolerances).
    assert jax_lines[-1].split(",")[:2] == port_lines[1].split(",")[:2]
    jleaves = port_ckpt.read_checkpoint_arrays(
        str(tmp_path / "jax" / "checkpoint_1.manifest"))[1]
    pleaves = port_ckpt.read_checkpoint_arrays(
        str(tmp_path / "port" / "checkpoint_1.manifest"))[1]
    assert list(jleaves) == list(pleaves)
    for name in pleaves:
        np.testing.assert_allclose(jleaves[name], pleaves[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    got = cli.run(cli.build_parser().parse_args(_CLI + [
        "--device", "cpu", "-e", "--checkpoint-dir", str(tmp_path / "e"),
        "--resume", str(tmp_path / "jax" / "checkpoint_1.manifest")]))
    assert got["start_epoch"] == 2
    np.testing.assert_allclose(got["test_loss"],
                               want["history"][-1]["test_loss"], rtol=1e-5)


def test_adjacent_publishes_share_unchanged_chunks(tmp_path):
    named = state_to_jax(_port_state("linear"))
    for pkg, directory in ((publish, tmp_path / "port"),
                           (jax_publish, tmp_path / "jax")):
        store = cas.ChunkStore(str(directory))
        pkg.publish_arrays(named, epoch=1, best_acc=0.5,
                           directory=str(directory), chunk_mb=0.001)
        before = store.digests()
        p2 = pkg.publish_arrays(_perturbed_named(named, 1e-3), epoch=2,
                                best_acc=0.5, directory=str(directory),
                                chunk_mb=0.001)
        new = store.digests() - before
        # The smallest params leaf (the bias) fits one chunk: one chunk
        # written, every other chunk of epoch 2 shared with epoch 1.
        assert len(new) == 1
        assert cas.manifest_digests(cas.read_manifest(p2)) - before == new
    assert cas.ChunkStore(str(tmp_path / "port")).digests() == \
        cas.ChunkStore(str(tmp_path / "jax")).digests()
    assert publish.last_publish["chunks_new"] == 1


def test_the_gc_window_holds_as_in_jax(tmp_path):
    named = state_to_jax(_port_state("linear"))
    listings = []
    for pkg, directory in ((publish, tmp_path / "port"),
                           (jax_publish, tmp_path / "jax")):
        for epoch in range(4):
            pkg.publish_arrays(_perturbed_named(named, 1e-3 * epoch),
                               epoch=epoch, best_acc=0.1,
                               directory=str(directory), chunk_mb=0.001,
                               is_best=epoch == 1, keep_last=1)
        listings.append((sorted(os.listdir(directory)),
                         cas.ChunkStore(str(directory)).digests()))
        referenced = set()
        for name in os.listdir(directory):
            if name.endswith(".manifest"):
                referenced |= cas.manifest_digests(
                    cas.read_manifest(str(directory / name)))
        # Exactly the chunks the manifests in the window (and the best
        # copy, of epoch 1) name survive.
        assert cas.ChunkStore(str(directory)).digests() == referenced
    assert listings[0] == listings[1]
    assert listings[0][0] == ["checkpoint_2.manifest",
                              "checkpoint_3.manifest", "chunks",
                              "model_best.manifest"]


def test_a_torn_manifest_pins_no_chunk(tmp_path):
    named = state_to_jax(_port_state("linear"))
    path = publish.publish_arrays(named, epoch=1, best_acc=0.5,
                                  directory=str(tmp_path), chunk_mb=0.001)
    whole = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(whole[:len(whole) // 2])
    with pytest.raises(ValueError) as info:  # json.JSONDecodeError
        port_ckpt.read_checkpoint_arrays(path)
    assert port_ckpt.is_corrupt_checkpoint_error(info.value)
    assert publish.gc_chunks(str(tmp_path)) > 0
    assert cas.ChunkStore(str(tmp_path)).digests() == set()


def test_the_chunk_store_is_write_once_and_verified(tmp_path):
    store = cas.ChunkStore(str(tmp_path))
    data = b"chunk bytes"
    digest = cas.digest_of(data)
    assert store.put(digest, data) is True
    assert store.put(digest, data) is False  # write-once
    assert store.get(digest) == data
    with pytest.raises(ValueError, match="does not match its digest"):
        store.put(cas.digest_of(b"other"), data)
    with pytest.raises(ValueError, match="missing chunk"):
        store.get(cas.digest_of(b"never stored"))
    # The JAX package reads the port's store and the other way round.
    assert jax_cas.ChunkStore(str(tmp_path)).get(digest) == data


def test_publish_from_checkpoint_converts_each_layout(tmp_path):
    state = _port_state("linear")
    npz = port_ckpt.save_checkpoint(state, epoch=2, best_acc=0.5,
                                    is_best=False,
                                    directory=str(tmp_path / "npz"))
    ckpt = port_ckpt.save_checkpoint(state, epoch=2, best_acc=0.5,
                                     is_best=False,
                                     directory=str(tmp_path / "dir"),
                                     layout="sharded")
    want = cas.read_manifest(jax_publish.publish_from_checkpoint(
        npz, str(tmp_path / "jax"), chunk_mb=0.001))
    for source in (npz, ckpt):
        path = publish.publish_from_checkpoint(
            source, str(tmp_path / f"out_{os.path.basename(source)}"),
            chunk_mb=0.001)
        got = cas.read_manifest(path)
        assert os.path.basename(path) == "checkpoint_2.manifest"
        assert got["leaves"] == want["leaves"]
        assert got["epoch"] == 3 and got["best_acc"] == 0.5
