"""The port's sharded ``.ckpt`` layout and asynchronous saver
(``train/checkpoint.py``) against the JAX package's, on the CPU: a JAX
directory written from the 8-device mesh resumes in the port, a port
directory written by a gloo world of 2 loads in JAX, the asynchronous
saver writes what the synchronous one writes in every trainer mode, a
write error surfaces, and the resolution, prune and quarantine rules see
all three layouts as JAX's do. Mirrors the sharded and async tests of
``tests/test_checkpoint.py``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.parallel.zero import shard_state_zero1
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)

pytestmark = pytest.mark.serve
torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120  # seconds the world of processes may take


def _port_state(seed: int = 3):
    return create_train_state(get_model("linear", compute_dtype=torch.float32),
                              seed=seed, device=CPU)


def _jax_state(seed: int = 0):
    return jax_create_train_state(
        jax_get_model("linear", compute_dtype=jnp.float32),
        jax.random.key(seed))


def _jax_leaves(state) -> dict:
    return {k: np.asarray(v) for k, v in jax_ckpt._leaves_with_names(
        jax_ckpt._state_tree(state))}


def _files_equal(a, b) -> None:
    """Every checkpoint in directories ``a`` and ``b`` holds the same
    leaves, bit for bit."""
    names = sorted(n for n in os.listdir(a) if n != "chunks")
    assert names == sorted(n for n in os.listdir(b) if n != "chunks")
    for name in names:
        ma, la = port_ckpt.read_checkpoint_arrays(os.path.join(a, name))
        mb, lb = port_ckpt.read_checkpoint_arrays(os.path.join(b, name))
        assert ma["epoch"] == mb["epoch"] and list(la) == list(lb)
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=name + k)


def test_a_jax_directory_from_the_8_device_mesh_resumes_in_the_port(
        tmp_path, mesh8, capsys):
    jstate, _ = shard_state_zero1(_jax_state(), mesh8)
    path = jax_ckpt.save_checkpoint(jstate, epoch=0, best_acc=0.25,
                                    is_best=True, directory=str(tmp_path),
                                    process_index=0, layout="sharded")
    assert os.path.isdir(path) and path.endswith("checkpoint_0.ckpt")
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == path
    state = _port_state()
    _, epoch, best = port_ckpt.try_resume(path, state)
    assert (epoch, best) == (1, 0.25)
    want = _jax_leaves(jstate)
    for name, arr in state_to_jax(state):
        np.testing.assert_array_equal(arr, want[name], err_msg=name)
    got = cli.run(cli.build_parser().parse_args([
        "--dataset", "synthetic", "--model", "linear", "--device", "cpu",
        "--synthetic-train-size", "256", "--synthetic-test-size", "128",
        "--batch-size", "64", "--epochs", "2", "--seed", "0",
        "--resume", str(tmp_path / "model_best.ckpt"),
        "--checkpoint-dir", str(tmp_path / "run")]))
    assert got["start_epoch"] == 1 and got["epochs_run"] == 1
    assert "Epoch: 1/2" in capsys.readouterr().out


# Rank 0 binds the rendezvous's port itself (port 0: the system picks a
# free one, held from then on) and hands the number to rank 1 through a
# file; the rendezvous then shares that listening store (multi-tenant).
# No other process can take the port between its choice and the bind.
_RANK = r"""
import os
import sys
import time
import torch
import torch.distributed as dist
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as ck
from pytorch_distributed_mnist_tpu_torch.train.state import create_train_state

port_file, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
deadline = time.monotonic() + float(sys.argv[4])
if rank == 0:
    store = dist.TCPStore("127.0.0.1", 0, 2, True, wait_for_workers=False,
                          multi_tenant=True)
    with open(port_file + ".tmp", "w") as f:
        f.write(str(store.port))
    os.replace(port_file + ".tmp", port_file)
else:
    while not os.path.exists(port_file):
        if time.monotonic() > deadline:
            sys.exit("rank 1: rank 0 never published its port")
        time.sleep(0.05)
with open(port_file) as f:
    port = int(f.read())
cpu = torch.device("cpu")
distributed.initialize_distributed(f"127.0.0.1:{port}", 2, rank, cpu)
state = create_train_state(get_model("linear", compute_dtype=torch.float32),
                           3, cpu)
path = ck.save_checkpoint(state, epoch=4, best_acc=0.5, is_best=True,
                          directory=out + "/sync", layout="sharded")
with ck.AsyncCheckpointer() as saver:
    saver.save(state, epoch=4, best_acc=0.5, is_best=True,
               directory=out + "/async", layout="sharded")
    # Published at the drain, not before.
    assert not os.path.isdir(out + "/async/checkpoint_4.ckpt")
print("rank", rank, "saved", path)
distributed.teardown()
"""


def test_a_port_directory_from_a_world_of_2_loads_in_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(tmp_path / "port"), str(r),
         str(tmp_path), str(WORLD_TIMEOUT)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} (rc {p.returncode}):\n{text}"
    path = tmp_path / "sync" / "checkpoint_4.ckpt"
    assert sorted(os.listdir(path)) == [
        "index_p00000.json", "index_p00001.json", "meta.json",
        "shards_p00000.npz"]
    with open(path / "index_p00001.json") as f:
        assert json.load(f) == {"file": None, "shards": []}
    meta = port_ckpt._read_meta(str(path))
    assert meta["world"] == {"processes": 2, "devices": 2}
    assert meta["format_version"] == 2
    assert os.path.isdir(tmp_path / "sync" / "model_best.ckpt")
    restored, epoch, best = jax_ckpt.load_checkpoint(str(path), _jax_state(7))
    assert (epoch, best) == (5, 0.5)
    got = _jax_leaves(restored)
    for name, arr in state_to_jax(_port_state()):
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    _files_equal(str(tmp_path / "sync"), str(tmp_path / "async"))


_CLI = ["--dataset", "synthetic", "--model", "linear", "--device", "cpu",
        "--synthetic-train-size", "256", "--synthetic-test-size", "128",
        "--batch-size", "64", "--epochs", "2", "--seed", "0"]


@pytest.mark.parametrize("publish", ["full", "delta"])
@pytest.mark.parametrize("mode", ["scan", "stepwise", "explicit"])
def test_the_async_saver_writes_what_the_sync_one_writes(tmp_path, mode,
                                                         publish):
    flags = _CLI + ["--trainer-mode", mode, "--publish", publish,
                    "--chunk-mb", "0.01"]
    sync = cli.run(cli.build_parser().parse_args(flags + [
        "--checkpoint-dir", str(tmp_path / "sync")]))
    asyn = cli.run(cli.build_parser().parse_args(flags + [
        "--checkpoint-dir", str(tmp_path / "async"), "--async-checkpoint"]))
    assert [r["train_loss"] for r in sync["history"]] == \
        [r["train_loss"] for r in asyn["history"]]
    assert sync["checkpoint_drain_ms"] is None
    assert len(asyn["checkpoint_drain_ms"]) == 3  # 2 saves, then the exit
    _files_equal(str(tmp_path / "sync"), str(tmp_path / "async"))


def test_the_async_saver_copies_the_state_before_it_returns(tmp_path):
    state = _port_state()
    want = state_to_jax(state)
    with port_ckpt.AsyncCheckpointer() as saver:
        saver.save(state, epoch=0, best_acc=0.0, is_best=False,
                   directory=str(tmp_path))
        with torch.no_grad():  # the next epoch moves the params in place
            for p in state.model.parameters():
                p.add_(1.0)
    got = port_ckpt.read_checkpoint_arrays(
        str(tmp_path / "checkpoint_0.npz"))[1]
    for name, arr in want:
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_a_write_error_surfaces_at_the_next_drain(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_bytes(b"x")
    saver = port_ckpt.AsyncCheckpointer()
    saver.save(_port_state(), epoch=0, best_acc=0.0, is_best=False,
               directory=str(blocker))
    with pytest.raises(OSError):
        saver.wait()
    assert saver.wait() is None  # raised once, then cleared
    with pytest.raises(OSError):
        with port_ckpt.AsyncCheckpointer() as other:
            other.save(_port_state(), epoch=0, best_acc=0.0, is_best=False,
                       directory=str(blocker))
    with pytest.raises(ValueError, match="publish_from_checkpoint"):
        saver.save(_port_state(), epoch=0, best_acc=0.0, is_best=False,
                   directory=str(tmp_path), publish="delta",
                   layout="sharded")


def test_async_checkpoint_with_keep_last_1_through_the_cli(tmp_path,
                                                            capsys):
    got = cli.run(cli.build_parser().parse_args(
        [a if a != "2" else "3" for a in _CLI] + [
            "--async-checkpoint", "--keep-last", "1",
            "--checkpoint-dir", str(tmp_path)]))
    assert got["epochs_run"] == 3
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint_1.npz", "checkpoint_2.npz", "model_best.npz"]
    assert capsys.readouterr().out.count("Epoch: ") == 3


def test_resolution_prune_and_quarantine_see_every_layout(tmp_path):
    state = _port_state()
    twin = tmp_path / "twin"
    for epoch, kw in enumerate([{}, {"layout": "sharded"},
                                {"publish": "delta"}, {"layout": "sharded"},
                                {}]):
        port_ckpt.save_checkpoint(state, epoch=epoch, best_acc=0.0,
                                  is_best=False, directory=str(tmp_path),
                                  **kw)
    os.makedirs(twin)
    for name in os.listdir(tmp_path):
        if name.startswith("checkpoint_"):
            if os.path.isdir(tmp_path / name):
                os.makedirs(twin / name)
            else:
                (twin / name).write_bytes(b"x")
    want = [(e, str(tmp_path / n)) for e, n in enumerate([
        "checkpoint_0.npz", "checkpoint_1.ckpt", "checkpoint_2.manifest",
        "checkpoint_3.ckpt", "checkpoint_4.npz"])]
    assert port_ckpt._epoch_checkpoints(str(tmp_path)) == want
    assert jax_ckpt._epoch_checkpoints(str(tmp_path)) == want
    dest = port_ckpt.quarantine_checkpoint(str(tmp_path / "checkpoint_4.npz"))
    assert dest.endswith("checkpoint_4.npz.corrupt")
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == want[3][1]
    (twin / "checkpoint_4.npz").rename(twin / "checkpoint_4.npz.corrupt")
    port_ckpt.prune_checkpoints(str(tmp_path), 1)
    jax_ckpt.prune_checkpoints(str(twin), 1)
    kept = sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("checkpoint_"))
    assert kept == sorted(os.listdir(twin)) == [
        "checkpoint_2.manifest", "checkpoint_3.ckpt",
        "checkpoint_4.npz.corrupt"]
    # The sharded directory resumes; a quarantined directory does not
    # resolve.
    _, epoch, _ = port_ckpt.load_checkpoint(str(tmp_path /
                                                "checkpoint_3.ckpt"), state)
    assert epoch == 4
    port_ckpt.quarantine_checkpoint(str(tmp_path / "checkpoint_3.ckpt"))
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == want[2][1]


def test_a_directory_missing_a_shard_is_absence_not_corruption(tmp_path):
    path = port_ckpt.save_checkpoint(_port_state(), epoch=0, best_acc=0.0,
                                     is_best=False, directory=str(tmp_path),
                                     layout="sharded")
    os.remove(os.path.join(path, "shards_p00000.npz"))
    with pytest.raises(ValueError, match="missing shards") as info:
        port_ckpt.load_checkpoint(path, _port_state())
    assert not port_ckpt.is_corrupt_checkpoint_error(info.value)


def _flaky_replace(monkeypatch, fail_on: str, *, lost_reply: bool = False):
    """``os.replace`` that fails its first rename onto a path ending in
    ``fail_on``: a transient ``OSError(116, 'Stale file handle')``, or,
    with ``lost_reply``, the rename made and its reply lost (``ENOENT``)."""
    real = os.replace
    state = {"failed": 0}

    def replace(src, dst):
        if str(dst).endswith(fail_on) and not state["failed"]:
            state["failed"] += 1
            if lost_reply:
                real(src, dst)
                raise FileNotFoundError(2, "No such file or directory", src)
            raise OSError(116, "Stale file handle")
        return real(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    monkeypatch.setattr("time.sleep", lambda s: None)
    return state


@pytest.mark.parametrize("case", ["stale_handle_once", "lost_reply"])
def test_the_sharded_publish_retries_a_transient_rename(tmp_path,
                                                        monkeypatch, case):
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        failure_events,
    )

    failure_events.reset()
    flaky = _flaky_replace(monkeypatch, "checkpoint_0.ckpt",
                           lost_reply=case == "lost_reply")
    state = _port_state()
    path = port_ckpt.save_checkpoint(state, epoch=0, best_acc=0.5,
                                     is_best=True, directory=str(tmp_path),
                                     layout="sharded")
    assert flaky["failed"] == 1
    assert path.endswith("checkpoint_0.ckpt") and os.path.isdir(path)
    assert not os.path.exists(path + ".tmp") and not any(
        n.endswith(".tmp") for n in os.listdir(tmp_path))
    retries = [e for e in failure_events.snapshot()
               if e["kind"] == "publish_retry"]
    # A lost reply is a publish that landed: no retry is scheduled.
    assert len(retries) == (1 if case == "stale_handle_once" else 0)
    _, epoch, _ = port_ckpt.load_checkpoint(path, _port_state(seed=4))
    assert epoch == 1
    assert os.path.isdir(tmp_path / "model_best.ckpt")


def test_a_post_publish_failure_says_the_checkpoint_was_published(
        tmp_path, monkeypatch):
    def broken_copy(src, dst):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(port_ckpt.shutil, "copytree", broken_copy)
    with pytest.raises(RuntimeError, match="WAS published, but a "
                                           "post-publish step"):
        port_ckpt.save_checkpoint(_port_state(), epoch=0, best_acc=0.5,
                                  is_best=True, directory=str(tmp_path),
                                  layout="sharded")
    assert os.path.isdir(tmp_path / "checkpoint_0.ckpt")
