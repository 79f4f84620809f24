"""Chaos twins of the port: real gloo worlds on the CPU with one rank
sabotaged at a named fault point (``TPUMNIST_FAULT``), through the chaos
harness (``runtime/chaos.py``) and the CLI.

- Rank 1 SIGKILLed at epoch 1's checkpoint publish agreement: rank 0
  exits 75 with ``PeerFailure`` naming host 1 and ``ckpt_publish`` within
  the deadline, not a hang, and ``--resume auto`` finishes the job from
  the last published checkpoint.
- A 3-rank elastic world loses rank 2 at epoch 1's entry: the supervisor
  shrinks it to 2 ranks resumed from ``checkpoint_0`` (``world_shrunk``
  recorded), and rank 0's epoch-1 line equals a direct 2-rank world's
  resumed from the same checkpoint.

Twin of the non-slow cases of ``tests/test_chaos.py`` and
``tests/test_elastic_chaos.py``. Every world bounds its wait
(``WORLD_TIMEOUT``)."""

import json
import os
import time

import pytest

from pytorch_distributed_mnist_tpu_torch.parallel.launcher import run_local

pytestmark = pytest.mark.chaos

WORLD_TIMEOUT = 120  # seconds any one world of processes may take
_DEADLINE = "8"  # the agreement deadline of the faulted worlds


def _args(ckpt, batch: int, epochs: int, *extra) -> list:
    return ["--device", "cpu", "--model", "linear", "--dataset",
            "synthetic", "--synthetic-train-size", "768",
            "--synthetic-test-size", "192", "--batch-size", str(batch),
            "--epochs", str(epochs), "--seed", "0", "--checkpoint-dir",
            str(ckpt), *extra]


def _epoch_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("Epoch: ")]


@pytest.fixture
def world_env(monkeypatch):
    """The ranks' environment: one intra-op thread each, no fault; the
    variables the harness sets are restored afterwards."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for var in ("TPUMNIST_FAULT", "TPUMNIST_AGREEMENT_TIMEOUT"):
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)


def test_kill_during_publish_agreement_peer_failure_then_resume(
        tmp_path, world_env, capfd):
    from pytorch_distributed_mnist_tpu_torch import cli
    from pytorch_distributed_mnist_tpu_torch.runtime import chaos

    ckpt = tmp_path / "ck"
    t0 = time.monotonic()
    rc = chaos.main(["--fault", "ckpt_publish:1:kill:1", "--nprocs", "2",
                     "--agreement-timeout", _DEADLINE, "--timeout",
                     str(WORLD_TIMEOUT), "--no-twin", "--",
                     *_args(ckpt, 64, 2)])
    seconds = time.monotonic() - t0
    cap = capfd.readouterr()
    out = cap.out + cap.err
    result = json.loads(cap.out.strip().splitlines()[-1])["chaos"]
    assert rc == 0, out[-3000:]
    # Rank 1 died by SIGKILL; rank 0 left on its own, with the watchdog's
    # code, naming the dead host and the phase.
    assert result["faulted"]["returncodes"] == [75, -9]
    assert result["faulted"]["stopped"] == []
    assert "PeerFailure" in out and "'ckpt_publish'" in out
    assert "host(s) [1]" in out
    assert seconds < 90
    # Epoch 1 was published before the agreement (process 0 writes first).
    names = set(os.listdir(ckpt))
    assert {"checkpoint_0.npz", "checkpoint_1.npz"} <= names

    # Recovery: --resume auto finds the last published checkpoint (epoch
    # 1, written by the world of 2) and finishes the job.
    summary = cli.run(cli.build_parser().parse_args(
        ["--resume", "auto", *_args(ckpt, 64, 3)]))
    assert summary["start_epoch"] == 2 and summary["epochs_run"] == 1
    assert [ln.split(",")[0] for ln in _epoch_lines(capfd.readouterr().out)
            ] == ["Epoch: 2/3"]
    assert "checkpoint_2.npz" in os.listdir(ckpt)


def test_three_rank_world_shrinks_to_two_and_matches_a_direct_one(
        tmp_path, world_env, monkeypatch, capfd):
    from pytorch_distributed_mnist_tpu_torch.runtime.elastic import (
        supervise,
    )

    el = tmp_path / "elastic"
    metrics = tmp_path / "m.jsonl"
    monkeypatch.setenv("TPUMNIST_FAULT", "train_epoch:2:kill:1")
    rc = supervise(3, ["--agreement-timeout", _DEADLINE, "--metrics-file",
                       str(metrics), *_args(el, 96, 2)], min_world=2,
                   settle_timeout=30.0, generation_timeout=WORLD_TIMEOUT)
    cap = capfd.readouterr()
    out = cap.out + cap.err
    assert rc == 0, out[-4000:]
    assert "generation 1: world size 2 (hosts [0, 1])" in out
    assert "generation 1: trained to completion on world size 2" in out
    events = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    (shrunk,) = [e for e in events if e.get("kind") == "world_shrunk"]
    assert shrunk["old_members"] == [0, 1, 2]
    assert shrunk["new_members"] == [0, 1]
    (reshard,) = [e for e in events if e.get("kind") == "checkpoint_reshard"]
    assert reshard["direction"] == "shrink"
    assert reshard["detail"].startswith(str(el / "checkpoint_0.npz"))
    shrunk_lines = _epoch_lines(cap.out)
    assert [ln.split(",")[0] for ln in shrunk_lines] == ["Epoch: 0/2",
                                                         "Epoch: 1/2"]

    monkeypatch.delenv("TPUMNIST_FAULT")
    got = run_local(2, ["--resume", str(el / "checkpoint_0.npz"),
                        *_args(tmp_path / "direct", 96, 2)], "cpu",
                    timeout=WORLD_TIMEOUT)
    cap = capfd.readouterr()
    assert got["returncodes"] == [0, 0], (cap.out + cap.err)[-3000:]
    assert _epoch_lines(cap.out) == shrunk_lines[1:]
