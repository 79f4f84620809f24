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

- The serving modes of the harness, each beside its no-fault twin, on a
  port server process on the CPU driven by ``tools/loadgen.py``: replica
  0 dies after 5 batches and is quarantined and regrouped with every
  request answered; ``/resize`` rolls the pool 3 -> 2 under traffic with
  zero drops; an injected disagreement rolls the canary back while the
  f32 baseline answers everything; a load spike scales a 1-replica pool
  to 2 and back (after a dry run that moves nothing).

- The grow drive: ``--elastic --elastic-grow --rejoin 1@1`` loses rank 1
  at epoch 1's entry, shrinks to host 0, admits host 1's join record at
  the next epoch boundary and ends at a world of 2, whose epoch-2 line
  equals a direct world of 2's resumed from the same checkpoint.
- The world's device is the CLI args' ``--device``, ``cuda`` when they
  name none: the chaos tool hands it to ``run_local`` and ``supervise``
  (their defaults are ``cuda`` too).
- The fleet modes, each beside its no-fault twin: the port's router over
  two port serve processes on the CPU, with a backend SIGKILLed, a
  rolling reload, a fleet canary rolled back under ``canary_disagree``
  and three delta publishes into a shared directory, every request
  answered, the router's process free of torch; and one server through
  torn publishes, a quota abuser and a cache storm over a hot reload.

Twin of the non-slow cases of ``tests/test_chaos.py`` and
``tests/test_elastic_chaos.py`` and of the serve and fleet twins of
``tools/chaos.py``. Every world and server bounds its wait
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
                   settle_timeout=30.0, generation_timeout=WORLD_TIMEOUT,
                   device="cpu")
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


def _serve_chaos(capfd, *argv):
    from pytorch_distributed_mnist_tpu_torch.runtime import chaos

    rc = chaos.main(["--device", "cpu", "--timeout", str(WORLD_TIMEOUT),
                     *argv])
    cap = capfd.readouterr()
    return rc, json.loads(cap.out.strip().splitlines()[-1])["chaos"], \
        cap.out + cap.err


@pytest.mark.parametrize("argv,check", [
    (["--serve-fault", "0:5"], "regroups"),
    (["--resize", "3,2"], "resized"),
])
def test_serve_chaos_replica_death_and_rolling_resize(world_env, capfd,
                                                      argv, check):
    rc, result, out = _serve_chaos(
        capfd, "--serve", "--serve-devices", "2", "--expect-groups", "2",
        "--requests", "120", *argv)
    assert rc == 0, out[-3000:]
    faulted, twin = result["faulted"], result["twin"]
    for run in (faulted, twin):
        assert run["ok"] and run["answered"] == 120
        assert run["transport_errors"] == 0
        assert run["topology"]["active_groups"] == 2
    if check == "regroups":
        assert faulted["topology"]["regroups"] == 1
        assert faulted["topology"]["failovers"] >= 3
        assert twin["topology"]["regroups"] == 0
    else:
        assert faulted["resized"] == [3, 2]
        assert faulted["topology"]["topology_generation"] == 2
        assert twin["resized"] == []


def test_serve_chaos_canary_rollback(world_env, capfd):
    rc, result, out = _serve_chaos(capfd, "--serve", "--canary-rollback",
                                   "--requests", "120")
    assert rc == 0, out[-3000:]
    faulted = result["faulted"]
    assert faulted["canary"]["state"] == "rolled_back"
    assert faulted["canary"]["rollbacks"] == 1
    assert faulted["answered"] == 120 and result["twin"]["ok"]


def test_serve_chaos_autoscale_spike(world_env, capfd):
    rc, result, out = _serve_chaos(capfd, "--autoscale-spike",
                                   "--slo-p95-ms", "2",
                                   "--spike-duration", "4")
    assert rc == 0, out[-3000:]
    spike = result["autoscale_spike"]
    assert spike["dry_run"]["scale_ups"] >= 1
    assert spike["dry_run"]["serve_devices"] == 1
    assert spike["real"]["scale_ups"] >= 1
    assert spike["real"]["scale_downs"] >= 1
    assert spike["real"]["transport_errors"] == 0
    assert spike["real"]["answered"] == spike["real"]["sends"]


# -- the world's device (F3, F4) ---------------------------------------------


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("flag,want", [([], "cuda"),
                                       (["--device", "cpu"], "cpu"),
                                       (["--device=cpu"], "cpu")])
def test_the_world_takes_the_cli_args_device(monkeypatch, capfd, world_env,
                                             elastic, flag, want):
    """The chaos tool's world runs on the ``--device`` its CLI args name,
    ``cuda`` when they name none (the CLI's default): never a CPU it was
    not asked for. The launcher gets the args without the flag."""
    from pytorch_distributed_mnist_tpu_torch.runtime import chaos

    calls = []

    def fake_run_local(nprocs, argv, device="cuda", **kw):
        calls.append((list(argv), device))
        return {"returncodes": [0] * nprocs, "stopped": [],
                "first_bad": None}

    def fake_supervise(nprocs, argv, device="cuda", **kw):
        calls.append((list(argv), device))
        return 0

    monkeypatch.setattr(chaos, "run_local", fake_run_local)
    monkeypatch.setattr(chaos, "supervise", fake_supervise)
    rc = chaos.main(["--nprocs", "2"] + (["--elastic"] if elastic else [])
                    + ["--", "--model", "linear", *flag])
    result = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["chaos"]["device"] == want
    assert [d for _, d in calls] == [want, want]  # the world and its twin
    assert all("--device" not in " ".join(a) for a, _ in calls)


def test_supervise_and_its_generations_default_to_the_card(monkeypatch,
                                                           tmp_path):
    """A caller of ``supervise`` that names no device gets the card, as
    the CLI's ``--device`` and ``spawn_local`` give it."""
    import inspect

    import torch

    from pytorch_distributed_mnist_tpu_torch.runtime import elastic

    for fn in (elastic.supervise, elastic._run_generation):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    seen = []

    def fake_generation(generation, members, child_argv, *a, device="cuda",
                        **kw):
        seen.append(device)
        return elastic.GenerationResult(generation=generation,
                                        members=list(members),
                                        returncodes=[0] * len(members),
                                        stragglers=[])

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(elastic, "_run_generation", fake_generation)
    assert elastic.supervise(2, ["--model", "linear"],
                             rendezvous_dir=str(tmp_path)) == 0
    assert seen == ["cuda"]


# -- the grow drive ---------------------------------------------------------


def test_shrink_then_grow_matches_a_direct_world_of_two(
        tmp_path, world_env, capfd):
    """2 -> 1 -> 2: rank 1 dies at epoch 1's entry, host 0 trains epoch
    1 alone while host 1's join record lands (``--rejoin 1@1``), the
    epoch-boundary grow rendezvous admits it, and the world of 2 resumed
    from the 1-host world's ``checkpoint_1`` trains epoch 2; a direct
    world of 2 resumed from the same checkpoint prints the same line."""
    from pytorch_distributed_mnist_tpu_torch.runtime import chaos

    ckpt, metrics = tmp_path / "grow", tmp_path / "m.jsonl"
    rc = chaos.main(["--elastic", "--elastic-grow", "--rejoin", "1@1",
                     "--fault", "train_epoch:1:kill:1", "--nprocs", "2",
                     "--agreement-timeout", _DEADLINE, "--settle-timeout",
                     "30", "--timeout", str(WORLD_TIMEOUT), "--",
                     "--metrics-file", str(metrics), *_args(ckpt, 64, 3)])
    cap = capfd.readouterr()
    out = cap.out + cap.err
    assert rc == 0, out[-4000:]
    result = json.loads(cap.out.strip().splitlines()[-1])["chaos"]
    assert result["device"] == "cpu" and result["rejoin"] == "1@1"
    assert result["twin"]["returncodes"] == [0]
    assert "host 1 announced a join (rejoin hook)" in out
    assert "generation 2: trained to completion on world size 2" in out
    events = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    (shrunk,) = [e for e in events if e.get("kind") == "world_shrunk"]
    (grown,) = [e for e in events if e.get("kind") == "world_grown"]
    assert (shrunk["old_members"], shrunk["new_members"]) == ([0, 1], [0])
    assert (grown["old_members"], grown["new_members"]) == ([0], [0, 1])
    reshards = [e for e in events if e.get("kind") == "checkpoint_reshard"]
    assert [r["direction"] for r in reshards] == ["shrink", "grow"]
    lines = _epoch_lines(cap.out)
    # The faulted run's generations (0, 1 and 2), then the twin's three.
    assert [ln.split(",")[0] for ln in lines] == [
        "Epoch: 0/3", "Epoch: 1/3", "Epoch: 2/3"] * 2
    grown_line = lines[2]

    got = run_local(2, ["--resume", str(ckpt / "checkpoint_1.npz"),
                        *_args(tmp_path / "direct", 64, 3)], "cpu",
                    timeout=WORLD_TIMEOUT)
    cap = capfd.readouterr()
    assert got["returncodes"] == [0, 0], (cap.out + cap.err)[-3000:]
    assert _epoch_lines(cap.out) == [grown_line]


# -- the fleet modes and the single-server twins -----------------------------


def _fleet_chaos(capfd, *argv):
    from pytorch_distributed_mnist_tpu_torch.runtime import chaos

    rc = chaos.main(["--device", "cpu", "--timeout", str(WORLD_TIMEOUT),
                     *argv])
    cap = capfd.readouterr()
    return rc, json.loads(cap.out.strip().splitlines()[-1])["chaos"], \
        cap.out + cap.err


@pytest.mark.parametrize("mode", [
    ["--kill-backend", "1"], ["--rolling-reload"],
    ["--fleet-canary-rollback", "--requests", "60"], ["--delta-publish", "3"],
])
def test_fleet_chaos_beside_its_twin(world_env, capfd, mode):
    rc, result, out = _fleet_chaos(capfd, "--fleet", "2", *mode)
    assert rc == 0, out[-4000:]
    assert result["ok"] and result["fleet"]["precision"] == "int8"
    faulted, twin = result["faulted"], result["twin"]
    for run in (faulted, twin):
        assert run["ok"]
        assert run["router"]["imports"] == {"torch": False, "numpy": False,
                                            "jax": False}
        assert run["load"]["transport_errors"] == 0
        assert set(run["load"]["status_counts"]) == {"200"}
        assert run["fleet"]["fleet_503s"] == 0
    if mode[0] == "--kill-backend":
        assert faulted["victim_quarantined"]
        assert faulted["victim_readmissions"] >= 1
        assert faulted["failovers"] >= 1
        assert twin["fleet"]["failovers"] == 0
        assert len(faulted["k3_launches_before_kill"]) == 2
    elif mode[0] == "--rolling-reload":
        assert faulted["rollout"]["ok"] and faulted["epochs"] == [1, 1]
        assert twin["epochs"] == [None, None]
    elif mode[0] == "--fleet-canary-rollback":
        assert faulted["fleet_canary"]["state"] == "rolled_back"
        assert faulted["canary_backend_epoch"] == 3
        assert twin["fleet_canary"]["state"] == "shadow"
        assert twin["fleet_canary"]["disagreed_rows"] == 0
    else:
        chunks = faulted["chunk_bytes"]
        assert 0 < chunks["per_publish"] < 0.3 * chunks["cold"]
        assert twin["chunk_bytes"]["per_publish"] == 0


@pytest.mark.parametrize("mode", ["--torn-manifest", "--quota-abuse",
                                  "--cache-storm"])
def test_single_server_chaos_beside_its_twin(world_env, capfd, mode):
    rc, result, out = _fleet_chaos(capfd, mode, "--quota-duration", "3")
    assert rc == 0, out[-4000:]
    faulted, twin = result["faulted"], result["twin"]
    assert faulted["ok"] and twin["ok"]
    if mode == "--torn-manifest":
        assert faulted["reload_failures"] == 2
        assert twin["reload_failures"] == 0
    elif mode == "--quota-abuse":
        assert faulted["hog"]["quota_rejected"] > 0
        assert faulted["hog"]["retry_after_seen"] > 0
        assert faulted["good"]["ok"] >= 0.9 * faulted["good"]["sends"]
        assert twin["good"]["ok"] == twin["good"]["sends"]
    else:
        assert faulted["stale_replies"] == 0 and faulted["dropped"] == 0
        assert faulted["epochs"][1] == 7 and twin["client_hits"] > 0
