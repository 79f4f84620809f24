"""The port's run supervision (``runtime/supervision.py``,
``utils/watchdog.py``, the ``EventLog`` of ``utils/profiling.py``): the
watchdog deadlines and retry, the fault plans, the record protocol (byte
for byte the JAX package's records), the fault registry against the
port's call sites and ``runtime/chaos.py --list``, and a gloo world of 2
that exchanges records, trips the watchdog with a phase report, delivers
a poison pill and turns a killed peer into ``PeerFailure``. Twin of
``tests/test_supervision.py``.

Every world of processes bounds its wait (``WORLD_TIMEOUT``)."""

import ast
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pytorch_distributed_mnist_tpu.runtime import supervision as jax_sup
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.runtime import supervision as sup
from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
    EventLog,
    failure_events,
)
from pytorch_distributed_mnist_tpu_torch.utils.watchdog import (
    HARD_EXIT_CODE,
    WatchdogTimeout,
    retry_with_backoff,
    run_with_deadline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pytorch_distributed_mnist_tpu_torch")
WORLD_TIMEOUT = 60  # seconds any one world of processes may take


@pytest.fixture(autouse=True)
def _reset_supervisor(monkeypatch):
    monkeypatch.delenv(sup.FAULT_ENV, raising=False)
    monkeypatch.delenv(sup.TIMEOUT_ENV, raising=False)
    sup.configure(timeout=0, hard_exit_after=None)
    failure_events.reset()
    yield
    sup.configure(timeout=0, hard_exit_after=None)
    failure_events.reset()


# -- utils/watchdog.py ---------------------------------------------------------


def test_deadline_zero_runs_inline():
    tid = {}
    out = run_with_deadline(
        lambda: tid.setdefault("t", threading.get_ident()) and 42 or 42,
        timeout=0, label="off")
    assert out == 42
    assert tid["t"] == threading.get_ident()


def test_deadline_returns_result_and_propagates_error():
    assert run_with_deadline(lambda: "ok", timeout=5, label="x") == "ok"
    with pytest.raises(ValueError, match="boom"):
        run_with_deadline(lambda: (_ for _ in ()).throw(ValueError("boom")),
                          timeout=5, label="x")


def test_deadline_trips_on_stall_and_dumps():
    stall = threading.Event()
    dumped = []
    t0 = time.monotonic()
    with pytest.raises(WatchdogTimeout) as exc:
        run_with_deadline(lambda: stall.wait(60), timeout=0.3,
                          label="fake collective",
                          on_timeout=lambda: dumped.append(True))
    elapsed = time.monotonic() - t0
    stall.set()
    assert dumped == [True]
    assert elapsed < 30
    assert "fake collective" in str(exc.value)
    assert exc.value.already_agreed


def test_retry_backoff_flaky_then_succeeds():
    calls, delays = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    out = retry_with_backoff(flaky, attempts=5, base_delay=0.5,
                             max_delay=8.0, jitter=0.25, sleep=delays.append)
    assert out == "done" and len(calls) == 3
    assert 0.5 <= delays[0] < 0.75 and 1.0 <= delays[1] < 1.25


def test_retry_backoff_exhaustion_and_nonretryable():
    with pytest.raises(OSError):
        retry_with_backoff(lambda: (_ for _ in ()).throw(OSError("x")),
                           attempts=2, sleep=lambda _: None)
    calls = []

    def wrong_type():
        calls.append(1)
        raise KeyError("not retryable")

    with pytest.raises(KeyError):
        retry_with_backoff(wrong_type, attempts=5, retry_on=(OSError,),
                           sleep=lambda _: None)
    assert len(calls) == 1
    observed = []
    with pytest.raises(OSError):
        retry_with_backoff(
            lambda: (_ for _ in ()).throw(OSError("x")), attempts=3,
            sleep=lambda _: None, jitter=0.0,
            on_retry=lambda n, exc, d: observed.append((n, d)))
    assert observed == [(1, 0.5), (2, 1.0)]


def test_hard_exit_code_is_the_references():
    from pytorch_distributed_mnist_tpu.utils import watchdog as jax_watchdog

    assert HARD_EXIT_CODE == jax_watchdog.HARD_EXIT_CODE == 75


# -- fault plans -------------------------------------------------------------------


def test_fault_plan_parse_and_defaults():
    p = sup.FaultPlan.parse("ckpt_publish:0:kill")
    assert (p.point, p.host, p.kind, p.arg) == ("ckpt_publish", "0", "kill",
                                                0.0)
    assert sup.FaultPlan.parse("train_epoch:*:kill:2").arg == 2.0
    assert sup.FaultPlan.parse("eval:1:stall").arg == 3600.0
    for bad in ("nope", "unknown_point:0:kill", "eval:0:explode",
                "eval:x1:kill"):
        with pytest.raises(ValueError):
            sup.FaultPlan.parse(bad)


@pytest.mark.parametrize("spec", ["ckpt_publish:0:kill",
                                  "train_epoch:*:raise:2", "eval:1:stall",
                                  "resume:2:kill,elastic_rebuild:1:stall"])
def test_fault_grammar_parses_as_jaxs(spec):
    mine = [(p.point, p.host, p.kind, p.arg)
            for p in sup.parse_fault_specs(spec)]
    assert mine == [(p.point, p.host, p.kind, p.arg)
                    for p in jax_sup.parse_fault_specs(spec)]


def test_maybe_fault_raise_kind(monkeypatch):
    monkeypatch.setenv(sup.FAULT_ENV, "eval:0:raise")
    sup.configure(timeout=0, hard_exit_after=None)
    monkeypatch.setattr(sup, "process_index", lambda: 0)
    with pytest.raises(sup.InjectedFault, match="eval:0:raise"):
        sup.maybe_fault("eval")
    monkeypatch.setattr(sup, "process_index", lambda: 1)
    sup.maybe_fault("eval")


def test_maybe_fault_skip_count(monkeypatch):
    monkeypatch.setenv(sup.FAULT_ENV, "train_epoch:*:raise:2")
    sup.configure(timeout=0, hard_exit_after=None)
    sup.maybe_fault("train_epoch")
    sup.maybe_fault("train_epoch")
    with pytest.raises(sup.InjectedFault):
        sup.maybe_fault("train_epoch")


def test_maybe_fault_stall(monkeypatch):
    monkeypatch.setenv(sup.FAULT_ENV, "eval:*:stall:0.2")
    sup.configure(timeout=0, hard_exit_after=None)
    t0 = time.monotonic()
    sup.maybe_fault("eval")
    assert time.monotonic() - t0 >= 0.2


def test_unregistered_fault_point_asserts():
    with pytest.raises(AssertionError):
        sup.maybe_fault("not_a_point")


def test_parse_fault_specs_multi():
    plans = sup.parse_fault_specs(
        "train_epoch:2:kill:1,elastic_rebuild:1:stall")
    assert [(p.point, p.host, p.kind) for p in plans] == [
        ("train_epoch", "2", "kill"), ("elastic_rebuild", "1", "stall")]
    assert plans[1].arg == 3600.0
    assert len(sup.parse_fault_specs("eval:0:raise")) == 1
    with pytest.raises(ValueError, match="unknown fault point"):
        sup.parse_fault_specs("eval:0:raise,bogus:0:kill")
    with pytest.raises(ValueError, match="one fault per spec"):
        sup.FaultPlan.parse("eval:0:raise,eval:1:raise")


def test_maybe_fault_multi_plan_fires_matching_point(monkeypatch):
    monkeypatch.setenv(sup.FAULT_ENV, "eval:*:raise,elastic_rebuild:*:raise")
    sup.configure(timeout=0, hard_exit_after=None)
    sup.maybe_fault("train_epoch")
    with pytest.raises(sup.InjectedFault, match="eval"):
        sup.maybe_fault("eval")
    with pytest.raises(sup.InjectedFault, match="elastic_rebuild"):
        sup.maybe_fault("elastic_rebuild")


def _call_sites():
    """Every ``maybe_fault(...)`` call in the port's package: (file, the
    point's literal, or None for a computed argument)."""
    sites = []
    for root, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                called = (fn.attr if isinstance(fn, ast.Attribute)
                          else getattr(fn, "id", None))
                if called != "maybe_fault" or not node.args:
                    continue
                arg = node.args[0]
                literal = (arg.value if isinstance(arg, ast.Constant)
                           and isinstance(arg.value, str) else None)
                sites.append((os.path.relpath(path, PORT), literal))
    return sites


def test_fault_points_registry_matches_call_sites():
    sites = _call_sites()
    # The registry's own assert (a computed name) is not a call site.
    sites = [s for s in sites if s[0] != os.path.join("runtime",
                                                      "supervision.py")]
    assert all(literal is not None for _, literal in sites), sites
    assert {literal for _, literal in sites} == set(sup.FAULT_POINTS)


def test_fault_points_are_the_references_eleven():
    assert set(sup.FAULT_POINTS) == set(jax_sup.FAULT_POINTS)
    assert len(sup.FAULT_POINTS) == 11


def test_fault_points_sit_where_the_reference_puts_them():
    where = {}
    for path, literal in _call_sites():
        where.setdefault(literal, set()).add(path)
    assert where["train_epoch"] == where["train_step"] == where["eval"] \
        == {os.path.join("train", "trainer.py")}
    for point in ("ckpt_prepare", "ckpt_collect", "ckpt_write",
                  "ckpt_publish"):
        assert where[point] == {os.path.join("train", "checkpoint.py")}
    assert where["data_stage"] == where["resume"] == {"cli.py"}
    assert where["download_fetch"] == {os.path.join("data", "download.py")}
    assert where["elastic_rebuild"] == {os.path.join("runtime",
                                                     "elastic.py")}


def test_chaos_list_matches_registry():
    from pytorch_distributed_mnist_tpu_torch.runtime import chaos

    buf = io.StringIO()
    chaos.list_fault_points(buf)
    lines = [line.split("\t") for line in buf.getvalue().splitlines()]
    assert {name for name, _ in lines} == set(sup.FAULT_POINTS)
    assert all(sup.FAULT_POINTS[name] == text for name, text in lines)
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch.runtime"
         ".chaos", "--list"], capture_output=True, text=True, cwd=REPO,
        timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0
    assert proc.stdout == buf.getvalue()


# -- agreement records ---------------------------------------------------------------


def _fake_world(monkeypatch, nproc=2, rank=0):
    monkeypatch.setattr(sup, "process_count", lambda: nproc)
    monkeypatch.setattr(sup, "process_index", lambda: rank)


def test_record_roundtrip():
    sup.set_phase("train@3")
    rec = sup._decode_record(sup._encode_record(sup._OK, "detail text"))
    assert rec.ok and not rec.poisoned
    assert rec.phase == "train@3" and rec.detail == "detail text"
    pill = sup._decode_record(sup._encode_record(sup._POISON, "r"))
    assert pill.poisoned and not pill.ok


@pytest.mark.parametrize("status, phase, detail", [
    (b"K", "startup", ""),
    (b"E", "checkpoint@1", "OSError('disk full')"),
    (b"P", "train@12", "x" * 5000),  # cut at DETAIL_BYTES
    (b"K", "p" * 300, "long phase, cut at 128 bytes"),
    (b"E", "resume", "päth/ünïcode"),
])
def test_records_are_byte_equal_to_the_references(status, phase, detail):
    assert sup.RECORD_BYTES == jax_sup.RECORD_BYTES
    assert sup.DETAIL_BYTES == jax_sup.DETAIL_BYTES
    sup.set_phase(phase)
    jax_sup.set_phase(phase)
    try:
        mine = sup._encode_record(status, detail)
        assert mine == jax_sup._encode_record(status, detail)
        assert len(mine) == sup.RECORD_BYTES
        ref = jax_sup._decode_record(mine)
        assert sup._decode_record(mine) == sup.Record(ref.status, ref.phase,
                                                      ref.detail)
    finally:
        jax_sup.set_phase("startup")


def test_single_process_agree_is_local():
    failed = sup.agree("write", None)
    assert failed == []
    err = OSError("local")
    failed = sup.agree("write", err)
    assert failed and failed[0][0] == 0
    assert getattr(err, "_poison_delivered", False)


def test_agreement_exchanges_records(monkeypatch):
    _fake_world(monkeypatch, rank=0)

    def fake_allgather(payload):
        saved = sup.current_phase()
        try:
            sup.set_phase("checkpoint@1")
            peer = np.frombuffer(sup._encode_record(sup._ERR,
                                                    "peer exploded"),
                                 np.uint8)
        finally:
            sup.set_phase(saved)
        return np.stack([payload, peer])

    monkeypatch.setattr(sup, "_raw_allgather", fake_allgather)
    assert sup.agree("ckpt_write", None) == [(1, "checkpoint@1",
                                              "peer exploded")]


def test_agreement_watchdog_trips_with_phase_report(monkeypatch, capsys):
    _fake_world(monkeypatch, nproc=3, rank=1)
    sup.configure(timeout=0.3, hard_exit_after=None)
    sup.set_phase("checkpoint@2")
    stall = threading.Event()
    monkeypatch.setattr(sup, "_raw_allgather", lambda p: stall.wait(60))
    with pytest.raises(sup.PeerFailure) as exc:
        sup.allgather_records("ckpt_publish", True)
    stall.set()
    assert exc.value.hosts == [0, 2]
    assert exc.value.phase == "ckpt_publish"
    assert exc.value.already_agreed
    err = capsys.readouterr().err
    assert "supervision watchdog report" in err
    assert "blocked in: agreement 'ckpt_publish'" in err
    assert "lifecycle phase: checkpoint@2" in err
    assert "agreement_timeout" in [e["kind"]
                                   for e in failure_events.snapshot()]


def test_agreement_transport_error_is_a_peer_failure(monkeypatch):
    _fake_world(monkeypatch, rank=0)

    def broken(payload):
        raise RuntimeError("Connection closed by peer [127.0.0.1]:1")

    monkeypatch.setattr(sup, "_raw_allgather", broken)
    with pytest.raises(sup.PeerFailure, match="failed in transport") as exc:
        sup.allgather_records("ckpt_publish", True)
    assert exc.value.hosts == [1] and exc.value.phase == "ckpt_publish"


def test_agreement_timeout_zero_disables_watchdog(monkeypatch):
    _fake_world(monkeypatch)
    sup.configure(timeout=0, hard_exit_after=None)
    seen = {}

    def fake_allgather(payload):
        seen["thread"] = threading.get_ident()
        return np.stack([payload, payload])

    monkeypatch.setattr(sup, "_raw_allgather", fake_allgather)
    records = sup.allgather_records("ckpt_write", True)
    assert len(records) == 2 and all(r.ok for r in records)
    assert seen["thread"] == threading.get_ident()


def test_heartbeats_recorded_and_dumped(monkeypatch, capsys):
    _fake_world(monkeypatch, rank=0)
    monkeypatch.setattr(sup, "_raw_allgather", lambda p: np.stack([p, p]))
    sup.configure(timeout=0.2, hard_exit_after=None)
    sup.set_phase("train@7")
    sup.allgather_records("ckpt_write", True)
    stall = threading.Event()
    monkeypatch.setattr(sup, "_raw_allgather", lambda p: stall.wait(60))
    with pytest.raises(sup.PeerFailure):
        sup.allgather_records("ckpt_publish", True)
    stall.set()
    assert "host 1: phase 'train@7' at agreement #1" in \
        capsys.readouterr().err


def test_deliver_poison_idempotent_and_skips_agreed(monkeypatch):
    _fake_world(monkeypatch)
    calls = []

    def fake_allgather(payload):
        calls.append(payload)
        return np.stack([payload, payload])

    monkeypatch.setattr(sup, "_raw_allgather", fake_allgather)
    err = RuntimeError("host-local")
    sup.deliver_poison(err)
    sup.deliver_poison(err)
    assert len(calls) == 1
    rec = sup._decode_record(calls[0].tobytes())
    assert rec.poisoned and "host-local" in rec.detail
    sup.deliver_poison(sup.PeerFailure("x", hosts=[1], phase="p"))
    sup.deliver_poison(WatchdogTimeout("label", 1.0))
    sup.deliver_poison(KeyboardInterrupt())
    assert len(calls) == 1
    assert "poison_sent" in [e["kind"] for e in failure_events.snapshot()]


def test_raise_if_poisoned(monkeypatch):
    _fake_world(monkeypatch, rank=0)
    records = [sup.Record("K", "resume", ""),
               sup.Record("P", "train@4", "OOM on host 1")]
    with pytest.raises(sup.PeerFailure) as exc:
        sup.raise_if_poisoned(records, "the resume agreement")
    assert exc.value.hosts == [1]
    assert exc.value.phase == "train@4"
    assert "OOM on host 1" in str(exc.value)
    sup.raise_if_poisoned([sup.Record("K", "resume", ""),
                           sup.Record("E", "resume", "no file")],
                          "the resume agreement")


def test_escalate_exit_marks_only_peer_failures(monkeypatch):
    armed = []
    from pytorch_distributed_mnist_tpu_torch.utils import watchdog

    monkeypatch.setattr(watchdog, "arm_hard_exit",
                        lambda delay, reason: armed.append(delay))
    peer = sup.PeerFailure("x", hosts=[1], phase="p")
    sup.escalate_exit(peer)  # one process: nothing to escalate
    assert not getattr(peer, "_escalated", False) and armed == []
    _fake_world(monkeypatch)
    local = RuntimeError("local")
    sup.escalate_exit(local)
    assert not getattr(local, "_escalated", False)
    sup.escalate_exit(peer, grace=3.0)
    assert peer._escalated and armed == [3.0]


def test_report_failure_names_the_phase(capsys):
    sup.set_phase("train@0")
    sup.report_failure(sup.InjectedFault("injected fault at x"))
    err = capsys.readouterr().err
    assert "run failed in phase 'train@0'" in err and "InjectedFault" in err
    (event,) = failure_events.snapshot()
    assert event["kind"] == "run_failed" and event["phase"] == "train@0"


def test_configure_env_resolution(monkeypatch):
    monkeypatch.setenv(sup.TIMEOUT_ENV, "12.5")
    assert sup.configure() == 12.5
    assert sup.configure(timeout=3.0) == 3.0
    assert sup.configure(timeout=0) == 0.0
    monkeypatch.setenv(sup.TIMEOUT_ENV, "not-a-number")
    with pytest.raises(SystemExit):
        sup.configure()


def test_event_log_thread_safe_snapshot(tmp_path):
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import JsonlSink

    log = EventLog()
    sink = JsonlSink(str(tmp_path / "m.jsonl"))
    log.set_sink(sink, source="train")
    log.record("kind_a", "one", phase="p")
    log.record("kind_b", "two")
    snap = log.snapshot()
    assert [e["kind"] for e in snap] == ["kind_a", "kind_b"]
    assert snap[0]["phase"] == "p"
    snap[0]["kind"] = "mutated"
    assert log.snapshot()[0]["kind"] == "kind_a"
    lines = [json.loads(line) for line in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [(e["kind"], e["source"]) for e in lines] == [
        ("kind_a", "train"), ("kind_b", "train")]
    log.reset()
    assert log.snapshot() == []


# -- a gloo world of 2 ------------------------------------------------------------------

_RANK = r"""
import json, os, signal, sys, time
import torch
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.runtime import supervision as sup
from pytorch_distributed_mnist_tpu_torch.utils.profiling import failure_events

coordinator, rank, scenario = sys.argv[1], int(sys.argv[2]), sys.argv[3]
distributed.initialize_distributed(coordinator, 2, rank,
                                   torch.device("cpu"))
sup.configure(timeout=float(sys.argv[4]), hard_exit_after=None)
out = {"rank": rank}
sup.set_phase(f"train@{rank}")
try:
    if scenario == "exchange":
        err = OSError("disk full") if rank == 1 else None
        out["failed"] = sup.agree("ckpt_write", err)
    elif scenario == "poison":
        if rank == 1:
            sup.deliver_poison(RuntimeError("OOM on rank 1"))
        else:
            records = sup.allgather_records("dataset_load", True)
            sup.raise_if_poisoned(records, "the dataset agreement")
    elif scenario == "stall":
        if rank == 1:
            time.sleep(2 * float(sys.argv[4]) + 1)  # misses the agreement
            os._exit(0)
        sup.allgather_records("ckpt_publish", True)
    elif scenario == "kill":
        # One completed agreement first: both ranks are past the
        # rendezvous's connection set-up before rank 1 dies.
        sup.allgather_records("dataset_load", True)
        if rank == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        sup.allgather_records("ckpt_publish", True)
except sup.PeerFailure as exc:
    out.update(error="PeerFailure", hosts=exc.hosts, phase=exc.phase,
               reason=exc.reason)
out["events"] = [e["kind"] for e in failure_events.snapshot()]
print("RESULT " + json.dumps(out), flush=True)
if "error" in out:
    os._exit(0)  # peers are gone: no teardown with them
distributed.teardown()
"""


def _world(tmp_path, scenario: str, timeout: float = 10.0):
    """Both ranks' ``(returncode, RESULT dict or None, output)``."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    port = launcher.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"127.0.0.1:{port}", str(r), scenario,
         str(timeout)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    results = []
    try:
        for p in procs:
            out = p.communicate(timeout=WORLD_TIMEOUT)[0]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            results.append((p.returncode,
                            json.loads(line[-1][7:]) if line else None, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


def test_a_world_of_2_exchanges_records(tmp_path):
    (rc0, r0, out0), (rc1, r1, out1) = _world(tmp_path, "exchange")
    assert rc0 == rc1 == 0, out0 + out1
    want = [[1, "train@1", "OSError('disk full')"]]
    assert r0["failed"] == r1["failed"] == want


def test_a_world_of_2_delivers_a_poison_pill(tmp_path):
    (rc0, r0, out0), (rc1, r1, out1) = _world(tmp_path, "poison")
    assert rc0 == rc1 == 0, out0 + out1
    assert r0["error"] == "PeerFailure" and r0["hosts"] == [1]
    assert r0["phase"] == "train@1" and "OOM on rank 1" in r0["reason"]
    assert "poison_sent" in r1["events"]
    assert "delivering poison pill" in out1


def test_a_world_of_2_trips_the_watchdog_with_a_phase_report(tmp_path):
    t0 = time.monotonic()
    (rc0, r0, out0), _ = _world(tmp_path, "stall", timeout=2.0)
    assert rc0 == 0, out0
    assert time.monotonic() - t0 < WORLD_TIMEOUT
    assert r0["error"] == "PeerFailure" and r0["hosts"] == [1]
    assert r0["phase"] == "ckpt_publish"
    assert "supervision watchdog report (process 0)" in out0
    assert "lifecycle phase: train@0" in out0
    assert "agreement_timeout" in r0["events"]


def test_a_world_of_2_turns_a_killed_peer_into_peer_failure(tmp_path):
    t0 = time.monotonic()
    (rc0, r0, out0), (rc1, _, _) = _world(tmp_path, "kill", timeout=8.0)
    assert rc1 == -9
    assert rc0 == 0, out0
    assert r0["error"] == "PeerFailure" and r0["hosts"] == [1]
    assert r0["phase"] == "ckpt_publish"
    assert time.monotonic() - t0 < WORLD_TIMEOUT
