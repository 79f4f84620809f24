"""The port's serving control loop (``serve/control.py``'s
``AutoScaler`` and ``WeightedFairGate``, ``utils/profiling.py``'s
rolling window): the cases of ``tests/test_serve_control.py`` on stubs,
then the wiring of the port's server: ``--autoscale`` sampling
``ServeLog.window_stats`` and actuating ``EnginePool.resize`` one replica
a step on CPU replicas under a spike, the dry run recording to ``/stats``
and the JSONL sink while actuating nothing, and the flags' refusals."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.serve.control import (
    AutoScaler,
    WeightedFairGate,
    parse_weight_spec,
)
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    save_params_checkpoint,
)
from pytorch_distributed_mnist_tpu_torch.utils.profiling import ServeLog

pytestmark = pytest.mark.serve
torch.set_num_threads(2)


# -- autoscaler --------------------------------------------------------------


class _FakePool:
    def __init__(self, n_devices=1, fail=False):
        self.n_devices = n_devices
        self.fail = fail
        self.calls = []

    def resize(self, n_devices=None, mesh_size=None):
        self.calls.append(n_devices)
        if self.fail:
            raise RuntimeError("a resize is already in progress")
        self.n_devices = n_devices
        return {"old": {}, "new": {}}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _EventSink:
    def __init__(self):
        self.events = []

    def record_pool_event(self, kind, **fields):
        self.events.append((kind, fields))


def _scaler(pool, stats, **kw):
    clock = kw.pop("clock", _Clock())
    defaults = dict(slo_p95_ms=100.0, queue_high=48, min_devices=1,
                    max_devices=4, interval_s=60.0, cooldown_s=10.0,
                    down_after=3)
    defaults.update(kw)
    return AutoScaler(pool, lambda: dict(stats), now_fn=clock,
                      **defaults), clock, stats


def test_autoscaler_scales_up_on_p95_breach_and_respects_cooldown():
    pool = _FakePool(1)
    scaler, clock, stats = _scaler(pool, {"p95_ms": 500.0,
                                          "queue_depth": 0})
    decision = scaler.tick()
    assert decision["action"] == "scale_up"
    assert pool.n_devices == 2 and pool.calls == [2]
    # Still breaching, but inside the cooldown: hold.
    clock.t = 5.0
    assert scaler.tick() is None
    # Past the cooldown: the next step fires.
    clock.t = 11.0
    assert scaler.tick()["action"] == "scale_up"
    assert pool.n_devices == 3


def test_autoscaler_scales_up_on_queue_depth_alone():
    pool = _FakePool(1)
    scaler, _, _ = _scaler(pool, {"p95_ms": 1.0, "queue_depth": 48})
    decision = scaler.tick()
    assert decision["action"] == "scale_up"
    assert "watermark" in decision["reason"]


def test_autoscaler_max_devices_caps_scale_up():
    pool = _FakePool(4)
    scaler, _, _ = _scaler(pool, {"p95_ms": 500.0, "queue_depth": 60})
    assert scaler.tick() is None
    assert pool.calls == []


def test_autoscaler_hysteresis_band_never_acts():
    """p95 between the down bar (slo/2) and the SLO is the hysteresis
    band: no action either way, the calm streak resets."""
    pool = _FakePool(2)
    scaler, clock, stats = _scaler(pool, {"p95_ms": 75.0,
                                          "queue_depth": 0})
    for t in (0.0, 100.0, 200.0, 300.0):
        clock.t = t
        assert scaler.tick() is None
    assert pool.calls == []
    # Two calm samples, then one band sample: the streak resets and
    # two MORE calm samples still don't scale down (needs 3 in a row).
    stats["p95_ms"] = 1.0
    clock.t = 400.0
    assert scaler.tick() is None
    clock.t = 500.0
    assert scaler.tick() is None
    stats["p95_ms"] = 75.0
    clock.t = 600.0
    assert scaler.tick() is None
    stats["p95_ms"] = 1.0
    clock.t = 700.0
    assert scaler.tick() is None
    clock.t = 800.0
    assert scaler.tick() is None
    assert pool.calls == []


def test_autoscaler_scales_down_after_sustained_calm_to_floor():
    pool = _FakePool(3)
    scaler, clock, _ = _scaler(pool, {"p95_ms": 1.0, "queue_depth": 0},
                               min_devices=2)
    clock.t = 0.0
    assert scaler.tick() is None
    clock.t = 100.0
    assert scaler.tick() is None
    clock.t = 200.0
    decision = scaler.tick()
    assert decision["action"] == "scale_down"
    assert pool.n_devices == 2
    # At the floor: sustained calm never goes below min_devices.
    for t in (300.0, 400.0, 500.0, 600.0):
        clock.t = t
        scaler.tick()
    assert pool.n_devices == 2


def test_autoscaler_dry_run_records_without_actuating():
    pool = _FakePool(1)
    sink = _EventSink()
    scaler, _, _ = _scaler(pool, {"p95_ms": 500.0, "queue_depth": 0},
                           dry_run=True, serve_log=sink)
    decision = scaler.tick()
    assert decision["action"] == "scale_up" and decision["dry_run"]
    assert pool.calls == []  # never actuated
    assert pool.n_devices == 1
    snap = scaler.snapshot()
    assert snap["dry_run"] and snap["scale_ups"] == 1
    assert snap["last_decision"]["action"] == "scale_up"
    assert [k for k, _ in sink.events] == ["serve_autoscale"]
    assert sink.events[0][1]["dry_run"] is True


def test_autoscaler_resize_failure_is_contained_and_recorded():
    pool = _FakePool(1, fail=True)
    sink = _EventSink()
    scaler, _, _ = _scaler(pool, {"p95_ms": 500.0, "queue_depth": 0},
                           serve_log=sink)
    decision = scaler.tick()  # must not raise
    assert "error" in decision and "resize" in decision["error"]
    snap = scaler.snapshot()
    assert snap["errors"] == 1 and snap["scale_ups"] == 0
    assert "error" in sink.events[0][1]


def test_autoscaler_constructor_validation():
    pool = _FakePool(1)
    with pytest.raises(ValueError, match="slo_p95_ms"):
        AutoScaler(pool, dict, slo_p95_ms=0, queue_high=10)
    with pytest.raises(ValueError, match="queue_high"):
        AutoScaler(pool, dict, slo_p95_ms=10, queue_high=0)
    with pytest.raises(ValueError, match="max_devices"):
        AutoScaler(pool, dict, slo_p95_ms=10, queue_high=10,
                   min_devices=4, max_devices=2)
    with pytest.raises(ValueError, match="down_frac"):
        AutoScaler(pool, dict, slo_p95_ms=10, queue_high=10,
                   down_frac=1.5)


# -- weighted-fair gate ------------------------------------------------------


def test_fair_gate_virtual_time_encodes_the_weight_ratio():
    """The accounting that decides every contention: a grant charges
    rows/weight, so after one grant each from equal clocks the
    3-weighted model's virtual time sits at a third of the 1-weighted
    model's — it wins the next contention — and exactly three a-grants
    equal one b-grant (the 3:1 ratio, as arithmetic)."""
    gate = WeightedFairGate({"a": 3.0, "b": 1.0})
    gate.grant("a", rows=1)
    gate.grant("b", rows=1)
    assert gate._vtime["a"] == pytest.approx(1 / 3)
    assert gate._vtime["b"] == pytest.approx(1.0)
    # Two more a-grants: 3 x (1/3) == 1 x 1 — the clocks meet.
    gate.grant("a", rows=1)
    gate.grant("a", rows=1)
    assert gate._vtime["a"] == pytest.approx(gate._vtime["b"])
    # Rows charge too: an 8-row batch costs 8x a 1-row one.
    gate.grant("b", rows=8)
    assert gate._vtime["b"] == pytest.approx(9.0)


def test_fair_gate_blocks_behind_lower_vtime_waiter_and_wakes():
    """The blocking half of the policy: a model whose virtual time is
    ABOVE another waiting model's parks on the gate's cv, and proceeds
    the moment the lower-vtime waiter is gone."""
    gate = WeightedFairGate({"a": 1.0, "b": 1.0})
    with gate._cv:
        gate._waiting["a"] = 1  # a parked at vtime 0
        gate._vtime["b"] = 0.5
    done = threading.Event()

    def b_dispatch():
        gate.grant("b", rows=1)
        done.set()

    t = threading.Thread(target=b_dispatch, daemon=True)
    t.start()
    # b must be blocked: a is waiting with the lower virtual time.
    assert not done.wait(0.2)
    with gate._cv:
        del gate._waiting["a"]
        gate._cv.notify_all()
    assert done.wait(5.0)
    t.join(5.0)
    assert gate.snapshot()["grants"]["b"] == 1


def test_fair_gate_idle_model_never_blocks_the_busy_one():
    gate = WeightedFairGate({"a": 1.0, "b": 1.0})
    for _ in range(50):
        gate.grant("a", rows=8)  # b never shows up; a never waits
    snap = gate.snapshot()
    assert snap["grants"]["a"] == 50 and snap["grants"]["b"] == 0


def test_fair_gate_reentry_floor_prevents_catchup_burst():
    """A model returning from idle is floored to the grant clock: its
    stale virtual time must not buy a monopoly repaying the idle
    period."""
    gate = WeightedFairGate({"a": 1.0, "b": 1.0})
    for _ in range(100):
        gate.grant("a", rows=1)
    # b re-enters with vtime 0; the floor lifts it to a's clock, so
    # alternation resumes immediately instead of 100 consecutive
    # b-grants.
    gate.grant("b", rows=1)
    assert gate._vtime["b"] >= 100.0


def test_fair_gate_unknown_model_and_weight_parsing():
    gate = WeightedFairGate({"a": 1.0})
    with pytest.raises(ValueError, match="unknown model"):
        gate.grant("zzz")
    with pytest.raises(ValueError, match="at least one"):
        WeightedFairGate({})
    with pytest.raises(ValueError, match="> 0"):
        WeightedFairGate({"a": 0.0})
    assert parse_weight_spec("a=2", ["a", "b"]) == {"a": 2.0, "b": 1.0}
    assert parse_weight_spec("", ["a"]) == {"a": 1.0}
    with pytest.raises(ValueError, match="not in the"):
        parse_weight_spec("zzz=2", ["a"])
    with pytest.raises(ValueError, match="MODEL=WEIGHT"):
        parse_weight_spec("just-a-name", ["a"])



def test_autoscaler_steps_by_mesh_group_quantum():
    """A sharded pool resizes by whole mesh groups (resize validates
    serve_mesh | serve_devices): with step=mesh_size the controller
    targets valid topologies only — 2 -> 4 up, 4 -> 2 down, never an
    odd chip count a 2-chip mesh can't host."""
    pool = _FakePool(2)
    scaler, clock, stats = _scaler(pool, {"p95_ms": 500.0,
                                          "queue_depth": 0},
                                   step=2, min_devices=2, max_devices=4)
    assert scaler.tick()["to_devices"] == 4
    assert pool.n_devices == 4
    # At max: hold, not an invalid 6.
    clock.t = 100.0
    assert scaler.tick() is None
    stats["p95_ms"] = 1.0
    for t in (200.0, 300.0, 400.0):
        clock.t = t
        decision = scaler.tick()
    assert decision["to_devices"] == 2 and pool.n_devices == 2
    assert pool.calls == [4, 2]



# -- rolling-window ServeLog ---------------------------------------------


def test_serve_log_window_ages_out_old_samples():
    log = ServeLog(window_s=60.0)
    clock = _Clock()
    log._now = clock
    log.reset()
    clock.t = 10.0
    for _ in range(10):
        log.record_request(latency_s=0.005)
    clock.t = 30.0
    for _ in range(5):
        log.record_request(latency_s=0.5)
    win = log.window_stats()
    assert win["count"] == 15
    # 80 seconds on: the fast early samples aged out; only the slow
    # ones remain, and the window quantiles see CURRENT load.
    clock.t = 80.0
    win = log.window_stats()
    assert win["count"] == 5
    assert win["p95_ms"] == pytest.approx(500.0, abs=1.0)
    assert win["rps"] == pytest.approx(5 / 60.0, abs=0.01)
    # Lifetime quantiles still carry everything.
    snap = log.snapshot()
    assert snap["latency_ms"]["count"] == 15
    assert snap["window"]["count"] == 5


def test_serve_log_window_rps_uses_elapsed_before_full_window():
    log = ServeLog(window_s=60.0)
    clock = _Clock()
    log._now = clock
    log.reset()
    clock.t = 10.0
    for _ in range(50):
        log.record_request(latency_s=0.001)
    win = log.window_stats()
    # 50 requests over 10 elapsed seconds (not diluted over the full
    # 60s window the log hasn't lived yet).
    assert win["rps"] == pytest.approx(5.0, abs=0.2)




def test_serve_log_replicas_probe_merges_pool_rows():
    log = ServeLog()
    log.record_batch(3, 8, replica="r0")
    log.set_replicas_probe(lambda: {"r0": {"device": "cpu", "pending": 1},
                                    "r1": {"device": "cpu", "pending": 0}})
    rows = log.snapshot()["replicas"]
    assert rows["r0"] == {"batches": 1, "images": 3,
                          "batch_histogram": {"8": 1}, "device": "cpu",
                          "pending": 1}
    assert rows["r1"]["batches"] == 0 and rows["r1"]["pending"] == 0
    log.set_replicas_probe(lambda: 1 / 0)  # stats never raise
    assert "r0" in log.snapshot()["replicas"]


# -- the server's wiring ------------------------------------------------------


def _args(ckpt, *extra):
    return build_parser().parse_args([
        "--checkpoint-dir", str(ckpt), "--model", "linear", "--dtype",
        "f32", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--buckets", "1,4", "--max-wait-ms", "1", "--max-queue", "64",
        "--no-fuse", "--no-reload", *extra])


def _boot(args):
    httpd = create_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}", thread


def _close(httpd, thread):
    httpd.shutdown()
    httpd.ctx.close()
    httpd.server_close()
    thread.join(10.0)


def _stats(url):
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        return json.loads(r.read())


def _hammer(url, stop, errors):
    body = json.dumps({"images": np.zeros((3, 28, 28)).tolist()}).encode()
    while not stop.is_set():
        req = urllib.request.Request(url + "/predict", data=body)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                if r.status != 200:
                    errors.append(r.status)
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))


@pytest.fixture
def ckpt(tmp_path):
    save_params_checkpoint(params_to_jax(init_params("linear", 0)), epoch=0,
                           directory=str(tmp_path))
    return tmp_path


def test_autoscaler_resizes_cpu_replicas_under_a_spike_and_back(ckpt):
    """An SLO no request can meet breaches under load: the controller
    resizes the pool 1 -> 2 CPU replicas under live traffic with zero
    failed requests, then, once the window has emptied, back to 1."""
    httpd, url, thread = _boot(_args(
        ckpt, "--serve-devices", "1", "--max-inflight", "2",
        "--autoscale", "--slo-p95-ms", "0.001", "--stats-window-s", "1",
        "--autoscale-interval-s", "0.1", "--autoscale-cooldown-s", "0.3",
        "--autoscale-down-after", "2", "--autoscale-max-devices", "2"))
    stop, errors = threading.Event(), []
    threads = [threading.Thread(target=_hammer, args=(url, stop, errors),
                                daemon=True) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while _stats(url)["serve_devices"] != 2:
            assert time.monotonic() < deadline, _stats(url)["autoscaler"]
            time.sleep(0.05)
        time.sleep(0.3)  # traffic on the grown pool
        stop.set()
        for t in threads:
            t.join(30.0)
        deadline = time.monotonic() + 30
        while _stats(url)["serve_devices"] != 1:
            assert time.monotonic() < deadline, _stats(url)["autoscaler"]
            time.sleep(0.05)
        scaler = _stats(url)["autoscaler"]
        assert scaler["scale_ups"] >= 1 and scaler["scale_downs"] >= 1
        assert scaler["errors"] == 0 and not scaler["dry_run"]
        assert not errors, errors[:3]
    finally:
        stop.set()
        _close(httpd, thread)


def test_autoscale_dry_run_records_to_stats_and_sink_only(ckpt, tmp_path):
    """The dry run: scale-up decisions in ``/stats`` and as
    ``serve_autoscale`` lines in the ``--metrics-file`` sink, the pool
    untouched."""
    metrics = tmp_path / "m.jsonl"
    httpd, url, thread = _boot(_args(
        ckpt, "--serve-devices", "1", "--max-inflight", "2",
        "--autoscale", "--autoscale-dry-run", "--slo-p95-ms", "0.001",
        "--autoscale-interval-s", "0.1", "--autoscale-cooldown-s", "0.2",
        "--autoscale-max-devices", "2", "--metrics-file", str(metrics)))
    stop, errors = threading.Event(), []
    worker = threading.Thread(target=_hammer, args=(url, stop, errors),
                              daemon=True)
    try:
        worker.start()
        deadline = time.monotonic() + 30
        while not _stats(url)["autoscaler"]["scale_ups"]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        stop.set()
        worker.join(30.0)
        stats = _stats(url)
        assert stats["serve_devices"] == 1 and stats["groups"] == 1
        ups = [d for d in stats["autoscaler"]["decisions"]
               if d["action"] == "scale_up"]
        assert ups and all(d["dry_run"] for d in ups)
        assert stats["autoscaler"]["max_devices"] == 2
    finally:
        stop.set()
        _close(httpd, thread)
    lines = [json.loads(line) for line in metrics.read_text().splitlines()]
    events = [r for r in lines if r["kind"] == "serve_autoscale"]
    assert events and all(r["dry_run"] for r in events)
    assert not errors, errors[:3]


@pytest.mark.parametrize("extra,match", [
    (["--autoscale"], "pooled data plane"),
    (["--autoscale-dry-run"], "pass both"),
    (["--serve-devices", "2", "--autoscale", "--autoscale-min-devices", "0"],
     "must be >= 1"),
    (["--serve-devices", "2", "--autoscale", "--autoscale-max-devices",
      "9"], "this host has 8 local device"),
    (["--serve-devices", "1", "--max-inflight", "2", "--autoscale",
      "--autoscale-dry-run", "--autoscale-max-devices", "9"],
     "this host has 8 local device"),
    (["--serve-devices", "2", "--autoscale", "--serve-precision", "bf16",
      "--canary-fraction", "0.5"], "canary"),
])
def test_autoscale_flag_refusals(ckpt, extra, match):
    with pytest.raises(SystemExit, match=match):
        create_server(_args(ckpt, *extra))
