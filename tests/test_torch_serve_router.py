"""The port's fleet router (``serve/router.py``), its pure parts on the
CPU: the cases of ``tests/test_serve_router.py`` run against the port's
copy, then parity cases that feed the port's router and the JAX router
the same seeded inputs and require exactly equal results (the hash ring
over 10,000 client ids, ``pick_backend``, ``merge_windows``, the health
machine, the fleet autoscaler, the failure classifier, and
``republish_with_epoch`` on the npz, ``.ckpt`` and ``.manifest`` layouts
written by either package and loaded by both), and the ``route``
subcommand's process, which imports no torch, numpy or JAX."""

import http.client
import json
import os
import random
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pytorch_distributed_mnist_tpu.serve import router as jax_router
from pytorch_distributed_mnist_tpu_torch.serve import router
from pytorch_distributed_mnist_tpu_torch.serve.router import (
    HEALTHY,
    PRIMARY,
    PROBATION,
    QUARANTINED,
    ROLLED_BACK,
    SHADOW,
    Backend,
    BackendHealth,
    Fleet,
    FleetAutoscaler,
    FleetCanary,
    HashRing,
    RollingReload,
    TransportError,
    classify_failure,
    epoch_of_checkpoint,
    merge_windows,
    pick_backend,
    republish_with_epoch,
    retry_safe,
)

pytestmark = pytest.mark.fleet
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Consistent-hash ring
# ---------------------------------------------------------------------------


def test_hash_ring_affinity_stable_under_node_removal():
    """Removing one of N nodes re-homes only ~1/N of the keys, and every
    key whose owner SURVIVED keeps it — the property that makes a
    backend death invisible to the other backends' warm clients."""
    nodes = ["10.0.0.1:8000", "10.0.0.2:8000", "10.0.0.3:8000"]
    ring = HashRing(nodes)
    keys = [f"client-{i}" for i in range(3000)]
    before = {k: ring.node_for(k) for k in keys}
    ring.remove(nodes[1])
    after = {k: ring.node_for(k) for k in keys}

    moved = sum(1 for k in keys if before[k] != after[k])
    # Every moved key belonged to the removed node; survivors' keys
    # never move (the defining consistent-hashing property).
    for k in keys:
        if before[k] != nodes[1]:
            assert after[k] == before[k], k
        else:
            assert after[k] != nodes[1]
    assert moved == sum(1 for k in keys if before[k] == nodes[1])
    # ~1/3 of keys moved (64 virtual points keep the spread tight).
    assert 0.15 < moved / len(keys) < 0.55

    # Re-adding restores the original assignment exactly (hashing is
    # deterministic, not history-dependent).
    ring.add(nodes[1])
    assert {k: ring.node_for(k) for k in keys} == before


def test_hash_ring_basics():
    ring = HashRing(replicas=8)
    assert ring.node_for("anyone") is None
    ring.add("a:1")
    assert len(ring) == 1 and "a:1" in ring
    assert ring.node_for("x") == "a:1"
    ring.add("a:1")  # idempotent
    assert len(ring) == 1
    ring.remove("a:1")
    assert len(ring) == 0 and ring.node_for("x") is None
    with pytest.raises(ValueError, match="replicas"):
        HashRing(replicas=0)


# ---------------------------------------------------------------------------
# Dispatch decision
# ---------------------------------------------------------------------------


def _backend(name, inflight=None, total=0):
    b = Backend(name)
    b.inflight = dict(inflight or {})
    b.total_inflight = total
    return b


def test_pick_backend_least_loaded_tie_breaks():
    """Order of the keys: per-class in-flight, then total in-flight,
    then lexicographic name — fully deterministic."""
    a = _backend("h:1", {"interactive": 2}, total=2)
    b = _backend("h:2", {"interactive": 1}, total=5)
    c = _backend("h:3", {"interactive": 1}, total=3)
    # Fewest per-class wins even with more total elsewhere.
    assert pick_backend([a, b, c], klass="interactive") is c
    # Tie on per-class -> fewest total.
    c.total_inflight = 5
    assert pick_backend([a, b, c], klass="interactive") is b
    # Full tie -> lexicographic name.
    b.inflight = {"interactive": 2}
    c.inflight = {"interactive": 2}
    b.total_inflight = c.total_inflight = 2
    assert pick_backend([a, b, c], klass="interactive") is a
    # No candidates -> None (the caller's fleet 503).
    assert pick_backend([], klass="interactive") is None


def test_pick_backend_rotates_when_idle():
    """In-flight all zero (fast backends, open-loop arrivals): the
    requests-served key rotates dispatch instead of pinning the whole
    stream to one lexicographic winner."""
    fleet = Fleet()
    for n in ("127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"):
        fleet.add(n)
    served = []
    for _ in range(9):
        b = fleet.acquire()
        served.append(b.name)
        fleet.release(b)  # completes before the next arrival
    assert sorted(served.count(n) for n in set(served)) == [3, 3, 3]


def test_pick_backend_affinity_beats_load():
    """A client's ring choice wins while that backend is a candidate;
    when it is not (quarantined/excluded), least-loaded takes over."""
    names = ["h:1", "h:2", "h:3"]
    backends = {n: _backend(n) for n in names}
    ring = HashRing(names)
    client = "sticky-client"
    home = ring.node_for(client)
    backends[home].total_inflight = 99  # affinity is not load-based
    backends[home].inflight = {"interactive": 99}
    chosen = pick_backend(list(backends.values()), klass="interactive",
                          client_id=client, ring=ring)
    assert chosen.name == home
    # Home gone from the candidates -> least-loaded among the rest.
    rest = [b for n, b in backends.items() if n != home]
    fallback = pick_backend(rest, klass="interactive",
                            client_id=client, ring=ring)
    assert fallback is min(rest, key=lambda b: b.name)


# ---------------------------------------------------------------------------
# Retry-safety classifier
# ---------------------------------------------------------------------------


def test_classify_failure_buckets():
    assert classify_failure(ConnectionRefusedError()) == "refused"
    assert classify_failure(ConnectionResetError()) == "reset"
    assert classify_failure(BrokenPipeError()) == "reset"
    assert classify_failure(http.client.RemoteDisconnected("")) == "reset"
    assert classify_failure(TimeoutError()) == "timeout"
    assert classify_failure(OSError("no route")) == "transport"
    assert classify_failure(ValueError("junk")) == "other"
    # URLError unwraps to its reason.
    assert classify_failure(
        urllib.error.URLError(ConnectionRefusedError())) == "refused"
    # TransportError unwraps to the underlying exception.
    assert classify_failure(
        TransportError(ConnectionResetError(), False)) == "reset"


def test_retry_safe_only_proves_non_execution():
    """Refused/reset-before-body retry (the backend provably never ran
    the request); timeout, mid-body reset, and HTTP replies do NOT —
    re-dispatching those could double-run a mutation-free but
    accounting-visible request."""
    assert retry_safe(ConnectionRefusedError())
    assert retry_safe(ConnectionResetError())
    assert retry_safe(http.client.RemoteDisconnected(""))
    assert retry_safe(TransportError(ConnectionRefusedError(), False))
    # The same reset AFTER response bytes arrived: the backend answered.
    assert not retry_safe(ConnectionResetError(), body_started=True)
    assert not retry_safe(TransportError(ConnectionResetError(), True))
    # Ambiguous or post-execution failures never retry.
    assert not retry_safe(TimeoutError())
    assert not retry_safe(OSError("no route"))
    assert not retry_safe(
        urllib.error.HTTPError("u", 500, "boom", {}, None))


# ---------------------------------------------------------------------------
# Quarantine / probation state machine
# ---------------------------------------------------------------------------


def test_health_quarantine_and_probation_readmission():
    h = BackendHealth(quarantine_after=3, probation_successes=2)
    assert h.state == HEALTHY and h.routable
    assert h.note_failure() is None
    assert h.note_failure() is None
    assert h.note_failure() == QUARANTINED
    assert h.state == QUARANTINED and not h.routable
    assert h.quarantines == 1
    # Further failures while quarantined are a no-op (no double count).
    assert h.note_failure() is None and h.quarantines == 1
    # First success -> probation (routable again, but on a short leash).
    assert h.note_success() == PROBATION
    assert h.routable
    # The readmission streak.
    assert h.note_success() is None  # streak 1 of 2
    assert h.note_success() == HEALTHY
    assert h.readmissions == 1


def test_health_probation_one_strike():
    h = BackendHealth(quarantine_after=3, probation_successes=3)
    for _ in range(3):
        h.note_failure()
    h.note_success()
    assert h.state == PROBATION
    # One failure on probation re-quarantines immediately — no grace of
    # quarantine_after for a backend that just proved flaky.
    assert h.note_failure() == QUARANTINED
    assert h.quarantines == 2


def test_health_success_resets_failure_count():
    h = BackendHealth(quarantine_after=3)
    h.note_failure()
    h.note_failure()
    h.note_success()  # blip over
    h.note_failure()
    h.note_failure()
    assert h.state == HEALTHY  # 2 consecutive, threshold is 3
    assert h.note_failure() == QUARANTINED
    with pytest.raises(ValueError, match="quarantine_after"):
        BackendHealth(quarantine_after=0)


def test_fleet_quarantine_removes_from_ring_and_acquire():
    fleet = Fleet(quarantine_after=2)
    for n in ("127.0.0.1:1", "127.0.0.1:2"):
        fleet.add(n)
    fleet.note_failure("127.0.0.1:1", "refused")
    fleet.note_failure("127.0.0.1:1", "refused")
    assert fleet.get("127.0.0.1:1").health.state == QUARANTINED
    assert fleet.n_routable() == 1
    # Acquire never lands on a quarantined backend — even for a client
    # whose ring point used to live there.
    for i in range(50):
        b = fleet.acquire(client_id=f"c{i}")
        assert b.name == "127.0.0.1:2"
        fleet.release(b)
    # Heal: success -> probation -> routable again.
    fleet.note_success("127.0.0.1:1", {"model_epoch": 3})
    assert fleet.get("127.0.0.1:1").health.state == PROBATION
    assert fleet.n_routable() == 2
    assert fleet.get("127.0.0.1:1").epoch == 3


def test_fleet_acquire_reserves_inflight_and_excludes():
    fleet = Fleet()
    fleet.add("127.0.0.1:1")
    fleet.add("127.0.0.1:2")
    a = fleet.acquire(klass="interactive")
    assert a.total_inflight == 1
    # The reservation is visible to the next acquire: it picks the
    # other backend (least-loaded saw the in-flight slot).
    b = fleet.acquire(klass="interactive")
    assert b.name != a.name
    # A retry excludes the failed backend even when it is least-loaded.
    fleet.release(a, "interactive")
    c = fleet.acquire(klass="interactive", exclude=(b.name,))
    assert c.name == a.name
    # Draining removes from rotation without touching health.
    fleet.release(b, "interactive")
    fleet.release(c, "interactive")
    fleet.set_draining(a.name, True)
    assert fleet.acquire().name == b.name
    assert fleet.get(a.name).health.state == HEALTHY
    fleet.set_draining(a.name, False)
    assert fleet.n_routable() == 2


# ---------------------------------------------------------------------------
# Rolling-reload sequencer
# ---------------------------------------------------------------------------


class _ScriptedOps:
    """Fake rollout ops recording the exact call sequence."""

    def __init__(self, target_epoch, fail_publish_on=None,
                 active_counts=None):
        self.calls = []
        self.target = target_epoch
        self.fail_publish_on = fail_publish_on
        self.epochs = {}
        self.active_counts = dict(active_counts or {})

    def drain(self, name):
        self.calls.append(("drain", name))

    def active_requests(self, name):
        self.calls.append(("active", name))
        n = self.active_counts.get(name, 0)
        if n > 0:
            self.active_counts[name] = n - 1
        return n

    def publish(self, name):
        self.calls.append(("publish", name))
        if name == self.fail_publish_on:
            raise OSError(f"disk full on {name}")
        self.epochs[name] = self.target

    def epoch(self, name):
        self.calls.append(("epoch", name))
        return self.epochs.get(name)

    def undrain(self, name):
        self.calls.append(("undrain", name))


def test_rolling_reload_strict_ordering():
    """One backend at a time, each fully through
    drain -> wait-zero -> publish -> verify -> undrain before the next
    is touched; in-flight requests are actually waited out."""
    ops = _ScriptedOps(target_epoch=7, active_counts={"b2": 2})
    rr = RollingReload(ops, sleep=lambda s: None,
                       clock=_FakeClock().tick)
    out = rr.run(["b1", "b2", "b3"], target_epoch=7)
    assert out == {"ok": True, "updated": ["b1", "b2", "b3"],
                   "target_epoch": 7}
    # Collapse the active-poll repeats; the shape must be the strict
    # per-backend sequence with zero interleaving.
    shape = [c for i, c in enumerate(ops.calls)
             if not (c[0] == "active" and i and ops.calls[i - 1] == c)]
    assert shape == [
        ("drain", "b1"), ("active", "b1"), ("publish", "b1"),
        ("epoch", "b1"), ("undrain", "b1"),
        ("drain", "b2"), ("active", "b2"), ("publish", "b2"),
        ("epoch", "b2"), ("undrain", "b2"),
        ("drain", "b3"), ("active", "b3"), ("publish", "b3"),
        ("epoch", "b3"), ("undrain", "b3"),
    ]
    # b2's two in-flight requests forced extra active polls.
    assert sum(1 for c in ops.calls if c == ("active", "b2")) == 3


def test_rolling_reload_failure_stops_and_undrains_victim():
    """A publish failure undrains the victim and STOPS: backends not
    yet touched keep serving the old epoch (the point of rolling)."""
    ops = _ScriptedOps(target_epoch=7, fail_publish_on="b2")
    rr = RollingReload(ops, sleep=lambda s: None,
                       clock=_FakeClock().tick)
    out = rr.run(["b1", "b2", "b3"], target_epoch=7)
    assert out["ok"] is False and out["failed"] == "b2"
    assert out["updated"] == ["b1"]
    assert "disk full" in out["error"]
    assert ("undrain", "b2") in ops.calls  # victim rejoined
    assert not any(name == "b3" for _, name in ops.calls)  # untouched


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def tick(self):
        self.t += 0.01
        return self.t


def test_rolling_reload_drain_timeout():
    class _Stuck(_ScriptedOps):
        def active_requests(self, name):
            return 1  # never drains

    ops = _Stuck(target_epoch=1)
    rr = RollingReload(ops, drain_timeout_s=0.5, sleep=lambda s: None,
                       clock=_FakeClock().tick)
    out = rr.run(["b1"], target_epoch=1)
    assert out["ok"] is False and out["failed"] == "b1"
    assert "in-flight" in out["error"]
    assert ("undrain", "b1") in ops.calls


# ---------------------------------------------------------------------------
# Fleet canary verdicts
# ---------------------------------------------------------------------------


def test_fleet_canary_promote():
    canary = FleetCanary(0.25, ["b1"], target_epoch=5, baseline_epoch=4,
                         promote_after=10, budget=0.2)
    assert canary.state == SHADOW
    verdicts = [canary.note_result(True) for _ in range(10)]
    assert verdicts[:-1] == [None] * 9 and verdicts[-1] == "promote"
    assert canary.state == PRIMARY
    # Post-verdict rows are ignored (the verdict fires exactly once).
    assert canary.note_result(False) is None
    snap = canary.snapshot()
    assert snap["compared_rows"] == 10 and snap["promotions"] == 1


def test_fleet_canary_rollback_outranks_promotion():
    # budget 0.2 * promote_after 10 = 2 disagreements tolerated; the
    # third rolls back even with plenty of agreeing rows banked.
    canary = FleetCanary(0.25, ["b1"], target_epoch=5, baseline_epoch=4,
                         promote_after=10, budget=0.2)
    for _ in range(7):
        assert canary.note_result(True) is None
    assert canary.note_result(False) is None
    assert canary.note_result(False) is None
    assert canary.note_result(False) == "rollback"
    assert canary.state == ROLLED_BACK
    snap = canary.snapshot()
    assert snap["rollbacks"] == 1 and snap["disagreed_rows"] == 3
    assert snap["disagree_rate"] == 0.3


def test_fleet_canary_install_failure_short_circuits():
    canary = FleetCanary(0.25, ["b1"], target_epoch=5, baseline_epoch=4)
    assert canary.fail() == "rollback"
    assert canary.state == ROLLED_BACK
    assert canary.fail() is None  # idempotent
    assert canary.note_result(True) is None  # measurement closed


def test_fleet_canary_cohort_deterministic():
    canary = FleetCanary(0.3, ["b1"], target_epoch=5, baseline_epoch=4)
    clients = [f"client-{i}" for i in range(2000)]
    cohort = [c for c in clients if canary.wants(c)]
    # Same client, same side, every time; anonymous stays baseline.
    assert cohort == [c for c in clients if canary.wants(c)]
    assert not canary.wants(None) and not canary.wants("")
    assert 0.2 < len(cohort) / len(clients) < 0.4
    with pytest.raises(ValueError, match="fraction"):
        FleetCanary(0.0, ["b1"], 5, 4)


def test_fleet_canary_fault_injection_forces_disagreement(monkeypatch):
    """TPUMNIST_FLEET_FAULT=canary_disagree turns every cohort reply
    into a disagreement — the chaos twin's deterministic bad publish."""
    monkeypatch.setenv("TPUMNIST_FLEET_FAULT", "canary_disagree")
    canary = FleetCanary(0.5, ["b1"], target_epoch=5, baseline_epoch=4,
                         promote_after=100, budget=0.02)
    verdict = None
    for _ in range(10):
        verdict = verdict or canary.note_result(True)  # ok, but faulted
    assert verdict == "rollback" and canary.state == ROLLED_BACK


# ---------------------------------------------------------------------------
# Merged fleet quantiles
# ---------------------------------------------------------------------------


def _flat_percentile(vals, q):
    vals = sorted(vals)
    idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return vals[idx]


def _window_block(samples, seconds=10.0, queue_depth=0):
    return {
        "seconds": seconds,
        "rps": round(len(samples) / seconds, 3),
        "queue_depth": queue_depth,
        "count": len(samples),
        "p50_ms": _flat_percentile(samples, 0.50),
        "p95_ms": _flat_percentile(samples, 0.95),
        "p99_ms": _flat_percentile(samples, 0.99),
    }


def test_merge_windows_identical_backends_exact():
    """Backends sharing a distribution merge to that distribution —
    the CDF model is exact in the homogeneous case."""
    rng = random.Random(7)
    samples = [rng.uniform(1.0, 100.0) for _ in range(4000)]
    block = _window_block(samples)
    merged = merge_windows([block, dict(block), dict(block)])
    assert merged["backends"] == 3
    assert merged["count"] == 3 * len(samples)
    assert merged["rps"] == pytest.approx(3 * block["rps"], rel=1e-6)
    for key in ("p50_ms", "p95_ms", "p99_ms"):
        assert merged[key] == pytest.approx(block[key], rel=0.02), key


def test_merge_windows_vs_flat_recompute():
    """Heterogeneous backends (one fast, one slow, one mid, skewed
    counts): the merged quantiles track a flat recompute over the
    pooled samples within the documented tolerance, and the merged p50
    lands between the per-backend extremes."""
    rng = random.Random(11)
    pools = [
        [rng.uniform(1.0, 10.0) for _ in range(3000)],     # fast, busy
        [rng.uniform(20.0, 60.0) for _ in range(1000)],    # mid
        [rng.uniform(80.0, 200.0) for _ in range(200)],    # slow, idle
    ]
    blocks = [_window_block(p) for p in pools]
    merged = merge_windows(blocks)
    flat = [s for p in pools for s in p]
    assert merged["count"] == len(flat)
    for q, key in ((0.50, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
        want = _flat_percentile(flat, q)
        assert merged[key] == pytest.approx(want, rel=0.15), (key, want)
    assert min(b["p50_ms"] for b in blocks) <= merged["p50_ms"] \
        <= max(b["p50_ms"] for b in blocks)


def test_merge_windows_skips_empty_and_none():
    merged = merge_windows([None, {"count": 0}, None])
    assert merged["backends"] == 0 and merged["count"] == 0
    assert merged["p99_ms"] == 0.0
    one = _window_block([5.0, 6.0, 7.0, 8.0])
    merged = merge_windows([None, one, {"count": 0}])
    assert merged["backends"] == 1 and merged["count"] == 4
    assert merged["p50_ms"] == pytest.approx(one["p50_ms"], rel=0.05)


# ---------------------------------------------------------------------------
# Fleet autoscaler decide()
# ---------------------------------------------------------------------------


def test_fleet_autoscaler_decisions():
    sc = FleetAutoscaler(2, 4, slo_p95_ms=100.0, cooldown_s=10.0,
                         down_after=2)
    calm = {"p95_ms": 10.0, "count": 100}
    busy = {"p95_ms": 250.0, "count": 100}
    # Below the floor: up immediately, cooldown or not.
    assert sc.decide(1, calm, now=0.0) == "up"
    assert sc.decide(1, calm, now=0.1) == "up"
    # At the floor, busy, but inside cooldown -> hold.
    assert sc.decide(2, busy, now=1.0) is None
    # Cooldown expired -> up on SLO breach.
    assert sc.decide(2, busy, now=20.0) == "up"
    # At the ceiling, still busy -> no further up.
    assert sc.decide(4, busy, now=40.0) is None
    # Scale down only after down_after consecutive calm ticks.
    assert sc.decide(4, calm, now=60.0) is None   # calm streak 1
    assert sc.decide(4, busy, now=61.0) is None   # streak broken
    assert sc.decide(4, calm, now=62.0) is None   # streak 1 again
    assert sc.decide(4, calm, now=63.0) == "down"
    # Never below the floor.
    assert sc.decide(2, calm, now=80.0) is None
    assert sc.decide(2, calm, now=81.0) is None
    snap = sc.snapshot()
    assert snap["scale_ups"] == 3 and snap["scale_downs"] == 1
    assert snap["decisions"][-1]["action"] == "down"
    with pytest.raises(ValueError, match="fleet-max"):
        FleetAutoscaler(3, 2)


# ---------------------------------------------------------------------------
# Odds and ends
# ---------------------------------------------------------------------------


def test_epoch_of_checkpoint():
    assert epoch_of_checkpoint("/tmp/x/checkpoint_12.npz") == 12
    assert epoch_of_checkpoint("checkpoint_0.ckpt") == 0
    with pytest.raises(ValueError):
        epoch_of_checkpoint("/tmp/weights.npz")


def test_chaos_fault_env_pinned():
    """The port's chaos tool spells the fault variable out; this pin
    keeps it equal to the port's router's and the JAX router's."""
    from pytorch_distributed_mnist_tpu_torch.runtime import chaos

    assert chaos.FLEET_FAULT_ENV == router.FLEET_FAULT_ENV \
        == jax_router.FLEET_FAULT_ENV


def test_backend_name_normalization():
    assert Backend("127.0.0.1:8000").name == "127.0.0.1:8000"
    assert Backend("http://127.0.0.1:8000").name == "127.0.0.1:8000"
    assert Backend("http://127.0.0.1:8000/").url \
        == "http://127.0.0.1:8000"
    with pytest.raises(ValueError, match="host:port"):
        Backend("no-port")


def test_republish_with_epoch_rebases_embedded_epoch(tmp_path):
    """The rollback's roll-forward republish must rewrite the epoch the
    checkpoint CARRIES, not just its filename — load_checkpoint trusts
    ``__meta__``'s epoch and the engines refuse older params, so a plain
    copy of baseline weights under a newer name would be rejected and
    the bad epoch would keep serving. Arrays must survive byte-for-byte."""
    import io
    import json as json_mod

    meta = {"epoch": 2, "best_acc": 0.5, "leaf_names": ["w", "b"],
            "format_version": 1}
    weights = np.arange(12, dtype=np.float32).reshape(3, 4)
    bias = np.ones(4, dtype=np.float32)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json_mod.dumps(meta).encode(), np.uint8),
        leaf_0=weights, leaf_1=bias)
    source = tmp_path / "checkpoint_1.npz"
    source.write_bytes(buf.getvalue())

    dest = tmp_path / "checkpoint_3.npz"
    republish_with_epoch(str(source), str(dest), 3)

    with np.load(str(dest)) as z:
        out_meta = json_mod.loads(bytes(z["__meta__"]).decode())
        assert out_meta["epoch"] == 4  # stored epoch+1 convention
        assert out_meta["best_acc"] == 0.5
        assert out_meta["leaf_names"] == ["w", "b"]
        np.testing.assert_array_equal(z["leaf_0"], weights)
        np.testing.assert_array_equal(z["leaf_1"], bias)
    # The source is untouched (the baseline stays what it was).
    with np.load(str(source)) as z:
        assert json_mod.loads(bytes(z["__meta__"]).decode())["epoch"] == 2


# ---------------------------------------------------------------------------
# Parity with the JAX router: the same seeded inputs, exactly equal results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 4, 5])
def test_hash_ring_parity_before_and_after_a_removal(n_nodes):
    rng = random.Random(n_nodes)
    nodes = [f"10.0.{rng.randrange(256)}.{i}:{8000 + i}"
             for i in range(n_nodes)]
    keys = [f"client-{rng.getrandbits(48):x}" for _ in range(10_000)]
    port, ref = HashRing(nodes), jax_router.HashRing(nodes)
    assert [port.node_for(k) for k in keys] == \
        [ref.node_for(k) for k in keys]
    port.remove(nodes[-1])
    ref.remove(nodes[-1])
    assert [port.node_for(k) for k in keys] == \
        [ref.node_for(k) for k in keys]


def _loaded(module, names, loads):
    out = []
    for name, (inflight, total, served) in zip(names, loads):
        b = module.Backend(name)
        b.inflight = dict(inflight)
        b.total_inflight = total
        b.requests = served
        out.append(b)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_pick_backend_parity_on_seeded_loads(seed):
    rng = random.Random(seed)
    names = [f"127.0.0.1:{9000 + i}" for i in range(5)]
    classes = router.PRIORITY_CLASSES
    port_ring = HashRing(names)
    ref_ring = jax_router.HashRing(names)
    for trial in range(200):
        loads = [({k: rng.randrange(3) for k in classes}, rng.randrange(6),
                  rng.randrange(4)) for _ in names]
        keep = [i for i in range(len(names)) if rng.random() < 0.8]
        klass = rng.choice(classes + (None,))
        client = rng.choice([None, f"c{trial % 17}"])
        port = _loaded(router, [names[i] for i in keep],
                       [loads[i] for i in keep])
        ref = _loaded(jax_router, [names[i] for i in keep],
                      [loads[i] for i in keep])
        got = pick_backend(port, klass=klass, client_id=client,
                           ring=port_ring)
        want = jax_router.pick_backend(ref, klass=klass, client_id=client,
                                       ring=ref_ring)
        assert (got and got.name) == (want and want.name), trial


@pytest.mark.parametrize("seed", range(4))
def test_merge_windows_parity_on_seeded_blocks(seed):
    rng = random.Random(100 + seed)
    for _ in range(50):
        blocks = []
        for _ in range(rng.randrange(1, 6)):
            if rng.random() < 0.15:
                blocks.append(rng.choice([None, {"count": 0}]))
                continue
            samples = [rng.uniform(0.5, 300.0)
                       for _ in range(rng.randrange(1, 400))]
            blocks.append(_window_block(samples, seconds=rng.uniform(1, 60),
                                        queue_depth=rng.randrange(9)))
        assert merge_windows(blocks) == jax_router.merge_windows(blocks)


@pytest.mark.parametrize("seed", range(3))
def test_backend_health_parity_on_a_seeded_sequence(seed):
    rng = random.Random(200 + seed)
    after, streak = rng.randrange(1, 5), rng.randrange(1, 5)
    port = BackendHealth(after, streak)
    ref = jax_router.BackendHealth(after, streak)
    for _ in range(2000):
        ok = rng.random() < 0.6
        got = port.note_success() if ok else port.note_failure()
        want = ref.note_success() if ok else ref.note_failure()
        assert got == want
        assert (port.state, port.consecutive_failures,
                port.probation_streak, port.quarantines,
                port.readmissions) == (ref.state, ref.consecutive_failures,
                                       ref.probation_streak,
                                       ref.quarantines, ref.readmissions)


@pytest.mark.parametrize("seed", range(3))
def test_fleet_autoscaler_decide_parity_on_a_seeded_series(seed):
    rng = random.Random(300 + seed)
    kwargs = dict(slo_p95_ms=rng.uniform(20, 200),
                  cooldown_s=rng.uniform(0, 10),
                  down_after=rng.randrange(1, 5))
    lo = rng.randrange(1, 3)
    port = FleetAutoscaler(lo, lo + 3, **kwargs)
    ref = jax_router.FleetAutoscaler(lo, lo + 3, **kwargs)
    now = 0.0
    for _ in range(500):
        now += rng.uniform(0.1, 3.0)
        n = rng.randrange(0, lo + 5)
        merged = {"p95_ms": rng.uniform(0, 400),
                  "count": rng.choice([0, rng.randrange(1, 500)]),
                  "rps": rng.uniform(0, 100)}
        assert port.decide(n, merged, now) == ref.decide(n, merged, now)
    assert port.snapshot() == ref.snapshot()


def _failures(module):
    """The same failures, the wrappers built from ``module``'s own
    TransportError."""
    base = [ConnectionRefusedError(), ConnectionResetError(),
            BrokenPipeError(), http.client.RemoteDisconnected(""),
            TimeoutError(), OSError("no route"), ValueError("junk"),
            RuntimeError("GET x -> 500"),
            urllib.error.URLError(ConnectionRefusedError()),
            urllib.error.URLError("name resolution"),
            urllib.error.HTTPError("u", 500, "boom", {}, None)]
    wrapped = [module.TransportError(exc, started) for exc in base[:6]
               for started in (False, True)]
    return base + wrapped


def test_classify_failure_and_retry_safe_parity():
    port, ref = _failures(router), _failures(jax_router)
    assert [classify_failure(e) for e in port] == \
        [jax_router.classify_failure(e) for e in ref]
    for started in (False, True):
        assert [retry_safe(e, started) for e in port] == \
            [jax_router.retry_safe(e, started) for e in ref]


def _jax_state():
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_mnist_tpu.models import get_model
    from pytorch_distributed_mnist_tpu.train.state import create_train_state

    return create_train_state(get_model("linear", compute_dtype=jnp.float32),
                              jax.random.key(4))


def _port_state():
    import torch

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )

    return create_train_state(get_model("linear",
                                        compute_dtype=torch.float32),
                              seed=5, device=torch.device("cpu"))


SUFFIX = {"npz": ".npz", "sharded": ".ckpt", "delta": ".manifest"}


def _write_source(writer, layout, directory):
    """``checkpoint_1`` of a full linear train state, in ``layout``,
    written by the JAX package or the port."""
    extra = ({"publish": "delta"} if layout == "delta"
             else {"layout": layout})
    if writer == "jax":
        from pytorch_distributed_mnist_tpu.train import checkpoint

        return checkpoint.save_checkpoint(
            _jax_state(), epoch=1, best_acc=0.5, is_best=False,
            directory=directory, process_index=0, **extra)
    from pytorch_distributed_mnist_tpu_torch.train import checkpoint

    return checkpoint.save_checkpoint(
        _port_state(), epoch=1, best_acc=0.5, is_best=False,
        directory=directory, **extra)


@pytest.mark.parametrize("layout", ["npz", "sharded", "delta"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("republisher", ["jax", "port"])
def test_republish_with_epoch_loads_in_both_packages(tmp_path, layout,
                                                     writer, republisher):
    """Either router's republish of either package's checkpoint, in each
    layout: the rebased epoch (stored as 5 + 1), the params byte for byte
    the source's, and a full restore in both packages."""
    from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
    from pytorch_distributed_mnist_tpu_torch.train import (
        checkpoint as port_ckpt,
    )

    directory = str(tmp_path)
    source = _write_source(writer, layout, directory)
    assert source.endswith(f"checkpoint_1{SUFFIX[layout]}")
    dest = os.path.join(directory, f"checkpoint_5{SUFFIX[layout]}")
    rewrite = (republish_with_epoch if republisher == "port"
               else jax_router.republish_with_epoch)
    rewrite(source, dest, 5)

    src_meta, src_leaves = port_ckpt.read_checkpoint_arrays(source)
    meta, leaves = port_ckpt.read_checkpoint_arrays(dest)
    assert meta["epoch"] == 6 and src_meta["epoch"] == 2
    assert {k: v for k, v in meta.items() if k != "epoch"} == \
        {k: v for k, v in src_meta.items() if k != "epoch"}
    assert list(leaves) == list(src_leaves)
    for name, arr in src_leaves.items():
        assert leaves[name].dtype == arr.dtype
        assert leaves[name].tobytes() == arr.tobytes(), name

    params, epoch = port_ckpt.load_params(dest)
    assert epoch == 5
    _, start, best = port_ckpt.load_checkpoint(dest, _port_state())
    assert (start, best) == (6, 0.5)
    jstate, jstart, jbest = jax_ckpt.load_checkpoint(dest, _jax_state())
    assert (jstart, jbest) == (6, 0.5)
    jax_leaves = dict(jax_ckpt._leaves_with_names(
        jax_ckpt._state_tree(jstate)))
    for name, arr in params.items():
        np.testing.assert_array_equal(np.asarray(jax_leaves[name]), arr)
        assert arr.tobytes() == src_leaves[name].tobytes()


# ---------------------------------------------------------------------------
# The route subcommand's process: stdlib only
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    env.pop("TPUMNIST_FLEET_FAULT", None)
    return env


def test_route_help_imports_no_torch_numpy_or_jax():
    code = ("import json, runpy, sys\n"
            "sys.argv = ['pytorch_distributed_mnist_tpu_torch', 'route', "
            "'--help']\n"
            "try:\n"
            "    runpy.run_module('pytorch_distributed_mnist_tpu_torch', "
            "run_name='__main__', alter_sys=True)\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr
    assert "--backends-dir" in proc.stdout
    modules = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "pytorch_distributed_mnist_tpu_torch.serve.router" in modules
    tops = {m.split(".")[0] for m in modules}
    assert not tops & {"torch", "numpy", "jax",
                       "pytorch_distributed_mnist_tpu"}


def test_route_serves_and_its_process_imports_no_torch(tmp_path):
    """``python -m pytorch_distributed_mnist_tpu_torch route`` boots and
    answers over a fleet whose one backend is gone: a loud 503 on
    /healthz and /predict, the backend quarantined; ``-X importtime``
    shows no torch, numpy or JAX among its imports."""
    log = tmp_path / "router.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "pytorch_distributed_mnist_tpu_torch", "route", "--backends",
             "127.0.0.1:9", "--port", "0", "--health-interval", "0.1",
             "--quarantine-after", "1", "--metrics-file",
             str(tmp_path / "m.jsonl")], stdout=f,
            stderr=subprocess.STDOUT, cwd=REPO, env=_env())
    try:
        deadline = time.monotonic() + 30
        url = None
        while url is None and time.monotonic() < deadline:
            assert proc.poll() is None, log.read_text()[-2000:]
            for line in log.read_text().splitlines():
                if line.startswith("routing on "):
                    url = line.split()[2]
            time.sleep(0.05)
        assert url, log.read_text()[-2000:]
        deadline = time.monotonic() + 30
        while True:
            try:
                urllib.request.urlopen(url + "/healthz", timeout=10)
            except urllib.error.HTTPError as err:
                body = json.loads(err.read())
                if body["backends"]["127.0.0.1:9"] == "quarantined":
                    assert err.code == 503 and body["routable"] == 0
                    break
            assert time.monotonic() < deadline
            time.sleep(0.1)
        req = urllib.request.Request(url + "/predict", data=b'{"images": []}')
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 503
        assert json.loads(err.value.read())["error"] == \
            "no routable backends in the fleet"
    finally:
        proc.kill()
        proc.wait()
    tops = {line.rsplit("|", 1)[1].strip().split(".")[0]
            for line in log.read_text().splitlines()
            if line.startswith("import time:") and "|" in line}
    assert "pytorch_distributed_mnist_tpu_torch" in tops
    assert not tops & {"torch", "numpy", "jax"}
    kinds = [json.loads(ln)["kind"]
             for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert "fleet_quarantine" in kinds and "fleet_503" in kinds
