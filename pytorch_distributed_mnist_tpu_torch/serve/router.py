"""The ``route`` subcommand: a fleet front-end over N port serve processes.

Counterpart of ``pytorch_distributed_mnist_tpu/serve/router.py``, copied
(the port imports nothing of the JAX package) and kept the same but for
the package it names: its backends are the port's serve processes, its
``--spawn-backend`` starts ``python -m pytorch_distributed_mnist_tpu_torch``,
and its event lines go through the port's ``utils/profiling.py``.

One serve process is one failure domain: one SIGKILL takes its whole
serving surface down. ``python -m pytorch_distributed_mnist_tpu_torch
route --backends host:port,...`` puts a pure-stdlib routing tier above N
backend serve processes and makes a BACKEND the failure domain, not the
system:

- **Discovery + health.** A static ``--backends`` list and/or dynamic
  ``--backends-dir`` discovery (serve processes started with
  ``--register-dir`` drop/remove ``backend_*.json`` records; the sweep
  reconciles joins on probation and reaps only what it discovered),
  plus a background ``/healthz`` poller running the replica pool's
  heal state machine (``serve/pool.py``) one level up:
  ``--quarantine-after`` consecutive failures quarantine a backend (not
  routable, still probed), a successful probe re-admits it on
  PROBATION (routable, one strike re-quarantines),
  ``--probation-successes`` clean results make it HEALTHY again.
- **Routing.** Each ``/predict`` routes on model x priority:
  least-loaded over the routable backends serving that model (fewest
  in-flight of the request's class, then fewest total, then name — a
  deterministic tie-break), with consistent-hash ``client_id`` affinity
  on top (a client sticks to one backend while the backend set is
  stable; when it changes, only ~1/N of clients move — the hash-ring
  property).
- **Defensive dispatch.** Per-request connect/read timeouts; ONE retry
  on a DIFFERENT backend only for failures that PROVE the backend never
  executed the request (connection refused, reset before any response
  bytes, or the backend's own drain-503 refusal) — a timeout or a
  mid-body reset may have executed, so it is never double-dispatched;
  backend 503/429 ``Retry-After`` passes through untouched (fleet-wide
  backpressure must reach clients); a loud fleet 503 only when ZERO
  routable backends remain.
- **Deploys as fleet operations.** ``POST /rollout`` runs a rolling
  reload — drain one backend (its own admission control, ``POST
  /drain``), wait for in-flight to hit zero via ``/stats``, publish the
  checkpoint into that backend's directory, verify ``/healthz`` epoch,
  rejoin, next — and fleet canaries: publish to one backend first,
  route a deterministic fraction of *clients* there, and reuse the
  shadow canary's verdict shape (``serve/canary.py``: shadow ->
  primary / rolled_back on an error budget) for fleet-wide
  auto-promote/auto-rollback.
- **Two-tier autoscaling.** ``--fleet-min/--fleet-max`` scale the
  NUMBER of backend processes (spawn via ``--spawn-backend``); the
  per-pool autoscaler (``serve/control.py``) stays the intra-process
  actuator.
- **Aggregated /stats.** Per-backend rows plus fleet quantiles merged
  from the backends' rolling-window blocks (count-weighted CDF merge —
  ``merge_windows``).

Lock discipline: the routing table has ONE lock and no network IO ever
runs under it — every dispatch snapshots the decision under the lock,
then talks HTTP outside it. The health poller keeps its own lock for
sweep bookkeeping with the same rule.

Deliberately pure stdlib: this module imports no torch and no numpy and
calls nothing in the data plane it fronts — the router keeps routing and
failing over even when every backend is down. The package's
``__main__`` dispatches ``route`` before it imports the training CLI, so
a router process never loads torch (``tests/test_torch_serve_router.py``
pins it).
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import http.client
import json
import os
import re
import shlex
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

# The shared request-economics layer (serve/economics.py) is pure
# stdlib BY CONTRACT — the router reuses the backend's exact-match
# keyed cache and generation-invalidation rule without growing a
# torch/numpy dependency.
from pytorch_distributed_mnist_tpu_torch.serve.economics import (
    ResponseCache,
    request_key,
)

# Mirrors serve/control.py::PRIORITY_CLASSES without importing it (that
# module imports numpy; the router is stdlib-only). The backend remains
# the authority — an unknown class forwarded anyway comes back 400.
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")

# Fault injection for the fleet chaos twins (runtime/chaos.py
# --fleet-canary-rollback): "canary_disagree" makes every canary-cohort
# row count as a disagreement, driving the budget rollback path
# deterministically — the same pattern as serve/canary.py's
# TPUMNIST_CANARY_FAULT one level down.
FLEET_FAULT_ENV = "TPUMNIST_FLEET_FAULT"

MAX_BODY_BYTES = 16 << 20

# Backend health states — the pool-heal vocabulary one level up.
HEALTHY = "healthy"
QUARANTINED = "quarantined"
PROBATION = "probation"

_EPOCH_RE = re.compile(r"checkpoint_(\d+)")


# ---------------------------------------------------------------------------
# Pure parts: every class below is deterministic and IO-free, unit-tested
# in tests/test_torch_serve_router.py without a socket in sight.
# ---------------------------------------------------------------------------


class BackendHealth:
    """The quarantine/probation state machine, as pure transitions.

    HEALTHY --(quarantine_after consecutive failures)--> QUARANTINED
    QUARANTINED --(one successful probe)--> PROBATION
    PROBATION --(one failure)--> QUARANTINED  (one strike on probation)
    PROBATION --(probation_successes consecutive successes)--> HEALTHY

    Any success resets the failure count (exactly the pool's rule).
    Callers hold whatever lock guards the backend table; this class
    holds none.
    """

    def __init__(self, quarantine_after: int = 3,
                 probation_successes: int = 3) -> None:
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}")
        if probation_successes < 1:
            raise ValueError(f"probation_successes must be >= 1, "
                             f"got {probation_successes}")
        self.quarantine_after = quarantine_after
        self.probation_successes = probation_successes
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.probation_streak = 0
        self.quarantines = 0
        self.readmissions = 0

    @property
    def routable(self) -> bool:
        return self.state != QUARANTINED

    def note_success(self) -> Optional[str]:
        """Record one successful probe/dispatch; returns the new state
        when a transition happened, else None."""
        self.consecutive_failures = 0
        if self.state == QUARANTINED:
            self.state = PROBATION
            self.probation_streak = 0
            return PROBATION
        if self.state == PROBATION:
            self.probation_streak += 1
            if self.probation_streak >= self.probation_successes:
                self.state = HEALTHY
                self.readmissions += 1
                return HEALTHY
        return None

    def note_failure(self) -> Optional[str]:
        """Record one failed probe/dispatch; returns QUARANTINED when
        this failure crossed the threshold, else None."""
        if self.state == PROBATION:
            # One strike: probation earns trust slowly, loses it fast.
            self.state = QUARANTINED
            self.consecutive_failures = 0
            self.probation_streak = 0
            self.quarantines += 1
            return QUARANTINED
        if self.state == QUARANTINED:
            return None
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.quarantine_after:
            self.state = QUARANTINED
            self.consecutive_failures = 0
            self.quarantines += 1
            return QUARANTINED
        return None


class HashRing:
    """Consistent hashing for client affinity: each node owns
    ``replicas`` points on a 64-bit ring; a key routes to the first
    point clockwise. Adding/removing one of N nodes moves only ~1/N of
    the keys — every other client keeps its backend (and that backend's
    warm batcher) across a fleet topology change."""

    def __init__(self, nodes: Sequence[str] = (), replicas: int = 64) -> None:
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.replicas = replicas
        self._points: List[Tuple[int, str]] = []  # sorted (hash, node)
        for node in nodes:
            self.add(node)

    @staticmethod
    def _hash(key: str) -> int:
        digest = hashlib.sha256(key.encode("utf-8", "replace")).digest()
        return int.from_bytes(digest[:8], "big")

    def __contains__(self, node: str) -> bool:
        return any(n == node for _, n in self._points)

    def __len__(self) -> int:
        return len({n for _, n in self._points})

    def add(self, node: str) -> None:
        if node in self:
            return
        for i in range(self.replicas):
            bisect.insort(self._points, (self._hash(f"{node}#{i}"), node))

    def remove(self, node: str) -> None:
        self._points = [(h, n) for h, n in self._points if n != node]

    def node_for(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        h = self._hash(key)
        idx = bisect.bisect_right(self._points, (h, "￿"))
        if idx == len(self._points):
            idx = 0
        return self._points[idx][1]


class TransportError(Exception):
    """One failed backend HTTP exchange, annotated with whether any
    response bytes had arrived — the fact the retry-safety classifier
    needs (a reset AFTER the status line may have executed)."""

    def __init__(self, exc: BaseException, body_started: bool) -> None:
        super().__init__(repr(exc))
        self.exc = exc
        self.body_started = body_started


def classify_failure(exc: BaseException) -> str:
    """Bucket one transport exception: ``refused`` / ``reset`` /
    ``timeout`` / ``http`` / ``transport`` / ``other``. URLError is
    unwrapped to its reason first."""
    if isinstance(exc, TransportError):
        exc = exc.exc
    reason = exc
    if isinstance(exc, urllib.error.HTTPError):
        return "http"
    if isinstance(exc, urllib.error.URLError) and isinstance(
            exc.reason, BaseException):
        reason = exc.reason
    if isinstance(reason, ConnectionRefusedError):
        return "refused"
    # RemoteDisconnected subclasses ConnectionResetError: "closed the
    # connection without response" is precisely reset-before-body.
    if isinstance(reason, (ConnectionResetError, BrokenPipeError)):
        return "reset"
    # socket.timeout is TimeoutError on 3.10+; check BEFORE the OSError
    # catch-all (TimeoutError subclasses OSError).
    if isinstance(reason, TimeoutError):
        return "timeout"
    if isinstance(reason, OSError):
        return "transport"
    return "other"


def retry_safe(exc: BaseException, body_started: bool = False) -> bool:
    """True only when the failure PROVES the backend never executed the
    request, so dispatching it to a different backend cannot double-run
    it: connection refused (never accepted) or reset before any
    response bytes (never answered — stdlib http.client raises
    RemoteDisconnected for exactly this). A timeout is ambiguous (the
    backend may be executing right now) and anything after the first
    response byte certainly reached application code: neither retries.
    HTTP status replies are not transport failures at all — 5xx passes
    through (the backend DID run something)."""
    if isinstance(exc, TransportError):
        body_started = body_started or exc.body_started
        exc = exc.exc
    if body_started:
        return False
    return classify_failure(exc) in ("refused", "reset")


def pick_backend(candidates: Sequence["Backend"], klass: Optional[str] = None,
                 client_id: Optional[str] = None,
                 ring: Optional[HashRing] = None) -> Optional["Backend"]:
    """The pure dispatch decision over a snapshot of routable backends:
    consistent-hash affinity when the client's ring choice is among the
    candidates, else least-loaded — fewest in-flight of the request's
    priority class, then fewest total, then fewest requests served so
    far (fast backends finish between arrivals, so the in-flight keys
    tie at zero constantly — without this the winner would be STICKY
    and one backend would absorb the whole open-loop stream), then
    lexicographic name (the deterministic last tie-break the unit
    suite pins)."""
    if not candidates:
        return None
    if client_id and ring is not None:
        preferred = ring.node_for(client_id)
        for backend in candidates:
            if backend.name == preferred:
                return backend
    k = klass or PRIORITY_CLASSES[0]
    return min(candidates,
               key=lambda b: (b.inflight.get(k, 0), b.total_inflight,
                              b.requests, b.name))


def _interp_cdf(knots: Sequence[Tuple[float, float]], x: float) -> float:
    """Piecewise-linear CDF through (value, cumulative-fraction) knots."""
    if x >= knots[-1][0]:
        return 1.0
    prev_x, prev_y = knots[0]
    if x <= prev_x:
        return prev_y if x == prev_x else 0.0
    for kx, ky in knots[1:]:
        if x <= kx:
            if kx == prev_x:
                return ky
            frac = (x - prev_x) / (kx - prev_x)
            return prev_y + frac * (ky - prev_y)
        prev_x, prev_y = kx, ky
    return 1.0


def merge_windows(blocks: Sequence[Optional[dict]]) -> dict:
    """Merge per-backend rolling-window blocks (serve/profiling.py
    ``ServeLog.window_stats``: seconds/rps/queue_depth/p50_ms/p95_ms/
    p99_ms/count) into fleet quantiles.

    Backends export quantiles, not raw samples, so the exact fleet
    quantile is unrecoverable; this is the standard deterministic
    approximation: model each backend's latency CDF as piecewise-linear
    through its known quantile knots ((p50, .5), (p95, .95), (p99, 1.0)
    — p99 treated as the effective max), sum the CDFs weighted by
    request count, and invert by bisection. Exact when backends share a
    distribution; always within [min, max] of the per-backend quantiles
    otherwise (pinned against a flat recompute in the unit suite).
    Throughput merges exactly: rps/count/queue_depth are sums."""
    rows = [b for b in blocks if b and b.get("count", 0) > 0]
    merged = {
        "backends": len(rows),
        "seconds": max((float(b.get("seconds", 0.0)) for b in rows),
                       default=0.0),
        "rps": round(sum(float(b.get("rps", 0.0)) for b in rows), 3),
        "queue_depth": sum(int(b.get("queue_depth", 0)) for b in rows),
        "count": sum(int(b["count"]) for b in rows),
    }
    if not rows:
        merged.update({"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0})
        return merged
    total = merged["count"]
    knotted = [
        ([(0.0, 0.0), (float(b["p50_ms"]), 0.50),
          (max(float(b["p95_ms"]), float(b["p50_ms"])), 0.95),
          (max(float(b["p99_ms"]), float(b["p95_ms"]),
               float(b["p50_ms"])), 1.0)], int(b["count"]))
        for b in rows
    ]
    hi_bound = max(knots[-1][0] for knots, _ in knotted)

    def cdf(x: float) -> float:
        return sum(c * _interp_cdf(knots, x)
                   for knots, c in knotted) / total

    def quantile(q: float) -> float:
        lo, hi = 0.0, max(hi_bound, 1e-9)
        for _ in range(64):
            mid = (lo + hi) / 2.0
            if cdf(mid) < q:
                lo = mid
            else:
                hi = mid
        return round(hi, 3)

    merged.update({"p50_ms": quantile(0.50), "p95_ms": quantile(0.95),
                   "p99_ms": quantile(0.99)})
    return merged


class RollingReload:
    """The rolling-deploy sequencer: strictly one backend at a time,
    each through drain -> wait in-flight zero -> publish -> verify
    epoch -> rejoin. ``ops`` is injected (the router's real ops do HTTP
    + an atomic file copy) so the ordering contract is unit-testable
    with a scripted fake; a failure undrains the victim and STOPS — the
    backends not yet touched keep serving the old epoch, which is the
    whole point of rolling."""

    def __init__(self, ops, *, drain_timeout_s: float = 30.0,
                 verify_timeout_s: float = 60.0, poll_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.ops = ops
        self.drain_timeout_s = float(drain_timeout_s)
        self.verify_timeout_s = float(verify_timeout_s)
        self.poll_s = float(poll_s)
        self._sleep = sleep
        self._clock = clock

    def _wait(self, check: Callable[[], bool], timeout_s: float,
              what: str) -> None:
        deadline = self._clock() + timeout_s
        while True:
            if check():
                return
            if self._clock() >= deadline:
                raise TimeoutError(f"timed out after {timeout_s}s "
                                   f"waiting for {what}")
            self._sleep(self.poll_s)

    def run(self, backends: Sequence[str], target_epoch: int) -> dict:
        updated: List[str] = []
        for name in backends:
            try:
                self.ops.drain(name)
                self._wait(lambda: self.ops.active_requests(name) == 0,
                           self.drain_timeout_s,
                           f"{name} in-flight to reach zero")
                self.ops.publish(name)
                self._wait(lambda: self.ops.epoch(name) == target_epoch,
                           self.verify_timeout_s,
                           f"{name} to serve epoch {target_epoch}")
                self.ops.undrain(name)
            except Exception as exc:  # noqa: BLE001 - report, never raise
                try:
                    self.ops.undrain(name)
                except Exception:  # noqa: BLE001 - best-effort rejoin
                    pass
                return {"ok": False, "updated": updated, "failed": name,
                        "error": repr(exc), "target_epoch": target_epoch}
            updated.append(name)
        return {"ok": True, "updated": updated,
                "target_epoch": target_epoch}


SHADOW = "shadow"
PRIMARY = "primary"
ROLLED_BACK = "rolled_back"


class FleetCanary:
    """The shadow canary's verdict shape, one level up. At fleet scope
    there are no logits to diff, so a "row" is one reply served by the
    canary cohort and a "disagreement" is a failed one (5xx or
    transport) — the contract under test is availability of the new
    epoch, not numerics (the backend's own shadow canary still guards
    those). Verdict rule is ``serve/canary.py``'s: rollback when
    disagreed_rows exceed ``budget * promote_after`` (rollback outranks
    promotion), promote when ``promote_after`` rows compared inside the
    budget. Counter
    mutation runs under one lock; the caller acts on the returned
    verdict OUTSIDE it (lock discipline: the follow-up is HTTP)."""

    def __init__(self, fraction: float, backends: Sequence[str],
                 target_epoch: int, baseline_epoch: Optional[int],
                 promote_after: int = 200, budget: float = 0.02) -> None:
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1], "
                             f"got {fraction}")
        if promote_after < 1:
            raise ValueError(f"promote_after must be >= 1, "
                             f"got {promote_after}")
        if budget < 0.0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.fraction = float(fraction)
        self.backends = tuple(backends)
        self.target_epoch = int(target_epoch)
        self.baseline_epoch = baseline_epoch
        self.promote_after = int(promote_after)
        self.budget = float(budget)
        self._lock = threading.Lock()
        self._state = SHADOW
        self.compared_rows = 0
        self.disagreed_rows = 0
        self.promotions = 0
        self.rollbacks = 0
        self._fault = os.environ.get(FLEET_FAULT_ENV, "")

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def wants(self, client_id: Optional[str]) -> bool:
        """Deterministic cohort membership: the same client hashes to
        the same side for the whole canary (no coin flips — a client
        never flaps between epochs mid-experiment). Anonymous requests
        stay on the baseline."""
        if not client_id or self.state != SHADOW:
            return False
        digest = hashlib.sha256(
            f"fleet-canary:{client_id}".encode()).digest()
        return (int.from_bytes(digest[:8], "big") % 10_000
                < self.fraction * 10_000)

    def note_result(self, ok: bool) -> Optional[str]:
        """Record one canary-cohort reply; returns "promote" or
        "rollback" exactly once, on the row that decides."""
        if self._fault == "canary_disagree":
            ok = False
        with self._lock:
            if self._state != SHADOW:
                return None
            self.compared_rows += 1
            if not ok:
                self.disagreed_rows += 1
            if self.disagreed_rows > self.budget * self.promote_after:
                self._state = ROLLED_BACK
                self.rollbacks += 1
                return "rollback"
            if self.compared_rows >= self.promote_after:
                self._state = PRIMARY
                self.promotions += 1
                return "promote"
        return None

    def fail(self) -> Optional[str]:
        """The install-verify failure path: the canary backend never
        reached the target epoch (corrupt/mislayouted publish — the
        watcher refused it), so there is nothing to measure: straight
        to rolled_back."""
        with self._lock:
            if self._state != SHADOW:
                return None
            self._state = ROLLED_BACK
            self.rollbacks += 1
            return "rollback"

    def snapshot(self) -> dict:
        with self._lock:
            compared = self.compared_rows
            return {
                "state": self._state,
                "fraction": self.fraction,
                "backends": list(self.backends),
                "target_epoch": self.target_epoch,
                "baseline_epoch": self.baseline_epoch,
                "promote_after": self.promote_after,
                "budget": self.budget,
                "compared_rows": compared,
                "disagreed_rows": self.disagreed_rows,
                "disagree_rate": round(self.disagreed_rows / compared, 4)
                                 if compared else 0.0,
                "promotions": self.promotions,
                "rollbacks": self.rollbacks,
            }


class FleetAutoscaler:
    """Two-tier control, the fleet half: decide when to START or STOP a
    whole backend process. The pool's AutoScaler (serve/control.py) keeps
    re-shaping the pool INSIDE each process; this tier only changes how
    many processes exist — the same DCN-over-ICI split the data plane
    uses. Same control shape as the per-pool scaler: scale up
    immediately on SLO breach (merged fleet p95 over ``slo_p95_ms``, or
    fewer routable backends than the floor), scale down only after
    ``down_after`` consecutive calm ticks, both behind a shared
    cooldown. ``decide`` is pure (explicit ``now``) for the unit suite;
    ``start_fn``/``stop_fn`` are injected actuators."""

    def __init__(self, min_backends: int, max_backends: int, *,
                 slo_p95_ms: float = 100.0, calm_frac: float = 0.3,
                 cooldown_s: float = 10.0, down_after: int = 3,
                 start_fn: Optional[Callable[[], bool]] = None,
                 stop_fn: Optional[Callable[[], bool]] = None) -> None:
        if min_backends < 1:
            raise ValueError(f"--fleet-min must be >= 1, "
                             f"got {min_backends}")
        if max_backends < min_backends:
            raise ValueError(f"--fleet-max {max_backends} is below "
                             f"--fleet-min {min_backends}")
        self.min_backends = min_backends
        self.max_backends = max_backends
        self.slo_p95_ms = float(slo_p95_ms)
        self.calm_frac = float(calm_frac)
        self.cooldown_s = float(cooldown_s)
        self.down_after = int(down_after)
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self.dry_run = start_fn is None
        self._last_action_t = float("-inf")
        self._calm_streak = 0
        self.ups = 0
        self.downs = 0
        self.decisions: List[dict] = []

    def decide(self, n_routable: int, merged: dict,
               now: float) -> Optional[str]:
        """One control tick over the merged fleet window; returns "up",
        "down", or None. Pure: no clock, no IO."""
        if n_routable < self.min_backends:
            # Below the floor is an availability hole, not a load
            # question: no cooldown, no hysteresis.
            self._calm_streak = 0
            self._note(now, "up", n_routable, merged, reason="below_min")
            return "up"
        if now - self._last_action_t < self.cooldown_s:
            return None
        p95 = float(merged.get("p95_ms", 0.0) or 0.0)
        busy = p95 > self.slo_p95_ms and merged.get("count", 0) > 0
        calm = merged.get("count", 0) == 0 or p95 < self.slo_p95_ms \
            * self.calm_frac
        if busy and n_routable < self.max_backends:
            self._calm_streak = 0
            self._note(now, "up", n_routable, merged, reason="p95_over_slo")
            return "up"
        if calm and n_routable > self.min_backends:
            self._calm_streak += 1
            if self._calm_streak >= self.down_after:
                self._calm_streak = 0
                self._note(now, "down", n_routable, merged, reason="calm")
                return "down"
        else:
            self._calm_streak = 0
        return None

    def _note(self, now: float, action: str, n: int, merged: dict,
              reason: str) -> None:
        self._last_action_t = now
        if action == "up":
            self.ups += 1
        else:
            self.downs += 1
        self.decisions.append({
            "t": round(now, 3), "action": action, "reason": reason,
            "routable": n, "p95_ms": merged.get("p95_ms"),
            "rps": merged.get("rps")})
        del self.decisions[:-20]

    def snapshot(self) -> dict:
        return {
            "min_backends": self.min_backends,
            "max_backends": self.max_backends,
            "slo_p95_ms": self.slo_p95_ms,
            "cooldown_s": self.cooldown_s,
            "down_after": self.down_after,
            "dry_run": self.dry_run,
            "scale_ups": self.ups,
            "scale_downs": self.downs,
            "decisions": list(self.decisions),
        }


# ---------------------------------------------------------------------------
# The routing table: the one lock, and everything it guards.
# ---------------------------------------------------------------------------


class Backend:
    """One fleet member as the router sees it: health state machine,
    in-flight counters (per priority class + total), and the last
    /healthz view (epoch, models, draining). Mutated only under the
    Fleet lock."""

    __slots__ = ("name", "url", "health", "inflight", "total_inflight",
                 "epoch", "models", "draining", "spawned", "proc",
                 "last_error", "requests", "failures")

    def __init__(self, url: str, quarantine_after: int = 3,
                 probation_successes: int = 3, spawned: bool = False,
                 proc=None) -> None:
        parsed = urllib.parse.urlsplit(
            url if "//" in url else f"http://{url}")
        if not parsed.hostname or not parsed.port:
            raise ValueError(f"backend must be host:port, got {url!r}")
        self.name = f"{parsed.hostname}:{parsed.port}"
        self.url = f"http://{self.name}"
        self.health = BackendHealth(quarantine_after, probation_successes)
        self.inflight: Dict[str, int] = {}
        self.total_inflight = 0
        self.epoch: Optional[int] = None
        self.models: Set[str] = set()
        self.draining = False
        self.spawned = spawned
        self.proc = proc
        self.last_error: Optional[str] = None
        self.requests = 0
        self.failures = 0

    @property
    def routable(self) -> bool:
        return self.health.routable and not self.draining

    def serves(self, model: Optional[str]) -> bool:
        return model is None or not self.models or model in self.models

    def row(self) -> dict:
        """The /stats per-backend row (cheap, no IO)."""
        return {
            "name": self.name,
            "state": self.health.state,
            "draining": self.draining,
            "routable": self.routable,
            "inflight": self.total_inflight,
            "epoch": self.epoch,
            "models": sorted(self.models),
            "requests": self.requests,
            "failures": self.failures,
            "quarantines": self.health.quarantines,
            "readmissions": self.health.readmissions,
            "spawned": self.spawned,
            "last_error": self.last_error,
        }


class Fleet:
    """The routing table. ONE lock guards the backend map, the hash
    ring, and every in-flight counter; the rule (enforced by the
    lock-discipline checker on this module) is snapshot-then-dispatch —
    ``acquire`` makes the whole routing decision and reserves the
    in-flight slot under the lock, and the HTTP exchange happens
    outside it."""

    def __init__(self, quarantine_after: int = 3,
                 probation_successes: int = 3, hash_replicas: int = 64,
                 on_event: Optional[Callable[..., None]] = None,
                 cache: Optional[ResponseCache] = None) -> None:
        self._lock = threading.Lock()
        self._backends: Dict[str, Backend] = {}
        self._ring = HashRing(replicas=hash_replicas)
        self.quarantine_after = quarantine_after
        self.probation_successes = probation_successes
        self._on_event = on_event
        # The router's response cache: invalidated (generation bump)
        # whenever the health poller observes ANY backend's serving
        # epoch change — a rollout/reload on one backend means a cached
        # reply anywhere in the fleet may now be stale.
        self._cache = cache
        self.failovers = 0
        self.retries = 0
        self.fleet_503s = 0

    def _emit(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            self._on_event(kind, **fields)

    def add(self, url: str, spawned: bool = False, proc=None) -> Backend:
        backend = Backend(url, self.quarantine_after,
                          self.probation_successes, spawned=spawned,
                          proc=proc)
        with self._lock:
            if backend.name in self._backends:
                return self._backends[backend.name]
            self._backends[backend.name] = backend
            self._ring.add(backend.name)
        self._emit("fleet_backend_added", backend=backend.name,
                   spawned=spawned)
        return backend

    def remove(self, name: str) -> Optional[Backend]:
        with self._lock:
            backend = self._backends.pop(name, None)
            self._ring.remove(name)
        if backend is not None:
            self._emit("fleet_backend_removed", backend=name)
        return backend

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._backends)

    def get(self, name: str) -> Optional[Backend]:
        with self._lock:
            return self._backends.get(name)

    def backends(self) -> List[Backend]:
        with self._lock:
            return [self._backends[n] for n in sorted(self._backends)]

    def n_routable(self) -> int:
        with self._lock:
            return sum(1 for b in self._backends.values() if b.routable)

    def acquire(self, model: Optional[str] = None,
                klass: Optional[str] = None,
                client_id: Optional[str] = None,
                exclude: Sequence[str] = (),
                within: Optional[Set[str]] = None) -> Optional[Backend]:
        """The routing decision + in-flight reservation, atomically
        under the table lock (so two concurrent acquires see each
        other's load). ``exclude`` removes the backend a retry already
        failed on; ``within`` restricts to a canary cohort. Returns
        None only when no routable backend fits — the caller's loud
        fleet 503."""
        with self._lock:
            candidates = [
                b for b in self._backends.values()
                if b.routable and b.serves(model) and b.name not in exclude
                and (within is None or b.name in within)]
            chosen = pick_backend(candidates, klass=klass,
                                  client_id=client_id, ring=self._ring)
            if chosen is None:
                return None
            k = klass or PRIORITY_CLASSES[0]
            chosen.inflight[k] = chosen.inflight.get(k, 0) + 1
            chosen.total_inflight += 1
            chosen.requests += 1
            return chosen

    def release(self, backend: Backend, klass: Optional[str] = None) -> None:
        k = klass or PRIORITY_CLASSES[0]
        with self._lock:
            backend.inflight[k] = max(0, backend.inflight.get(k, 0) - 1)
            backend.total_inflight = max(0, backend.total_inflight - 1)

    def note_success(self, name: str, info: Optional[dict] = None) -> None:
        """A successful probe or dispatch: health transition + cached
        /healthz view, all under the lock; the transition event is
        emitted after it drops."""
        transition = None
        epoch_changed = False
        with self._lock:
            backend = self._backends.get(name)
            if backend is None:
                return
            transition = backend.health.note_success()
            if transition == PROBATION:
                self._ring.add(name)
            if info is not None:
                epoch = info.get("model_epoch")
                new_epoch = int(epoch) if epoch is not None else None
                epoch_changed = new_epoch != backend.epoch
                backend.epoch = new_epoch
                backend.draining = bool(info.get("draining", False))
                models = info.get("models")
                if isinstance(models, dict):
                    backend.models = set(models)
                elif info.get("model"):
                    backend.models = {info["model"]}
                backend.last_error = None
        if epoch_changed and self._cache is not None:
            # Invalidation rides the poller's observation (same idiom
            # as _emit: the cache's own lock, taken OUTSIDE the table
            # lock): any backend epoch change makes every router entry
            # unreachable in O(1).
            self._cache.bump_generation()
        if transition == PROBATION:
            self._emit("fleet_probation", backend=name)
        elif transition == HEALTHY:
            self._emit("fleet_readmitted", backend=name)

    def note_failure(self, name: str, reason: str) -> None:
        transition = None
        with self._lock:
            backend = self._backends.get(name)
            if backend is None:
                return
            backend.failures += 1
            backend.last_error = reason
            transition = backend.health.note_failure()
            if transition == QUARANTINED:
                # Quarantined backends leave the affinity ring so their
                # clients re-home NOW (and, by consistency, only them).
                self._ring.remove(name)
        if transition == QUARANTINED:
            self._emit("fleet_quarantine", backend=name, reason=reason)

    def admit_probation(self, name: str) -> None:
        """Admit a just-spawned backend on PROBATION: a fresh process
        earns HEALTHY through the same streak a healed one does."""
        with self._lock:
            backend = self._backends.get(name)
            if backend is None:
                return
            backend.health.state = PROBATION
            backend.health.probation_streak = 0
            self._ring.add(name)

    def set_draining(self, name: str, draining: bool) -> None:
        with self._lock:
            backend = self._backends.get(name)
            if backend is None:
                return
            backend.draining = draining
            if draining:
                self._ring.remove(name)
            elif backend.health.routable:
                self._ring.add(name)

    def snapshot_rows(self) -> List[dict]:
        with self._lock:
            return [self._backends[n].row()
                    for n in sorted(self._backends)]

    def spawned_backends(self) -> List[Backend]:
        with self._lock:
            return [b for n, b in sorted(self._backends.items())
                    if b.spawned]


# ---------------------------------------------------------------------------
# HTTP plumbing (all of it OUTSIDE any lock).
# ---------------------------------------------------------------------------


def http_exchange(url: str, *, method: str = "GET",
                  body: Optional[bytes] = None,
                  connect_timeout: float = 1.0,
                  read_timeout: float = 30.0) -> Tuple[int, dict, bytes]:
    """One backend HTTP exchange with SPLIT connect/read timeouts
    (urllib's single knob can't tell "backend is gone" from "backend is
    slow"). Returns (status, headers, body). Raises TransportError with
    ``body_started`` set precisely: failures up to and including the
    status line are pre-response (the retry-safe window); failures
    while reading the body are not."""
    parsed = urllib.parse.urlsplit(url)
    path = parsed.path or "/"
    if parsed.query:
        path += "?" + parsed.query
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=connect_timeout)
    try:
        try:
            conn.connect()
            if conn.sock is not None:
                conn.sock.settimeout(read_timeout)
            headers = {"Content-Type": "application/json"} if body else {}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
        except Exception as exc:  # noqa: BLE001 - classified by caller
            raise TransportError(exc, body_started=False) from exc
        try:
            data = resp.read()
        except Exception as exc:  # noqa: BLE001 - classified by caller
            raise TransportError(exc, body_started=True) from exc
        # http.client only raises IncompleteRead for CHUNK-framed short
        # bodies; a Content-Length body torn mid-stream comes back as
        # plain short bytes. Verify the count or truncated JSON reaches
        # json.loads as a decode error the retry logic misclassifies
        # (the distrib/fetch.py torn-chunk incident, one layer over).
        expected = resp.getheader("Content-Length")
        if expected and expected.isdigit() and len(data) != int(expected):
            raise TransportError(
                OSError(f"short body from {url}: got {len(data)} of "
                        f"{expected} bytes"),
                body_started=True)
        return resp.status, dict(resp.headers.items()), data
    finally:
        conn.close()


def get_json(url: str, *, connect_timeout: float = 1.0,
             read_timeout: float = 10.0) -> dict:
    status, _, body = http_exchange(url, connect_timeout=connect_timeout,
                                    read_timeout=read_timeout)
    if status != 200:
        raise TransportError(
            RuntimeError(f"GET {url} -> {status}"), body_started=True)
    return json.loads(body)


def post_json(url: str, payload: dict, *, connect_timeout: float = 1.0,
              read_timeout: float = 30.0) -> dict:
    status, _, body = http_exchange(
        url, method="POST", body=json.dumps(payload).encode(),
        connect_timeout=connect_timeout, read_timeout=read_timeout)
    if status != 200:
        raise TransportError(
            RuntimeError(f"POST {url} -> {status}: {body[:200]!r}"),
            body_started=True)
    return json.loads(body)


class RouterLog:
    """The router's own stdlib observability (it cannot import
    ServeLog: it owns no serve plane). Counters plus a bounded latency
    reservoir; quantiles computed on snapshot."""

    def __init__(self, window: int = 4096) -> None:
        self._lock = threading.Lock()
        self._window = window
        self._latencies: List[float] = []
        self._t0 = time.time()
        self.requests = 0
        self.by_code: Dict[str, int] = {}
        self.by_class: Dict[str, int] = {}

    def record(self, latency_s: float, code: int,
               klass: Optional[str] = None) -> None:
        with self._lock:
            self.requests += 1
            self.by_code[str(code)] = self.by_code.get(str(code), 0) + 1
            if klass:
                self.by_class[klass] = self.by_class.get(klass, 0) + 1
            self._latencies.append(latency_s)
            del self._latencies[:-self._window]

    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = q * (len(sorted_vals) - 1)
        lo = int(idx)
        hi = min(lo + 1, len(sorted_vals) - 1)
        frac = idx - lo
        return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac

    def snapshot(self) -> dict:
        with self._lock:
            vals = sorted(self._latencies)
            ms = lambda s: round(s * 1e3, 3)  # noqa: E731
            return {
                "requests": self.requests,
                "by_code": dict(self.by_code),
                "by_class": dict(self.by_class),
                "uptime_s": round(time.time() - self._t0, 3),
                "latency_ms": {
                    "p50": ms(self._percentile(vals, 0.50)),
                    "p95": ms(self._percentile(vals, 0.95)),
                    "p99": ms(self._percentile(vals, 0.99)),
                    "count": len(vals),
                },
            }


class HealthPoller:
    """The background /healthz sweep that drives the quarantine/
    probation machine. Lock discipline, same as dispatch: snapshot the
    backend list under the table lock (Fleet.backends), probe each one
    OUTSIDE any lock, then write results back through Fleet.note_*.
    The poller's own ``_lock`` guards only its sweep bookkeeping
    (last-sweep clock + per-backend probe ages for /stats).

    ``backends_dir`` adds dynamic discovery: backends started with
    ``--register-dir DIR`` drop a ``backend_*.json`` record there
    (tmp+rename; removed on drain and on shutdown), and every sweep
    reconciles first — a new record joins the fleet on PROBATION (a
    discovered process earns HEALTHY exactly like a spawned or healed
    one), a vanished record removes the backend IF this poller
    discovered it (static ``--backends`` members and scaler-spawned
    processes are never reaped by discovery)."""

    def __init__(self, fleet: Fleet, interval_s: float = 0.5,
                 connect_timeout: float = 0.5,
                 read_timeout: float = 2.0,
                 backends_dir: Optional[str] = None) -> None:
        self.fleet = fleet
        self.interval_s = float(interval_s)
        self.connect_timeout = float(connect_timeout)
        self.read_timeout = float(read_timeout)
        self.backends_dir = backends_dir
        # Backend names THIS poller added from records — the only ones
        # a vanished record may remove.
        self._discovered: Set[str] = set()
        self._lock = threading.Lock()
        self._last_sweep_t: Optional[float] = None
        self._probes: Dict[str, float] = {}
        self.sweeps = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sync_backends_dir(self) -> None:
        """Reconcile the fleet against the registration records. All
        file IO outside any lock; Fleet.add/remove take the table lock
        briefly per mutation, the sweep-then-dispatch rule intact."""
        if not self.backends_dir:
            return
        urls: List[str] = []
        try:
            entries = sorted(os.listdir(self.backends_dir))
        except OSError:
            entries = []
        for entry in entries:
            if not (entry.startswith("backend_")
                    and entry.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.backends_dir, entry)) as f:
                    url = json.load(f).get("url")
            except Exception:  # noqa: BLE001 - torn record: next sweep
                continue
            if url:
                urls.append(url)
        present: Set[str] = set()
        for url in urls:
            try:
                parsed = urllib.parse.urlsplit(
                    url if "//" in url else f"http://{url}")
                name = f"{parsed.hostname}:{parsed.port}"
            except ValueError:
                continue
            present.add(name)
            if name in self._discovered or self.fleet.get(name) is not None:
                continue
            self.fleet.add(url)
            self._discovered.add(name)
            self.fleet.admit_probation(name)
        for name in sorted(self._discovered - present):
            self._discovered.discard(name)
            self.fleet.remove(name)

    def sweep_once(self) -> None:
        """One full probe pass — public and thread-free so tests drive
        re-admission deterministically. Discovery reconciles FIRST, so
        a just-registered backend is probed in the same sweep that
        admits it."""
        self.sync_backends_dir()
        for backend in self.fleet.backends():
            name, url = backend.name, backend.url
            try:
                info = get_json(f"{url}/healthz",
                                connect_timeout=self.connect_timeout,
                                read_timeout=self.read_timeout)
            except Exception as exc:  # noqa: BLE001 - a probe never kills the poller
                self.fleet.note_failure(name, classify_failure(exc))
            else:
                self.fleet.note_success(name, info=info)
            with self._lock:
                self._probes[name] = time.time()
        with self._lock:
            self._last_sweep_t = time.time()
            self.sweeps += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "sweeps": self.sweeps,
                "last_sweep_t": self._last_sweep_t,
            }

    def start(self) -> "HealthPoller":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="router-health")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sweep_once()
            except Exception as exc:  # noqa: BLE001 - poller never dies
                print(f"router health: sweep failed: {exc!r}", flush=True)


def epoch_of_checkpoint(path: str) -> int:
    """Epoch from a publish filename (``checkpoint_{e}.npz``/``.ckpt``/
    ``.manifest`` — train/checkpoint.py's naming contract; a delta
    manifest rides the same pattern, so rollouts ship manifests with no
    router-side special case)."""
    match = _EPOCH_RE.search(os.path.basename(path))
    if not match:
        raise ValueError(
            f"cannot parse an epoch from {path!r}; publishes are named "
            f"checkpoint_EPOCH.npz/.ckpt/.manifest (train/checkpoint.py)")
    return int(match.group(1))


def atomic_copy(source: str, dest_dir: str) -> str:
    """Publish one checkpoint file into a backend's directory the way
    the trainer does: full write to a dot-tmp name, then one
    os.replace — the backend's watcher can never see a torn file."""
    base = os.path.basename(source)
    tmp = os.path.join(dest_dir, f".tmp-router-{base}")
    dest = os.path.join(dest_dir, base)
    shutil.copyfile(source, tmp)
    os.replace(tmp, dest)
    return dest


def _rewrite_meta_npy(npy: bytes, stored_epoch: int) -> bytes:
    """Rebuild a checkpoint's ``__meta__`` npy member (a 1-D uint8 array
    of JSON bytes — train/checkpoint.py's container) with ``epoch``
    replaced by ``stored_epoch``. Stdlib-only npy surgery: parse the
    header to find the payload, edit the JSON, emit a fresh v1.0 header."""
    if npy[:6] != b"\x93NUMPY":
        raise ValueError("checkpoint __meta__ member is not an npy array")
    if npy[6] == 1:
        (hlen,) = struct.unpack_from("<H", npy, 8)
        payload = npy[10 + hlen:]
    else:
        (hlen,) = struct.unpack_from("<I", npy, 8)
        payload = npy[12 + hlen:]
    meta = json.loads(payload.decode())
    meta["epoch"] = stored_epoch
    data = json.dumps(meta).encode()
    header = ("{'descr': '|u1', 'fortran_order': False, "
              f"'shape': ({len(data)},), }}")
    pad = (64 - (10 + len(header) + 1) % 64) % 64
    header_bytes = (header + " " * pad + "\n").encode("latin1")
    return (b"\x93NUMPY\x01\x00" + struct.pack("<H", len(header_bytes))
            + header_bytes + data)


def republish_with_epoch(source: str, dest: str, epoch: int) -> None:
    """Copy checkpoint ``source`` to ``dest`` with its EMBEDDED epoch
    rebased to ``epoch`` (stored as ``epoch + 1``, save_checkpoint's
    resume-at-next convention). The engines' swap-ordering rule trusts
    the meta epoch, not the filename — so rolling BASELINE weights
    forward under a new epoch number requires rewriting the meta, or the
    backend refuses the "older" params and keeps serving the bad ones.
    An npz is a zip of npy members; only ``__meta__.npy`` changes, every
    array member is copied byte-for-byte. Sharded ``.ckpt`` directories
    get the same edit on ``meta.json``; a delta ``.manifest`` is plain
    JSON — same edit, chunk references untouched (the fetchers pull the
    SAME bytes, only the swap-ordering epoch moves). Write-then-replace,
    atomic either way."""
    tmp = dest + ".tmp"
    if source.endswith(".manifest"):
        with open(source) as f:
            meta = json.load(f)
        meta["epoch"] = epoch + 1
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, dest)
        return
    if os.path.isdir(source):
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        shutil.copytree(source, tmp)
        meta_path = os.path.join(tmp, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["epoch"] = epoch + 1
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        if os.path.exists(dest):
            shutil.rmtree(dest)
        os.replace(tmp, dest)
        return
    with zipfile.ZipFile(source) as zin, \
            zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "__meta__.npy":
                data = _rewrite_meta_npy(data, epoch + 1)
            zout.writestr(item.filename, data)
    os.replace(tmp, dest)


class HttpRolloutOps:
    """RollingReload's real actuator: router-side drain marking first
    (dispatch stops choosing the backend), then the backend's own
    admission gate, /stats for quiescence, an atomic file copy for
    publish, /healthz for epoch verification."""

    def __init__(self, ctx: "RouterContext", dirs: Dict[str, str],
                 source: str) -> None:
        self.ctx = ctx
        self.dirs = dirs
        self.source = source
        self.published: Dict[str, str] = {}

    def _url(self, name: str) -> str:
        backend = self.ctx.fleet.get(name)
        if backend is None:
            raise RuntimeError(f"backend {name} left the fleet mid-rollout")
        return backend.url

    def drain(self, name: str) -> None:
        # Router first (no NEW dispatches), backend second (stragglers
        # already on the wire get the drain-503 the dispatch loop
        # treats as retry-safe refusal).
        self.ctx.fleet.set_draining(name, True)
        post_json(f"{self._url(name)}/drain", {"drain": True},
                  connect_timeout=self.ctx.connect_timeout,
                  read_timeout=self.ctx.read_timeout)
        self.ctx.event("fleet_rollout_drain", backend=name)

    def active_requests(self, name: str) -> int:
        stats = get_json(f"{self._url(name)}/stats",
                         connect_timeout=self.ctx.connect_timeout,
                         read_timeout=self.ctx.read_timeout)
        return int(stats.get("active_requests", 0)) \
            + int(stats.get("queue_depth", 0))

    def publish(self, name: str) -> None:
        dest_dir = self.dirs[name]
        self.published[name] = atomic_copy(self.source, dest_dir)
        self.ctx.event("fleet_rollout_publish", backend=name,
                       path=self.published[name])

    def epoch(self, name: str) -> Optional[int]:
        info = get_json(f"{self._url(name)}/healthz",
                        connect_timeout=self.ctx.connect_timeout,
                        read_timeout=self.ctx.read_timeout)
        epoch = info.get("model_epoch")
        return None if epoch is None else int(epoch)

    def undrain(self, name: str) -> None:
        try:
            post_json(f"{self._url(name)}/drain", {"drain": False},
                      connect_timeout=self.ctx.connect_timeout,
                      read_timeout=self.ctx.read_timeout)
        finally:
            self.ctx.fleet.set_draining(name, False)
        self.ctx.event("fleet_rollout_rejoin", backend=name)

    def unpublish(self, name: str) -> None:
        """Rollback for a publish that never installed: remove the bad
        file so the watcher's latest resolves back to the baseline."""
        path = self.published.pop(name, None)
        if path is not None and os.path.exists(path):
            os.remove(path)


class RouterContext:
    """Everything one router process owns; built by
    :func:`create_router` and shared with the handlers via the server
    object (the serve/server.py pattern, so tests boot in-process on
    port 0)."""

    def __init__(self, fleet: Fleet, poller: HealthPoller, *,
                 sink=None, connect_timeout: float = 1.0,
                 read_timeout: float = 30.0,
                 drain_timeout_s: float = 30.0,
                 verify_timeout_s: float = 60.0,
                 fleet_autoscaler: Optional[FleetAutoscaler] = None,
                 spawn_template: Optional[str] = None,
                 cache: Optional[ResponseCache] = None) -> None:
        self.fleet = fleet
        self.poller = poller
        self.sink = sink
        self.cache = cache
        self.log = RouterLog()
        self.connect_timeout = float(connect_timeout)
        self.read_timeout = float(read_timeout)
        self.drain_timeout_s = float(drain_timeout_s)
        self.verify_timeout_s = float(verify_timeout_s)
        self.fleet_autoscaler = fleet_autoscaler
        self.spawn_template = spawn_template
        self.t_start = time.time()
        self.canary: Optional[FleetCanary] = None
        self.canary_ops: Optional[HttpRolloutOps] = None
        self.canary_pending: List[str] = []
        self._rollout_lock = threading.Lock()
        self.last_rollout: Optional[dict] = None
        self._scaler_stop = threading.Event()
        self._scaler_thread: Optional[threading.Thread] = None

    # -- events -----------------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        """Router lifecycle line into the JSONL sink (quarantines,
        failovers, rollout steps, canary verdicts, fleet scaling). Only
        touched when a sink exists, so the stdlib-only router never
        imports the profiling module without --metrics-file."""
        if self.sink is None:
            return
        from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
            record_fleet_event,
        )

        record_fleet_event(self.sink, kind, **fields)

    # -- rollouts ---------------------------------------------------------

    def resolve_dirs(self, names: Sequence[str],
                     overrides: Optional[dict]) -> Dict[str, str]:
        """Each backend's publish directory: an explicit ``dirs`` map in
        the /rollout body wins; otherwise the dirname of the checkpoint
        the backend reported on /healthz. Unresolvable is a loud error
        — publishing into a guessed directory is how fleets eat bad
        deploys."""
        overrides = overrides or {}
        dirs: Dict[str, str] = {}
        missing = []
        for name in names:
            if name in overrides:
                dirs[name] = overrides[name]
                continue
            backend = self.fleet.get(name)
            info = None
            if backend is not None:
                try:
                    info = get_json(f"{backend.url}/healthz",
                                    connect_timeout=self.connect_timeout,
                                    read_timeout=self.read_timeout)
                except Exception:  # noqa: BLE001 - reported below
                    info = None
            checkpoint = (info or {}).get("checkpoint")
            if checkpoint:
                dirs[name] = os.path.dirname(checkpoint)
            else:
                missing.append(name)
        if missing:
            raise ValueError(
                f"cannot resolve a checkpoint directory for {missing} "
                f"(fresh-init backends report none on /healthz); pass "
                f"'dirs': {{\"host:port\": \"/path\"}} in the /rollout "
                f"body")
        return dirs

    def rollout(self, source: str, dir_overrides: Optional[dict] = None,
                backends: Optional[Sequence[str]] = None,
                drain_timeout_s: Optional[float] = None,
                verify_timeout_s: Optional[float] = None) -> dict:
        """The full rolling reload, one backend at a time."""
        if not self._rollout_lock.acquire(blocking=False):
            raise RuntimeError("a rollout is already in progress")
        try:
            target = epoch_of_checkpoint(source)
            if not os.path.exists(source):
                raise ValueError(f"no such checkpoint: {source!r}")
            names = list(backends) if backends else \
                [b.name for b in self.fleet.backends() if b.routable]
            if not names:
                raise ValueError("no routable backends to roll out to")
            ops = HttpRolloutOps(self, self.resolve_dirs(
                names, dir_overrides), source)
            self.event("fleet_rollout_start", target_epoch=target,
                       backends=names)
            result = RollingReload(
                ops,
                drain_timeout_s=drain_timeout_s or self.drain_timeout_s,
                verify_timeout_s=verify_timeout_s or self.verify_timeout_s,
            ).run(names, target)
            self.event("fleet_rollout_done", **{
                k: v for k, v in result.items() if k != "error"})
            self.last_rollout = result
            return result
        finally:
            self._rollout_lock.release()

    def canary_rollout(self, source: str, canary_spec: dict,
                       dir_overrides: Optional[dict] = None,
                       drain_timeout_s: Optional[float] = None,
                       verify_timeout_s: Optional[float] = None) -> dict:
        """Publish to the canary cohort's backends only, then hand
        routing the deterministic client split. The verdict (note_result
        / fail) later promotes to the rest of the fleet or rolls the
        canary backends back."""
        if not self._rollout_lock.acquire(blocking=False):
            raise RuntimeError("a rollout is already in progress")
        try:
            if self.canary is not None and self.canary.state == SHADOW:
                raise RuntimeError("a fleet canary is already active")
            target = epoch_of_checkpoint(source)
            if not os.path.exists(source):
                raise ValueError(f"no such checkpoint: {source!r}")
            fraction = float(canary_spec.get("fraction", 0.25))
            promote_after = int(canary_spec.get("promote_after", 200))
            budget = float(canary_spec.get("budget", 0.02))
            all_names = [b.name for b in self.fleet.backends()
                         if b.routable]
            if len(all_names) < 2:
                raise ValueError(
                    "a fleet canary needs >= 2 routable backends (one "
                    "cohort on each epoch)")
            canary_names = list(canary_spec.get("backends") or
                                all_names[:1])
            rest = [n for n in all_names if n not in canary_names]
            if not rest:
                raise ValueError("the canary cohort covers every "
                                 "backend; nothing left on the baseline")
            dirs = self.resolve_dirs(all_names, dir_overrides)
            ops = HttpRolloutOps(self, dirs, source)
            # The baseline epoch anchors the rollback (which weights to
            # republish), so read it LIVE from the backend — the
            # poller's cached view can lag a just-finished rollout by
            # one sweep, and a stale/None baseline would turn a budget
            # rollback into a bare unpublish.
            try:
                baseline_epoch = ops.epoch(canary_names[0])
            except Exception:  # noqa: BLE001 - cache fallback
                backend = self.fleet.get(canary_names[0])
                baseline_epoch = backend.epoch if backend else None
            canary = FleetCanary(fraction, canary_names, target,
                                 baseline_epoch,
                                 promote_after=promote_after,
                                 budget=budget)
            self.event("fleet_canary_start", target_epoch=target,
                       backends=canary_names, fraction=fraction)
            result = RollingReload(
                ops,
                drain_timeout_s=drain_timeout_s or self.drain_timeout_s,
                verify_timeout_s=verify_timeout_s or self.verify_timeout_s,
            ).run(canary_names, target)
            if not result["ok"]:
                # The publish never installed (corrupt file, wrong
                # layout — the watcher refused it): auto-rollback is
                # just removing the bad file; the baseline epoch was
                # serving the whole time.
                canary.fail()
                for name in canary_names:
                    ops.unpublish(name)
                self.canary = canary
                self.event("fleet_canary_rollback",
                           target_epoch=target, install_failed=True,
                           **{k: v for k, v in result.items()
                              if k in ("failed", "error")})
                return {"ok": False, "canary": canary.snapshot(),
                        "rollout": result}
            self.canary = canary
            self.canary_ops = ops
            self.canary_pending = rest
            return {"ok": True, "canary": canary.snapshot(),
                    "rollout": result}
        finally:
            self._rollout_lock.release()

    def canary_verdict(self, verdict: str) -> None:
        """Act on a flipped canary verdict on a worker thread (the
        deciding row's handler must not pay the follow-up rollout)."""
        threading.Thread(target=self._apply_verdict, args=(verdict,),
                         daemon=True, name="router-canary").start()

    def _apply_verdict(self, verdict: str) -> None:
        canary, ops = self.canary, self.canary_ops
        if canary is None or ops is None:
            return
        try:
            if verdict == "promote":
                self.event("fleet_canary_promote",
                           target_epoch=canary.target_epoch)
                pending = list(self.canary_pending)
                result = RollingReload(
                    ops, drain_timeout_s=self.drain_timeout_s,
                    verify_timeout_s=self.verify_timeout_s,
                ).run(pending, canary.target_epoch)
                self.last_rollout = result
            else:
                # Budget rollback after a successful install: epochs
                # only move forward (the engines' swap-ordering rule
                # refuses older params), so restoring the baseline is a
                # roll-forward republish of the BASELINE WEIGHTS as
                # target_epoch + 1, plus removing the bad file. Epochs
                # are publish sequence numbers, not identities — the
                # canary block records which weights each one carries.
                self.event("fleet_canary_rollback",
                           target_epoch=canary.target_epoch,
                           install_failed=False)
                for name in canary.backends:
                    backend = self.fleet.get(name)
                    if backend is None:
                        continue
                    try:
                        self._restore_baseline(name, ops, canary)
                    except Exception as exc:  # noqa: BLE001 - keep restoring the rest
                        self.event("fleet_canary_restore_failed",
                                   backend=name, error=repr(exc))
        finally:
            self.canary_ops = None
            self.canary_pending = []

    def _restore_baseline(self, name: str, ops: HttpRolloutOps,
                          canary: FleetCanary) -> None:
        dest_dir = ops.dirs[name]
        if canary.baseline_epoch is None:
            ops.unpublish(name)
            return
        baseline = None
        for fname in os.listdir(dest_dir):
            match = _EPOCH_RE.search(fname)
            if match and int(match.group(1)) == canary.baseline_epoch:
                baseline = os.path.join(dest_dir, fname)
                break
        ops.unpublish(name)
        if baseline is None:
            return
        ext = os.path.splitext(baseline)[1]
        restored = os.path.join(
            dest_dir, f"checkpoint_{canary.target_epoch + 1}{ext}")
        republish_with_epoch(baseline, restored, canary.target_epoch + 1)
        self.event("fleet_canary_restored", backend=name,
                   weights_epoch=canary.baseline_epoch,
                   published_as=canary.target_epoch + 1)

    # -- fleet autoscaling ------------------------------------------------

    def spawn_backend(self) -> bool:
        """Start one backend process from --spawn-backend's argv
        template (port forced to 0), parse its "serving on" line, and
        admit it on PROBATION — a fresh process earns HEALTHY the same
        way a healed one does."""
        if not self.spawn_template:
            return False
        argv = [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
                *shlex.split(self.spawn_template), "--port", "0"]
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        url = None
        try:
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                line = proc.stdout.readline() if proc.stdout else ""
                if not line:
                    if proc.poll() is not None:
                        break
                    continue
                match = re.search(r"serving on (http://\S+)", line)
                if match:
                    url = match.group(1)
                    break
        finally:
            # No URL — deadline, early exit, or an exception while
            # parsing — means nobody will ever own this process: kill
            # AND wait here, or the half-booted backend leaks (kill
            # without wait still leaves a zombie holding its card).
            if url is None:
                proc.kill()
                proc.wait()
        if url is None:
            self.event("fleet_scale_up_failed")
            return False
        # The spawned process keeps writing to stdout; drain it on a
        # reaper thread so the pipe never fills and blocks serving.
        threading.Thread(target=lambda: [None for _ in proc.stdout],
                         daemon=True, name="router-spawn-drain").start()
        backend = self.fleet.add(url, spawned=True, proc=proc)
        self.fleet.admit_probation(backend.name)
        self.event("fleet_scale_up", backend=backend.name)
        return True

    def stop_backend(self) -> bool:
        """Scale down: drain the least-loaded SPAWNED backend (static
        --backends members are the operator's; the scaler only reaps
        what it sowed), wait for quiescence, terminate, remove."""
        spawned = [b for b in self.fleet.spawned_backends() if b.routable]
        if not spawned:
            return False
        victim = min(spawned, key=lambda b: (b.total_inflight, b.name))
        self.fleet.set_draining(victim.name, True)
        try:
            post_json(f"{victim.url}/drain", {"drain": True},
                      connect_timeout=self.connect_timeout,
                      read_timeout=self.read_timeout)
            deadline = time.monotonic() + self.drain_timeout_s
            while time.monotonic() < deadline:
                stats = get_json(f"{victim.url}/stats",
                                 connect_timeout=self.connect_timeout,
                                 read_timeout=self.read_timeout)
                if not stats.get("active_requests", 0) and \
                        not stats.get("queue_depth", 0):
                    break
                time.sleep(0.05)
        except Exception:  # noqa: BLE001 - a dead victim still gets reaped
            pass
        if victim.proc is not None:
            victim.proc.terminate()
            try:
                victim.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                victim.proc.kill()
        self.fleet.remove(victim.name)
        self.event("fleet_scale_down", backend=victim.name)
        return True

    def scaler_tick(self) -> Optional[str]:
        """One fleet-autoscaler control step: merged window from the
        routable backends' /stats, a pure decide(), then the actuator."""
        scaler = self.fleet_autoscaler
        if scaler is None:
            return None
        windows = []
        for backend in self.fleet.backends():
            if not backend.routable:
                continue
            try:
                stats = get_json(f"{backend.url}/stats",
                                 connect_timeout=self.connect_timeout,
                                 read_timeout=self.read_timeout)
                windows.append(stats.get("window"))
            except Exception:  # noqa: BLE001 - the poller owns health accounting
                continue
        action = scaler.decide(self.fleet.n_routable(),
                               merge_windows(windows), time.monotonic())
        if action == "up" and not scaler.dry_run:
            scaler.start_fn()
        elif action == "down" and not scaler.dry_run:
            scaler.stop_fn()
        return action

    def start_scaler(self, interval_s: float) -> None:
        if self.fleet_autoscaler is None or self._scaler_thread:
            return

        def _loop():
            while not self._scaler_stop.wait(interval_s):
                try:
                    self.scaler_tick()
                except Exception as exc:  # noqa: BLE001 - scaler never dies
                    print(f"fleet autoscaler: tick failed: {exc!r}",
                          flush=True)

        self._scaler_thread = threading.Thread(
            target=_loop, daemon=True, name="router-fleet-scaler")
        self._scaler_thread.start()

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        self._scaler_stop.set()
        if self._scaler_thread is not None:
            self._scaler_thread.join()
            self._scaler_thread = None
        self.poller.stop()
        for backend in self.fleet.spawned_backends():
            if backend.proc is not None:
                backend.proc.terminate()


class _RouterHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
        pass

    @property
    def ctx(self) -> RouterContext:
        return self.server.ctx  # type: ignore[attr-defined]

    def _reply(self, code: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, str(value))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass  # client gave up; same contract as the backend server

    def _reply_raw(self, code: int, body: bytes,
                   headers: Optional[dict] = None) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, str(value))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass

    # -- GET --------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 - stdlib name
        ctx = self.ctx
        if self.path == "/healthz":
            rows = ctx.fleet.snapshot_rows()
            routable = sum(1 for r in rows if r["routable"])
            self._reply(200 if routable else 503, {
                "ok": routable > 0,
                "role": "router",
                "backends": {r["name"]: r["state"] for r in rows},
                "routable": routable,
                "total": len(rows),
                "uptime_s": round(time.time() - ctx.t_start, 3),
            })
        elif self.path == "/stats":
            self._reply(200, self._stats())
        else:
            self._reply(404, {"error": f"no route {self.path!r}"})

    def _stats(self) -> dict:
        """The aggregated fleet view: per-backend rows (the router's
        cached health/load state joined with a live /stats fetch from
        each routable backend) plus fleet quantiles merged from the
        rolling-window blocks."""
        ctx = self.ctx
        rows = ctx.fleet.snapshot_rows()
        windows = []
        for row in rows:
            if not row["routable"]:
                continue
            backend = ctx.fleet.get(row["name"])
            if backend is None:
                continue
            try:
                stats = get_json(f"{backend.url}/stats",
                                 connect_timeout=ctx.connect_timeout,
                                 read_timeout=ctx.read_timeout)
            except Exception as exc:  # noqa: BLE001 - a row, not a failure
                row["stats_error"] = classify_failure(exc)
                continue
            row["window"] = stats.get("window")
            row["active_requests"] = stats.get("active_requests")
            row["queue_depth"] = stats.get("queue_depth")
            row["counts"] = stats.get("counts")
            windows.append(stats.get("window"))
        out = {
            "role": "router",
            "router": ctx.log.snapshot(),
            "backends": rows,
            "fleet": {
                "routable": sum(1 for r in rows if r["routable"]),
                "total": len(rows),
                "failovers": ctx.fleet.failovers,
                "retries": ctx.fleet.retries,
                "fleet_503s": ctx.fleet.fleet_503s,
                "window": merge_windows(windows),
            },
            "health_poller": ctx.poller.snapshot(),
        }
        if ctx.cache is not None and ctx.cache.enabled:
            out["cache"] = ctx.cache.snapshot()
        if ctx.canary is not None:
            out["fleet_canary"] = ctx.canary.snapshot()
        if ctx.last_rollout is not None:
            out["last_rollout"] = ctx.last_rollout
        if ctx.fleet_autoscaler is not None:
            out["fleet_autoscaler"] = ctx.fleet_autoscaler.snapshot()
        return out

    # -- POST -------------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802 - stdlib name
        if self.path == "/rollout":
            self._do_rollout()
            return
        if self.path != "/predict":
            self._reply(404, {"error": f"no route {self.path!r}"})
            return
        self._do_predict()

    def _do_predict(self) -> None:
        ctx = self.ctx
        t0 = time.perf_counter()
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            self._reply(413, {"error": f"body over {MAX_BODY_BYTES} "
                                       f"bytes; batch client-side"})
            return
        raw = self.rfile.read(length) if length else b"{}"
        # Routing fields only — the body is NOT validated here (the
        # backend is the authority on images/priority vocabulary; a
        # router that second-guesses it would have to track every
        # backend schema change). A malformed body still routes and
        # comes back 400 from the backend.
        model = klass = client_id = None
        try:
            peek = json.loads(raw)
            if isinstance(peek, dict):
                model = peek.get("model")
                klass = peek.get("priority") or None
                cid = peek.get("client_id")
                client_id = cid if isinstance(cid, str) else None
        except (ValueError, TypeError):
            pass
        canary = ctx.canary
        within = None
        is_canary_row = False
        if canary is not None and canary.state == SHADOW:
            cohort = set(canary.backends)
            if canary.wants(client_id):
                within, is_canary_row = cohort, True
            else:
                # The baseline cohort must NOT land on a canary backend
                # (its reply would carry the unjudged epoch).
                within = {b.name for b in ctx.fleet.backends()
                          if b.name not in cohort}
        # Router response cache (request-path economics, the same keyed
        # cache as the backends'): exact-byte repeats replay the cached
        # 200 body without a dispatch. Disabled for the duration of a
        # fleet canary SHADOW — cohort replies carry the unjudged
        # epoch, and a cache would leak them across cohorts.
        cache = ctx.cache if ctx.cache is not None and ctx.cache.enabled \
            and within is None else None
        ckey, gen = None, 0
        if cache is not None:
            ckey = request_key(raw, model, "fleet", "route")
            hit_body, _hit_epoch, gen = cache.get(ckey)
            if hit_body is not None:
                ctx.log.record(time.perf_counter() - t0, 200, klass)
                self._reply_raw(200, hit_body,
                                headers={"X-Cache": "hit"})
                return
        exclude: Set[str] = set()
        attempt = 0
        while True:
            backend = ctx.fleet.acquire(model=model, klass=klass,
                                        client_id=client_id,
                                        exclude=exclude, within=within)
            if backend is None and within is not None:
                # Cohort empty (canary backends all died): availability
                # beats the experiment — fall back to the whole fleet.
                backend = ctx.fleet.acquire(model=model, klass=klass,
                                            client_id=client_id,
                                            exclude=exclude)
            if backend is None:
                # The loud fleet-wide 503: ZERO routable backends (or
                # all excluded by a failed retry). Nothing quieter is
                # honest — there is no capacity to shed toward.
                ctx.fleet.fleet_503s += 1
                ctx.log.record(time.perf_counter() - t0, 503, klass)
                ctx.event("fleet_503", model=model,
                          excluded=sorted(exclude))
                self._reply(
                    503,
                    {"error": "no routable backends in the fleet",
                     "fleet": {r["name"]: r["state"]
                               for r in ctx.fleet.snapshot_rows()},
                     "retry_after_s": 1.0},
                    headers={"Retry-After": 1})
                return
            try:
                status, headers, body = http_exchange(
                    f"{backend.url}/predict", method="POST", body=raw,
                    connect_timeout=ctx.connect_timeout,
                    read_timeout=ctx.read_timeout)
            except TransportError as err:
                ctx.fleet.release(backend, klass)
                reason = classify_failure(err)
                ctx.fleet.note_failure(backend.name, reason)
                if is_canary_row:
                    self._note_canary(False)
                if attempt == 0 and retry_safe(err):
                    attempt += 1
                    exclude.add(backend.name)
                    ctx.fleet.retries += 1
                    ctx.fleet.failovers += 1
                    ctx.event("fleet_failover", backend=backend.name,
                              reason=reason)
                    continue
                ctx.log.record(time.perf_counter() - t0, 502, klass)
                self._reply(502, {
                    "error": f"backend {backend.name} failed: {reason}",
                    "backend": backend.name,
                    "retried": attempt > 0})
                return
            ctx.fleet.release(backend, klass)
            if status == 503 and attempt == 0 and b'"draining"' in body:
                # The backend's drain gate REFUSED the request before
                # any work — a proof of non-execution as strong as
                # connection-refused, so the one-retry budget applies.
                # (An overload 503 is different: it must pass through —
                # retrying it just moves the overload sideways.)
                attempt += 1
                exclude.add(backend.name)
                ctx.fleet.retries += 1
                ctx.event("fleet_drain_retry", backend=backend.name)
                continue
            ctx.fleet.note_success(backend.name)
            if is_canary_row:
                self._note_canary(status < 500)
            ctx.log.record(time.perf_counter() - t0, status, klass)
            passthrough = {}
            if "Retry-After" in headers:
                # 503/429 back-pressure contracts pass through
                # UNTOUCHED: the backend derived Retry-After from its
                # measured drain rate and the router has no better
                # information.
                passthrough["Retry-After"] = headers["Retry-After"]
            if cache is not None and status == 200:
                # Insert stamped with the probe-time generation: a
                # backend epoch change the poller observed mid-flight
                # bumped it, and put() drops this (possibly-stale)
                # body instead of installing it.
                cache.put(ckey, body, len(body) + 64,
                          epoch=backend.epoch, generation=gen)
                passthrough["X-Cache"] = "miss"
            self._reply_raw(status, body, headers=passthrough)
            return

    def _note_canary(self, ok: bool) -> None:
        canary = self.ctx.canary
        if canary is None:
            return
        verdict = canary.note_result(ok)
        if verdict is not None:
            self.ctx.event("fleet_canary_verdict", verdict=verdict,
                           **{k: canary.snapshot()[k] for k in
                              ("compared_rows", "disagreed_rows")})
            self.ctx.canary_verdict(verdict)

    def _do_rollout(self) -> None:
        """``POST /rollout`` — body ``{"source": checkpoint_path,
        "dirs": {name: dir}?, "backends": [name]?, "canary":
        {"fraction": f?, "promote_after": n?, "budget": b?,
        "backends": [name]?}?}``. Without ``canary``: the full rolling
        reload, synchronous. With it: publish to the cohort and return;
        the verdict promotes or rolls back in the background."""
        ctx = self.ctx
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            self._reply(413, {"error": "oversized /rollout body"})
            return
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict) or not payload.get("source"):
                raise ValueError(
                    "body must be JSON {\"source\": checkpoint_path, "
                    "...}")
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        try:
            kwargs = {
                "dir_overrides": payload.get("dirs"),
                "drain_timeout_s": payload.get("drain_timeout_s"),
                "verify_timeout_s": payload.get("verify_timeout_s"),
            }
            if payload.get("canary"):
                result = ctx.canary_rollout(payload["source"],
                                            payload["canary"], **kwargs)
            else:
                result = ctx.rollout(payload["source"],
                                     backends=payload.get("backends"),
                                     **kwargs)
        except (ValueError,) as exc:
            self._reply(400, {"error": str(exc)})
            return
        except RuntimeError as exc:
            self._reply(409, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - an admin op never kills routing
            self._reply(500, {"error": repr(exc)})
            return
        self._reply(200 if result.get("ok") else 502, result)


class _RouterServer(ThreadingHTTPServer):
    # Same rationale as the backend server: bursts must reach the
    # router's dispatch (which has a whole fleet to absorb them), not
    # die as kernel-level connection-refused at backlog 5.
    request_queue_size = 128


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_mnist_tpu_torch route",
        description="Fleet federation: route /predict over N backend "
                    "serve processes with health-gated failover, "
                    "rolling deploys, fleet canaries, and two-tier "
                    "autoscaling.")
    p.add_argument("--backends", type=str, default="",
                   help="comma-separated host:port list of backend "
                        "serve processes (the static fleet; the health "
                        "poller owns their state from here on)")
    p.add_argument("--backends-dir", type=str, default=None,
                   metavar="DIR",
                   help="dynamic discovery: watch DIR for backend_*.json "
                        "records written by serve processes started with "
                        "--register-dir DIR; new records join the fleet "
                        "on probation, vanished records leave (static "
                        "--backends members are never reaped). Composes "
                        "with --backends")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100,
                   help="router port (0 = ephemeral). Default 8100")
    p.add_argument("--health-interval", type=float, default=0.5,
                   help="seconds between /healthz sweeps. Default 0.5")
    p.add_argument("--quarantine-after", type=int, default=3,
                   help="consecutive probe/dispatch failures before a "
                        "backend is quarantined (not routed, still "
                        "probed). Default 3")
    p.add_argument("--probation-successes", type=int, default=3,
                   help="consecutive successes a re-admitted backend "
                        "needs on probation before it is HEALTHY again "
                        "(one failure on probation re-quarantines). "
                        "Default 3")
    p.add_argument("--connect-timeout", type=float, default=1.0,
                   help="per-request backend connect timeout (seconds); "
                        "refusal inside it is the retry-safe failure. "
                        "Default 1.0")
    p.add_argument("--read-timeout", type=float, default=30.0,
                   help="per-request backend read timeout (seconds); a "
                        "timeout is NEVER retried (the backend may be "
                        "executing). Default 30")
    p.add_argument("--hash-replicas", type=int, default=64,
                   help="points per backend on the consistent-hash "
                        "affinity ring. Default 64")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="rollout: max wait for a drained backend's "
                        "in-flight to reach zero. Default 30")
    p.add_argument("--verify-timeout-s", type=float, default=60.0,
                   help="rollout: max wait for a published epoch to be "
                        "serving on /healthz. Default 60")
    p.add_argument("--fleet-min", type=int, default=0,
                   help="fleet autoscaler floor (backend processes); 0 "
                        "disables the fleet autoscaler. Default 0")
    p.add_argument("--fleet-max", type=int, default=0,
                   help="fleet autoscaler ceiling; required with "
                        "--fleet-min")
    p.add_argument("--fleet-slo-p95-ms", type=float, default=100.0,
                   help="merged fleet p95 above which the fleet scales "
                        "UP a backend process. Default 100")
    p.add_argument("--fleet-interval-s", type=float, default=2.0,
                   help="fleet autoscaler control period. Default 2")
    p.add_argument("--fleet-cooldown-s", type=float, default=10.0,
                   help="min seconds between fleet scale actions. "
                        "Default 10")
    p.add_argument("--fleet-down-after", type=int, default=3,
                   help="consecutive calm ticks before a scale-down. "
                        "Default 3")
    p.add_argument("--spawn-backend", type=str, default=None,
                   metavar="ARGS",
                   help="argv template for scale-up, e.g. 'serve "
                        "--model linear --checkpoint-dir /ckpt' (the "
                        "router appends --port 0 and parses the bound "
                        "port). Without it --fleet-min/max only RECORD "
                        "decisions (dry run)")
    p.add_argument("--cache-mb", type=float, default=0.0,
                   help="router response-cache byte budget in MB "
                        "(bounded LRU, same keyed cache as the "
                        "backends'): an exact-byte repeat of a routed "
                        "/predict replays the cached 200 body without "
                        "a backend dispatch; ANY backend epoch change "
                        "the health poller observes invalidates every "
                        "entry in O(1). Default 0 = DISABLED: a "
                        "router cache also starves the per-backend "
                        "load signal the fleet tier routes on, so it "
                        "is an explicit opt-in (the backends' own "
                        "caches already absorb duplicates fleet-wide)")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the router response cache")
    p.add_argument("--metrics-file", type=str, default=None,
                   help="append router JSONL events (quarantines, "
                        "failovers, rollout steps, canary verdicts, "
                        "scale actions) to this file via the shared "
                        "profiling sink")
    return p


def create_router(args) -> ThreadingHTTPServer:
    """Build the fleet + poller (+ autoscaler) and bind the router
    socket (bound, not serving — callers run serve_forever, so tests
    boot on port 0 in-process). ``server.ctx.close()`` tears it down."""
    backends = [tok.strip() for tok in (args.backends or "").split(",")
                if tok.strip()]
    backends_dir = getattr(args, "backends_dir", None)
    if not backends and not backends_dir \
            and not (args.fleet_min and args.spawn_backend):
        raise SystemExit(
            "--backends host:port,... is required (or --backends-dir "
            "DIR for dynamic discovery, or --fleet-min N with "
            "--spawn-backend to boot an all-spawned fleet)")
    sink = None
    if getattr(args, "metrics_file", None):
        from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
            JsonlSink,
        )

        sink = JsonlSink(args.metrics_file)

    ctx_ref: List[RouterContext] = []

    def _emit(kind: str, **fields) -> None:
        if ctx_ref:
            ctx_ref[0].event(kind, **fields)

    cache_mb = float(getattr(args, "cache_mb", 64.0) or 0.0)
    if getattr(args, "no_cache", False) or cache_mb < 0:
        cache_mb = 0.0
    cache = ResponseCache(int(cache_mb * (1 << 20)))
    fleet = Fleet(quarantine_after=args.quarantine_after,
                  probation_successes=args.probation_successes,
                  hash_replicas=args.hash_replicas, on_event=_emit,
                  cache=cache if cache.enabled else None)
    for url in backends:
        fleet.add(url)
    poller = HealthPoller(fleet, interval_s=args.health_interval,
                          connect_timeout=args.connect_timeout,
                          read_timeout=max(2.0, args.connect_timeout),
                          backends_dir=backends_dir)
    scaler = None
    if args.fleet_min:
        if not args.fleet_max:
            raise SystemExit("--fleet-min requires --fleet-max")
        scaler = FleetAutoscaler(
            args.fleet_min, args.fleet_max,
            slo_p95_ms=args.fleet_slo_p95_ms,
            cooldown_s=args.fleet_cooldown_s,
            down_after=args.fleet_down_after)
    ctx = RouterContext(
        fleet, poller, sink=sink,
        connect_timeout=args.connect_timeout,
        read_timeout=args.read_timeout,
        drain_timeout_s=args.drain_timeout_s,
        verify_timeout_s=args.verify_timeout_s,
        fleet_autoscaler=scaler,
        spawn_template=args.spawn_backend,
        cache=cache if cache.enabled else None)
    ctx_ref.append(ctx)
    if scaler is not None and args.spawn_backend:
        scaler.start_fn = ctx.spawn_backend
        scaler.stop_fn = ctx.stop_backend
        scaler.dry_run = False
    poller.start()
    if scaler is not None:
        ctx.start_scaler(args.fleet_interval_s)
    httpd = _RouterServer((args.host, args.port), _RouterHandler)
    httpd.daemon_threads = True
    httpd.ctx = ctx  # type: ignore[attr-defined]
    return httpd


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    httpd = create_router(args)
    host, port = httpd.server_address[:2]
    n = len(httpd.ctx.fleet.names())  # type: ignore[attr-defined]
    print(f"routing on http://{host}:{port}  "
          f"({n} backend(s); /predict, /healthz, /stats, /rollout)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("router shutting down", flush=True)
    finally:
        httpd.ctx.close()  # type: ignore[attr-defined]
        httpd.server_close()


if __name__ == "__main__":
    main()
