"""The serving control plane: policy above the data plane.

The data plane (engine/pool/batcher) answers requests as fast as the
chips allow; this module decides WHICH requests get that capacity when
there is not enough of it, and how much capacity there should be:

- **Priority shedding** (:class:`ShedPolicy`): ``/predict`` requests
  carry a priority class (``interactive`` > ``batch`` > ``best_effort``),
  the batcher's bounded queue is priority-ORDERED, and each class has an
  admission watermark — a fraction of the queue past which that class is
  shed with 503. ``best_effort`` sheds first (half-full queue), ``batch``
  next (three-quarters), ``interactive`` last (the full queue, exactly
  the pre-policy admission bound). A 503 carries ``Retry-After`` derived
  from the batcher's measured drain rate: overload stops being a
  coin flip every class loses equally and becomes a policy.

- **Per-client quotas** (:class:`TokenBucket` / :class:`ClientQuotas`):
  one token bucket per (client, class) rejects an abuser with 429
  BEFORE the request consumes a queue slot — admission control protects
  the server, quotas protect the OTHER clients. Pure arithmetic under
  the lock (never a sleep: a blocked handler thread would be the quota
  consuming the capacity it exists to protect); the refusal carries the
  bucket's own refill time as ``Retry-After``.

- **SLO-driven autoscaling** (:class:`AutoScaler`): a background
  controller samples the ROLLING-window p95 and queue depth the
  :class:`~pytorch_distributed_mnist_tpu_torch.utils.profiling.ServeLog`
  collects (lifetime quantiles can't see current load) and actuates the
  PR 10 ``EnginePool.resize`` path — add replicas on an SLO breach,
  remove them after a sustained calm. Hysteresis (the scale-down bar is
  a fraction of the scale-up bar, plus a consecutive-calm streak) and a
  cooldown after every actuation keep it from flapping; every decision
  is a ``serve_autoscale`` JSONL event through the shared sink, and
  ``dry_run`` records the decisions without actuating (the twin/canary
  mode). The controller snapshots state under its lock and ACTS outside
  it — ``resize`` builds and AOT-warms a whole layout, and holding any
  lock across that would stall ``/stats`` for the build (the
  lock-discipline fixture shape).

- **Weighted-fair multi-model dispatch** (:class:`WeightedFairGate`):
  N models served from one chip budget each get a weight; when more
  than one model has queued work, dispatch grants interleave in weight
  proportion (start-time fair queueing over per-model virtual time), so
  one model's backlog cannot starve another's. An idle model neither
  blocks the busy one nor banks credit for a catch-up burst (its
  virtual time is floored to the grant clock on re-entry).

Pure stdlib on purpose — no torch import: policy must be unit-testable
with stubs and importable without touching a device.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

#: Priority classes, best-served first. The order IS the queue order and
#: the REVERSE of the shed order: ``best_effort`` sheds first,
#: ``interactive`` last.
PRIORITY_CLASSES: Tuple[str, ...] = ("interactive", "batch", "best_effort")

_RANK = {name: rank for rank, name in enumerate(PRIORITY_CLASSES)}

#: Default admission watermarks (fraction of the batcher queue a class
#: may fill before it is shed). ``interactive`` at 1.0 keeps the exact
#: pre-policy admission bound for the default class.
DEFAULT_WATERMARKS: Dict[str, float] = {
    "interactive": 1.0,
    "batch": 0.75,
    "best_effort": 0.5,
}


def priority_rank(klass: str) -> int:
    """Queue rank of a priority class (0 = most urgent). Raises
    ``ValueError`` on an unknown class — the HTTP layer turns that into
    a 400 naming the vocabulary."""
    try:
        return _RANK[klass]
    except KeyError:
        raise ValueError(
            f"unknown priority {klass!r}; one of "
            f"{list(PRIORITY_CLASSES)}") from None


class ShedPolicy:
    """Per-class admission watermarks over a bounded queue.

    ``admits(klass, depth, max_queue)`` is the admission decision the
    batcher asks under its own lock (pure arithmetic);
    ``retry_after_s`` converts the queue overhang into the honest
    back-off hint a 503 carries — how long the measured drain rate
    needs to bring the queue back under this class's watermark.
    """

    def __init__(self, watermarks: Optional[Dict[str, float]] = None
                 ) -> None:
        marks = dict(DEFAULT_WATERMARKS)
        for klass, frac in (watermarks or {}).items():
            priority_rank(klass)  # vocabulary check
            frac = float(frac)
            if not 0.0 < frac <= 1.0:
                raise ValueError(
                    f"watermark for {klass!r} must be in (0, 1], "
                    f"got {frac}")
            marks[klass] = frac
        self.watermarks = marks

    def admit_depth(self, klass: str, max_queue: int) -> int:
        """Queue slots class ``klass`` may occupy/see: depth >= this
        sheds. At least 1 — a watermark must never shed an empty
        queue."""
        return max(1, int(self.watermarks[klass] * max_queue))

    def admits(self, klass: str, depth: int, max_queue: int) -> bool:
        return depth < self.admit_depth(klass, max_queue)

    def retry_after_s(self, klass: str, depth: int, max_queue: int,
                      drain_rps: float, incoming: float = 1.0) -> float:
        """Seconds until the queue plausibly re-admits ``klass``: the
        load above its watermark divided by the measured drain rate.
        ``depth``, ``drain_rps`` and ``incoming`` (the refused
        request's own price) share ONE unit — request counts by
        default, cost units when the batcher prices admission — so a
        cost-priced 503's hint derives from drained COST, not drained
        count. Clamped to [0.1, 30] — an idle-drain estimate of hours
        is not a useful client hint, and sub-100ms retries just
        re-offer the overload."""
        over = depth - self.admit_depth(klass, max_queue) + float(incoming)
        rate = max(float(drain_rps), 1.0)
        return round(min(30.0, max(0.1, over / rate)), 3)


class DrainRate:
    """Units-per-second the data plane is actually completing, over a
    short sliding window — the denominator of every ``Retry-After``.
    The unit is whatever the caller notes: request counts by default,
    COST units on a priced batcher (fractional notes are preserved — a
    drained cache hit at ~0 cost must not round up to a full request).
    Thread-safe; the batcher's completion stage notes each delivered
    batch."""

    def __init__(self, window_s: float = 10.0) -> None:
        self._lock = threading.Lock()
        self.window_s = float(window_s)
        self._events: collections.deque = collections.deque(maxlen=4096)

    def note(self, n: float = 1, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, float(n)))

    def rate(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        cutoff = now - self.window_s
        with self._lock:
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()
            total = sum(n for _, n in self._events)
        return total / self.window_s


class TokenBucket:
    """One client×class rate limiter: ``rate`` tokens/sec refill up to
    ``burst``. ``admit`` is pure arithmetic — it never sleeps; a refusal
    returns the refill time the 429's ``Retry-After`` carries."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None) -> None:
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.t_last = time.monotonic() if now is None else now

    def admit(self, now: Optional[float] = None,
              cost: float = 1.0) -> Tuple[bool, float]:
        """``(admitted, retry_after_s)`` — retry_after is 0.0 on
        admission, else the seconds until ``cost`` tokens exist."""
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + max(0.0, now - self.t_last)
                          * self.rate)
        self.t_last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True, 0.0
        return False, round((cost - self.tokens) / self.rate, 3)


def parse_quota_spec(spec: str) -> Dict[str, float]:
    """``--quota-rps`` grammar -> {class: rps}.

    ``"100"`` bounds every class at 100 req/s per client;
    ``"100,interactive=20"`` overrides one class;
    ``"batch=50"`` bounds only that class (others unlimited).
    0 (or an absent class) = unlimited for that class.
    """
    rates: Dict[str, float] = {}
    default: Optional[float] = None
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" in tok:
            klass, _, val = tok.partition("=")
            klass = klass.strip()
            priority_rank(klass)
            rates[klass] = float(val)
        else:
            if default is not None:
                raise ValueError(
                    f"--quota-rps {spec!r}: more than one bare default "
                    f"rate")
            default = float(tok)
    if default is not None:
        for klass in PRIORITY_CLASSES:
            rates.setdefault(klass, default)
    for klass, rate in rates.items():
        if rate < 0:
            raise ValueError(
                f"--quota-rps: rate for {klass!r} must be >= 0, "
                f"got {rate}")
    return rates


class ClientQuotas:
    """Per-client token buckets with per-class rates.

    One bucket per (client_id, class); clients the server has never
    seen get a fresh bucket at the class's burst. The map is an LRU
    bounded at ``max_clients`` — an adversary minting client_ids per
    request must not grow server memory without bound (evicting an old
    client merely refills its burst, which is the conservative
    direction). Requests with no ``client_id`` share one anonymous
    bucket per class, so anonymity is not a quota bypass.
    """

    def __init__(self, rps_by_class: Dict[str, float],
                 burst_s: float = 2.0, max_clients: int = 4096) -> None:
        for klass in rps_by_class:
            priority_rank(klass)
        self.rps_by_class = {k: float(v) for k, v in rps_by_class.items()}
        self.burst_s = float(burst_s)
        self.max_clients = int(max_clients)
        self._lock = threading.Lock()
        self._buckets: "collections.OrderedDict[Tuple[str, str], TokenBucket]" = \
            collections.OrderedDict()
        self._rejected = 0

    @property
    def enabled(self) -> bool:
        return any(r > 0 for r in self.rps_by_class.values())

    def admit(self, client_id: Optional[str], klass: str,
              now: Optional[float] = None,
              cost: float = 1.0) -> Tuple[bool, float]:
        """``(admitted, retry_after_s)`` for one request. ``cost`` is
        the request's price in cost units (the TokenBucket was always
        cost-capable; a cost-pricing server finally wires real prices
        through — an expensive-bucket request spends its measured
        multiple, a cache hit spends ~0, and the default 1.0 keeps
        count-based quotas byte-identical). Arithmetic only under the
        lock — never a sleep, never IO (a handler thread parked inside
        here would hold queue capacity hostage to the very client being
        limited)."""
        rate = self.rps_by_class.get(klass, 0.0)
        if rate <= 0:
            return True, 0.0
        key = (client_id or "", klass)
        now = time.monotonic() if now is None else now
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = TokenBucket(rate, burst=rate * self.burst_s,
                                     now=now)
                self._buckets[key] = bucket
            else:
                self._buckets.move_to_end(key)
            while len(self._buckets) > self.max_clients:
                self._buckets.popitem(last=False)
            admitted, retry_after = bucket.admit(now=now, cost=cost)
            if not admitted:
                self._rejected += 1
        return admitted, retry_after

    def snapshot(self) -> Dict:
        """The ``/stats`` ``quota`` block."""
        with self._lock:
            return {
                "rps_by_class": dict(self.rps_by_class),
                "clients_tracked": len({c for c, _ in self._buckets}),
                "rejected": self._rejected,
            }


class AutoScaler:
    """The SLO feedback loop: rolling-window p95 / queue depth in,
    ``EnginePool.resize`` out.

    ``stats_fn() -> {"p95_ms": float, "queue_depth": int}`` is sampled
    every ``interval_s`` on a background thread (the ``ServeLog``'s
    ``window_stats`` — CURRENT load, not lifetime averages). The
    controller state machine:

    - **breach** (p95 > ``slo_p95_ms`` OR depth >= ``queue_high``):
      scale UP one step, unless already at ``max_devices`` or inside
      the cooldown.
    - **calm** (p95 < ``slo_p95_ms * down_frac`` AND depth <=
      ``queue_low``): one more tick of the calm streak; after
      ``down_after`` consecutive calm ticks, scale DOWN one step toward
      ``min_devices``. The lowered bar + streak is the hysteresis band —
      a p95 hovering at the SLO can trigger neither direction twice.
    - anything between: hold, streak resets.

    ``step`` is the scale quantum: 1 replica on the replicated plane,
    one whole MESH GROUP (``mesh_size`` chips) on a sharded pool —
    ``resize`` validates ``serve_mesh | serve_devices``, so any finer
    step could never actuate there (the server wiring also requires
    mesh-multiple min/max bounds for the same reason).

    A cooldown after every actuation bounds the resize rate (a resize
    builds + AOT-warms a whole layout; back-to-back resizes would spend
    the capacity they're trying to add). Every scale decision lands as
    a ``serve_autoscale`` event in the shared JSONL sink and in the
    in-memory decision log ``/stats`` surfaces; ``dry_run`` records
    without actuating. The tick snapshots state under the controller
    lock and calls ``resize`` strictly OUTSIDE it (and outside the
    pool/stats locks): the actuation is the slow part.
    """

    def __init__(
        self,
        pool,
        stats_fn: Callable[[], Dict],
        slo_p95_ms: float,
        queue_high: int,
        queue_low: Optional[int] = None,
        min_devices: int = 1,
        max_devices: Optional[int] = None,
        step: int = 1,
        interval_s: float = 2.0,
        cooldown_s: float = 10.0,
        down_frac: float = 0.5,
        down_after: int = 3,
        dry_run: bool = False,
        serve_log=None,
        model: Optional[str] = None,
        now_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        if slo_p95_ms <= 0:
            raise ValueError(f"slo_p95_ms must be > 0, got {slo_p95_ms}")
        if queue_high < 1:
            raise ValueError(f"queue_high must be >= 1, got {queue_high}")
        if min_devices < 1:
            raise ValueError(
                f"min_devices must be >= 1, got {min_devices}")
        if max_devices is not None and max_devices < min_devices:
            raise ValueError(
                f"max_devices {max_devices} < min_devices {min_devices}")
        if not 0.0 < down_frac < 1.0:
            raise ValueError(
                f"down_frac must be in (0, 1) — the hysteresis band — "
                f"got {down_frac}")
        if down_after < 1:
            raise ValueError(f"down_after must be >= 1, got {down_after}")
        self.pool = pool
        self.stats_fn = stats_fn
        self.slo_p95_ms = float(slo_p95_ms)
        self.queue_high = int(queue_high)
        self.queue_low = (max(0, queue_high // 4)
                          if queue_low is None else int(queue_low))
        self.min_devices = int(min_devices)
        self.max_devices = max_devices if max_devices is None \
            else int(max_devices)
        self.step = max(1, int(step))
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.down_frac = float(down_frac)
        self.down_after = int(down_after)
        self.dry_run = bool(dry_run)
        self.serve_log = serve_log
        self.model = model
        self._now = now_fn
        self._lock = threading.Lock()
        self._calm_streak = 0
        self._last_action_t: Optional[float] = None
        self._scale_ups = 0
        self._scale_downs = 0
        self._errors = 0
        self._decisions: collections.deque = collections.deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the state machine --------------------------------------------------

    def decide(self, p95_ms: float, queue_depth: int, n_devices: int,
               now: float) -> Optional[Dict]:
        """One controller step over one sample: mutates the streak /
        cooldown state and returns a scale decision dict, or ``None``
        to hold. Decision only — actuation is :meth:`tick`'s job, so
        the unit matrix drives this directly with synthetic samples."""
        breach = (p95_ms > self.slo_p95_ms
                  or queue_depth >= self.queue_high)
        calm = (p95_ms < self.slo_p95_ms * self.down_frac
                and queue_depth <= self.queue_low)
        with self._lock:
            in_cooldown = (self._last_action_t is not None
                           and now - self._last_action_t
                           < self.cooldown_s)
            if breach:
                self._calm_streak = 0
                if in_cooldown:
                    return None
                at_max = (self.max_devices is not None
                          and n_devices >= self.max_devices)
                if at_max:
                    return None
                target = n_devices + self.step
                if self.max_devices is not None:
                    target = min(target, self.max_devices)
                self._last_action_t = now
                return {
                    "action": "scale_up",
                    "from_devices": n_devices, "to_devices": target,
                    "reason": (
                        f"p95 {p95_ms:.1f}ms > SLO {self.slo_p95_ms}ms"
                        if p95_ms > self.slo_p95_ms else
                        f"queue depth {queue_depth} >= high watermark "
                        f"{self.queue_high}"),
                    "p95_ms": round(p95_ms, 3),
                    "queue_depth": int(queue_depth),
                }
            if not calm:
                # The hysteresis band: neither breach nor calm. The calm
                # streak resets — scale-down needs SUSTAINED headroom.
                self._calm_streak = 0
                return None
            self._calm_streak += 1
            if (self._calm_streak < self.down_after or in_cooldown
                    or n_devices <= self.min_devices):
                return None
            target = max(self.min_devices, n_devices - self.step)
            self._last_action_t = now
            self._calm_streak = 0
            return {
                "action": "scale_down",
                "from_devices": n_devices, "to_devices": target,
                "reason": (
                    f"p95 {p95_ms:.1f}ms < {self.down_frac:.0%} of SLO "
                    f"and queue <= {self.queue_low} for "
                    f"{self.down_after} samples"),
                "p95_ms": round(p95_ms, 3),
                "queue_depth": int(queue_depth),
            }

    def tick(self) -> Optional[Dict]:
        """Sample -> decide -> (maybe) actuate. Returns the recorded
        decision, or ``None`` on hold. The resize call runs with NO
        controller lock held — snapshot, release, act."""
        stats = self.stats_fn()
        decision = self.decide(
            float(stats.get("p95_ms", 0.0)),
            int(stats.get("queue_depth", 0)),
            int(self.pool.n_devices), self._now())
        if decision is None:
            return None
        decision["dry_run"] = self.dry_run
        if self.model is not None:
            decision["model"] = self.model
        if not self.dry_run:
            try:
                # The actuation: the PR 10 resize path (build + warm the
                # new layout while the old serves; atomic swap; zero
                # dropped in-flight requests by construction).
                self.pool.resize(n_devices=decision["to_devices"])
            except Exception as exc:  # noqa: BLE001 - controller survives
                # A concurrent /resize (409-shaped RuntimeError) or a
                # failed build must not kill the control loop; record
                # and let the next sample re-decide.
                decision["error"] = repr(exc)
                with self._lock:
                    self._errors += 1
        with self._lock:
            if "error" not in decision:
                if decision["action"] == "scale_up":
                    self._scale_ups += 1
                else:
                    self._scale_downs += 1
            self._decisions.append(dict(decision))
        if self.serve_log is not None:
            self.serve_log.record_pool_event("serve_autoscale", **decision)
        print(f"serve autoscale: {decision['action']} "
              f"{decision['from_devices']} -> {decision['to_devices']} "
              f"device(s) ({decision['reason']})"
              + (" [dry run]" if self.dry_run else "")
              + (f" FAILED: {decision['error']}"
                 if "error" in decision else ""),
              flush=True)
        return decision

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "AutoScaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serve-autoscale")
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
                self.tick()
            except Exception as exc:  # noqa: BLE001 - controller never dies
                print(f"serve autoscale: tick failed: {exc!r}", flush=True)

    def snapshot(self) -> Dict:
        """The ``/stats`` ``autoscaler`` block: configuration, counters,
        and the recent decision log (what the chaos twin asserts in
        dry-run mode)."""
        with self._lock:
            decisions = [dict(d) for d in self._decisions]
            return {
                "dry_run": self.dry_run,
                "slo_p95_ms": self.slo_p95_ms,
                "queue_high": self.queue_high,
                "queue_low": self.queue_low,
                "cooldown_s": self.cooldown_s,
                "min_devices": self.min_devices,
                "max_devices": self.max_devices,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "errors": self._errors,
                "calm_streak": self._calm_streak,
                "decisions": decisions,
                "last_decision": decisions[-1] if decisions else None,
            }


class WeightedFairGate:
    """Start-time fair queueing over per-model dispatch grants.

    Each model's batcher has ONE dispatch thread; before dispatching a
    batch it calls :meth:`grant` with its row count. When several
    models have a dispatch waiting, grants go to the model with the
    lowest virtual time, and each grant charges ``rows / weight`` — so
    over a sustained backlog the models' granted rows converge to the
    weight ratio, regardless of who queues faster. A model with no
    waiter never blocks anyone (work-conserving), and a model returning
    from idle has its virtual time floored to the grant clock, so it
    gets its fair share FORWARD from now — not a monopoly burst
    repaying the idle period.

    ``grant`` blocks (on the gate's condition variable) only while
    other models are ahead in virtual time; the caller dispatches
    OUTSIDE the gate's lock.
    """

    def __init__(self, weights: Dict[str, float]) -> None:
        if not weights:
            raise ValueError("WeightedFairGate needs at least one model")
        for model, w in weights.items():
            if w <= 0:
                raise ValueError(
                    f"weight for {model!r} must be > 0, got {w}")
        self.weights = {m: float(w) for m, w in weights.items()}
        self._cv = threading.Condition()
        self._vtime = {m: 0.0 for m in self.weights}
        self._floor = 0.0
        self._waiting: Dict[str, int] = {}
        self._granted_rows = {m: 0 for m in self.weights}
        self._grants = {m: 0 for m in self.weights}

    def grant(self, model: str, rows: int = 1) -> None:
        """Block until ``model`` is the fairness-eligible dispatcher,
        then charge the grant. One waiter per model (the batcher's
        single dispatch thread)."""
        if model not in self.weights:
            raise ValueError(
                f"unknown model {model!r}; gate serves "
                f"{sorted(self.weights)}")
        rows = max(1, int(rows))
        with self._cv:
            # Re-entry floor: an idle model's stale (small) vtime must
            # not buy it a catch-up monopoly.
            self._vtime[model] = max(self._vtime[model], self._floor)
            self._waiting[model] = rows
            while min(self._waiting,
                      key=lambda m: (self._vtime[m], m)) != model:
                self._cv.wait()
            del self._waiting[model]
            self._floor = max(self._floor, self._vtime[model])
            self._vtime[model] += rows / self.weights[model]
            self._granted_rows[model] += rows
            self._grants[model] += 1
            self._cv.notify_all()

    def snapshot(self) -> Dict:
        with self._cv:
            return {
                "weights": dict(self.weights),
                "granted_rows": dict(self._granted_rows),
                "grants": dict(self._grants),
            }


def parse_weight_spec(spec: str, models: List[str]) -> Dict[str, float]:
    """``--model-weights`` grammar -> {model: weight}; models not named
    default to 1.0. Unknown model names are a flag error."""
    weights = {m: 1.0 for m in models}
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, val = tok.partition("=")
        if not sep:
            raise ValueError(
                f"--model-weights {spec!r}: expected MODEL=WEIGHT, "
                f"got {tok!r}")
        name = name.strip()
        if name not in weights:
            raise ValueError(
                f"--model-weights names {name!r}, which is not in the "
                f"model set {sorted(models)}")
        weights[name] = float(val)
        if weights[name] <= 0:
            raise ValueError(
                f"--model-weights: weight for {name!r} must be > 0")
    return weights
