"""Shadow-traffic accuracy canary: "is int8 safe" as a production control.

Counterpart of ``pytorch_distributed_mnist_tpu/serve/canary.py``, with the
same state machine, counters, events and ``/stats`` block.

A quantized serving plane (``serve/programs.py``'s precision axis) is an
accuracy claim as much as a speed claim — and offline sweeps validate it
against yesterday's checkpoint, not the one the fleet hot-reloaded five
minutes ago. The canary turns the claim into a per-publish control loop:

- **Shadow.** The BASELINE (f32) plane answers every request; a
  configurable fraction of live batches is ADDITIONALLY dispatched to
  the quantized CANDIDATE plane. Both planes enqueue on the device
  without waiting, so the shadow forward overlaps the baseline's: the
  client pays one result fetch, not two serial forwards. On completion the two logit
  sets are compared: per-row argmax disagreements and per-row max
  |Δlogit| accumulate (``/stats``' ``canary`` block), and the reply is
  ALWAYS the baseline's — a broken candidate can cost nothing but its
  own shadow work.
- **Promote.** After ``promote_after`` shadowed rows with disagreements
  inside the budget, the candidate becomes PRIMARY: dispatch routes to
  the quantized plane alone and the throughput/HBM win materializes.
  In-flight batches complete on the plane that dispatched them.
- **Roll back.** The budget is ``budget * promote_after`` disagreeing
  rows (shadow-plane ERRORS count too — a crashing candidate must never
  promote). Exceeding it rolls the canary back: the baseline keeps
  answering, the candidate goes idle, and the decision is PERMANENT FOR
  THAT PUBLISH — no flapping retry against weights already judged bad.
  The server keeps serving throughout; rollback is a routing decision,
  never an outage.
- **Reset per publish.** The reload watcher's one callback
  (``swap_params`` — the same ``CheckpointWatcher(validate_fn=)`` path
  every plane reloads through) fans the new f32 params to BOTH planes
  (each quantizes at install, per the precision contract) and restarts
  the cycle at SHADOW: every publish re-earns promotion.

Transitions land as ``serve_canary`` JSONL events in the shared
``--metrics-file`` stream (``ServeLog.record_pool_event``) and as
counters in ``/stats``.

The canary deliberately does NOT invent a data plane: baseline and
candidate are ordinary engines or pools (``serve/pool.py``): the pool's
quarantine, failover and regroup heal each side independently, and the
pool surface
(``dispatch``/``complete``/``swap_params``/``warmup``) is all the canary
touches. ``TPUMNIST_CANARY_FAULT=disagree`` is the chaos-harness hook:
every shadow comparison counts as disagreement, rehearsing the
rollback-under-traffic scenario (``runtime/chaos.py --canary-rollback``).
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Optional, Tuple

import numpy as np

# Chaos/e2e-test injection: "disagree" (or "1") makes every shadow
# comparison count as a full disagreement — the single-process stand-in
# for a quantized publish whose accuracy really did regress.
CANARY_FAULT_ENV = "TPUMNIST_CANARY_FAULT"

SHADOW = "shadow"
PRIMARY = "primary"
ROLLED_BACK = "rolled_back"


def _dispatch(plane, images):
    """One dispatch against either data-plane surface: a pool's
    ``dispatch`` or a bare engine's ``dispatch_logits`` (both enqueue
    without waiting and pair with ``plane.complete(handle)``)."""
    fn = getattr(plane, "dispatch", None)
    if fn is not None:
        return fn(images)
    return plane.dispatch_logits(images)


class _CanaryHandle:
    """One dispatched batch: the handle whose plane ANSWERS, plus the
    shadow handle (when this batch was sampled) — completion compares
    the two and the reply never waits on anything but its own plane's
    fetch ordering."""

    __slots__ = ("reply", "reply_plane", "shadow")

    def __init__(self, reply, reply_plane: str, shadow=None) -> None:
        self.reply = reply
        self.reply_plane = reply_plane  # "baseline" | "candidate"
        self.shadow = shadow


class ShadowCanary:
    """Routes traffic between a baseline (f32) plane and a quantized
    candidate plane per the state machine in the module docstring.

    Exposes the engine-compatible surface the server's handlers,
    batcher, and reload watcher use (``dispatch``/``complete``/
    ``predict_complete``/``swap_params``/``warmup``/``preprocess``/
    ``buckets``/``max_batch``/``params_epoch``), so it drops in wherever
    one engine or pool did. Counter mutation and state transitions run
    under one lock; device work (dispatch enqueues, completion fetches)
    and event emission always run outside it.
    """

    def __init__(self, baseline, candidate, precision: str,
                 fraction: float = 0.1, promote_after: int = 200,
                 budget: float = 0.02, serve_log=None,
                 max_delta_samples: int = 4096) -> None:
        if not (0.0 < fraction <= 1.0):
            raise ValueError(
                f"canary fraction must be in (0, 1], got {fraction}")
        if promote_after < 1:
            raise ValueError(
                f"canary promote_after must be >= 1, got {promote_after}")
        if budget < 0.0:
            raise ValueError(f"canary budget must be >= 0, got {budget}")
        self.baseline = baseline
        self.candidate = candidate
        self.precision = precision
        self.fraction = float(fraction)
        self.promote_after = int(promote_after)
        self.budget = float(budget)
        self.serve_log = serve_log
        # Disagreement allowance per promotion window, in ROWS: blowing
        # it rolls back immediately, staying inside it for promote_after
        # rows promotes.
        self._allowed = self.budget * self.promote_after
        self._injected = os.environ.get(
            CANARY_FAULT_ENV, "").strip().lower() in ("1", "disagree")
        self._lock = threading.Lock()
        self._state = SHADOW
        self._acc = 0.0  # deterministic fraction sampler (no RNG)
        self._publishes = 0
        self._promotions = 0
        self._rollbacks = 0
        # Swap hooks: run under the canary lock on every
        # publish reset AND on a promotion — the two transitions that
        # change what a repeated request would be answered with
        # (rollback keeps the baseline answering, so it needs no
        # invalidation). O(1) arithmetic only.
        self._swap_hooks = []
        self._deltas = collections.deque(maxlen=max_delta_samples)
        self._reset_counters_locked()

    def _reset_counters_locked(self) -> None:
        self._shadow_batches = 0
        self._compared_rows = 0
        self._disagreed_rows = 0
        self._shadow_errors = 0
        self._skewed = 0
        self._acc = 0.0
        self._deltas.clear()

    # -- engine-compatible surface ----------------------------------------

    @property
    def buckets(self):
        return self.baseline.buckets

    @property
    def max_batch(self) -> int:
        return self.baseline.max_batch

    @property
    def params_epoch(self) -> Optional[int]:
        """The serving epoch of the plane currently ANSWERING."""
        with self._lock:
            plane = self.candidate if self._state == PRIMARY \
                else self.baseline
        return plane.params_epoch

    def preprocess(self, images) -> np.ndarray:
        return self.baseline.preprocess(images)

    def staging_allocated(self) -> dict:
        """Both planes' staging buffers, summed."""
        from pytorch_distributed_mnist_tpu_torch.serve.engine import (
            sum_staging,
        )

        return sum_staging([self.baseline.staging_allocated(),
                            self.candidate.staging_allocated()])

    def warmup(self) -> None:
        """AOT-warm BOTH planes before the socket opens: a shadowed or
        newly-promoted batch must never pay a compile either."""
        self.baseline.warmup()
        self.candidate.warmup()

    def swap_params(self, params, epoch: Optional[int] = None,
                    path: Optional[str] = None):
        """The reload watcher's one callback, fanned to both planes (each
        applies its own install-time quantization and swap-ordering
        rule), then the canary cycle RESETS to shadow: a new publish —
        including one arriving after a rollback — re-earns promotion
        from zero. Returns the baseline's install result (the watcher's
        staleness contract follows the plane that answers by default)."""
        installed = self.baseline.swap_params(params, epoch=epoch, path=path)
        cand_installed = self.candidate.swap_params(params, epoch=epoch,
                                                    path=path)
        if not installed and not cand_installed:
            # Both planes refused the publish as STALE (the engines'
            # swap-ordering rule): nothing changed, so nothing re-earns
            # — resetting here would silently demote a promoted
            # candidate over a checkpoint that never served.
            return installed
        with self._lock:
            prev = self._state
            self._state = SHADOW
            self._publishes += 1
            self._reset_counters_locked()
            for hook in self._swap_hooks:
                hook(epoch)
        self._record_event("reset", previous_state=prev, epoch=epoch)
        return installed

    def add_swap_hook(self, hook) -> None:
        """Register ``hook(epoch)`` to run under the canary lock on each
        publish reset and on promotion (the response cache's
        ``bump_generation`` seam — O(1) arithmetic only)."""
        with self._lock:
            self._swap_hooks.append(hook)

    # -- dispatch / complete ----------------------------------------------

    def dispatch(self, images) -> _CanaryHandle:
        """Route one formed batch: the current PRIMARY plane answers;
        in shadow state, a ``fraction`` of batches additionally dispatch
        on the candidate (sampled by a deterministic accumulator — exact
        rate, no RNG). A candidate dispatch failure is contained here
        and counted against the budget: the client's reply never depends
        on the candidate."""
        with self._lock:
            state = self._state
            shadow = False
            if state == SHADOW:
                self._acc += self.fraction
                if self._acc >= 1.0 - 1e-9:
                    self._acc -= 1.0
                    shadow = True
                    self._shadow_batches += 1
        if state == PRIMARY:
            return _CanaryHandle(_dispatch(self.candidate, images),
                                 "candidate")
        reply = _dispatch(self.baseline, images)
        shadow_handle = None
        if shadow:
            try:
                shadow_handle = _dispatch(self.candidate, images)
            except Exception as exc:  # noqa: BLE001 - shadow must not fail the reply
                self._note_shadow_error(int(np.shape(images)[0]), exc)
        return _CanaryHandle(reply, "baseline", shadow_handle)

    def complete(self, handle: _CanaryHandle) \
            -> Tuple[np.ndarray, Optional[int]]:
        """Fetch the answering plane's logits; when this batch carried a
        shadow, fetch and judge the candidate's too (the shadow forward
        was enqueued beside the baseline's: this is a fetch, not a
        second forward)."""
        plane = self.candidate if handle.reply_plane == "candidate" \
            else self.baseline
        logits, epoch = plane.complete(handle.reply)
        if handle.shadow is not None:
            self._judge(handle.shadow, logits, epoch)
        return logits, epoch

    def predict_complete(self, handle: _CanaryHandle) \
            -> Tuple[np.ndarray, Optional[int]]:
        logits, epoch = self.complete(handle)
        return np.argmax(logits, axis=-1), epoch

    # -- the state machine -------------------------------------------------

    def _judge(self, shadow_handle, base_logits: np.ndarray,
               base_epoch: Optional[int]) -> None:
        rows = int(base_logits.shape[0])
        try:
            cand_logits, cand_epoch = self.candidate.complete(shadow_handle)
        except Exception as exc:  # noqa: BLE001 - contained; counts against budget
            self._note_shadow_error(rows, exc)
            return
        if cand_epoch != base_epoch:
            # A hot reload landed between the two planes' param captures:
            # the rows would judge two different checkpoints. Skip the
            # comparison (counted, for observability) — the next shadowed
            # batch compares like-for-like.
            with self._lock:
                self._skewed += 1
            return
        disagreed = int(np.sum(
            np.argmax(cand_logits, axis=-1) != np.argmax(base_logits,
                                                         axis=-1)))
        if self._injected:
            disagreed = rows
        deltas = np.max(np.abs(cand_logits.astype(np.float32)
                               - base_logits.astype(np.float32)),
                        axis=tuple(range(1, base_logits.ndim)))
        transition = None
        with self._lock:
            self._compared_rows += rows
            self._disagreed_rows += disagreed
            self._deltas.extend(float(d) for d in deltas)
            transition = self._walk_locked()
        self._emit_transition(transition)

    def _note_shadow_error(self, rows: int, exc: BaseException) -> None:
        """A candidate dispatch/completion failure: contained (the reply
        already came from the baseline) but counted as ``rows``
        disagreeing rows — an erroring quantized plane must neither
        promote nor keep burning shadow work past the budget."""
        print(f"serve canary: shadow ({self.precision}) failed, counted "
              f"against the budget: {exc!r}", flush=True)
        transition = None
        with self._lock:
            self._shadow_errors += 1
            self._compared_rows += rows
            self._disagreed_rows += rows
            transition = self._walk_locked()
        self._emit_transition(transition)

    def _walk_locked(self) -> Optional[str]:
        """Walk the promote/rollback thresholds (caller holds the lock);
        returns the transition taken, for the caller to emit OUTSIDE the
        lock. Rollback outranks promotion when one batch crosses both."""
        if self._state != SHADOW:
            return None
        if self._disagreed_rows > self._allowed:
            self._state = ROLLED_BACK
            self._rollbacks += 1
            return "rolled_back"
        if self._compared_rows >= self.promote_after:
            self._state = PRIMARY
            self._promotions += 1
            # The answering plane just changed: cached baseline answers
            # must not outlive the promote.
            for hook in self._swap_hooks:
                hook(None)
            return "promoted"
        return None

    def _emit_transition(self, transition: Optional[str]) -> None:
        if transition is None:
            return
        with self._lock:
            detail = {"compared_rows": self._compared_rows,
                      "disagreed_rows": self._disagreed_rows,
                      "shadow_errors": self._shadow_errors}
        if transition == "promoted":
            print(f"serve canary: PROMOTED {self.precision} to primary "
                  f"after {detail['compared_rows']} clean shadowed rows "
                  f"({detail['disagreed_rows']} disagreements within "
                  f"budget {self._allowed:.1f})", flush=True)
        else:
            print(f"serve canary: ROLLED BACK {self.precision} — "
                  f"{detail['disagreed_rows']} disagreeing rows of "
                  f"{detail['compared_rows']} compared exceeded the "
                  f"budget ({self._allowed:.1f}); baseline keeps "
                  f"serving, permanent for this publish", flush=True)
        self._record_event(transition, **detail)

    def _record_event(self, event: str, **fields) -> None:
        if self.serve_log is not None:
            self.serve_log.record_pool_event(
                "serve_canary", event=event, precision=self.precision,
                state=self.state, **fields)

    # -- observability -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        """The ``/stats`` ``canary`` block: state, sampling shape, the
        disagreement counters, and the per-row max-|Δlogit| quantiles of
        the recent shadow window."""
        from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
            _percentile,
        )

        with self._lock:
            deltas = sorted(self._deltas)
            compared = self._compared_rows
            snap = {
                "precision": self.precision,
                "state": self._state,
                "fraction": self.fraction,
                "promote_after": self.promote_after,
                "budget": self.budget,
                "shadow_batches": self._shadow_batches,
                "compared_rows": compared,
                "disagreed_rows": self._disagreed_rows,
                "disagree_rate": round(self._disagreed_rows / compared, 6)
                if compared else 0.0,
                "shadow_errors": self._shadow_errors,
                "skewed_comparisons": self._skewed,
                "publishes": self._publishes,
                "promotions": self._promotions,
                "rollbacks": self._rollbacks,
            }
        snap["logit_delta"] = {
            "p50": round(_percentile(deltas, 0.50), 6),
            "p95": round(_percentile(deltas, 0.95), 6),
            "p99": round(_percentile(deltas, 0.99), 6),
            "max": round(deltas[-1], 6) if deltas else 0.0,
            "count": len(deltas),
        }
        return snap
