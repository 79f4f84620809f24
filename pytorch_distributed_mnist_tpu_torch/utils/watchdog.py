"""Host-side deadline and retry primitives of the run-supervision layer.

Counterpart of ``pytorch_distributed_mnist_tpu/utils/watchdog.py``; host
code only, so a copy.

A host-side collective (``runtime/supervision.py``'s record exchange over
the gloo group) has no deadline of its own that a caller can set per
call: a peer that died outside an agreed phase leaves this host blocked
until gloo's own timeout. ``run_with_deadline`` bounds such a call by
running it on a worker thread and joining with a timeout. The main thread
blocks on the join, so process-wide at most one record exchange is still
in flight at a time.

On expiry the watchdog (a) runs the caller's diagnostic dump, (b)
optionally arms a hard-exit timer, so a process whose interpreter teardown
would block on the stuck collective still dies, and (c) raises
``WatchdogTimeout`` in the caller. The worker thread stays parked in the
dead collective; a ``WatchdogTimeout`` is fatal for the run
(``already_agreed`` marks it as needing, and safe for, no further
collective).

``retry_with_backoff`` is the primitive for the retryable host-side
failures (a dataset mirror fetch): bounded attempts, exponential backoff,
and jitter, so hosts retrying one shared resource do not stampede in
lockstep.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
from typing import Callable, Optional, Tuple, Type

# Exit code of a watchdog hard exit and of a process that dies on a peer's
# failure: distinct from SIGKILL's 137 and from an ordinary failure's 1.
# 75 = EX_TEMPFAIL.
HARD_EXIT_CODE = 75


def arm_hard_exit(delay: float, reason: str) -> None:
    """Arm a daemon timer that ``os._exit(HARD_EXIT_CODE)``s the process
    ``delay`` seconds from now unless it exits on its own first: the last
    resort for a process stuck on its way out (a watchdog-expired
    collective's thread, a process-group teardown that dead peers never
    join). Announces itself on stderr."""
    t = threading.Timer(delay, lambda: os._exit(HARD_EXIT_CODE))
    t.daemon = True
    t.start()
    print(f"watchdog: {reason}; hard exit ({HARD_EXIT_CODE}) in {delay:g}s "
          f"unless the process unwinds first", file=sys.stderr, flush=True)


class WatchdogTimeout(RuntimeError):
    """A supervised call exceeded its deadline. ``already_agreed`` tells
    the agreed-exit protocol not to attempt a poison-pill exchange on the
    way out: the peers it would exchange with are the ones that failed to
    show up."""

    already_agreed = True

    def __init__(self, label: str, timeout: float) -> None:
        super().__init__(
            f"watchdog: {label} made no progress within {timeout:g}s")
        self.label = label
        self.timeout = timeout


def run_with_deadline(fn: Callable, *, timeout: float, label: str,
                      on_timeout: Optional[Callable[[], None]] = None,
                      hard_exit_after: Optional[float] = None):
    """Run ``fn()`` with a deadline; return its result or raise.

    ``timeout <= 0`` disables supervision: ``fn`` runs inline on the
    calling thread. On expiry: ``on_timeout()`` runs first (diagnostics;
    it must not block or raise), then, with ``hard_exit_after`` set, a
    hard-exit timer is armed, then ``WatchdogTimeout`` is raised. ``fn``'s
    own exception propagates unchanged when it finishes in time."""
    if not timeout or timeout <= 0:
        return fn()
    outcome: dict = {}

    def _body() -> None:
        try:
            outcome["result"] = fn()
        except BaseException as exc:  # propagated by the joiner below
            outcome["error"] = exc

    t = threading.Thread(target=_body, daemon=True, name=f"watchdog-{label}")
    t.start()
    t.join(timeout)
    if t.is_alive():
        if on_timeout is not None:
            try:
                on_timeout()
            except Exception as exc:  # diagnostics must never mask the abort
                print(f"watchdog: diagnostic dump for {label} failed: "
                      f"{exc!r}", file=sys.stderr, flush=True)
        if hard_exit_after and hard_exit_after > 0:
            arm_hard_exit(hard_exit_after, f"{label} timed out")
        raise WatchdogTimeout(label, timeout)
    if "error" in outcome:
        raise outcome["error"]
    return outcome.get("result")


def retry_with_backoff(
    fn: Callable,
    *,
    attempts: int,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    base_delay: float = 0.5,
    max_delay: float = 8.0,
    jitter: float = 0.5,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Optional[Callable[[float], None]] = None,
    rng: Optional[random.Random] = None,
):
    """Call ``fn()`` up to ``attempts`` times; return its first success.

    Retries only on ``retry_on`` exceptions (anything else propagates at
    once). The delay before retry ``k`` (1-based) is ``min(max_delay,
    base_delay * 2**(k-1))`` plus a uniform ``[0, jitter)`` draw.
    ``on_retry(attempt, exc, delay)`` observes each scheduled retry; the
    last failure re-raises unchanged."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if sleep is None:
        sleep = time.sleep  # late-bound: monkeypatched clocks apply
    draw = (rng or random).uniform
    last: Optional[BaseException] = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as exc:
            last = exc
            if attempt == attempts:
                raise
            delay = min(max_delay, base_delay * (2 ** (attempt - 1)))
            delay += draw(0.0, jitter) if jitter > 0 else 0.0
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
    raise last  # unreachable
