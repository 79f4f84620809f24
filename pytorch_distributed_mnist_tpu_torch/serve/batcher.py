"""Dynamic micro-batching with a deadline and admission control.

The latency/throughput trade at the heart of serving: a single request
underfills even the smallest useful device batch, but waiting forever to
fill the largest one destroys tail latency. The batcher holds a
thread-safe queue; one worker thread coalesces whatever arrives within
``max_wait`` of the OLDEST waiting request — or until ``max_batch`` rows
are ready, whichever is first — and runs the engine once per formed
batch. Device work is serialized on the worker by construction (the
chips are one shared resource; concurrent forwards would only contend).

Overload is explicit, not emergent: the queue is bounded (``max_queue``
requests), and a submit against a full queue raises :class:`Overloaded`
immediately — the caller (HTTP layer) turns that into a 503. Without the
bound, a stalled or slow engine converts overload into unbounded queue
growth and minutes-long latency for every request already in line, which
is strictly worse than telling new arrivals to back off.

With a :class:`~pytorch_distributed_mnist_tpu_torch.serve.control.ShedPolicy`
attached, overload additionally becomes a POLICY instead of a coin
flip: each submit carries a priority class, the queue is priority-
ORDERED (``interactive`` ahead of ``batch`` ahead of ``best_effort``,
FIFO within a class), and each class has an admission watermark — a
fraction of ``max_queue`` past which THAT class is shed while more
urgent classes are still admitted. The raised :class:`Overloaded`
carries ``retry_after_s`` derived from the completion stage's measured
drain rate, so the 503 tells the client when capacity plausibly
exists. Without a policy (the default), every request is the default
class at watermark 1.0 and behavior is byte-identical to the
pre-policy batcher.

The worker is split into two stages. The **form/dispatch** stage
coalesces a batch and hands it to ``dispatch_fn`` — which, against the
engine/pool two-phase API, stages + pads the batch and ENQUEUES the
device execution without waiting (CUDA runs it asynchronously) — then
immediately forms the next batch. The **completion** stage pops
dispatched batches FIFO, blocks on ``complete_fn`` (the result fetch),
and delivers results, errors, and accounting exactly as the single
worker did. ``max_inflight`` bounds how many batches may sit between
dispatch and completion: batch N+1's host-side preprocessing/padding
overlaps batch N's device execution instead of serializing behind its
result fetch, and across a replica pool up to ``max_inflight`` batches
execute on different chips concurrently. ``max_inflight=1`` restores
strict dispatch→complete alternation — byte-for-byte the pre-pipelining
behavior — and the classic single-callable ``infer_fn`` form runs the
whole inference inside the dispatch stage, so stub-driven tests and the
single-device server are unchanged.

Per-request accounting: enqueue->batch-formed (queue wait) and
enqueue->result (total latency) land in the :class:`ServeLog` the server
exposes at ``/stats``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from pytorch_distributed_mnist_tpu_torch.serve.control import (
    DrainRate,
    PRIORITY_CLASSES,
    priority_rank,
)


class Overloaded(RuntimeError):
    """Admission control: the request queue is at capacity (or past this
    priority class's shed watermark); back off. ``retry_after_s`` (when
    known) is the drain-rate-derived hint the HTTP 503 forwards as
    ``Retry-After``."""

    def __init__(self, message: str,
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


class _Pending:
    """One submitted request riding the queue."""

    __slots__ = ("images", "rows", "event", "result", "error", "t_submit",
                 "t_batched", "abandoned", "klass", "rank", "seq",
                 "ckey", "cost", "waiters", "guard")

    def __init__(self, images: np.ndarray, rows: int,
                 klass: Optional[str] = None, rank: int = 0,
                 seq: int = 0, ckey: Optional[str] = None,
                 cost: float = 1.0, guard=None) -> None:
        self.images = images
        self.rows = rows
        self.klass = klass
        self.rank = rank
        self.seq = seq
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_batched = self.t_submit
        # In-flight collapsing (ISSUE 19): ``ckey`` is the request's
        # collapse key while it owns a slot in the batcher's inflight-key
        # map; ``waiters`` counts the callers (leader + collapsed
        # followers) whose result() is riding this pending, guarded by
        # ``guard`` (the batcher's _cv — shared, never a new lock).
        self.ckey = ckey
        self.cost = float(cost)
        self.waiters = 1
        self.guard = guard
        # Set when EVERY caller's result() wait timed out: still-queued
        # abandoned requests are dropped before execution (no device work
        # for an answer nobody will read, no phantom /stats samples, and
        # the queue slot frees for admission control).
        self.abandoned = False

    def finish(self, result: Optional[np.ndarray],
               error: Optional[BaseException], serve_log) -> None:
        self.result = result
        self.error = error
        if serve_log is not None and not self.abandoned:
            now = time.perf_counter()
            if self.guard is not None:
                with self.guard:
                    waiters = self.waiters
            else:
                waiters = self.waiters
            # One record per caller still waiting: a collapsed follower
            # is a served request exactly like a cache hit, so it must
            # count in the per-model/class totals even though only one
            # dispatch ran. waiters excludes callers that timed out
            # (result() decrements on timeout), which is the honest
            # count of replies actually delivered.
            for _ in range(max(1, waiters)):
                serve_log.record_request(
                    latency_s=now - self.t_submit,
                    queue_wait_s=self.t_batched - self.t_submit,
                    images=self.rows,
                    klass=self.klass,
                )
        self.event.set()


class MicroBatcher:
    """Coalesces concurrent requests into engine-sized batches.

    Two inference forms:

    - ``infer_fn(images) -> outputs`` maps a float/uint8 row-stack to a
      per-row output stack (first dims equal); the engine's ``predict``
      is the production value, but any callable works — the unit tests
      drive the state machine with stubs, no device or socket required.
      The whole call runs inside the dispatch stage (no pipelining gain,
      full behavioral compatibility).
    - ``dispatch_fn(images) -> handle`` + ``complete_fn(handle) ->
      outputs`` (passed together, ``infer_fn=None``): the two-phase form
      the engine/pool expose. Dispatch enqueues device work and returns
      immediately; completion blocks on the fetch — with
      ``max_inflight > 1`` the stages overlap.

    ``max_inflight`` bounds batches dispatched but not completed
    (default 1: strict alternation, the pre-pipelining behavior).
    """

    def __init__(
        self,
        infer_fn: Optional[Callable[[np.ndarray], np.ndarray]],
        max_batch: int,
        max_wait_s: float = 0.005,
        max_queue: int = 256,
        serve_log=None,
        dispatch_fn: Optional[Callable] = None,
        complete_fn: Optional[Callable] = None,
        max_inflight: int = 1,
        shed_policy=None,
        cost_model=None,
        priced: bool = False,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}")
        if (dispatch_fn is None) != (complete_fn is None):
            raise ValueError(
                "dispatch_fn and complete_fn come as a pair")
        if (infer_fn is None) == (dispatch_fn is None):
            raise ValueError(
                "exactly one of infer_fn or dispatch_fn/complete_fn "
                "is required")
        if infer_fn is not None:
            # Classic form: the full inference runs at dispatch; the
            # "handle" is already the output stack.
            dispatch_fn, complete_fn = infer_fn, lambda out: out
        self.infer_fn = infer_fn
        self.dispatch_fn = dispatch_fn
        self.complete_fn = complete_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        self.max_inflight = int(max_inflight)
        self.serve_log = serve_log
        # Priority shedding (serve/control.py): None keeps the classic
        # single-class admission (full queue = 503) and FIFO order.
        self.shed_policy = shed_policy
        # Request-path economics (serve/economics.py): with a CostModel
        # attached the completion stage feeds it measured batch walls
        # (the serve-time EWMA refresh); ``priced`` additionally switches
        # admission depth, drain rate, and Retry-After to COST units —
        # off (the default) is byte-identical to the count-based batcher.
        self.cost_model = cost_model
        self.priced = bool(priced)
        # Collapse map: collapse_key -> the live _Pending duplicates
        # join, guarded by _cv; entries leave before their event fires.
        self._inflight_keys = {}
        self.collapsed = 0
        self._queue_cost = 0.0
        # Completion-side requests/sec over a sliding window — the
        # denominator every Retry-After hint is derived from.
        self._drain = DrainRate()
        self._seq = 0
        self._cv = threading.Condition()
        self._queue: List[_Pending] = []
        self._stopped = False
        # dispatch -> completion conduit: (taken, handle, dispatch_error)
        # triples, FIFO; bounded by the _window semaphore, not the queue.
        self._inflight: "queue.Queue" = queue.Queue()
        self._window = threading.Semaphore(self.max_inflight)
        self._thread: Optional[threading.Thread] = None
        self._completion: Optional[threading.Thread] = None
        if serve_log is not None:
            serve_log.set_queue_depth_probe(self.queue_depth)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name="serve-batcher")
            self._completion = threading.Thread(
                target=self._completion_loop, daemon=True,
                name="serve-completion")
            self._thread.start()
            self._completion.start()
        return self

    def close(self) -> None:
        """Stop the workers; queued requests are drained first (formed,
        dispatched, completed) so a clean shutdown never strands a caller
        blocked on ``result``."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._completion is not None:
            self._completion.join()
            self._completion = None

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.close()

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def drain_rps(self) -> float:
        """Completed requests/sec over the drain window — what
        ``Retry-After`` hints are derived from."""
        return self._drain.rate()

    # -- producer side -----------------------------------------------------

    def submit(self, images, klass: Optional[str] = None,
               collapse_key: Optional[str] = None,
               cost: float = 1.0) -> _Pending:
        """Enqueue one request. ``images`` must be a row-stack whose first
        dim is the example count (the server preprocesses through
        ``engine.preprocess`` first, so row counting and concatenation
        are unambiguous); any row count is accepted — oversized batches
        ride alone and the engine chunks them. Raises :class:`Overloaded`
        when the queue is at capacity — admission control happens HERE,
        before any work is done for the request.

        ``klass`` is the request's priority class. ``None`` (a client
        that never spoke priorities) is TREATED as the most urgent
        class for ordering and admission — identical behavior to the
        pre-policy batcher — but stays ``None`` in the accounting, so
        a server whose clients never send priorities keeps the
        classless ``/stats`` schema (no ``classes`` block). With a
        shed policy attached, admission additionally applies the
        class's queue watermark and the queue is kept priority-ordered
        (FIFO within a class) — an interactive arrival overtakes every
        queued best_effort request.

        ``collapse_key`` opts into in-flight collapsing: a submit whose
        key matches a still-QUEUED (not yet dispatched, not abandoned)
        pending JOINS it — no new queue slot, no re-dispatch; the
        caller's ``result()`` rides the leader's event and sees the
        same result or error (error fan-out reaches every joiner
        exactly once, one raise per ``result()`` call). A follower
        still passes ADMISSION first, at its own price: count-mode
        depth counts every outstanding waiter (a collapsed client is
        still an outstanding client, so a byte-identical flood sheds
        at exactly the classic watermark), and quota accounting for
        the follower's CLIENT is the server's job before this call.
        Once a batch dispatches its key retires — a duplicate arriving
        mid-execution queues normally and is answered by the response
        cache one layer up after the leader completes. ``cost`` is the
        request's admission price in cost units (``priced`` batchers
        account queue depth, drain rate and Retry-After in these
        units; the default 1.0 per request is byte-identical to count
        accounting)."""
        arr = np.asarray(images)
        if arr.ndim < 2 or arr.shape[0] == 0:
            raise ValueError(
                f"submit expects a non-empty (rows, ...) stack of "
                f"examples; got shape {arr.shape}")
        effective = klass or PRIORITY_CLASSES[0]
        rank = priority_rank(effective)
        cost = float(cost)
        with self._cv:
            if self._stopped:
                raise RuntimeError("batcher is shut down")
            if self.priced:
                # Cost-unit depth: the queue's admitted cost plus this
                # request's price beyond the 1.0 a count would charge —
                # at cost 1.0 everywhere this IS the count depth. A
                # would-be follower checks at its own price too; if it
                # then joins, the queue's cost is untouched (it adds
                # no compute).
                depth = self._queue_cost + cost - 1.0
            else:
                # Outstanding-CLIENT depth: every waiter on a queued
                # pending counts — a collapsed follower is still an
                # outstanding request, so a byte-identical flood sheds
                # at exactly the watermark a distinct flood would.
                # Without collapsing this IS len(queue).
                depth = sum(p.waiters for p in self._queue)
            if self.shed_policy is not None:
                admitted = self.shed_policy.admits(
                    effective, depth, self.max_queue)
            else:
                admitted = depth < self.max_queue
            if not admitted:
                if self.serve_log is not None:
                    self.serve_log.record_rejection(klass=klass)
                if self.shed_policy is None:
                    raise Overloaded(
                        f"request queue full ({self.max_queue} pending)")
                limit = self.shed_policy.admit_depth(
                    effective, self.max_queue)
                retry_after = self.shed_policy.retry_after_s(
                    effective, depth, self.max_queue,
                    self._drain.rate(), incoming=cost if self.priced
                    else 1.0)
                raise Overloaded(
                    f"request queue past the {effective!r} admission "
                    f"watermark ({depth:g} pending, class limit {limit} "
                    f"of {self.max_queue})", retry_after_s=retry_after)
            if collapse_key is not None:
                # Admitted — now a duplicate of a still-queued pending
                # joins it instead of consuming a slot and a dispatch.
                leader = self._inflight_keys.get(collapse_key)
                if leader is not None and not leader.abandoned:
                    leader.waiters += 1
                    self.collapsed += 1
                    return leader
            pending = _Pending(arr, int(arr.shape[0]), klass=klass,
                               rank=rank, seq=self._seq,
                               ckey=collapse_key, cost=cost,
                               guard=self._cv)
            self._seq += 1
            if collapse_key is not None:
                self._inflight_keys[collapse_key] = pending
            # Priority insert, stable within a class: scan back from
            # the tail (same-or-more-urgent arrivals append in O(1),
            # the common case; an interactive request overtakes only
            # the less-urgent tail).
            i = len(self._queue)
            while i > 0 and self._queue[i - 1].rank > rank:
                i -= 1
            self._queue.insert(i, pending)
            self._queue_cost += cost
            self._cv.notify_all()
        return pending

    @staticmethod
    def result(pending: _Pending, timeout: Optional[float] = None):
        if not pending.event.wait(timeout):
            # This caller will never read the answer — but a collapsed
            # follower still might: only when the LAST waiter leaves is
            # the pending abandoned (then, if still queued, the worker
            # drops it instead of executing it; an already in-flight
            # batch can't be recalled from the device).
            if pending.guard is not None:
                with pending.guard:
                    pending.waiters -= 1
                    if pending.waiters <= 0:
                        pending.abandoned = True
            else:
                pending.abandoned = True
            raise TimeoutError("request did not complete in time")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def predict(self, images, timeout: Optional[float] = 30.0,
                klass: Optional[str] = None,
                collapse_key: Optional[str] = None, cost: float = 1.0):
        """Synchronous submit + wait — the HTTP handler's one call."""
        return self.result(
            self.submit(images, klass=klass, collapse_key=collapse_key,
                        cost=cost),
            timeout)

    # -- worker side -------------------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        """Block until work exists, then coalesce under the deadline.

        The deadline is anchored to the OLDEST request's submit time, so
        a trickle of arrivals cannot postpone the flush indefinitely; a
        full ``max_batch`` flushes immediately. Returns ``[]`` only when
        stopped with an empty queue."""
        def takeable_rows() -> int:
            """Rows the take loop below would ACTUALLY co-batch right
            now — same walk, same no-split rule, skipping abandoned
            entries. The flush trigger must use this, not a raw sum: a
            1-row request followed by an oversized one would otherwise
            'fill' the batch on paper and flush the 1-row alone with
            coalescing time still on the clock."""
            rows = 0
            dtype = None
            for p in self._queue:
                if p.abandoned:
                    continue
                if rows and (rows + p.rows > self.max_batch
                             or p.images.dtype != dtype):
                    break
                rows += p.rows
                dtype = p.images.dtype
                if rows >= self.max_batch:
                    break
            return rows

        with self._cv:
            while True:  # until a non-empty take, or stopped + drained
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if not self._queue:
                    return []
                # Anchored to the OLDEST waiting request (with priority
                # ordering the head is the most URGENT, not the oldest —
                # an interactive trickle must not reset a queued batch
                # request's clock).
                deadline = min(p.t_submit for p in self._queue) \
                    + self.max_wait_s
                while not self._stopped:
                    remaining = deadline - time.perf_counter()
                    if takeable_rows() >= self.max_batch or remaining <= 0:
                        break
                    self._cv.wait(remaining)
                taken, rows = [], 0
                while self._queue and rows < self.max_batch:
                    head = self._queue[0]
                    if head.abandoned:
                        # Every caller timed out and left: drop without
                        # executing (finish() skips stats for abandoned).
                        self._queue.pop(0)
                        self._queue_cost -= head.cost
                        if head.ckey is not None and \
                                self._inflight_keys.get(head.ckey) is head:
                            del self._inflight_keys[head.ckey]
                        head.finish(None, TimeoutError("abandoned"),
                                    self.serve_log)
                        continue
                    # Never split one request across batches: results map
                    # back by whole slices. A request bigger than
                    # max_batch rides alone (the engine chunks it through
                    # the top bucket). Never MIX dtypes either: with the
                    # fused serve plane, raw uint8 requests ride the
                    # preprocess passthrough next to already-normalized
                    # float ones, and np.concatenate's promotion would
                    # silently reinterpret 0-255 bytes as normalized
                    # pixels — a dtype change flushes the batch instead.
                    if taken and (rows + head.rows > self.max_batch
                                  or head.images.dtype
                                  != taken[0].images.dtype):
                        break
                    self._queue.pop(0)
                    self._queue_cost -= head.cost
                    if head.ckey is not None and \
                            self._inflight_keys.get(head.ckey) is head:
                        # Collapse window closes AT DISPATCH: a
                        # duplicate arriving mid-execution queues
                        # normally (and the response cache answers it
                        # after this batch completes) — it must never
                        # ride a result that predates a param swap.
                        del self._inflight_keys[head.ckey]
                    taken.append(head)
                    rows += head.rows
                if not self._queue:
                    self._queue_cost = 0.0  # re-zero any float drift
                if not taken:
                    continue  # everything seen was abandoned: wait again
                t = time.perf_counter()
                for p in taken:
                    p.t_batched = t
                return taken

    def _dispatch_loop(self) -> None:
        """Form/dispatch stage: coalesce a batch, hand it to
        ``dispatch_fn`` (which enqueues device work and returns — or, in
        the classic ``infer_fn`` form, runs the whole inference), and
        immediately form the next one. The ``_window`` semaphore holds
        dispatch ``max_inflight`` batches ahead of completion at most;
        with a window of 1 this loop alternates with completion exactly
        like the original single worker."""
        try:
            while True:
                self._window.acquire()
                taken = self._take_batch()
                if not taken:
                    self._window.release()
                    return  # stopped and drained
                handle, error = None, None
                try:
                    # Concatenation inside the try: co-batched requests
                    # with mismatched trailing shapes (submit validates
                    # only ndim) must become per-request errors, not a
                    # dead worker.
                    images = (taken[0].images if len(taken) == 1
                              else np.concatenate(
                                  [p.images for p in taken], axis=0))
                    handle = self.dispatch_fn(images)
                except BaseException as exc:  # noqa: BLE001 - per-request
                    error = exc
                self._inflight.put((taken, handle, error))
        finally:
            # ALWAYS hand completion its shutdown sentinel — a dispatch
            # thread dying any other way would otherwise leave close()
            # blocked forever on the completion join.
            self._inflight.put(None)

    def _completion_loop(self) -> None:
        """Completion stage: pop dispatched batches FIFO, block on the
        result fetch, deliver results/errors/accounting per request —
        exactly what the tail of the original worker loop did."""
        while True:
            item = self._inflight.get()
            if item is None:
                return
            taken, handle, error = item
            try:
                self._complete_batch(taken, handle, error)
            finally:
                self._window.release()

    def _complete_batch(self, taken: List[_Pending], handle,
                        error) -> None:
        out = None
        if error is None:
            # Validation INSIDE the try: a malformed return (0-d array,
            # wrong row count) must become a per-request error — an
            # exception escaping here would kill the completion thread
            # and wedge close() behind the window semaphore.
            try:
                out = np.asarray(self.complete_fn(handle))
                rows = sum(p.rows for p in taken)
                if out.ndim == 0 or out.shape[0] != rows:
                    which = ("infer_fn" if self.infer_fn is not None
                             else "complete_fn")
                    raise RuntimeError(
                        f"{which} returned "
                        f"{'a scalar' if out.ndim == 0 else out.shape[0]}"
                        f" row(s) for {rows} inputs")
            except BaseException as exc:  # noqa: BLE001 - per-request delivery
                error = exc
        if error is not None:
            for p in taken:
                p.finish(None, error, self.serve_log)
            return
        if self.cost_model is not None:
            # Serve-time EWMA refresh of the per-bucket cost table: the
            # measured wall from batch formation to delivered results.
            self.cost_model.observe(
                sum(p.rows for p in taken),
                time.perf_counter() - taken[0].t_batched)
        off = 0
        for p in taken:
            p.finish(out[off:off + p.rows], None, self.serve_log)
            off += p.rows
        # Completed requests feed the drain-rate estimate Retry-After
        # hints divide by (errors excluded: a failing plane is not
        # drain capacity). Priced batchers drain COST units, so the
        # hint says when the drained cost plausibly re-admits, not the
        # drained request count.
        self._drain.note(sum(p.cost for p in taken) if self.priced
                         else len(taken))
