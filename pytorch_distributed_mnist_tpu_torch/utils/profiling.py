"""Observability of the port: the training :class:`StepTimer`, the JSONL
metrics sink, the scan trainer's :class:`StagingLog`, the
:class:`ServeLog` behind ``/stats``, the per-bucket warm-up record,
:func:`step_part`, which names the part of a train step a device kernel
is (a step profile's breakdown; the collectives' kernels are a part of
their own), and ``--profile-dir``'s :func:`profile_trace` with the
lifecycle spans of :func:`phase`, the run supervision's
:class:`EventLog` (``failure_events``) and the build and capture record
:class:`CompileLog` (``compile_log``).

Counterpart of the training-input and serving parts of
``pytorch_distributed_mnist_tpu/utils/profiling.py``. The reference's
``CompileLog`` block of ``/stats`` (the AOT compile of each bucket
program) becomes :class:`WarmupLog`:
PyTorch compiles nothing, so what is recorded per bucket is the wall time
of its first forward (which, on the int8 plane, includes the one-time
build of the CUDA kernel library).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple


# Substrings of the collectives' device kernels (NCCL's
# ``ncclDevKernel_AllReduce_...`` and the like), matched case-blind.
COLLECTIVE_KERNELS = ("nccl",)


def step_part(kernel: str, own: Sequence[Tuple[str, str]] = ()) -> str:
    """A device kernel's part of a train step, by its name: ``collective``
    for the collectives' kernels; the part that ``own`` (``(name, part)``
    pairs: the port's own kernels) gives the first name the kernel's
    holds; else ``copy``, ``conv``, ``fc_gemm`` or ``other_elementwise``
    by the library kernels' names."""
    name = kernel.lower()
    if any(s in name for s in COLLECTIVE_KERNELS):
        return "collective"
    for own_name, part in own:
        if own_name in name:
            return part
    if "memcpy" in name or "memset" in name:
        return "copy"
    if any(s in name for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                               "implicit", "winograd")):
        return "conv"
    if any(s in name for s in ("gemm", "gemv", "nvjet", "cutlass", "cublas")):
        return "fc_gemm"
    return "other_elementwise"


def trace_path(logdir: str, rank: int) -> str:
    """Where :func:`profile_trace` writes rank ``rank``'s trace."""
    return os.path.join(logdir, f"trace_rank{rank}.json")


@contextlib.contextmanager
def profile_trace(logdir: Optional[str], cuda: bool = False):
    """A ``torch.profiler`` capture of the block (the host's ops and, with
    ``cuda``, the card's kernels, replays of captured graphs included),
    written to ``logdir`` as a Chrome trace, one file per rank
    (:func:`trace_path`); nothing when ``logdir`` is empty. The
    reference's ``jax.profiler`` trace of ``--profile-dir``."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
        process_index,
    )

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(trace_path(logdir, process_index()))


def phase(name: str, **fields):
    """A named span of one lifecycle phase (``train``, ``eval``,
    ``checkpoint``, ``checkpoint_drain``), its fields (the epoch) as the
    span's arguments: ``torch.profiler.record_function``, which costs
    next to nothing outside a capture. The reference's
    ``TraceAnnotation`` spans."""
    import torch

    args = ", ".join(f"{k}={v}" for k, v in fields.items()) or None
    return torch.profiler.record_function(name, args)


class StepTimer:
    """Throughput meter over explicitly measured phases: only wall time
    inside ``measure(...)`` counts, so eval and checkpoint time between
    epochs do not dilute the training rate. The caller makes sure the
    device work is done before a block exits (the trainer reads its
    metrics back inside it)."""

    def __init__(self) -> None:
        self.images = 0
        self.seconds = 0.0
        self.last_images = 0
        self.last_seconds = 0.0

    @contextlib.contextmanager
    def measure(self, images: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.last_seconds = time.perf_counter() - t0
            self.last_images = images
            self.seconds += self.last_seconds
            self.images += images

    @property
    def images_per_sec(self) -> float:
        return self.images / max(self.seconds, 1e-9)

    @property
    def last_images_per_sec(self) -> float:
        """Rate of the most recent measured phase only."""
        return self.last_images / max(self.last_seconds, 1e-9)


class JsonlSink:
    """Append-only JSONL file shared by every metrics producer.

    One line per record, written atomically under a lock (the serve
    batcher worker and the reload watcher record from their own threads).
    ``--metrics-file`` resolves to ONE of these per process, in the same
    line format as the reference's, so one consumer reads both.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._warned = False
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def write(self, record: Dict) -> None:
        """Append one record; raises on I/O failure."""
        line = json.dumps(record)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")

    def try_write(self, record: Dict) -> bool:
        """Best-effort append for callers on failure/supervision paths:
        a metrics-disk error (ENOSPC/EIO — plausible exactly when the
        run is already failing) must never mask the event being
        reported or break the agreed-exit machinery. Warns once."""
        try:
            self.write(record)
            return True
        except OSError as exc:
            with self._lock:
                first, self._warned = not self._warned, True
            if first:
                import sys

                print(f"WARNING: metrics sink {self.path!r} write failed "
                      f"({exc!r}); further events stay in memory only",
                      file=sys.stderr, flush=True)
            return False


class StagingLog:
    """Where feeding the device spends its time, and how much of it is
    hidden behind the device's work: the reference's ``StagingLog``.

    The scan trainer records one :meth:`record_stage` per staged epoch:
    the host gather (the permuted copy into a host buffer) and the
    host-to-device copy, and whether the prefetch thread ran the gather.
    The consumer records how long it blocked waiting for the staged
    epoch (:meth:`record_wait`). ``overlap_fraction`` = 1 - waited /
    staging time: 0 when every staging millisecond stalls the trainer,
    near 1 when the prefetch hides it. The host-to-device copy is timed
    as queued, not as landed, so ``feed_images_per_sec`` is an upper
    bound. Thread-safe: the prefetch thread and the trainer both
    record."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stages = 0
        self._pipelined_stages = 0
        self._host_ms = 0.0
        self._h2d_ms = 0.0
        self._images = 0
        self._wait_ms = 0.0

    def record_stage(self, host_ms: float, h2d_ms: float, images: int,
                     pipelined: bool) -> None:
        """One staged epoch: host-gather wall, host-to-device wall, the
        images it carried, and whether the prefetch thread gathered it."""
        with self._lock:
            self._stages += 1
            self._pipelined_stages += int(pipelined)
            self._host_ms += host_ms
            self._h2d_ms += h2d_ms
            self._images += images

    def record_wait(self, wait_ms: float) -> None:
        """The trainer's blocked time for one staged epoch."""
        with self._lock:
            self._wait_ms += wait_ms

    def summary(self) -> Dict:
        """Totals so far; all zero when nothing was recorded."""
        with self._lock:
            staging_ms = self._host_ms + self._h2d_ms
            overlap = 0.0
            if staging_ms > 0:
                overlap = max(0.0, min(1.0, 1.0 - self._wait_ms / staging_ms))
            return {
                "stages": self._stages,
                "pipelined_stages": self._pipelined_stages,
                "host_ms": round(self._host_ms, 1),
                "h2d_ms": round(self._h2d_ms, 1),
                "consumer_wait_ms": round(self._wait_ms, 1),
                "overlap_fraction": round(overlap, 4),
                "images": self._images,
                "feed_images_per_sec": round(
                    self._images / max(staging_ms / 1e3, 1e-9), 1)
                if self._images else 0.0,
            }


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (0 when empty).
    Nearest-rank (not interpolated) so p99 of a small sample is a latency
    that actually happened, never an optimistic blend."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


class ServeLog:
    """Serving observability: latency quantiles, batch-size histogram,
    queue depth, admission-control rejections, and hot reloads.

    The batcher worker records per-request latency, the engine records each
    executed bucket, the HTTP layer records rejections, and the reload
    watcher records checkpoint swaps — ``snapshot()`` is the ``/stats``
    payload. Thread-safe throughout (requests complete on the batcher
    worker thread while ``/stats`` reads from HTTP handler threads).

    Latency samples live in a bounded deque (recent-window quantiles, no
    unbounded growth under sustained load). With a :class:`JsonlSink`
    attached, ``write_stats()`` appends a ``{"kind": "serve_stats", ...}``
    snapshot line — the same ``--metrics-file`` stream training writes its
    epoch rows and failure events to.

    Two schema-ADDITIVE planes ride the same log:

    - a **rolling window** (``window_s``, default 60s): every snapshot
      carries a ``window`` block — p50/p95/p99 and requests/sec over
      the last ``window_s`` seconds ONLY — because the lifetime
      quantiles the block sits next to converge to history and cannot
      see current load (the autoscaler and an operator mid-incident
      both need "now", not "since boot"). ``window_stats()`` is the
      cheap probe the autoscaler samples.
    - **per-class counters** (priority serving): requests recorded with
      a ``klass`` land per-class latency quantiles, shed (503) and
      quota (429) counts in a ``classes`` block — present only when a
      class was ever recorded, so the single-class schema is unchanged.
    """

    #: Rolling-window sample bounds: latency samples and request
    #: timestamps kept for the window quantiles/rps. At 60s these cap
    #: the honest window at ~1k rps sustained — beyond that the window
    #: rps undercounts (documented, bounded memory wins).
    WINDOW_SAMPLES = 8192
    WINDOW_TIMES = 65536

    def __init__(self, max_samples: int = 8192,
                 window_s: float = 60.0) -> None:
        self._lock = threading.Lock()
        self._max_samples = max_samples
        self.window_s = float(window_s)
        self._now = time.monotonic  # overridable clock (tests)
        self._sink: Optional[JsonlSink] = None
        self._source = "serve"
        self._queue_depth_probe: Optional[Callable[[], int]] = None
        self._replicas_probe: Optional[Callable[[], Dict]] = None
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._latency = collections.deque(maxlen=self._max_samples)
            self._queue_wait = collections.deque(maxlen=self._max_samples)
            self._batch_hist: Dict[int, int] = {}
            self._counts = {"requests": 0, "images": 0, "batches": 0,
                            "rejected": 0, "reloads": 0,
                            "reload_failures": 0}
            # Rolling window: (t, latency_s) samples + bare timestamps
            # (for rps), pruned past window_s at record/snapshot time.
            self._win = collections.deque(maxlen=self.WINDOW_SAMPLES)
            self._win_times = collections.deque(maxlen=self.WINDOW_TIMES)
            self._t_reset = self._now()
            # Per-priority-class accounting (priority serving only):
            # stays empty — and out of the snapshot — when no request
            # ever carried a class.
            self._classes: Dict[str, Dict] = {}
            # Per-engine execution counters, keyed by the engine's name
            # (a pool's replica ``r0``, or a precision-named engine such
            # as ``int8``); empty when the engine is unnamed.
            self._replica_counts: Dict[str, Dict] = {}

    def set_sink(self, sink: Optional[JsonlSink],
                 source: str = "serve") -> None:
        with self._lock:
            self._sink = sink
            self._source = source

    def set_queue_depth_probe(self, probe: Optional[Callable[[], int]]) -> None:
        """Register a live queue-depth callable (the batcher's); read at
        snapshot time so ``/stats`` shows the instantaneous depth."""
        with self._lock:
            self._queue_depth_probe = probe

    def set_replicas_probe(self, probe: Optional[Callable[[], Dict]]) -> None:
        """Register the pool's per-replica snapshot callable (device,
        serving epoch, in-flight count per replica); merged into this
        log's per-replica batch counters at snapshot time so ``/stats``
        and the JSONL ``serve_stats`` lines carry one row per replica."""
        with self._lock:
            self._replicas_probe = probe

    # -- recorders (each from its owning thread) --------------------------

    def _class_rec(self, klass: str) -> Dict:
        """Per-class record (caller holds the lock)."""
        rec = self._classes.get(klass)
        if rec is None:
            rec = self._classes[klass] = {
                "requests": 0, "images": 0, "shed": 0,
                "quota_rejected": 0,
                "latency": collections.deque(maxlen=4096),
            }
        return rec

    def record_request(self, latency_s: float, queue_wait_s: float = 0.0,
                       images: int = 1,
                       klass: Optional[str] = None) -> None:
        now = self._now()
        with self._lock:
            self._counts["requests"] += 1
            self._counts["images"] += images
            self._latency.append(latency_s)
            self._queue_wait.append(queue_wait_s)
            self._win.append((now, latency_s))
            self._win_times.append(now)
            if klass is not None:
                rec = self._class_rec(klass)
                rec["requests"] += 1
                rec["images"] += images
                rec["latency"].append(latency_s)

    def _prune_window(self, now: float) -> None:
        """Drop window samples older than ``window_s`` (lock held)."""
        cutoff = now - self.window_s
        while self._win and self._win[0][0] < cutoff:
            self._win.popleft()
        while self._win_times and self._win_times[0] < cutoff:
            self._win_times.popleft()

    def window_stats(self) -> Dict:
        """The rolling-window block: latency quantiles + rps over the
        last ``window_s`` seconds only. Cheap enough to sample on the
        autoscaler's interval; also merged into every ``snapshot()``."""
        now = self._now()
        with self._lock:
            self._prune_window(now)
            lat = [s for _, s in self._win]
            n_requests = len(self._win_times)
            t_reset = self._t_reset
            probe = self._queue_depth_probe
        # The honest span: the full window once one has elapsed, the
        # log's lifetime before that (a fresh boot's rps must neither
        # be diluted over a window it hasn't lived nor inflated over
        # the microseconds since its first request), floored at 1s.
        span = max(1.0, min(self.window_s, now - t_reset))
        stats = self._quantiles(lat)
        depth = 0
        if probe is not None:
            try:
                depth = int(probe())
            except Exception:  # noqa: BLE001 - stats must never raise
                depth = -1
        return {
            "seconds": self.window_s,
            "rps": round(n_requests / span, 2),
            "queue_depth": depth,
            "p50_ms": stats["p50"], "p95_ms": stats["p95"],
            "p99_ms": stats["p99"], "count": stats["count"],
        }

    def record_batch(self, rows: int, bucket: int,
                     replica: Optional[str] = None) -> None:
        """One executed forward program: ``rows`` real examples padded up
        to ``bucket``, on ``replica`` (None = the single-engine plane)."""
        with self._lock:
            self._counts["batches"] += 1
            self._batch_hist[bucket] = self._batch_hist.get(bucket, 0) + 1
            if replica is not None:
                rec = self._replica_counts.setdefault(
                    replica, {"batches": 0, "images": 0,
                              "batch_histogram": {}})
                rec["batches"] += 1
                rec["images"] += rows
                hist = rec["batch_histogram"]
                hist[bucket] = hist.get(bucket, 0) + 1

    def record_rejection(self, klass: Optional[str] = None,
                         quota: bool = False) -> None:
        """One shed (503) or — with ``quota=True`` — one per-client
        quota refusal (429). Quota refusals never touch the lifetime
        ``rejected`` counter: they are the CLIENT's overload, not the
        server's, and conflating them would make the admission-control
        history unreadable."""
        with self._lock:
            if not quota:
                self._counts["rejected"] += 1
            if klass is not None:
                rec = self._class_rec(klass)
                rec["quota_rejected" if quota else "shed"] += 1

    def record_reload(self, path: str, epoch: int) -> None:
        with self._lock:
            self._counts["reloads"] += 1
            sink, source = self._sink, self._source
        if sink is not None:
            sink.try_write({"t": round(time.time(), 3),
                            "kind": "serve_reload", "path": path,
                            "epoch": epoch, "source": source})

    def record_reload_failure(self, path: str, detail: str) -> None:
        with self._lock:
            self._counts["reload_failures"] += 1
            sink, source = self._sink, self._source
        if sink is not None:
            sink.try_write({"t": round(time.time(), 3),
                            "kind": "serve_reload_failed", "path": path,
                            "detail": detail, "source": source})

    def record_pool_event(self, kind: str, **fields) -> None:
        """Sink-only serve lifecycle line (``serve_quarantine`` /
        ``serve_regroup`` / ``serve_resize``, and the shadow canary's
        ``serve_canary`` promote/rollback/reset transitions): the
        counters live in the pool's ``topology()`` / the canary's
        ``snapshot()`` blocks (surfaced via ``/stats``), so the
        single-engine snapshot schema stays untouched — this just lands
        the event in the shared ``--metrics-file`` stream next to the
        reloads it rides with."""
        with self._lock:
            sink, source = self._sink, self._source
        if sink is not None:
            sink.try_write({"t": round(time.time(), 3), "kind": kind,
                            "source": source, **fields})

    # -- consumers --------------------------------------------------------

    @staticmethod
    def _quantiles(samples) -> Dict[str, float]:
        vals = sorted(samples)
        ms = lambda s: round(s * 1e3, 3)  # noqa: E731
        return {
            "p50": ms(_percentile(vals, 0.50)),
            "p95": ms(_percentile(vals, 0.95)),
            "p99": ms(_percentile(vals, 0.99)),
            "mean": ms(sum(vals) / len(vals)) if vals else 0.0,
            "max": ms(vals[-1]) if vals else 0.0,
            "count": len(vals),
        }

    def snapshot(self) -> Dict:
        with self._lock:
            counts = dict(self._counts)
            latency = list(self._latency)
            queue_wait = list(self._queue_wait)
            hist = {str(k): v for k, v in sorted(self._batch_hist.items())}
            probe = self._queue_depth_probe
            replicas_probe = self._replicas_probe
            classes = {
                klass: {
                    "requests": rec["requests"],
                    "images": rec["images"],
                    "shed": rec["shed"],
                    "quota_rejected": rec["quota_rejected"],
                    "latency_ms": self._quantiles(list(rec["latency"])),
                }
                for klass, rec in sorted(self._classes.items())
            }
            replicas = {name: {**rec,
                               "batch_histogram": {
                                   str(k): v for k, v in
                                   sorted(rec["batch_histogram"].items())}}
                        for name, rec in self._replica_counts.items()}
        if replicas_probe is not None:
            try:
                for name, row in replicas_probe().items():
                    replicas.setdefault(
                        name, {"batches": 0, "images": 0,
                               "batch_histogram": {}}).update(row)
            except Exception:  # noqa: BLE001 - stats must never raise
                pass
        depth = 0
        if probe is not None:
            try:
                depth = int(probe())
            except Exception:  # noqa: BLE001 - stats must never raise
                depth = -1
        snap = {
            **counts,
            "queue_depth": depth,
            "latency_ms": self._quantiles(latency),
            "queue_wait_ms": self._quantiles(queue_wait),
            "batch_histogram": hist,
            # Rolling-window block (schema-ADDITIVE next to the
            # lifetime quantiles): what the load looks like NOW.
            "window": self.window_stats(),
        }
        # Per-priority-class rows appear only once a request carried a
        # class (priority serving) — classless servers' schema is
        # unchanged beyond the window block.
        if classes:
            snap["classes"] = classes
        # Per-engine rows appear only for a named engine or a pool.
        if replicas:
            snap["replicas"] = {k: replicas[k] for k in sorted(replicas)}
        return snap

    def write_stats(self, **extra) -> Dict:
        """Snapshot + append it to the attached sink (no-op without one);
        returns the snapshot either way."""
        snap = self.snapshot()
        with self._lock:
            sink, source = self._sink, self._source
        if sink is not None:
            sink.try_write({"t": round(time.time(), 3),
                            "kind": "serve_stats", "source": source,
                            **snap, **extra})
        return snap


class WarmupLog:
    """Per-program warm-up record: wall ms of each measured block (one
    per serving bucket and plane), keyed by program name. Each engine
    owns one; ``/stats`` reads it. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._programs: Dict[str, Dict] = {}

    @contextlib.contextmanager
    def measure(self, program: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                rec = self._programs.setdefault(
                    program, {"runs": 0, "wall_ms": 0.0})
                rec["runs"] += 1
                rec["wall_ms"] = round(rec["wall_ms"] + wall_ms, 3)

    def stats(self) -> Dict:
        with self._lock:
            programs = {k: dict(v) for k, v in sorted(self._programs.items())}
        return {"programs": programs,
                "totals": {"runs": sum(v["runs"] for v in programs.values()),
                           "wall_ms": round(sum(v["wall_ms"] for v in
                                                programs.values()), 3)}}

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()


class EventLog:
    """Append-only log of supervision and failure events for the run
    summary: the reference's ``EventLog``.

    The run-supervision layer (``runtime/supervision.py``) records every
    watchdog trip, poison pill sent or undelivered, retry, quarantine and
    world rebuild here, and ``cli.run`` returns the snapshot as the
    summary's ``failure_events``. With a :class:`JsonlSink` attached
    (``set_sink``), every event is also appended to the sink as it
    happens (the ``--metrics-file`` stream), tagged with ``source``.
    Thread-safe: watchdog timers and the checkpoint writer record from
    their own threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events = []
        self._sink: Optional[JsonlSink] = None
        self._source = "train"

    def set_sink(self, sink: Optional[JsonlSink],
                 source: str = "train") -> None:
        """Attach (or detach, ``None``) the JSONL sink; ``source`` stamps
        each mirrored line."""
        with self._lock:
            self._sink = sink
            self._source = source

    def record(self, kind: str, detail: str, **fields) -> Dict:
        event = {"t": round(time.time(), 3), "kind": kind,
                 "detail": detail, **fields}
        with self._lock:
            self._events.append(event)
            sink, source = self._sink, self._source
        if sink is not None:
            # try_write: recording runs inside poison-pill delivery and
            # watchdog escalation, where a sink error must mask nothing.
            sink.try_write({**event, "source": source})
        return event

    def snapshot(self) -> list:
        with self._lock:
            return [dict(e) for e in self._events]

    def reset(self) -> None:
        """Clear the events and detach the sink (a later run in the same
        process reports its own events, to its own file)."""
        with self._lock:
            self._events.clear()
            self._sink = None
            self._source = "train"


# One run, one failure story; cli.run resets it at entry.
failure_events = EventLog()


def record_world_shrunk(old_members, new_members, generation) -> Dict:
    """The elastic runtime's shrink event (``runtime/elastic.py``): this
    run is the world rebuilt after a host loss. Old and new membership
    (stable host ids) and the generation go to the summary's
    ``failure_events`` and, through the sink, the metrics JSONL."""
    old_members, new_members = list(old_members), list(new_members)
    return failure_events.record(
        "world_shrunk",
        f"world shrank from {len(old_members)} to {len(new_members)} "
        f"host(s) at generation {int(generation)}: members {old_members} "
        f"-> {new_members}; resumed from the last published checkpoint",
        old_members=old_members, new_members=new_members,
        generation=int(generation))


def record_world_grown(old_members, new_members, generation) -> Dict:
    """The grow mirror of :func:`record_world_shrunk`: the world rebuilt
    after a join rendezvous admitted a returned or replacement host."""
    old_members, new_members = list(old_members), list(new_members)
    return failure_events.record(
        "world_grown",
        f"world grew from {len(old_members)} to {len(new_members)} "
        f"host(s) at generation {int(generation)}: members {old_members} "
        f"-> {new_members}; resumed from the last published checkpoint",
        old_members=old_members, new_members=new_members,
        generation=int(generation))


class CompileLog:
    """What a run compiled: the reference's ``CompileLog``. PyTorch
    compiles no programs; what the port builds is its libraries (one
    ``nvcc`` per CUDA kernel source, ``ops/cuda_build.py``, and the
    native host library, ``data/native.py``), and what it captures is
    CUDA graphs (``train/steps.py::EpochProgram``). Each build records its
    wall seconds, or that an earlier build in the build directory was
    reused; each capture its wall seconds. ``cli.run`` resets it at entry
    and returns :meth:`stats` as the summary's ``compile_stats``.
    Thread-safe: the precompile thread builds beside the main one."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._builds: Dict[str, Dict] = {}
        self._captures: Dict[str, Dict] = {}

    def record_build(self, name: str, seconds: float, built: bool) -> None:
        with self._lock:
            rec = self._builds.setdefault(
                name, {"built": 0, "reused": 0, "seconds": 0.0})
            rec["built" if built else "reused"] += 1
            rec["seconds"] = round(rec["seconds"] + seconds, 3)

    def record_capture(self, name: str, seconds: float) -> None:
        with self._lock:
            rec = self._captures.setdefault(name, {"captures": 0,
                                                   "seconds": 0.0})
            rec["captures"] += 1
            rec["seconds"] = round(rec["seconds"] + seconds, 3)

    def stats(self) -> Dict:
        with self._lock:
            builds = {k: dict(v) for k, v in sorted(self._builds.items())}
            captures = {k: dict(v) for k, v in sorted(self._captures.items())}
        return {"builds": builds, "captures": captures,
                "built": sum(v["built"] for v in builds.values()),
                "reused": sum(v["reused"] for v in builds.values()),
                "graph_captures": sum(v["captures"]
                                      for v in captures.values())}

    def reset(self) -> None:
        with self._lock:
            self._builds.clear()
            self._captures.clear()


# Builds and captures happen wherever a library is first loaded or a pass
# first replayed; one log per process, reset by cli.run.
compile_log = CompileLog()
