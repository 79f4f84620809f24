"""Pipelined host-to-device input staging for the per-batch trainer modes.

Counterpart of ``pytorch_distributed_mnist_tpu/data/staging.py``. The
scan trainer stages whole epochs; the per-batch modes (``stepwise``,
``explicit``) stage one batch a step. :class:`BatchFeeder` runs that
staging on a feeder thread: batch N+1's host gather (into a pinned host
buffer on the card) and its copy to the card (on a side CUDA stream)
overlap batch N's step, bounded by a window.

Window semantics, the reference's: ``window`` counts the batch the
consumer holds plus at most ``window - 1`` beyond it (staged or being
staged: the batch in the feeder's hands counts against the bound).
``window=1`` starts no thread: staging runs inline on the consumer
thread, the trainer's strict gather, copy, step alternation, bit for bit.
``window=2`` is double buffering.

Rules:

- **Purity.** The epoch's index matrix is snapshotted
  (``loader.epoch_ticks()``) on the consumer thread before the feeder
  starts; the feeder never reads the sampler, so a ``set_sample_epoch``
  between epochs cannot race it.
- **No collectives on the feeder thread.** A world of more than one
  process stays inline (``pipelined`` is false), as in the reference.
- **Buffers.** The ``window`` pinned host buffers are a
  :class:`PinnedRing`: each carries the event recorded after its copy to
  the card, and the feeder waits on it before it gathers into the buffer
  again, so a copy in flight is never overwritten (the scan trainer's
  two epoch buffers are a ring too). The consumer's stream waits on that
  event before it reads the batch, and each device tensor is marked as
  used on the consumer's stream (``record_stream``), so the caching
  allocator does not hand the side stream's memory out again before the
  consumer's work on it is done.
- **Same batches.** Both paths gather the same rows in the same order;
  pipelining changes when, never what.

Every stage records into a ``utils/profiling.py::StagingLog`` when one
is attached: host-gather ms, host-to-device ms (as queued) and how long
the consumer blocked.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.data.loader import to_device
from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    process_count,
)


def host_buffer(loader, lead: tuple, pin: bool) -> Dict[str, torch.Tensor]:
    """Empty host arrays of ``lead`` rows of ``loader``'s batches (image,
    label, mask), pinned for asynchronous copies to the card when
    ``pin``."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=pin)

    return {"image": empty(lead + loader.images.shape[1:],
                           torch.from_numpy(loader.images[:0]).dtype),
            "label": empty(lead, torch.int64),
            "mask": empty(lead, torch.float32)}


class PinnedRing:
    """``n`` host buffers handed out in turn, the one rule of their reuse
    in one place: a buffer carries the event recorded after its last copy
    to the card (:meth:`copied`), and :meth:`take` hands it out again only
    once that event has passed, so a gather never overwrites a copy in
    flight. Buffers off the card (``pin`` false) carry no event."""

    def __init__(self, n: int, make, pin: bool) -> None:
        self.buffers: List[Dict[str, torch.Tensor]] = [make()
                                                       for _ in range(n)]
        self._pin = pin
        self._copied: List[Optional[torch.cuda.Event]] = [None] * n
        self._turn = 0

    def take(self) -> int:
        """The next buffer's index, once its last copy has landed."""
        turn, self._turn = self._turn, (self._turn + 1) % len(self.buffers)
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()
        return turn

    def copied(self, turn: int) -> Optional[torch.cuda.Event]:
        """Mark buffer ``turn``'s copies, just queued on the current
        stream, as its last: returns their event (None off the card)."""
        if not self._pin:
            return None
        event = torch.cuda.Event()
        event.record()
        self._copied[turn] = event
        return event


class _Staged:
    """One batch staged by the feeder: its device tensors and, on the
    card, the event its copy recorded on the side stream."""

    def __init__(self, batch: Dict[str, torch.Tensor],
                 ready: Optional[torch.cuda.Event],
                 device: torch.device) -> None:
        self.batch = batch
        self.ready = ready
        self.device = device

    def take(self) -> Dict[str, torch.Tensor]:
        """The batch, usable on the consumer's current stream."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.ready)
            for t in self.batch.values():
                t.record_stream(stream)
        return self.batch


class _EpochRun:
    """One epoch's feeder thread and its bounded conduit of staged
    batches: a deque under one condition variable. The feeder stages
    outside the lock and appends under it; the consumer waits under it
    and pops. ``close()`` unblocks both sides, so an abandoned epoch
    never leaves a thread blocked on a full conduit."""

    def __init__(self, feeder: "BatchFeeder", m: np.ndarray,
                 mask: np.ndarray) -> None:
        self.feeder = feeder
        self._cv = threading.Condition()
        self._staged: collections.deque = collections.deque()
        self._error: Optional[BaseException] = None
        self._done = False
        self._cancelled = False
        self._thread = threading.Thread(
            target=self._feed, args=(m, mask), daemon=True,
            name="input-feeder")
        self._thread.start()

    def _feed(self, m: np.ndarray, mask: np.ndarray) -> None:
        feeder = self.feeder
        try:
            for row, mrow in zip(m, mask):
                # Room first: the batch being staged counts against the
                # window, so W keeps at most W - 1 beyond the consumer's.
                with self._cv:
                    while (len(self._staged) >= feeder.window - 1
                           and not self._cancelled):
                        self._cv.wait()
                    if self._cancelled:
                        return
                staged = feeder._stage_pipelined(row, mrow)
                with self._cv:
                    if self._cancelled:
                        return
                    self._staged.append(staged)
                    self._cv.notify_all()
        except BaseException as exc:  # noqa: BLE001 - re-raised at next_batch
            with self._cv:
                self._error = exc
                self._cv.notify_all()
        else:
            with self._cv:
                self._done = True
                self._cv.notify_all()

    def next_batch(self) -> Dict[str, torch.Tensor]:
        """The next staged batch, blocking until the feeder delivers it
        (the blocked time is recorded as the consumer's wait). Raises the
        feeder's error, or StopIteration once the epoch is drained or
        cancelled."""
        t0 = time.perf_counter()
        with self._cv:
            while not self._staged and not self._done \
                    and self._error is None and not self._cancelled:
                self._cv.wait()
            wait_ms = (time.perf_counter() - t0) * 1e3
            staged = None
            if self._staged:
                staged = self._staged.popleft()
                self._cv.notify_all()
            elif self._error is not None:
                raise self._error
        log = self.feeder.staging_log
        if log is not None:
            log.record_wait(wait_ms)
        if staged is None:
            raise StopIteration
        return staged.take()

    def close(self) -> None:
        """Cancel and join the feeder (idempotent)."""
        with self._cv:
            self._cancelled = True
            self._staged.clear()
            self._cv.notify_all()
        self._thread.join()


class BatchFeeder:
    """Host-to-device staging of one loader's batches on ``device``.

    ``epoch()`` yields the batches ``to_device(batch, device)`` gives for
    each batch of the loader's current sampler epoch, in the same order,
    with batch N+1's staging overlapped against the consumer's work on
    batch N when ``window > 1`` (and this is the only process)."""

    def __init__(self, loader, device: torch.device, window: int = 2,
                 staging_log=None) -> None:
        if window < 1:
            raise ValueError(f"feed window must be >= 1, got {window}")
        self.loader = loader
        self.device = device
        self.window = int(window)
        self.staging_log = staging_log
        self._active_run: Optional[_EpochRun] = None
        # The card's pinned host buffers (one per window slot) and the
        # side stream of their copies; made at the first pipelined epoch.
        self._ring: Optional[PinnedRing] = None
        self._side: Optional[torch.cuda.Stream] = None

    @property
    def pipelined(self) -> bool:
        """Whether epochs run the feeder thread: not at a window of 1, and
        not in a world of more than one process."""
        return self.window > 1 and process_count() == 1

    def _record(self, t0: float, t1: float, images: int,
                pipelined: bool) -> None:
        if self.staging_log is not None:
            self.staging_log.record_stage(
                host_ms=(t1 - t0) * 1e3,
                h2d_ms=(time.perf_counter() - t1) * 1e3, images=images,
                pipelined=pipelined)

    def _stage_host(self, row: np.ndarray, mrow: np.ndarray,
                    pipelined: bool) -> Dict[str, torch.Tensor]:
        """The trainer's own per-batch staging (``host_batch``, then
        ``to_device``), on the calling thread."""
        t0 = time.perf_counter()
        host = self.loader.host_batch(row, mrow)
        t1 = time.perf_counter()
        batch = to_device(host, self.device)
        self._record(t0, t1, len(row), pipelined=pipelined)
        return batch

    def _stage_pipelined(self, row: np.ndarray, mrow: np.ndarray) -> _Staged:
        """One batch on the feeder thread: on the card, gathered into a
        pinned buffer and copied on the side stream; on the CPU, the
        inline staging."""
        if self.device.type != "cuda":
            return _Staged(self._stage_host(row, mrow, pipelined=True),
                           None, self.device)
        t0 = time.perf_counter()
        loader = self.loader
        if self._ring is None:
            self._side = torch.cuda.Stream(self.device)
            self._ring = PinnedRing(
                self.window,
                lambda: host_buffer(loader, (loader.local_batch_size,),
                                    pin=True), pin=True)
        turn = self._ring.take()
        pinned = self._ring.buffers[turn]
        np.take(loader.images, row, axis=0, out=pinned["image"].numpy())
        np.take(loader.labels, row, out=pinned["label"].numpy())
        pinned["mask"].numpy()[...] = mrow
        t1 = time.perf_counter()
        with torch.cuda.stream(self._side):
            batch = {k: t.to(self.device, non_blocking=True)
                     for k, t in pinned.items()}
            ready = self._ring.copied(turn)
        self._record(t0, t1, len(row), pipelined=True)
        return _Staged(batch, ready, self.device)

    def epoch(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Iterate one epoch of staged batches. The index matrix is
        snapshotted here, on the consumer thread, before any feeder
        starts."""
        # An epoch abandoned by an exception may still hold its feeder
        # (the traceback keeps its generator alive): join it first.
        self.close()
        m, mask = self.loader.epoch_ticks()
        if not self.pipelined or len(m) == 0:
            return self._inline_epoch(m, mask)
        return self._pipelined_epoch(m, mask)

    def _inline_epoch(self, m: np.ndarray, mask: np.ndarray) \
            -> Iterator[Dict[str, torch.Tensor]]:
        """Window 1, or a world of processes: staging on the consumer
        thread, its whole wall recorded as the consumer's wait."""
        for row, mrow in zip(m, mask):
            t0 = time.perf_counter()
            batch = self._stage_host(row, mrow, pipelined=False)
            if self.staging_log is not None:
                self.staging_log.record_wait(
                    (time.perf_counter() - t0) * 1e3)
            yield batch

    def _pipelined_epoch(self, m: np.ndarray, mask: np.ndarray) \
            -> Iterator[Dict[str, torch.Tensor]]:
        run = _EpochRun(self, m, mask)
        self._active_run = run
        try:
            while True:
                try:
                    batch = run.next_batch()
                except StopIteration:
                    return
                yield batch
        finally:
            if self._active_run is run:
                self._active_run = None
            run.close()

    def close(self) -> None:
        """Cancel and join the in-flight epoch's feeder thread, if any
        (idempotent); the trainer's ``close()`` calls it."""
        run = self._active_run
        if run is not None:
            self._active_run = None
            run.close()
