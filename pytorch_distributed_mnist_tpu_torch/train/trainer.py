"""Training engine.

Counterpart of ``pytorch_distributed_mnist_tpu/train/trainer.py``:
``train()`` and ``evaluate()`` each run one pass over this process's
shard and return ``(Average, Accuracy)`` meters. Every step's metrics
stay on the device and fold into one accumulator; the pass reads it back
once, its only host sync. On a data axis that reduces (a world of
processes, ``parallel/mesh.py::DataAxis``), every train step averages
the gradients over the axis, and the pass's accumulator is summed over
the axis (one all-reduce) before that read, so every rank prints the
world's metrics.

- ``scan`` (the default, as in the reference): each pass is an epoch
  program (``train/steps.py::EpochProgram``), on the card one CUDA graph
  of the step replayed per batch. With ``epoch_gather="host"`` the epoch
  is gathered on the host into a host buffer (pinned on the card) and
  copied into one device buffer; the next epoch's gather runs on a
  background thread, into the other of two host buffers, while this one
  trains (``prefetch_enabled``; ``close()`` joins it). With
  ``epoch_gather="device"`` the dataset crosses to the device once per
  run and each tick gathers its rows there. The eval set is staged on the
  device once and reused every pass.
- ``stepwise``: one eager step per batch, each batch copied to the device
  from pinned host memory by ``data/staging.py::BatchFeeder``: with
  ``feed_window`` 2 or more (and one process) batch N+1 is gathered and
  copied on a feeder thread while batch N's step runs; 1 stages inline.
- ``explicit``: as ``stepwise``, through ``parallel/collectives.py``'s
  explicit data-parallel steps (DDP's per-replica mean), whose metrics
  come back summed over the axis every step (the JAX explicit step's
  ``psum``).

``grad_accum`` splits every train step's batch into that many
micro-batches (``train/steps.py::train_step``), in ``scan`` and
``stepwise``; ``explicit`` refuses it, as the reference does, and so it
refuses ``aux_weight`` (the MoE's load-balance term in the objective)
and a ZeRO-placed state (``parallel/zero.py``). Under ZeRO-3 the whole
params are gathered from the shards before each eval pass;
``zero_overlap`` asks for the overlapped plane
(``parallel/zero_overlap.py``), whose carry is rebuilt before a train
pass when a load replaced the shards; ``zero_bucket_mb_dcn``, on a
two-tier mesh, must plan the cross-slice buckets the state was placed
with.

Under ``--debug-nans`` (``utils/debug_nans.py``) the per-batch modes run
every step under the NaN-checking dispatch mode; ``scan`` keeps a copy of
the train state from each pass's start on the device, and a pass whose
loss sum reads NaN is restored and re-run eagerly under the mode, which
raises at the op that made the NaN.

The run supervision's fault points (``runtime/supervision.py``) sit at
``train()``'s entry (``train_epoch``), before each step of the per-batch
modes (``train_step``; a scan pass replays the epoch with no host
boundary between steps) and at ``evaluate()``'s entry (``eval``).

On the card the trainer makes cuDNN deterministic (no benchmark search),
so a resumed run repeats the uninterrupted one, and under float32 compute
it turns TF32 off for convolutions and matrix products, so that float32
means float32. These settings are fixed before any graph is captured.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from pytorch_distributed_mnist_tpu_torch.data.loader import (
    MNISTDataLoader,
    to_device,
)
from pytorch_distributed_mnist_tpu_torch.data.staging import (
    BatchFeeder,
    PinnedRing,
    host_buffer,
)
from pytorch_distributed_mnist_tpu_torch.models.convert import state_leaves
from pytorch_distributed_mnist_tpu_torch.ops.metrics import (
    Accuracy,
    Average,
    MetricState,
    accumulate_metrics,
    metrics_init,
)
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    make_explicit_dp_eval_step,
    make_explicit_dp_train_step,
    metric_all_reduce,
)
from pytorch_distributed_mnist_tpu_torch.runtime.supervision import (
    maybe_fault,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    eval_step,
    make_eval_epoch,
    make_train_epoch,
    make_train_epoch_indexed,
    train_step,
)
from pytorch_distributed_mnist_tpu_torch.utils import debug_nans

MODES = ("scan", "stepwise", "explicit")
EPOCH_GATHERS = ("host", "device")


def _meters(ms: Optional[MetricState]) -> Tuple[Average, Accuracy]:
    """One device-to-host read: fold a MetricState into the meters.
    ``None`` (no batches) gives empty meters."""
    loss, acc = Average(), Accuracy()
    count = 0 if ms is None else int(ms.count)
    if count:
        loss.update(float(ms.loss_sum) / count, count)
        acc.update(int(ms.correct), count)
    return loss, acc


class Trainer:
    """Runs train and eval passes on this process's device, in ``mode``
    (``MODES``), on the data axis ``axis`` (None: one process)."""

    def __init__(self, state, train_loader: MNISTDataLoader,
                 test_loader: MNISTDataLoader, device: torch.device,
                 mode: str = "scan", epoch_gather: str = "host",
                 staging_log=None, axis=None, grad_accum: int = 1,
                 feed_window: int = 2, aux_weight: float = 0.0,
                 zero_overlap: bool = False,
                 zero_bucket_mb_dcn: float = 0.0) -> None:
        if mode not in MODES:
            raise ValueError(f"unknown trainer mode {mode!r} "
                             f"({', '.join(MODES)})")
        if grad_accum > 1 and mode == "explicit":
            raise ValueError("grad_accum does not compose with the explicit "
                             "mode; use scan or stepwise")
        if epoch_gather not in EPOCH_GATHERS:
            raise ValueError(f"unknown epoch_gather {epoch_gather!r}")
        if epoch_gather == "device" and mode != "scan":
            raise ValueError("epoch_gather='device' is a scan-mode path (the "
                             "gather runs inside the epoch program)")
        if aux_weight and mode == "explicit":
            raise ValueError("mode='explicit' does not support aux_weight; "
                             "use scan/stepwise")
        if zero_overlap:
            if state.zero is None or not state.zero.overlap:
                raise ValueError(
                    "zero_overlap requires the ZeRO state sharding "
                    "(parallel/zero.py shard_state_zero, overlap=True)")
            if mode == "explicit":
                raise ValueError(
                    "zero_overlap does not compose with mode='explicit' "
                    "(both own the mesh as one shard_map data axis)")
            if epoch_gather == "device":
                raise ValueError(
                    "zero_overlap requires epoch_gather='host' (the "
                    "overlapped step is not embedded in the device-gather "
                    "epoch program)")
            # On a two-tier mesh the cross-slice buckets' budget (0: as
            # placed), as the JAX Trainer builds its step with it.
            from pytorch_distributed_mnist_tpu_torch.parallel.zero_overlap \
                import check_dcn_budget

            check_dcn_budget(state, zero_bucket_mb_dcn)
        elif zero_bucket_mb_dcn:
            raise ValueError(
                "zero_bucket_mb_dcn sizes the zero_overlap schedule's "
                "cross-slice buckets; it requires zero_overlap")
        if mode == "explicit" and (state.zero is not None
                                   or state.placements):
            raise ValueError(
                "mode='explicit' is the replicated-DP shard_map path; "
                "use scan/stepwise with a sharded state")
        self.state = state
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.device = device
        self.mode = mode
        self.epoch_gather = epoch_gather
        self.staging_log = staging_log
        self.axis = axis
        # The next epoch's host gather runs on a thread while this one
        # trains (scan, host gather); the CLI turns it off for the last.
        self.prefetch_enabled = True
        self._prefetch = None  # (epoch, thread, buffer turn, holder)
        self._eval_batches: Optional[List[dict]] = None  # stepwise
        self._eval_staged: Optional[Dict[str, torch.Tensor]] = None
        self._host: Optional[PinnedRing] = None  # two epoch buffers
        self._device_epoch: Optional[Dict[str, torch.Tensor]] = None
        self._train_data: Optional[Dict[str, torch.Tensor]] = None
        self._ticks: Optional[Dict[str, torch.Tensor]] = None
        if device.type == "cuda":
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            if getattr(state.model, "compute_dtype", None) == torch.float32:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
        self._train_epoch = None
        self._eval_epoch = None
        self._feeder = None
        if mode == "scan":
            make = (make_train_epoch_indexed if epoch_gather == "device"
                    else make_train_epoch)
            self._train_epoch = make(state, axis, grad_accum=grad_accum,
                                     aux_weight=aux_weight)
            self._eval_epoch = make_eval_epoch(state)
        else:
            self._feeder = BatchFeeder(train_loader, device,
                                       window=feed_window,
                                       staging_log=staging_log)
        if mode == "explicit":
            self._train_step = make_explicit_dp_train_step(state, axis)
            self._eval_step = make_explicit_dp_eval_step(state, axis)
        else:
            self._train_step = lambda batch: train_step(
                state, batch, axis, grad_accum, aux_weight=aux_weight)
            self._eval_step = lambda batch: eval_step(state, batch)

    # -- host-gather staging (scan) ----------------------------------------

    def _take_host_buffer(self) -> int:
        """The next of the two host buffers (pinned on the card), once
        its last copy to the device has landed."""
        if self._host is None:
            loader, pin = self.train_loader, self.device.type == "cuda"
            lead = (loader.steps_per_epoch, loader.local_batch_size)
            self._host = PinnedRing(
                2, lambda: host_buffer(loader, lead, pin), pin)
        return self._host.take()

    def _gather(self, epoch: int, turn: int) -> None:
        self.train_loader.stacked_epoch(
            epoch, out={k: t.numpy()
                        for k, t in self._host.buffers[turn].items()})

    def _start_prefetch(self) -> None:
        """Gather the next epoch into the other host buffer on a thread
        while the device trains this one. The gather is the pure form
        (``stacked_epoch(epoch)``), so the sampler is never touched off
        the main thread; :meth:`_staged_train_epoch` uses it only if the
        sampler is on that epoch then."""
        epoch = self.train_loader.sampler.epoch + 1
        turn = self._take_host_buffer()
        holder = {}

        def work():
            t0 = time.perf_counter()
            try:
                self._gather(epoch, turn)
            except Exception as exc:  # re-raised where the epoch is used
                holder["error"] = exc
                return
            holder["host_ms"] = (time.perf_counter() - t0) * 1e3

        thread = threading.Thread(target=work, daemon=True,
                                  name="epoch-prefetch")
        thread.start()
        self._prefetch = (epoch, thread, turn, holder)

    def _staged_train_epoch(self) -> Dict[str, torch.Tensor]:
        """This epoch's batches in the device buffer: from the prefetch
        thread's host buffer when it gathered this epoch, else gathered
        now; then one copy to the device, queued on the stream the epoch
        program runs on."""
        epoch = self.train_loader.sampler.epoch
        t0 = time.perf_counter()
        turn, host_ms = None, None
        if self._prefetch is not None:
            p_epoch, thread, p_turn, holder = self._prefetch
            self._prefetch = None
            thread.join()
            if "error" in holder:
                raise holder["error"]
            if p_epoch == epoch:
                turn, host_ms = p_turn, holder["host_ms"]
        pipelined = turn is not None
        if not pipelined:
            turn = self._take_host_buffer()
            self._gather(epoch, turn)
            host_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        host = self._host.buffers[turn]
        if self._device_epoch is None:
            self._device_epoch = {k: torch.empty_like(t, device=self.device)
                                  for k, t in host.items()}
        for k, t in host.items():
            self._device_epoch[k].copy_(t, non_blocking=True)
        self._host.copied(turn)
        t2 = time.perf_counter()
        if self.staging_log is not None:
            self.staging_log.record_stage(
                host_ms=host_ms, h2d_ms=(t2 - t1) * 1e3,
                images=int(host["label"].numel()), pipelined=pipelined)
            # The trainer blocked for the join (or the whole gather) and
            # the copy's queueing.
            self.staging_log.record_wait((t2 - t0) * 1e3)
        return self._device_epoch

    def close(self) -> None:
        """Join and drop an in-flight epoch prefetch and the per-batch
        feeder's thread (idempotent); the CLI closes the trainer on every
        exit."""
        if self._prefetch is not None:
            _epoch, thread, _turn, _holder = self._prefetch
            self._prefetch = None
            thread.join()
        if self._feeder is not None:
            self._feeder.close()

    # -- passes ----------------------------------------------------------

    def _refresh_zero(self) -> None:
        """Before a train pass: rebuild the overlapped ZeRO-3 carry (the
        whole params gathered from the shards) if a checkpoint load or
        an outside install replaced the shards since it was gathered; a
        replayed graph gathers only at each step's tail."""
        zero = self.state.zero
        if zero is not None and zero.level == 3 and zero.stale:
            zero.gather_params()

    def _read(self, ms: MetricState) -> Tuple[Average, Accuracy]:
        """The pass's meters: its accumulator summed over the axis (the
        explicit steps summed theirs already), then read once."""
        if self.mode != "explicit":
            ms = metric_all_reduce(ms, self.axis)
        return _meters(ms)

    def _checked_pass(self, epoch, source, train: bool, then=None) \
            -> Tuple[Average, Accuracy]:
        """One scan pass of ``epoch`` (an epoch function of
        ``train/steps.py``) over ``source``, read once; ``then()``, when
        given, runs between the pass's launch and its read. Under
        ``--debug-nans`` the train state is copied first (on the device),
        and a NaN loss sum restores the copy and re-runs the pass eagerly
        under the checking mode, which raises at the op that made the
        NaN."""
        snapshot = None
        if debug_nans.enabled() and train:
            with torch.no_grad():
                snapshot = [t.clone() for _, t in state_leaves(self.state)]
        ms = epoch(*source)
        if then is not None:
            then()
        meters = self._read(ms)
        if debug_nans.enabled() and math.isnan(meters[0].sum):
            if snapshot is not None:
                with torch.no_grad():
                    for (_, t), saved in zip(state_leaves(self.state),
                                             snapshot):
                        t.copy_(saved)
            epoch.program.rerun_checked()
            raise FloatingPointError(
                "--debug-nans: the pass's loss sum is NaN, but its eager "
                "re-run made no NaN")
        return meters

    def train(self) -> Tuple[Average, Accuracy]:
        """One training epoch over the loader's current shuffle."""
        maybe_fault("train_epoch")
        self.state.model.train()
        self._refresh_zero()
        if self.mode != "scan":
            acc = metrics_init(self.device)
            with debug_nans.checking():
                for batch in self._feeder.epoch():
                    maybe_fault("train_step")
                    accumulate_metrics(acc, self._train_step(batch))
            return self._read(acc)
        if self.epoch_gather == "device":
            if self._train_data is None:
                # The dataset crosses to the device once per run.
                self._train_data = {
                    "image": torch.from_numpy(self.train_loader.images).to(
                        self.device),
                    "label": torch.from_numpy(self.train_loader.labels).to(
                        self.device)}
            idx, mask = self.train_loader.epoch_ticks()
            ticks = {"idx": torch.from_numpy(idx),
                     "mask": torch.from_numpy(mask)}
            if self._ticks is None:
                self._ticks = {k: torch.empty_like(t, device=self.device)
                               for k, t in ticks.items()}
            for k, t in ticks.items():
                self._ticks[k].copy_(t)
            return self._checked_pass(self._train_epoch,
                                      (self._train_data, self._ticks), True)
        return self._checked_pass(
            self._train_epoch, (self._staged_train_epoch(),), True,
            then=self._start_prefetch if self.prefetch_enabled else None)

    def evaluate(self) -> Tuple[Average, Accuracy]:
        """One evaluation pass: no gradient, no state update."""
        maybe_fault("eval")
        self.state.model.eval()
        zero = self.state.zero
        if zero is not None and zero.level == 3:
            # The eval forward reads the whole params: gather the shards.
            zero.gather_params()
        if self.mode == "scan":
            if self._eval_staged is None:
                # The eval set never reshuffles: stage it once.
                self._eval_staged = {
                    k: torch.from_numpy(v).to(self.device)
                    for k, v in self.test_loader.stacked_epoch().items()}
            return self._checked_pass(self._eval_epoch,
                                      (self._eval_staged,), False)
        if self._eval_batches is None:
            self._eval_batches = [to_device(batch, self.device)
                                  for batch in self.test_loader]
        acc = metrics_init(self.device)
        with debug_nans.checking():
            for batch in self._eval_batches:
                accumulate_metrics(acc, self._eval_step(batch))
        return self._read(acc)
