"""The serving data plane over several replicas: one engine per device, or
one engine per mesh group.

Counterpart of ``pytorch_distributed_mnist_tpu/serve/pool.py``. A single
:class:`~pytorch_distributed_mnist_tpu_torch.serve.engine.InferenceEngine`
drives one device; the pool owns one :class:`EngineReplica` per device
(its own model module, params placed there, every bucket warmed) behind a
dispatcher that hands each formed batch to the least-loaded replica. MNIST
inference is parallel across batches, so no collective runs on the serve
path.

Dispatch is two-phase, as the engine's: ``dispatch`` picks a replica and
enqueues the batch on its device (the card runs it asynchronously) and
counts it in flight; ``complete`` waits for that batch's event and
releases the count. The pipelined batcher dispatches from its worker and
completes from its completion thread, so up to ``max_inflight`` batches
run at once across the replicas while the host stages the next one.

A hot reload fans out: the watcher loads a checkpoint once on the host,
the pool quantizes it once, and ``swap_params`` installs it per replica,
each under the engine's ordering rule (an older checkpoint never installs
over a newer one). Each batch reports the epoch of the params that
computed it, captured under its replica's lock.

**Self-healing.** A replica's failure is a lifecycle, not an outage:

- **Attribution.** Every dispatch or completion error lands on the replica
  that raised it. Input-shaped errors (``ValueError``, ``TypeError``: the
  request's fault) are exempt: malformed requests never condemn a healthy
  replica.
- **Failover, never a drop.** The failed batch is dispatched again on
  another healthy replica (the handle keeps the rows for it); only when
  no healthy replica is left does the error reach the caller.
- **Quarantine.** ``quarantine_after`` consecutive failures (any success
  resets the count) quarantine the replica: dispatch and the reload
  fan-out skip it.
- **Regroup.** A background thread builds a fresh engine on the
  replica's own device, warms it outside the pool lock (traffic keeps
  flowing on the healthy replicas), installs it atomically under the
  lock and bumps ``topology_generation``. A failed rebuild retries with
  backoff; an unhealable replica stays quarantined and says so. On the
  card the rebuild is on the card: no replica is ever moved to the CPU.

``resize()`` is the same machinery on purpose: build and warm the new
layout while the old one serves, swap the replica list atomically, and
let in-flight batches complete on the engines their handles hold.
``topology()`` is what ``/stats`` and ``loadgen --expect-groups`` read.

**Sharded and staged plane** (``serve_mode`` other than replicated): a
sharded engine spans a mesh, so the pool partitions its devices into
``mesh_size``-device GROUPS (``serve/programs.py::partition_groups``,
slice-major under an emulated slice map) and builds one engine per group
through ``build_group_engine``: a ``tensor`` or ``expert`` group is a
sharded ``InferenceEngine``, a ``pipeline`` group a chain of stage
programs (``serve/pipeline.py``). Everything above the engine is
group-agnostic: least-loaded dispatch picks among groups, quarantine and
regroup take a WHOLE group or chain (a chain with a dead stage serves
nothing), the reload fan-out installs the one host-side load per group
(a pipeline's engines split and quantize it per stage themselves), and
the names are ``{mode}[.g{i}][.{prec}]`` (``{mode}`` alone when one
group spans the pool). ``resize(mesh_size=)`` re-shapes the groups; the
mode itself is fixed at boot. On the card the pool's groups may repeat a
device (``[cuda:0, cuda:0]``: two shards, or two stages, on one card).

The reference's
``fused_staging_retired`` counts donated staging buffers; the port reuses
its buffers after their copy's event instead of donating them, and the
pool's observable of the same lifecycle is :meth:`EnginePool.
staging_allocated` (buffers ever allocated, summed over the replicas).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    InferenceEngine,
    _InFlightBatch,
    sum_staging,
)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
    device_slice_map,
)
from pytorch_distributed_mnist_tpu_torch.serve.programs import (
    REPLICATED,
    build_group_engine,
    get_precision,
    group_name,
    partition_groups,
    precision_engine_name,
    staged_mode,
    validate_serve_mode,
)
from pytorch_distributed_mnist_tpu_torch.utils.device import (
    local_devices,
    resolve_device,
)
from pytorch_distributed_mnist_tpu_torch.utils.profiling import WarmupLog

# Fault injection for the serve plane: "GROUP[:AFTER]" makes replica
# GROUP's dispatch raise after AFTER successful dispatches, the
# single-process stand-in for its device dying under it (the rebuilt
# generation serves cleanly). ``tools/chaos.py`` spells the same name.
SERVE_FAULT_ENV = "TPUMNIST_SERVE_FAULT"


def _parse_serve_fault(spec: str) -> Optional[Tuple[int, int]]:
    spec = spec.strip()
    if not spec:
        return None
    parts = spec.split(":")
    try:
        group = int(parts[0])
        after = int(parts[1]) if len(parts) > 1 else 0
        if len(parts) > 2:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"bad {SERVE_FAULT_ENV} spec {spec!r}: expected "
            f"GROUP_INDEX[:AFTER_N_BATCHES]") from None
    return group, after


def _is_input_error(exc: BaseException) -> bool:
    """Errors the REQUEST caused (shape or dtype validation), not the
    replica: they neither count toward quarantine nor fail over (another
    replica would refuse the same rows the same way)."""
    return isinstance(exc, (ValueError, TypeError))


class EngineReplica:
    """One engine pinned to one device, with the pool's bookkeeping for
    it. ``pending`` and the counters belong to the POOL's lock: placement
    needs one consistent view over every replica. ``generation`` counts
    rebuilds (0 = the boot engine)."""

    __slots__ = ("index", "name", "device", "devices", "engine", "pending",
                 "dispatched", "completed", "failures",
                 "consecutive_failures", "quarantined", "generation")

    def __init__(self, index: int, device, engine: InferenceEngine,
                 name: Optional[str] = None, devices=None) -> None:
        self.index = index
        self.name = name if name is not None else f"r{index}"
        self.device = device
        # The engine's whole span: the one device on the replicated
        # plane, the mesh group (or the chain, stage k on device k) on
        # the sharded one.
        self.devices = tuple(devices) if devices is not None else (device,)
        self.engine = engine
        self.pending = 0  # in-flight batches
        self.dispatched = 0  # lifetime batches assigned
        self.completed = 0  # lifetime batches fetched
        self.failures = 0  # lifetime attributed errors
        self.consecutive_failures = 0  # reset by any success
        self.quarantined = False  # skipped by dispatch and the fan-out
        self.generation = 0  # rebuilds of this replica


class _PoolHandle:
    """An in-flight batch, the replica that owns it, and the rows
    themselves, so a completion failure can fail the batch over instead
    of dropping it."""

    __slots__ = ("replica", "inflight", "images")

    def __init__(self, replica: EngineReplica,
                 inflight: _InFlightBatch, images) -> None:
        self.replica = replica
        self.inflight = inflight
        self.images = images


class EnginePool:
    """N engine replicas over N devices (or N / mesh_size mesh groups)
    behind a least-loaded dispatcher.

    ``model_factory()`` returns a fresh model module per replica (the
    engine's forward swaps the module's parameters for the length of a
    call, so replicas never share one); ``params`` maps its parameter
    names to float32 host arrays (the pipelined tree under
    ``serve_mode="pipeline"``). A sharded ``serve_mode`` needs
    ``model_name`` (the rule tables are per model family) and takes
    ``mesh_size`` devices per group. ``devices`` defaults to every visible
    card (:func:`~pytorch_distributed_mnist_tpu_torch.utils.device.
    local_devices`); a device may repeat (two replicas sharing one card).
    Every replica of a pool is on one device type.

    Exposes the surface the server and the reload watcher use on a bare
    engine (``preprocess``, ``buckets``, ``max_batch``, ``params_epoch``,
    ``swap_params``, ``add_swap_hook``, ``warmup``), so a pool drops in
    wherever one engine did.
    """

    def __init__(
        self,
        model_factory: Callable[[], torch.nn.Module],
        params,
        devices: Optional[Sequence] = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        input_shape: Tuple[int, ...] = (28, 28, 1),
        serve_log=None,
        params_epoch: Optional[int] = None,
        workers: int = 4,
        serve_mode: str = REPLICATED,
        mesh_size: int = 1,
        model_name: Optional[str] = None,
        quarantine_after: int = 3,
        auto_regroup: bool = True,
        regroup_retries: int = 3,
        precision: Optional[str] = None,
        name_prefix: str = "",
        fuse: bool = False,
        warmup_log: Optional[WarmupLog] = None,
    ) -> None:
        devices = [resolve_device(d) for d in devices] \
            if devices is not None else local_devices("cuda")
        if not devices:
            raise ValueError("EnginePool needs at least one device")
        kinds = {d.type for d in devices}
        if len(kinds) != 1:
            raise ValueError(f"a pool's replicas share one device type; "
                             f"got {[str(d) for d in devices]}")
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}")
        self.model_factory = model_factory
        self.serve_log = serve_log
        self.serve_mode = serve_mode
        self.mesh_size = int(mesh_size)
        self.model_name = model_name
        self.staged = staged_mode(serve_mode)
        self.device_type = kinds.pop()
        self.input_shape = tuple(input_shape)
        self.workers = workers
        self.n_devices = len(devices)
        # Replica name prefix (multi-model serving: ``cnn.r0`` beside
        # ``vit.r0``), so /stats rows and warm-up records stay per model.
        self.name_prefix = name_prefix
        self.quarantine_after = quarantine_after
        self.auto_regroup = auto_regroup
        self.regroup_retries = regroup_retries
        self._buckets = tuple(buckets)
        # One precision per pool: every replica runs it, and the reload
        # fan-out quantizes the one host load once (_params_host stays
        # the raw tree a regroup or resize builds from).
        self._precision_spec = get_precision(precision)
        self.precision = self._precision_spec.name
        self.fuse = bool(fuse)
        self.warmup_log = warmup_log if warmup_log is not None \
            else WarmupLog()
        self._injected_fault = _parse_serve_fault(
            os.environ.get(SERVE_FAULT_ENV, ""))
        self._lock = threading.Lock()
        # The latest host-side params and epoch of any fan-out: what a
        # rebuilt replica boots on, never the boot checkpoint after a hot
        # reload moved the fleet on.
        self._params_host = params
        self._params_host_epoch = params_epoch
        # Run under the pool lock after a whole reload fan-out (the
        # response cache's generation bump). O(1) work only.
        self._swap_hooks: List[Callable] = []
        self._topology_generation = 0
        self._regroups = 0
        self._failovers = 0
        self._resizing = False
        self.replicas: List[EngineReplica] = self._make_replicas(
            devices, self.mesh_size, params, params_epoch)
        if serve_log is not None:
            serve_log.set_replicas_probe(self.snapshot)

    def _build_engine(self, devices: Tuple, name: str, params,
                      params_epoch: Optional[int]) -> InferenceEngine:
        """One fresh engine over ``devices`` (one device on the
        replicated plane, a mesh group or a chain on the sharded one):
        the boot layout, a regroup and a resize all build through here,
        so they cannot drift."""
        if self.serve_mode != REPLICATED:
            return build_group_engine(
                self.serve_mode, self.model_name, list(devices), params,
                name, model=self.model_factory(), buckets=self._buckets,
                input_shape=self.input_shape, serve_log=self.serve_log,
                params_epoch=params_epoch, workers=self.workers,
                precision=self.precision, fuse=self.fuse,
                warmup_log=self.warmup_log)
        return InferenceEngine(
            self.model_factory(), params, buckets=self._buckets,
            input_shape=self.input_shape, serve_log=self.serve_log,
            params_epoch=params_epoch, name=name, precision=self.precision,
            fuse=self.fuse, device=devices[0], workers=self.workers,
            warmup_log=self.warmup_log)

    def _make_replicas(self, devices: List, mesh_size: int, params,
                       params_epoch: Optional[int]) -> List[EngineReplica]:
        """One generation of replicas over ``devices`` (the boot layout
        and every :meth:`resize` target): one per device, or on the
        sharded plane one per ``mesh_size``-device group.
        ``serve/programs.py`` owns the validity checks and the group
        engines, so the pool names no mode."""
        replicas = []
        if self.serve_mode != REPLICATED:
            if self.model_name is None:
                raise ValueError(
                    f"serve_mode {self.serve_mode!r} needs model_name= "
                    f"(the mode's rule table is per model family)")
            validate_serve_mode(self.serve_mode, self.model_name,
                                mesh_size, params)
            groups = partition_groups(devices, mesh_size)
            for i, group in enumerate(groups):
                name = precision_engine_name(
                    self.name_prefix
                    + group_name(self.serve_mode, i, len(groups)),
                    self.precision)
                replicas.append(EngineReplica(
                    i, group[0], self._build_engine(group, name, params,
                                                    params_epoch),
                    name=name, devices=group))
            return replicas
        if mesh_size != 1:
            raise ValueError(
                "replicated serving runs one engine per chip; a "
                f"{mesh_size}-device mesh needs a sharded serve_mode")
        for i, device in enumerate(devices):
            name = precision_engine_name(f"{self.name_prefix}r{i}",
                                         self.precision)
            replicas.append(EngineReplica(
                i, device, self._build_engine((device,), name, params,
                                              params_epoch), name=name))
        return replicas

    # -- engine-compatible surface ----------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def buckets(self):
        return self.replicas[0].engine.buckets

    @property
    def max_batch(self) -> int:
        return self.replicas[0].engine.max_batch

    @property
    def params_epoch(self) -> Optional[int]:
        """The fleet's serving epoch: replica 0's (replicas disagree only
        while a fan-out is mid-walk)."""
        return self.replicas[0].engine.params_epoch

    def preprocess(self, images) -> np.ndarray:
        return self.replicas[0].engine.preprocess(images)

    def warmup(self) -> None:
        """Warm every replica's buckets, the replicas in parallel."""
        self._warm(self.replicas)

    @staticmethod
    def _warm(replicas: Sequence[EngineReplica]) -> None:
        errors: List[BaseException] = []

        def _one(replica: EngineReplica) -> None:
            try:
                replica.engine.warmup()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=_one, args=(r,), daemon=True,
                                    name=f"pool-warmup-{r.name}")
                   for r in replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def swap_params(self, params, epoch: Optional[int] = None,
                    path: Optional[str] = None) -> int:
        """Fan one host-side load out to every healthy replica. Each
        replica applies the ordering rule under its own lock, so a stale
        fan-out racing a newer one never downgrades a replica.
        Quarantined replicas are skipped: their rebuild installs the
        pool's latest params. Returns the number of replicas that
        installed (0: stale everywhere)."""
        with self._lock:
            stale = (epoch is not None
                     and self._params_host_epoch is not None
                     and epoch < self._params_host_epoch)
            if not stale:
                self._params_host = params
                self._params_host_epoch = epoch
            replicas = [r for r in self.replicas if not r.quarantined]
        if stale:
            return 0
        # Quantize once per publish, not once per replica: an engine's
        # install-time quantize passes QuantLeaf leaves through. A staged
        # mode's engines quantize per stage slice after splitting (the
        # split runs on the float32 tree), so they get the raw tree.
        if not self.staged:
            params = self._precision_spec.quantize(params,
                                                   workers=self.workers)
        installed = 0
        for replica in replicas:
            if replica.engine.swap_params(params, epoch=epoch, path=path):
                installed += 1
        # After the whole fan-out: anything probed after this bump is
        # computed on replicas that all hold the new params.
        with self._lock:
            for hook in self._swap_hooks:
                hook(epoch)
        return installed

    def add_swap_hook(self, hook: Callable) -> None:
        """``hook(epoch)`` runs under the pool lock after each fan-out."""
        with self._lock:
            self._swap_hooks.append(hook)

    # -- dispatch / complete ----------------------------------------------

    def dispatch(self, images) -> _PoolHandle:
        """Enqueue one formed batch on the least-loaded healthy replica
        (returns before the device is done). A replica whose dispatch
        raises is attributed and excluded, and the batch fails over to
        the next healthy one; the caller sees an error only when none is
        left."""
        return self._dispatch_excluding(images, set())

    def _dispatch_excluding(self, images, exclude: set) -> _PoolHandle:
        while True:
            with self._lock:
                candidates = [r for r in self.replicas
                              if not r.quarantined and r not in exclude]
                if not candidates:
                    quarantined = [r.name for r in self.replicas
                                   if r.quarantined]
                    raise RuntimeError(
                        f"no healthy replica to dispatch to "
                        f"({len(self.replicas)} replica(s), quarantined "
                        f"{quarantined}"
                        + (f", {len(exclude)} failed for this batch"
                           if exclude else "")
                        + "); regroup in progress — retry")
                replica = min(candidates,
                              key=lambda r: (r.pending, r.index))
                replica.pending += 1
                replica.dispatched += 1
                injected = (
                    self._injected_fault is not None
                    and replica.generation == 0
                    and replica.index == self._injected_fault[0]
                    and replica.dispatched > self._injected_fault[1])
            try:
                if injected:
                    raise RuntimeError(
                        f"injected serve fault on {replica.name} "
                        f"({SERVE_FAULT_ENV}): this replica's device is "
                        f"'dead' until the regroup rebuilds it")
                inflight = replica.engine.dispatch_logits(images)
            except BaseException as exc:  # noqa: BLE001 - attributed below
                with self._lock:
                    replica.pending -= 1
                if _is_input_error(exc):
                    raise  # the request's fault: no attribution
                self._note_failure(replica, exc, "dispatch")
                exclude.add(replica)
                with self._lock:
                    self._failovers += 1
                continue
            return _PoolHandle(replica, inflight, images)

    def complete(self, handle: _PoolHandle) \
            -> Tuple[np.ndarray, Optional[int]]:
        """Wait for one dispatched batch: ``(logits (N, classes), epoch)``.
        A completion failure is attributed and the batch fails over,
        dispatched again whole on a healthy replica (from this, the
        completion thread: an engine's dispatch may run on any thread);
        only with no healthy replica left does the error reach the
        caller."""
        current = handle
        exclude: set = set()
        while True:
            try:
                out = current.inflight.complete()
            except BaseException as exc:  # noqa: BLE001 - attributed below
                with self._lock:
                    current.replica.pending -= 1
                if _is_input_error(exc):
                    raise
                self._note_failure(current.replica, exc, "complete")
                exclude.add(current.replica)
                with self._lock:
                    self._failovers += 1
                current = self._dispatch_excluding(handle.images, exclude)
                continue
            with self._lock:
                current.replica.pending -= 1
                current.replica.completed += 1
                current.replica.consecutive_failures = 0
            return out

    def predict_complete(self, handle: _PoolHandle) \
            -> Tuple[np.ndarray, Optional[int]]:
        """``complete`` + host-side argmax: ``(labels (N,), epoch)``."""
        logits, epoch = self.complete(handle)
        return np.argmax(logits, axis=-1), epoch

    # -- self-healing ------------------------------------------------------

    def _note_failure(self, replica: EngineReplica, exc: BaseException,
                      stage: str) -> None:
        """Attribute one error to its replica and walk the quarantine
        threshold. Counters under the pool lock; logging, events and the
        rebuild thread's start outside it."""
        with self._lock:
            replica.failures += 1
            replica.consecutive_failures += 1
            quarantine = (not replica.quarantined
                          and replica.consecutive_failures
                          >= self.quarantine_after)
            if quarantine:
                replica.quarantined = True
                self._topology_generation += 1
        print(f"serve pool: {stage} failed on {replica.name} "
              f"({replica.consecutive_failures} consecutive): {exc!r}",
              flush=True)
        if not quarantine:
            return
        print(f"serve pool: QUARANTINED {replica.name} after "
              f"{self.quarantine_after} consecutive failures; dispatch "
              f"skips it"
              + ("; rebuilding it on its device in the background"
                 if self.auto_regroup else ""), flush=True)
        if self.serve_log is not None:
            self.serve_log.record_pool_event(
                "serve_quarantine", group=replica.name,
                consecutive_failures=replica.consecutive_failures,
                error=repr(exc)[:300])
        if self.auto_regroup:
            threading.Thread(
                target=self._regroup, args=(replica,), daemon=True,
                name=f"pool-regroup-{replica.name}").start()

    def _regroup(self, replica: EngineReplica) -> None:
        """Rebuild one quarantined replica on its own device: fresh
        engine, warmed, installed atomically under the pool lock, while
        traffic flows on the healthy replicas. Retries with backoff; an
        unhealable replica stays quarantined, loudly."""
        for attempt in range(self.regroup_retries):
            try:
                with self._lock:
                    params = self._params_host
                    epoch = self._params_host_epoch
                engine = self._build_engine(replica.devices, replica.name,
                                            params, epoch)
                engine.warmup()
            except BaseException as exc:  # noqa: BLE001 - retried, never fatal
                print(f"serve pool: regroup of {replica.name} failed "
                      f"(attempt {attempt + 1}/{self.regroup_retries}): "
                      f"{exc!r}", flush=True)
                time.sleep(0.2 * (attempt + 1))
                continue
            with self._lock:
                replica.engine = engine
                replica.quarantined = False
                replica.consecutive_failures = 0
                replica.generation += 1
                self._regroups += 1
                self._topology_generation += 1
                generation = replica.generation
                if (self._injected_fault is not None
                        and replica.index == self._injected_fault[0]):
                    # The injected death is spent once its replica is
                    # rebuilt: a later resize's fresh generation-0
                    # replica at the same index must not die again.
                    self._injected_fault = None
                params = self._params_host
                epoch = self._params_host_epoch
            # A hot reload may have landed during the build and warm-up:
            # the stale-refusing swap makes this catch-up idempotent.
            engine.swap_params(params, epoch=epoch)
            print(f"serve pool: REGROUPED {replica.name} (generation "
                  f"{generation}) from its {len(replica.devices)} "
                  f"device(s) {[str(d) for d in replica.devices]}; back "
                  f"in dispatch", flush=True)
            if self.serve_log is not None:
                self.serve_log.record_pool_event(
                    "serve_regroup", group=replica.name,
                    generation=generation)
            return
        print(f"serve pool: giving up on {replica.name} after "
              f"{self.regroup_retries} rebuild attempts; it stays "
              f"quarantined (resize or restart to recover its device)",
              flush=True)

    # -- resize ------------------------------------------------------------

    def resize(self, n_devices: Optional[int] = None,
               mesh_size: Optional[int] = None,
               devices: Optional[Sequence] = None) -> dict:
        """Re-shape the pool under live traffic to ``n_devices`` devices
        (0: every local device) over ``devices`` (default: the local
        devices of the pool's type), and on the sharded plane to
        ``mesh_size`` devices per group (0: one group over all of them;
        it must divide ``n_devices``). The new layout is built and warmed
        while the old one serves; the swap is one atomic replica-list
        install; in-flight batches complete on the old engines their
        handles hold. Returns ``{"old": topology, "new": topology}``. One
        resize at a time (a concurrent call raises ``RuntimeError``); the
        replicated pool has no mesh (``mesh_size`` other than 1 is
        refused), and the serve mode is fixed at boot."""
        with self._lock:
            if self._resizing:
                raise RuntimeError("a resize is already in progress")
            self._resizing = True
            params = self._params_host
            epoch = self._params_host_epoch
            old = self._topology_locked()
        try:
            local = [resolve_device(d) for d in devices] \
                if devices is not None else local_devices(self.device_type)
            n = self.n_devices if n_devices is None else int(n_devices)
            if n == 0:
                n = len(local)
            if n < 1 or n > len(local):
                raise ValueError(
                    f"resize to {n} device(s): this host has "
                    f"{len(local)} local device(s)")
            mesh = self.mesh_size if mesh_size is None else int(mesh_size)
            if self.serve_mode != REPLICATED:
                if mesh == 0:
                    mesh = n
                if n % mesh:
                    raise ValueError(
                        f"serve_mesh {mesh} must divide serve_devices "
                        f"{n} (the pool runs one spanning engine per "
                        f"mesh group)")
                validate_serve_mode(self.serve_mode, self.model_name,
                                    mesh, params)
            else:
                if mesh not in (0, 1):
                    raise ValueError(
                        "replicated serving has no mesh to resize; "
                        "serve_mesh must stay 1")
                mesh = 1
            if {d.type for d in local[:n]} != {self.device_type}:
                raise ValueError(
                    f"resize onto {[str(d) for d in local[:n]]}: this "
                    f"pool's replicas are on {self.device_type}")
            new_replicas = self._make_replicas(local[:n], mesh, params,
                                               epoch)
            self._warm(new_replicas)
            with self._lock:
                self.replicas = new_replicas
                self.n_devices = n
                self.mesh_size = mesh
                self._topology_generation += 1
                # The injection targets the BOOT layout only.
                self._injected_fault = None
                new = self._topology_locked()
                params = self._params_host
                epoch = self._params_host_epoch
            # Latest-params catch-up, as in a regroup.
            for replica in new_replicas:
                replica.engine.swap_params(params, epoch=epoch)
            print(f"serve pool: RESIZED {old['groups']} group(s) x "
                  f"{old['mesh_devices']} -> {new['groups']} group(s) x "
                  f"{new['mesh_devices']} (topology generation "
                  f"{new['topology_generation']}); in-flight batches "
                  f"drain on the old engines", flush=True)
            if self.serve_log is not None:
                self.serve_log.record_pool_event(
                    "serve_resize", old=old, new=new)
            return {"old": old, "new": new}
        finally:
            with self._lock:
                self._resizing = False

    # -- observability -----------------------------------------------------

    def _topology_locked(self) -> dict:
        quarantined = [r.name for r in self.replicas if r.quarantined]
        topo = {
            "topology_generation": self._topology_generation,
            "serve_mode": self.serve_mode,
            "serve_precision": self.precision,
            "fused": self.fuse,
            "serve_devices": self.n_devices,
            "mesh_devices": self.mesh_size,
            "groups": len(self.replicas),
            "active_groups": len(self.replicas) - len(quarantined),
            "quarantined_groups": quarantined,
            "regroups": self._regroups,
            "failovers": self._failovers,
        }
        if self.staged:
            # A staged group is a chain of this many stage programs.
            topo["pipeline_stages"] = self.mesh_size
        if self.serve_mode != REPLICATED:
            # Present only under a slice map: the groups whose devices
            # straddle slices (partition_groups keeps a group in one
            # slice whenever the mesh size fits).
            straddling = None
            for r in self.replicas:
                smap = device_slice_map(r.devices)
                if smap is None:
                    continue
                straddling = [] if straddling is None else straddling
                if len(set(smap)) > 1:
                    straddling.append(r.name)
            if straddling is not None:
                topo["slice_straddling_groups"] = straddling
        return topo

    def topology(self) -> dict:
        """The pool's shape and self-healing counters: the ``/stats``
        block ``loadgen --expect-groups`` asserts against."""
        with self._lock:
            return self._topology_locked()

    def staging_allocated(self) -> dict:
        """Staging buffers ever allocated per plane and bucket, summed
        over the current replicas."""
        with self._lock:
            replicas = list(self.replicas)
        return sum_staging(r.engine.staging_allocated() for r in replicas)

    def snapshot(self) -> dict:
        """Per-replica rows for ``/stats`` and the JSONL sink: device,
        serving epoch, in-flight and lifetime dispatch counts; a sharded
        group's row also carries the mode and its devices (a chain's, its
        stage count); the health fields (``quarantined``, ``generation``,
        ``failures``) appear only once they are true or nonzero."""
        sharded = self.serve_mode != REPLICATED
        with self._lock:
            rows = {}
            replicas = list(self.replicas)
            for r in replicas:
                row = {"device": str(r.device),
                       "pending": r.pending,
                       "dispatched": r.dispatched}
                if sharded:
                    row["mode"] = self.serve_mode
                    row["devices"] = [str(d) for d in r.devices]
                    if self.staged:
                        row["stages"] = len(r.devices)
                if r.quarantined:
                    row["quarantined"] = True
                if r.generation:
                    row["generation"] = r.generation
                if r.failures:
                    row["failures"] = r.failures
                rows[r.name] = row
        for replica in replicas:
            rows[replica.name]["params_epoch"] = replica.engine.params_epoch
        return rows
