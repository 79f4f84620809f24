"""Bucketed inference engine on one device.

Counterpart of ``pytorch_distributed_mnist_tpu/serve/engine.py``. The
engine owns a fixed set of batch buckets (default 1/8/32/128) and pads
every batch up to the nearest one, as the reference does. Besides keeping
the shapes the kernels see to a known few, the padding is part of the
numerics: the int8 plane quantizes the Dense activations per tensor, so
the pad rows take part in the scale exactly as they do in the reference.
``warmup`` runs one forward per bucket before the server opens its socket
(on the int8 plane the first one also builds the CUDA kernel library).

Params are installed as a dict of device tensors (``QuantLeaf`` pairs on
the int8 planes) and passed to the model with
``torch.func.functional_call``; ``swap_params`` is an atomic reference
swap between batches that refuses to put an older checkpoint over a newer
one. An in-flight batch keeps the params it captured at dispatch.

Dispatch/complete split: ``dispatch_logits`` copies the batch into a
pinned staging buffer, enqueues the host-to-device copy, the forward and
the device-to-host copy of the logits on the engine's own device's current
stream, records an event on that stream and returns; ``complete`` waits
for that event only. The staging buffers go back to their free-list only
then, when the device is done reading them. Dispatch runs under
``torch.cuda.device(engine.device)``, so it is right from any thread
whatever that thread's current device: a pool dispatches from the
batcher's worker and re-dispatches a failed-over batch from the
completion thread (``serve/pool.py``). A batch's event waits for its own
device's stream only; two replicas sharing one card share its stream,
in the order they enqueued.

A SHARDED engine (``placement=``, a ``serve/programs.py::MeshPlacement``)
spans a mesh group's devices: its params are one dict per device (each
split leaf's piece on its device, the rest on the lead, ``devices[0]``),
the staged batch goes to the lead, the forward is the placement's
(``serve/sharded.py``: each shard's products on its device, the partial
sums on the lead) and the float32 logits come back from the lead. The
engine's ``device`` is then the lead: dispatch runs under it and the
batch's event is recorded on its stream, after the last copy. Names
follow ``serve_forward_b{b}@{mode}[.g{i}][.{prec}]``.

The fused plane (the server's default) takes raw uint8 requests: the
normalize and, on ``int8``, the activation quantization run on the device
(``serve/programs.py``), so the host's work is one byte copy. Float
(already normalized) input takes the split plane: normalize and
quantization on the host, as in the reference. The split plane's host
work (the float64 cast, the normalize, the int8 quantize and the float32
pad into the staging buffer) runs in the native C++ library over
``workers`` threads (the server's ``-j``, ``data/native.py``), bitwise
equal to the NumPy expressions that ``TPUMNIST_NATIVE=0`` runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.data.mnist import normalize_images
from pytorch_distributed_mnist_tpu_torch.serve.programs import (
    QuantLeaf,
    get_precision,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    make_forward_program,
)
from pytorch_distributed_mnist_tpu_torch.utils.device import resolve_device
from pytorch_distributed_mnist_tpu_torch.utils.profiling import WarmupLog

DEFAULT_BUCKETS = (1, 8, 32, 128)


class StagingPool:
    """Per-bucket free-lists of host staging buffers (pinned when the
    engine runs on the card, so the host-to-device copy is asynchronous).
    A buffer is acquired at dispatch and released at completion, when the
    device has read it; steady-state serving allocates nothing."""

    def __init__(self, buckets: Sequence[int],
                 input_shape: Tuple[int, ...], dtype=torch.float32,
                 pin: bool = False) -> None:
        self.input_shape = tuple(input_shape)
        self.dtype = dtype
        self.pin = pin
        self._lock = threading.Lock()
        self._free: dict = {b: [] for b in buckets}
        self._allocated = {b: 0 for b in buckets}

    def acquire(self, bucket: int) -> torch.Tensor:
        with self._lock:
            free = self._free[bucket]
            if free:
                return free.pop()
            self._allocated[bucket] += 1
        return torch.zeros((bucket,) + self.input_shape, dtype=self.dtype,
                           pin_memory=self.pin)

    def release(self, buffers: List[Tuple[int, torch.Tensor]]) -> None:
        with self._lock:
            for bucket, buf in buffers:
                self._free[bucket].append(buf)

    def allocated(self) -> dict:
        """Buffers ever allocated per bucket: it stops growing once the
        in-flight window is warm."""
        with self._lock:
            return dict(self._allocated)


def sum_staging(blocks) -> dict:
    """Sum ``staging_allocated()`` blocks (``{"split": {bucket: n},
    "fused": {...}}``) over the engines of a pool or a canary."""
    total: dict = {"split": {}, "fused": {}}
    for block in blocks:
        for plane, per_bucket in block.items():
            for bucket, n in per_bucket.items():
                total[plane][bucket] = total[plane].get(bucket, 0) + n
    return total


def stage_batch(images: np.ndarray, bucket: int, staging: StagingPool,
                buffers: List, workers: int = 4) -> torch.Tensor:
    """Copy one chunk into a staging buffer of its bucket, pad rows zero,
    and append the buffer to ``buffers`` (pinned until completion). A
    float32 chunk fills through the native pad over ``workers`` threads;
    int8 and uint8 chunks (a quarter of the bytes) fill through NumPy."""
    from pytorch_distributed_mnist_tpu_torch.data import native

    n = images.shape[0]
    buf = staging.acquire(bucket)
    view = buf.numpy()
    filled = (images.dtype == np.float32 and view.dtype == np.float32
              and images.flags["C_CONTIGUOUS"]
              and native.pad_into(view, images, workers=workers))
    if not filled:
        view[:n] = images
        if n < bucket:
            view[n:] = 0
    buffers.append((bucket, buf))
    return buf


def preprocess_images(images, input_shape: Tuple[int, ...],
                      workers: int = 4) -> np.ndarray:
    """Raw request pixels -> the float32 normalized layout: uint8 ``(N, 28,
    28)`` raw images are normalized with ``normalize_images``; float
    ``(N,) + input_shape`` arrays pass as already normalized (float64 cast
    by the native kernel). A single example may drop its leading axis
    either way."""
    from pytorch_distributed_mnist_tpu_torch.data import native

    arr = np.asarray(images)
    if arr.size == 0:
        raise ValueError("at least one image required")
    raw_shape = input_shape[:-1]
    if arr.dtype == np.uint8:
        if arr.shape == raw_shape:
            arr = arr[None]
        if arr.ndim == len(raw_shape) + 1 and arr.shape[1:] == raw_shape:
            return normalize_images(arr, workers=workers)
    elif np.issubdtype(arr.dtype, np.floating):
        cast = native.cast_f32(arr, workers=workers) \
            if arr.dtype == np.float64 else None
        arr = cast if cast is not None \
            else arr.astype(np.float32, copy=False)
        if arr.shape == input_shape:
            arr = arr[None]
        if arr.ndim == len(input_shape) + 1 \
                and arr.shape[1:] == input_shape:
            return arr
    raise ValueError(
        f"expected uint8 (N, {', '.join(map(str, raw_shape))}) raw "
        f"images or float32 (N, {', '.join(map(str, input_shape))})"
        f" normalized images; got {arr.dtype} {arr.shape}")


def as_raw_images(images, input_shape: Tuple[int, ...]) \
        -> Optional[np.ndarray]:
    """The fused plane's validation: raw uint8 ``(N, 28, 28)`` pixels pass
    through unnormalized; anything else returns ``None`` (the split
    plane's business)."""
    arr = np.asarray(images)
    if arr.dtype != np.uint8 or arr.size == 0:
        return None
    raw_shape = input_shape[:-1]
    if arr.shape == raw_shape:
        arr = arr[None]
    if arr.ndim == len(raw_shape) + 1 and arr.shape[1:] == raw_shape:
        return arr
    return None


def bucket_for(buckets: Sequence[int], n: int) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


class _InFlightBatch:
    """One dispatched batch: the host tensors the logits are copied into,
    the epoch of the params that computed them, the staging buffers it
    pins, and the CUDA event that marks the copies done."""

    __slots__ = ("engine", "chunks", "epoch", "buffers", "event")

    def __init__(self, engine: "InferenceEngine", chunks, epoch, buffers,
                 event) -> None:
        self.engine = engine
        self.chunks = chunks  # [(host_logits, real_rows), ...]
        self.epoch = epoch
        self.buffers = buffers  # [(pool, [(bucket, buf), ...]), ...]
        self.event = event

    def complete(self) -> Tuple[np.ndarray, Optional[int]]:
        return self.engine.complete(self)


class InferenceEngine:
    """Params + the bucketed forward of one model on one device.

    ``model`` is an ``nn.Module`` whose parameters name the params dict
    (``models/convert.py`` gives both); ``params`` maps those names to
    float32 host arrays. ``precision`` picks the plane
    (``serve/programs.py``); ``fuse`` adds the raw-uint8 plane.

    Threading: ``dispatch_logits`` and ``complete`` from any thread (a
    pool's batcher worker and its completion thread may both dispatch
    on one engine), ``swap_params`` from any thread (the reload
    watcher). ``torch.func.functional_call`` swaps the model module's
    parameters in and back out around a call, so two forwards on one
    module must not overlap: a dispatch's enqueue (staging, the
    forward, the event) holds ``_enqueue_lock``, one thread at a time
    per engine, and the module is this engine's own (two engines must
    never share one). Only the host-side enqueue is serialized: the
    card still runs one batch while the next is staged, and ``complete``
    waits outside the lock. ``warmup_log`` may be shared between
    engines (a pool's or a model plane's), each recording its own
    program names."""

    def __init__(
        self,
        model: torch.nn.Module,
        params,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        input_shape: Tuple[int, ...] = (28, 28, 1),
        serve_log=None,
        params_epoch: Optional[int] = None,
        name: Optional[str] = None,
        precision: Optional[str] = None,
        fuse: bool = False,
        device="cuda",
        workers: int = 4,
        warmup_log: Optional[WarmupLog] = None,
        placement=None,
    ) -> None:
        buckets = sorted({int(b) for b in buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.buckets = tuple(buckets)
        self.input_shape = tuple(input_shape)
        self.raw_shape = self.input_shape[:-1]
        self.serve_log = serve_log
        self.name = name
        self.workers = int(workers)  # the split plane's host threads
        self.warmup_log = warmup_log if warmup_log is not None \
            else WarmupLog()
        # The sharded plane: the placement owns where params live and
        # the forward; the engine runs on its lead device.
        self.placement = placement
        self.device = resolve_device(device) if placement is None \
            else placement.lead
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            # float32 must mean float32: cuDNN would run float32
            # convolutions in TF32 (about three decimal digits) by
            # default, and the reference's f32 plane does not.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.eval()
        # Evaluation's forward (train/steps.py): serve and eval cannot
        # disagree on the forward's math.
        self._apply = make_forward_program(self.model) if placement is None \
            else placement.make_forward(self.model)
        self._precision_spec = get_precision(precision)
        self.precision = self._precision_spec.name
        self._forward = self._precision_spec.wrap_forward(self._apply)
        self.fuse = bool(fuse)
        self._fused_forward = self._precision_spec.wrap_fused_forward(
            self._apply)
        self._lock = threading.Lock()
        # Held for the whole of one dispatch's enqueue (see Threading).
        self._enqueue_lock = threading.Lock()
        self._params = self._place(params)
        self._params_epoch = params_epoch
        # Called under _lock right after an install, so a response-cache
        # generation bump is atomic with the swap. O(1) work only.
        self._swap_hooks: List[Callable] = []
        self._staging = StagingPool(
            self.buckets, self.input_shape,
            dtype=self._precision_spec.input_dtype, pin=self._cuda)
        self._raw_staging = StagingPool(self.buckets, self.raw_shape,
                                        dtype=torch.uint8, pin=self._cuda)

    def _place(self, params):
        """Quantize (host-side, per install) and move a params dict to this
        engine's device, or through the placement onto its group's
        devices. Runs outside the lock, from ``__init__`` and
        ``swap_params``."""
        tree = self._precision_spec.quantize(params)
        if self.placement is not None:
            return self.placement.place_params(tree)
        dev = self.device

        def put(leaf):
            if isinstance(leaf, QuantLeaf):
                return QuantLeaf(q=put(leaf.q),
                                 s=torch.tensor(float(leaf.s),
                                                dtype=torch.float32,
                                                device=dev))
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(np.ascontiguousarray(leaf))
            return leaf.to(dev)

        return {name: put(leaf) for name, leaf in tree.items()}

    # -- lifecycle ---------------------------------------------------------

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    @property
    def params_epoch(self) -> Optional[int]:
        with self._lock:
            return self._params_epoch

    def program_name(self, bucket: int, fused: bool = False) -> str:
        """The warm-up record's name of one bucket's forward:
        ``serve_forward_b{bucket}[.fused][@{name}]``."""
        base = f"serve_forward_b{bucket}" + (".fused" if fused else "")
        return f"{base}@{self.name}" if self.name else base

    def warmup(self) -> None:
        """One forward per bucket (and per plane), timed into
        ``self.warmup_log``, so no request pays a first-call cost."""
        planes = [(False, self._staging)]
        if self.fuse:
            planes.append((True, self._raw_staging))
        for fused, pool in planes:
            for bucket in self.buckets:
                zeros = torch.zeros((bucket,) + pool.input_shape,
                                    dtype=pool.dtype).numpy()
                with self.warmup_log.measure(self.program_name(bucket, fused)):
                    inflight = self._dispatch(zeros, fused, record=False)
                    self.complete(inflight)

    def add_swap_hook(self, hook: Callable) -> None:
        with self._lock:
            self._swap_hooks.append(hook)

    def swap_params(self, params, epoch: Optional[int] = None,
                    path: Optional[str] = None) -> bool:
        """Atomically install new params (the reload watcher's callback).
        Returns False, and installs nothing, when ``epoch`` is older than
        the serving params' (two concurrent swaps may reach the install in
        either order). Epoch-less swaps always install."""
        del path
        placed = self._place(params)
        with self._lock:
            if (epoch is not None and self._params_epoch is not None
                    and epoch < self._params_epoch):
                return False
            self._params = placed
            self._params_epoch = epoch
            for hook in self._swap_hooks:
                hook(epoch)
            return True

    # -- inference ---------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        return bucket_for(self.buckets, n)

    def preprocess(self, images) -> np.ndarray:
        """Raw uint8 passes through on a fused engine; everything else is
        normalized on the host (:func:`preprocess_images`)."""
        if self.fuse:
            raw = as_raw_images(images, self.input_shape)
            if raw is not None:
                return raw
        return preprocess_images(images, self.input_shape, self.workers)

    def staging_allocated(self) -> dict:
        return {"split": self._staging.allocated(),
                "fused": self._raw_staging.allocated()}

    def _device_scope(self):
        """``torch.cuda.device(self.device)`` on the card: what a dispatch
        enqueues goes to this engine's device and its current stream,
        whatever the calling thread's current device is."""
        if self._cuda:
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _dispatch(self, x: np.ndarray, fused: bool,
                  record: bool = True) -> _InFlightBatch:
        """Chunk ``x`` through the top bucket; per chunk: stage, copy to
        the device, run the forward, copy the logits back. Returns before
        the device is done (on the card), with an event recorded on this
        engine's device's current stream after the last copy."""
        pool = self._raw_staging if fused else self._staging
        forward = self._fused_forward if fused else self._forward
        with self._lock:
            params = self._params  # captured ONCE: the swap boundary
            epoch = self._params_epoch
        chunks, buffers = [], []
        event = None
        try:
            with self._enqueue_lock, self._device_scope(), \
                    torch.inference_mode():
                for start in range(0, x.shape[0], self.max_batch):
                    chunk = x[start:start + self.max_batch]
                    n = chunk.shape[0]
                    bucket = self.bucket_for(n)
                    staged = stage_batch(chunk, bucket, pool, buffers,
                                         self.workers)
                    dev_in = staged.to(self.device, non_blocking=True) \
                        if self.placement is None \
                        else self.placement.place_input(staged)
                    out = forward(params, dev_in)
                    if self._cuda:
                        host = torch.empty(out.shape, dtype=out.dtype,
                                           pin_memory=pool.pin)
                        host.copy_(out, non_blocking=True)
                        out = host
                    chunks.append((out, n))
                    if record and self.serve_log is not None:
                        self.serve_log.record_batch(n, bucket,
                                                    replica=self.name)
                if self._cuda:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(self.device))
        except BaseException:
            pool.release(buffers)
            raise
        return _InFlightBatch(self, chunks, epoch, [(pool, buffers)], event)

    def dispatch_logits(self, images) -> _InFlightBatch:
        """Preprocess + stage + enqueue the forward without waiting. A
        fused engine routes raw uint8 to the fused plane; float input (and
        every input on an unfused engine) takes the split plane, whose
        int8 activations are quantized on the host before staging."""
        if self.fuse:
            raw = as_raw_images(images, self.input_shape)
            if raw is not None:
                return self._dispatch(raw, fused=True)
        x = preprocess_images(images, self.input_shape, self.workers)
        x = self._precision_spec.stage_host(x, self.workers)
        return self._dispatch(x, fused=False)

    def complete(self, inflight: _InFlightBatch) \
            -> Tuple[np.ndarray, Optional[int]]:
        """Wait for an in-flight batch (its own event: never another
        engine's work), release its staging buffers, and return
        ``(logits (N, classes), epoch)``."""
        try:
            if inflight.event is not None:
                inflight.event.synchronize()
            out = [host.numpy()[:n] for host, n in inflight.chunks]
        finally:
            for pool, buffers in inflight.buffers:
                pool.release(buffers)
            inflight.buffers = []
        return np.concatenate(out, axis=0), inflight.epoch

    def logits_with_epoch(self, images) -> Tuple[np.ndarray, Optional[int]]:
        """``(logits, epoch)``: dispatch immediately followed by complete,
        so the synchronous path and the pipelined one are the same code."""
        return self.dispatch_logits(images).complete()

    def logits(self, images) -> np.ndarray:
        return self.logits_with_epoch(images)[0]

    def predict(self, images) -> np.ndarray:
        return np.argmax(self.logits(images), axis=-1)

    def predict_with_epoch(self, images) -> Tuple[np.ndarray, Optional[int]]:
        logits, epoch = self.logits_with_epoch(images)
        return np.argmax(logits, axis=-1), epoch


def load_params_for_serving(path: str, template) -> Tuple[dict, int]:
    """``(params, epoch)`` from a published checkpoint, in the port's
    layout of ``template``: a model name (the model's own params), or a
    ``serve/programs.py::ServeTemplate`` (the pipeline plane's split
    tree). Name and shape mismatches raise ``ValueError``. ``epoch`` is
    the file's own ``checkpoint_{e}`` index."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        params_from_flat,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.programs import (
        template_of,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        load_params,
    )

    tpl = template_of(template)
    flat, epoch = load_params(path)
    return params_from_flat(flat, tpl.shapes, tpl.model_name,
                            tpl.root), epoch
