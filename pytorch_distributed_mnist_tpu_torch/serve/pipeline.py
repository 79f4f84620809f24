"""Pipeline serving: one program per stage device, batches streamed along
the chain.

Counterpart of ``pytorch_distributed_mnist_tpu/serve/pipeline.py``. A
pipeline-trained checkpoint holds the ViT's params stage-stacked
(``{embed, blocks, head}``, ``parallel/pipeline_vit.py``); serving it as
one spanning program would hold every stage's weights everywhere. Here
each stage runs on its own device:

- **Stage split.** ``parallel/pipeline_vit.py::split_stage_params`` cuts
  the tree at the block boundaries training's stage axis used; stage 0
  carries the patch embedding, the last stage the head. Each stage's
  params live on that stage's device only, and quantize on their own
  (per-leaf scales of the stage's slice), as the reference's do.
- **Stage forwards.** ``make_stage_forward_fns`` gives each stage's
  forward, the model's own embed, blocks and head; the precision plane
  wraps them per stage (``ServePrecision.wrap_stage_forward``: the first
  stage takes the staged dtype, the hop rides the precision's hop dtype,
  the last casts the logits to float32). Warm-up records are named
  ``serve_forward_b{b}@{name}.s{k}``.
- **Streaming.** On the card each stage has its own CUDA stream.
  ``dispatch_logits`` copies the staged batch onto stage 0's device on
  stage 0's stream and enqueues the whole chain: stage k's forward on
  its stream, an event, stage k+1's stream waiting on it, the hop to
  stage k+1's device as a non-blocking copy there, and so on; the
  logits' copy to the host follows the last stage, and an event marks
  it. Nothing waits on the host, so with an in-flight window of at least
  S batches stage k runs batch N while stage k+1 runs batch N-1 (the
  reference gets this from JAX's asynchronous dispatch). A batch keeps
  every tensor its chain touched (the captured params, each hop) until
  ``complete``, so the caching allocator never hands one to another
  stream's work early. On the CPU the chain simply runs in order.

Hot reload is coordinated across stages: ``swap_params`` splits and
places every stage's slice outside the lock, then installs the whole
per-stage list and the epoch under one lock; dispatch captures the list
under that lock once per batch, so no batch runs stage 0 on epoch E and
stage 1 on epoch E+1.

The engine surface is ``InferenceEngine``'s, so ``EnginePool`` treats a
chain as one replica spanning its stage devices: least-loaded dispatch
across chains, quarantine and regroup of the whole chain, the reload
fan-out. Registered as serve mode ``pipeline`` in ``serve/programs.py``.
The fused plane (raw uint8 in) has a fused stage-0 program; later stages
are the split chain's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
    make_stage_forward_fns,
    split_stage_params,
    split_vit_params,
)
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    StagingPool,
    _InFlightBatch,
    as_raw_images,
    bucket_for,
    preprocess_images,
    stage_batch,
)
from pytorch_distributed_mnist_tpu_torch.serve.programs import (
    ServeTemplate,
    _put,
    get_precision,
)
from pytorch_distributed_mnist_tpu_torch.utils.device import resolve_device
from pytorch_distributed_mnist_tpu_torch.utils.profiling import WarmupLog

__all__ = ["PipelineEngine", "make_pipeline_template",
           "pipeline_engine_factory"]


class _StageProgram:
    """One pipeline stage: its forward, its device and, on the card, its
    own stream. Holds no params: the engine owns the per-stage list so
    the cross-stage swap stays atomic."""

    __slots__ = ("index", "device", "name", "forward", "fused", "stream")

    def __init__(self, index: int, forward: Callable, device: torch.device,
                 name: str, fused: bool = False, stream=None) -> None:
        self.index = index
        self.device = device
        self.name = name  # e.g. "pipeline.s0" / "pipeline.g1.int8.s0"
        self.forward = forward
        self.fused = fused
        self.stream = stream

    def program_name(self, bucket: int) -> str:
        tag = ".fused" if self.fused else ""
        return f"serve_forward_b{bucket}{tag}@{self.name}"

    def scope(self):
        """This stage's device and stream as the current ones (the card),
        or nothing (the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def run(self, params, x: torch.Tensor) -> torch.Tensor:
        """This stage's forward; ``x`` is on this stage's device."""
        return self.forward(params, x)


class _ChainBatch(_InFlightBatch):
    """An in-flight batch of a chain: also the tensors its chain touched
    (the captured params, each stage's output), held until completion."""

    __slots__ = ("keep",)

    def __init__(self, engine, chunks, epoch, buffers, event, keep) -> None:
        super().__init__(engine, chunks, epoch, buffers, event)
        self.keep = keep


class PipelineEngine:
    """S per-stage programs behind the one-engine surface.

    ``devices`` gives one device per stage (stage k on ``devices[k]``; a
    device may repeat: two stages sharing one card run on two streams of
    it). ``params`` is the WHOLE pipelined tree (split names,
    ``blocks.*`` stacked on the depth dim); the engine splits it by
    stage itself, at construction and on every ``swap_params``, so the
    pool, the reload watcher and a regroup never learn the stage layout.
    ``model`` is the ViT module the stage forwards are built from (the
    engine's own: the stage forwards run its modules with
    ``functional_call``), carrying the int8 matmul on the int8 plane.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        params,
        devices: Sequence,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        input_shape: Tuple[int, ...] = (28, 28, 1),
        serve_log=None,
        params_epoch: Optional[int] = None,
        name: str = "pipeline",
        workers: int = 4,
        precision: Optional[str] = None,
        fuse: bool = False,
        warmup_log: Optional[WarmupLog] = None,
    ) -> None:
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("PipelineEngine needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a chain's stages share one device type; got "
                             f"{[str(d) for d in devices]}")
        buckets = sorted({int(b) for b in buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.buckets = tuple(buckets)
        self.input_shape = tuple(input_shape)
        self.raw_shape = self.input_shape[:-1]
        self.serve_log = serve_log
        self.workers = int(workers)
        self.name = name
        self.warmup_log = warmup_log if warmup_log is not None \
            else WarmupLog()
        self.n_stages = len(devices)
        self.devices = tuple(devices)
        self.device = devices[0]
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            # float32 must mean float32, as in the one-device engine.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.eval()
        self._precision_spec = get_precision(precision)
        self.precision = self._precision_spec.name
        stage_fwds = list(make_stage_forward_fns(self.model, self.n_stages))
        last = self.n_stages - 1
        streams = [torch.cuda.Stream(device=d) if self._cuda else None
                   for d in devices]
        self._stages = [
            _StageProgram(k, self._precision_spec.wrap_stage_forward(
                fwd, first=(k == 0), last=(k == last)), dev,
                f"{name}.s{k}", stream=stream)
            for k, (fwd, dev, stream) in enumerate(
                zip(stage_fwds, devices, streams))]
        # The fused plane cuts in at the chain's one host boundary: a
        # second stage-0 program takes the raw uint8 bytes; later stages
        # are the split chain's.
        self.fuse = bool(fuse)
        self._fused_stage0 = _StageProgram(
            0, self._precision_spec.wrap_fused_stage_forward(
                stage_fwds[0], first=True, last=(last == 0)),
            devices[0], f"{name}.s0", fused=True, stream=streams[0])
        self._lock = threading.Lock()
        # One enqueue at a time: the stage forwards share the model's
        # modules (functional_call swaps their params for a call).
        self._enqueue_lock = threading.Lock()
        self._stage_params = self._place_stages(params)
        self._params_epoch = params_epoch
        self._staging = StagingPool(
            self.buckets, self.input_shape,
            dtype=self._precision_spec.input_dtype, pin=self._cuda)
        self._raw_staging = StagingPool(self.buckets, self.raw_shape,
                                        dtype=torch.uint8, pin=self._cuda)

    def _place_stages(self, params) -> List[dict]:
        """Split the whole pipelined tree by stage, quantize each slice
        on its own (the split runs on the float32 tree the stage
        boundaries are defined over) and put each on its stage's device
        only. Runs outside the lock."""
        split = split_stage_params(params, self.n_stages)
        return [{name: _put(leaf, stage.device) for name, leaf in
                 self._precision_spec.quantize(tree).items()}
                for tree, stage in zip(split, self._stages)]

    # -- lifecycle ---------------------------------------------------------

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    @property
    def params_epoch(self) -> Optional[int]:
        with self._lock:
            return self._params_epoch

    def stage_names(self) -> List[str]:
        return [s.name for s in self._stages]

    def _sync(self) -> None:
        if self._cuda:
            for stage in self._stages:
                stage.stream.synchronize()

    def warmup(self) -> None:
        """One run of every bucket x stage (and of the fused stage 0 per
        bucket), each stage alone and timed under its own name into
        ``self.warmup_log``, so no request pays a first-call cost."""
        with self._lock:
            stage_params = list(self._stage_params)
        planes = [(False, self._staging)]
        if self.fuse:
            planes.append((True, self._raw_staging))
        with self._enqueue_lock, torch.inference_mode():
            for fused, pool in planes:
                first = self._fused_stage0 if fused else self._stages[0]
                for bucket in self.buckets:
                    x = torch.zeros((bucket,) + pool.input_shape,
                                    dtype=pool.dtype)
                    for stage in [first] + self._stages[1:]:
                        with self.warmup_log.measure(
                                stage.program_name(bucket)), stage.scope():
                            x = stage.run(stage_params[stage.index],
                                          x.to(stage.device))
                            self._sync()

    def swap_params(self, params, epoch: Optional[int] = None,
                    path: Optional[str] = None) -> bool:
        """The coordinated hot-reload swap (the reload watcher's
        ``on_params``): split and place every stage's slice outside the
        lock, then install the whole list and the epoch under it.
        Returns False, installing nothing, when ``epoch`` is older than
        the serving one."""
        del path
        placed = self._place_stages(params)
        with self._lock:
            if (epoch is not None and self._params_epoch is not None
                    and epoch < self._params_epoch):
                return False
            self._stage_params = placed
            self._params_epoch = epoch
            return True

    # -- inference ---------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        return bucket_for(self.buckets, n)

    def preprocess(self, images) -> np.ndarray:
        if self.fuse:
            raw = as_raw_images(images, self.input_shape)
            if raw is not None:
                return raw
        return preprocess_images(images, self.input_shape, self.workers)

    def staging_allocated(self) -> dict:
        return {"split": self._staging.allocated(),
                "fused": self._raw_staging.allocated()}

    def _chain(self, stage_params: List[dict], staged: torch.Tensor,
               fused: bool, keep: list) -> torch.Tensor:
        """Enqueue one staged chunk through every stage; returns the
        last stage's logits on its device (on the card, not waited
        for)."""
        stages = [self._fused_stage0 if fused else self._stages[0]] \
            + self._stages[1:]
        x, prev = None, None
        for stage in stages:
            with stage.scope():
                if prev is None:
                    x = staged.to(stage.device, non_blocking=True)
                else:
                    if self._cuda:
                        ready = torch.cuda.Event()
                        ready.record(prev.stream)
                        stage.stream.wait_event(ready)
                    x = x.to(stage.device, non_blocking=True)  # the hop
                keep.append(x)
                x = stage.run(stage_params[stage.index], x)
            prev = stage
        keep.append(x)
        return x

    def _dispatch(self, x: np.ndarray, fused: bool) -> _ChainBatch:
        """Chunk ``x`` through the top bucket; per chunk: stage it, then
        enqueue the chain and the logits' copy to the host. Returns
        before the card is done, with an event recorded on the last
        stage's stream after the last copy."""
        pool = self._raw_staging if fused else self._staging
        with self._lock:
            stage_params = list(self._stage_params)  # captured ONCE
            epoch = self._params_epoch
        last = self._stages[-1]
        chunks, buffers, keep = [], [], [stage_params]
        event = None
        try:
            with self._enqueue_lock, torch.inference_mode():
                for start in range(0, x.shape[0], self.max_batch):
                    chunk = x[start:start + self.max_batch]
                    n = chunk.shape[0]
                    bucket = self.bucket_for(n)
                    staged = stage_batch(chunk, bucket, pool, buffers,
                                         self.workers)
                    out = self._chain(stage_params, staged, fused, keep)
                    if self._cuda:
                        with last.scope():
                            host = torch.empty(out.shape, dtype=out.dtype,
                                               pin_memory=True)
                            host.copy_(out, non_blocking=True)
                        out = host
                    chunks.append((out, n))
                    if self.serve_log is not None:
                        self.serve_log.record_batch(n, bucket,
                                                    replica=self.name)
                if self._cuda:
                    event = torch.cuda.Event()
                    event.record(last.stream)
        except BaseException:
            pool.release(buffers)
            raise
        return _ChainBatch(self, chunks, epoch, [(pool, buffers)], event,
                           keep)

    def dispatch_logits(self, images) -> _ChainBatch:
        """Preprocess, stage and enqueue the chain without waiting. A
        fused chain routes raw uint8 through the fused stage 0; float
        input (and every input on an unfused chain) takes the split
        plane, int8 activations quantized on the host before staging."""
        if self.fuse:
            raw = as_raw_images(images, self.input_shape)
            if raw is not None:
                return self._dispatch(raw, fused=True)
        x = preprocess_images(images, self.input_shape, self.workers)
        x = self._precision_spec.stage_host(x, self.workers)
        return self._dispatch(x, fused=False)

    def complete(self, inflight: _ChainBatch) \
            -> Tuple[np.ndarray, Optional[int]]:
        """Wait for the chain's last event, release the staging buffers
        and the kept tensors, and return ``(logits (N, classes), epoch)``:
        the one-engine contract, so the pool's failover treats a chain
        like any replica."""
        try:
            if inflight.event is not None:
                inflight.event.synchronize()
            out = [host.numpy()[:n] for host, n in inflight.chunks]
        finally:
            for pool, buffers in inflight.buffers:
                pool.release(buffers)
            inflight.buffers = []
            inflight.keep = []
        return np.concatenate(out, axis=0), inflight.epoch

    def logits_with_epoch(self, images) -> Tuple[np.ndarray, Optional[int]]:
        return self.dispatch_logits(images).complete()

    def logits(self, images) -> np.ndarray:
        return self.logits_with_epoch(images)[0]

    def predict(self, images) -> np.ndarray:
        return np.argmax(self.logits(images), axis=-1)

    def predict_with_epoch(self, images) -> Tuple[np.ndarray, Optional[int]]:
        logits, epoch = self.logits_with_epoch(images)
        return np.argmax(logits, axis=-1), epoch

    # -- measurement -------------------------------------------------------

    def stage_step_ms(self, bucket: int, reps: int = 5) -> dict:
        """Per-stage synchronous step walls (``{"s{k}": best-of-reps
        ms}``) at one bucket: each stage run alone on its device with
        nothing else in flight, waited for on the host. Under full
        streaming the pipe's clock is the slowest stage's wall; this is
        an occupancy probe, not a serving-path measurement."""
        with self._lock:
            stage_params = list(self._stage_params)
        walls: dict = {}
        x = torch.zeros((bucket,) + self.input_shape,
                        dtype=self._precision_spec.input_dtype)
        with self._enqueue_lock, torch.inference_mode():
            for stage in self._stages:
                with stage.scope():
                    x = x.to(stage.device)
                    y = stage.run(stage_params[stage.index], x)
                    self._sync()
                    best = float("inf")
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        y = stage.run(stage_params[stage.index], x)
                        self._sync()
                        best = min(best, time.perf_counter() - t0)
                walls[stage.name.rsplit(".", 1)[-1]] = best * 1e3
                x = y
        return walls


def make_pipeline_template(model_name: str) -> ServeTemplate:
    """The template a pipeline-trained checkpoint restores onto: the
    model's params in the pipelined ``{embed, blocks, head}`` layout
    (blocks stacked on the depth dim, what training saved), whose JAX
    paths hang off the state's params directly (``root=""``). The serve
    boot and every hot reload load through it; the plane splits by stage
    itself."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        param_shapes,
    )

    whole = {n: np.zeros(s, np.float32)
             for n, s in param_shapes(model_name).items()}
    shapes = {n: tuple(v.shape) for n, v in split_vit_params(whole).items()}
    return ServeTemplate(model_name, shapes, root="", split=True)


def pipeline_engine_factory(*, model, model_name, params, devices, name,
                            buckets, input_shape, serve_log, params_epoch,
                            workers, precision=None, fuse=False,
                            warmup_log=None):
    """The registry's engine hook (``serve/programs.py`` registers mode
    ``pipeline`` with it): one chain spanning ``devices``, stage k on
    device k. It needs the model module, not only a forward: the stage
    boundary cuts through the forward."""
    if model is None:
        raise ValueError(
            "--serve-mode pipeline needs the model object (stage "
            f"programs are built from --model {model_name}'s structure); "
            "pass a model factory to the pool")
    return PipelineEngine(
        model, params, devices, buckets=buckets, input_shape=input_shape,
        serve_log=serve_log, params_epoch=params_epoch, name=name,
        workers=workers, precision=precision, fuse=fuse,
        warmup_log=warmup_log)
