"""The ``serve`` subcommand: a stdlib HTTP JSON inference endpoint.

Counterpart of ``pytorch_distributed_mnist_tpu/serve/server.py`` in its
replicated mode.
``python -m pytorch_distributed_mnist_tpu_torch serve --checkpoint-dir ckpt
--model cnn --serve-precision int8`` boots: the model, the newest
published checkpoint (or seeded fresh params with a loud warning), the
bucketed :class:`~pytorch_distributed_mnist_tpu_torch.serve.engine.
InferenceEngine` on ``--device`` (``cuda`` unless asked otherwise; every
bucket warmed before the socket opens), the
:class:`~pytorch_distributed_mnist_tpu_torch.serve.batcher.MicroBatcher`
and the :class:`~pytorch_distributed_mnist_tpu_torch.serve.reload.
CheckpointWatcher` on the training run's checkpoint directory. On
``--serve-precision int8`` the model's Dense layers run the hand-written
int8 matmul kernel (``ops/matmul_i8.py``). Every registered model is
served (``cnn``, ``linear`` and ``vit``, the ViT at its registered
defaults with dense attention), at every precision, on the fused and the
split plane.

The data plane of one process at full breadth:

- ``--serve-devices N`` (0: every local device) makes the engine an
  :class:`~pytorch_distributed_mnist_tpu_torch.serve.pool.EnginePool`,
  one replica per device behind a least-loaded dispatcher, with failover,
  quarantine (``--quarantine-after``), background regroup and live
  ``POST /resize``; the batcher pipelines up to ``--max-inflight``
  batches (default replicas + 1). On the card the local devices are the
  visible cards; under ``--device cpu`` up to
  :data:`~pytorch_distributed_mnist_tpu_torch.utils.device.CPU_SLOTS`
  replicas share the host.
- ``--canary-fraction`` puts the f32 baseline in front and shadows that
  fraction of batches on the ``--serve-precision`` plane
  (:class:`~pytorch_distributed_mnist_tpu_torch.serve.canary.
  ShadowCanary`): it promotes after ``--canary-promote-after`` clean rows
  and rolls back past ``--canary-budget``.
- ``--model-set NAME=DIR,...`` boots one model plane per pair (engine or
  pool, batcher, watcher, canary, autoscaler and ``ServeLog`` each),
  requests route on their ``model`` field, and a
  :class:`~pytorch_distributed_mnist_tpu_torch.serve.control.
  WeightedFairGate` (``--model-weights``) shares the devices between
  the planes' dispatches.
- ``--autoscale`` runs the SLO controller
  (:class:`~pytorch_distributed_mnist_tpu_torch.serve.control.AutoScaler`)
  over each plane's pool: it samples ``ServeLog.window_stats`` and
  resizes the pool one replica a step (``--autoscale-dry-run`` records
  its decisions and actuates nothing).

Endpoints (one handler thread per connection, all funneling into the
batchers' workers, which own device submission):

- ``POST /predict`` — body ``{"images": ...}``: one 28x28 image or a list
  of them, raw 0-255 pixel values, and ``"model"`` on a multi-model
  server. Replies ``{"predictions": [...], "model_epoch": e,
  "latency_ms": t}``; 503 under admission control.
- ``GET /healthz`` — liveness + which checkpoint epoch is serving (per
  model under ``models`` on a multi-model server).
- ``GET /stats`` — the ServeLog snapshot (latency quantiles, queue,
  batch-size histogram, reloads, rejections), the per-bucket warm-up
  record, the cache block and the kernels' launch counts; a pool adds the
  topology block (``topology_generation``, ``groups``,
  ``active_groups``, ``quarantined_groups``, ``regroups``,
  ``failovers``) and one row per replica, a canary its ``canary`` block,
  the autoscaler its ``autoscaler`` block, and a multi-model server one
  ``models`` block per plane and the ``fair_dispatch`` block.
- ``POST /resize`` — ``{"serve_devices": N, "model": ...?}`` re-shapes a
  plane's pool under live traffic with zero dropped requests (refused
  without a pool and under a canary).
- ``POST /drain`` — ``{"drain": true|false}`` closes/reopens /predict
  admission (503 + Retry-After) while in-flight requests complete.
- ``GET /chunks/<sha256>`` — the gossip plane of delta distribution: one
  chunk of this server's stores (``<checkpoint-dir>/chunks/``), whole
  (200) or from ``Range: bytes=N-`` (206; 416 past its end); 404 for a
  malformed or unknown digest. Not gated by the drain: a draining server
  keeps seeding its peers.

Checkpoints of every layout are served: npz files, sharded ``.ckpt``
directories and delta-published manifests. The reload watcher loads
through a :class:`~pytorch_distributed_mnist_tpu_torch.distrib.fetch.
DeltaFetcher`: a manifest's missing chunks come from ``--chunk-peers``
first, then ``--chunk-source``, and only the leaves that changed are
rebuilt and quantized again (``-j`` threads); the server boots from a
manifest through the same fetcher.

``--register-dir DIR`` announces the server to a fleet router
(``serve/router.py``, ``--backends-dir DIR``): a ``backend_*.json``
record naming its URL, written once the socket is bound and the planes
are warm, removed while draining and on shutdown. ``/healthz`` carries
what the router reads of a backend: ``model_epoch``, ``model`` (or
``models`` per plane) and ``draining``.

Not ported yet: the sharded and pipeline serve modes (``--serve-mode``,
``--serve-mesh``: ROADMAP Queue 1 item 12). Their flags are absent from
the parser rather than accepted and ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from pytorch_distributed_mnist_tpu_torch.serve.batcher import (
    MicroBatcher,
    Overloaded,
)
from pytorch_distributed_mnist_tpu_torch.serve.canary import (
    SHADOW as CANARY_SHADOW,
)
from pytorch_distributed_mnist_tpu_torch.serve.canary import ShadowCanary
from pytorch_distributed_mnist_tpu_torch.serve.control import (
    PRIORITY_CLASSES,
    AutoScaler,
    ClientQuotas,
    ShedPolicy,
    WeightedFairGate,
    parse_quota_spec,
    parse_weight_spec,
    priority_rank,
)
from pytorch_distributed_mnist_tpu_torch.serve.economics import (
    HIT_COST,
    CostModel,
    ResponseCache,
    request_key,
)
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    InferenceEngine,
)
from pytorch_distributed_mnist_tpu_torch.serve.programs import (
    REPLICATED,
    precision_engine_name,
    serve_precisions,
)
from pytorch_distributed_mnist_tpu_torch.serve.reload import CheckpointWatcher
from pytorch_distributed_mnist_tpu_torch.utils.device import CPU_SLOTS
from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
    JsonlSink,
    ServeLog,
    WarmupLog,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_mnist_tpu_torch serve",
        description="JSON inference endpoint over a training run's "
                    "checkpoint directory (PyTorch/CUDA)",
        allow_abbrev=False,
    )
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints",
                   help="directory the training run publishes checkpoints "
                        "into; the newest is served and newer ones are "
                        "hot-reloaded as they appear")
    p.add_argument("--model", type=str, default="cnn",
                   help="model architecture the checkpoints belong to (a "
                        "mismatched checkpoint is rejected at load)")
    p.add_argument("--model-set", type=str, default=None,
                   metavar="NAME=DIR[,NAME=DIR...]",
                   help="multi-model serving: one model plane (engine or "
                        "pool, batcher, watcher, canary, layout gate) per "
                        "MODEL=CHECKPOINT_DIR pair, from one process "
                        "sharing the devices; requests route on their "
                        "'model' field. Overrides --model/--checkpoint-dir;"
                        " every other serving flag applies to each plane")
    p.add_argument("--model-weights", type=str, default=None,
                   metavar="NAME=W[,NAME=W...]",
                   help="multi-model weighted-fair dispatch: when more "
                        "than one model has queued work, device dispatch "
                        "grants interleave in this weight proportion "
                        "(unnamed models weigh 1.0). Requires --model-set")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="where the model runs: 'cuda' (default) needs a "
                        "card and fails without one; 'cpu' runs the "
                        "kernels' plain PyTorch versions")
    p.add_argument("--dtype", type=str, default=None, choices=["bf16", "f32"],
                   help="compute dtype override (default: the model's, "
                        "bf16)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (printed at startup)")
    p.add_argument("--buckets", type=str,
                   default=",".join(str(b) for b in DEFAULT_BUCKETS),
                   help="comma-separated batch buckets, each warmed at "
                        "startup; batches pad up to the nearest bucket")
    p.add_argument("--serve-devices", type=int, default=1,
                   help="devices the data plane spans (0 = every local "
                        "device): one engine replica per device behind "
                        "the least-loaded dispatcher. On the card, the "
                        "visible cards; under --device cpu, up to "
                        f"{CPU_SLOTS} replicas sharing the host. Default 1 "
                        "is the single-device data plane")
    p.add_argument("--serve-precision", type=str, default="f32",
                   choices=serve_precisions(),
                   help="'f32' (default); 'bf16' stores weights bfloat16; "
                        "'int8w' quantizes weights to int8 (per-leaf "
                        "scales, dequantized on the device); 'int8' also "
                        "quantizes activations and runs the Dense layers "
                        "through the int8 matmul kernel")
    p.add_argument("--no-fuse", action="store_true",
                   help="serve every request on the SPLIT plane (host-side "
                        "normalize/quantize/pad, float staging). Default: "
                        "raw uint8 requests are normalized (and quantized) "
                        "on the device")
    p.add_argument("--canary-fraction", type=float, default=0.0,
                   help="shadow-traffic accuracy canary: serve replies "
                        "from the f32 BASELINE while this fraction of "
                        "live batches also runs the --serve-precision "
                        "plane in shadow; argmax disagreements and logit "
                        "deltas accumulate in /stats, the precision "
                        "PROMOTES to primary after --canary-promote-after "
                        "clean rows and ROLLS BACK (permanent for that "
                        "publish; the server keeps serving) past "
                        "--canary-budget. 0 (default) serves "
                        "--serve-precision directly; requires a quantized "
                        "--serve-precision when set")
    p.add_argument("--canary-promote-after", type=int, default=200,
                   help="canary: shadowed rows (images) that must compare "
                        "within budget before the quantized plane is "
                        "promoted to primary")
    p.add_argument("--canary-budget", type=float, default=0.02,
                   help="canary: allowed argmax-disagreement fraction of "
                        "the promotion window (budget x promote-after "
                        "rows; shadow-plane errors count); exceeding it "
                        "rolls the publish back")
    p.add_argument("--quarantine-after", type=int, default=3,
                   help="pool self-healing threshold: this many "
                        "CONSECUTIVE dispatch/completion failures on one "
                        "replica (any success resets the count) "
                        "quarantine it: dispatch skips it, in-flight "
                        "batches fail over to healthy replicas, and a "
                        "background regroup rebuilds it on its device "
                        "under live traffic. Pooled data plane only; "
                        "input-shaped (4xx) errors never count")
    p.add_argument("--max-inflight", type=int, default=0,
                   help="pipelined dispatch window: batches dispatched but "
                        "not yet completed (0 = auto: replicas+1 on a "
                        "multi-replica pool, 1 otherwise; 1 disables "
                        "pipelining)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="micro-batcher deadline: a request waits at most "
                        "this long for co-riders before its batch flushes")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission control: pending requests beyond this "
                        "are rejected with 503")
    p.add_argument("--shed-watermarks", type=str, default=None,
                   metavar="CLASS=FRAC[,...]",
                   help="per-priority-class admission watermarks as "
                        "fractions of --max-queue (defaults best_effort="
                        "0.5, batch=0.75, interactive=1.0)")
    p.add_argument("--quota-rps", type=str, default=None,
                   metavar="RPS[,CLASS=RPS...]",
                   help="per-client token-bucket quotas (429 + Retry-After "
                        "past them); unset = no quotas")
    p.add_argument("--quota-burst-s", type=float, default=2.0,
                   help="quota burst allowance in seconds of the class rate")
    p.add_argument("--stats-window-s", type=float, default=60.0,
                   help="rolling-window size for /stats' `window` block")
    p.add_argument("--autoscale", action="store_true",
                   help="SLO-driven autoscaling: a background controller "
                        "samples the rolling-window p95 and queue depth "
                        "and actuates the pool's resize, one replica a "
                        "step: up on an SLO breach (--slo-p95-ms, or the "
                        "queue high watermark), down after sustained "
                        "calm; hysteresis and a cooldown prevent "
                        "flapping; every decision is a serve_autoscale "
                        "JSONL event. Needs the pooled data plane "
                        "(--serve-devices/--max-inflight) and is refused "
                        "under an active canary")
    p.add_argument("--autoscale-dry-run", action="store_true",
                   help="record every scale decision (JSONL + /stats) "
                        "without actuating the resize")
    p.add_argument("--slo-p95-ms", type=float, default=100.0,
                   help="the serving SLO the autoscaler defends: "
                        "rolling-window p95 latency above this is a "
                        "breach (scale up); sustained p95 below half of "
                        "it with an empty-ish queue scales down")
    p.add_argument("--autoscale-queue-high", type=float, default=0.75,
                   help="autoscaler queue-depth high watermark as a "
                        "fraction of --max-queue: depth at/above it is a "
                        "breach even while p95 holds")
    p.add_argument("--autoscale-interval-s", type=float, default=2.0,
                   help="seconds between autoscaler samples")
    p.add_argument("--autoscale-cooldown-s", type=float, default=10.0,
                   help="seconds after any scale action before the next "
                        "may fire")
    p.add_argument("--autoscale-down-after", type=int, default=3,
                   help="consecutive calm samples required before a "
                        "scale-down")
    p.add_argument("--autoscale-min-devices", type=int, default=1,
                   help="autoscaler floor: never scale below this many "
                        "devices")
    p.add_argument("--autoscale-max-devices", type=int, default=0,
                   help="autoscaler ceiling (0 = all local devices)")
    p.add_argument("--cache-mb", type=float, default=64.0,
                   help="response-cache byte budget in MB (exact-byte "
                        "repeats answer from the cache; a hot reload "
                        "invalidates it atomically). 0 disables")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the response cache")
    p.add_argument("--price-admission", action="store_true",
                   help="price admission in measured per-bucket cost "
                        "units instead of 1 per request")
    p.add_argument("--max-request-images", type=int, default=1024,
                   help="reject /predict requests with more images (400)")
    p.add_argument("--poll-interval", type=float, default=2.0,
                   help="seconds between checkpoint-directory polls")
    p.add_argument("--no-reload", action="store_true",
                   help="serve the boot-time checkpoint forever")
    p.add_argument("--chunk-peers", type=str, default=None, metavar="URLS",
                   help="comma-separated peer server base URLs "
                        "(http://host:port) to gossip checkpoint chunks "
                        "from: a delta-published manifest's missing chunks "
                        "are pulled from the peers' GET /chunks/<hash> "
                        "before the --chunk-source fallback")
    p.add_argument("--chunk-source", type=str, default=None, metavar="DIR",
                   help="source chunk-store directory (the trainer's "
                        "--checkpoint-dir) to fall back to when no peer "
                        "holds a chunk")
    p.add_argument("--register-dir", type=str, default=None, metavar="DIR",
                   help="fleet registration directory: write a backend "
                        "record (tmp+rename JSON naming this server's "
                        "URL) once the socket is bound and the planes are "
                        "warm, remove it while draining and on shutdown; "
                        "a router's --backends-dir polls it for dynamic "
                        "join and leave without a restart")
    p.add_argument("--require-checkpoint", action="store_true",
                   help="refuse to start without a published checkpoint")
    p.add_argument("--metrics-file", type=str, default=None,
                   help="append serve_stats / serve_reload JSONL lines here")
    p.add_argument("--stats-interval", type=float, default=30.0,
                   help="seconds between serve_stats lines to "
                        "--metrics-file (0 disables periodic writes)")
    p.add_argument("--seed", type=int, default=0,
                   help="fresh-param seed when no checkpoint exists")
    p.add_argument("-j", "--workers", type=int, default=4,
                   help="host threads of the split plane's native staging "
                        "(the float64 cast, normalize, int8 quantize and "
                        "pad, data/native.py) and of a delta install's "
                        "leaf quantize")
    p.add_argument("--compile-cache", type=str, default=None, metavar="DIR",
                   help="build directory of the CUDA kernel libraries and "
                        "the native host library, reused across runs. "
                        "Default: the TPUMNIST_COMPILE_CACHE env var, else "
                        "<checkout>/build/torch_kernels; an empty string "
                        "builds into a fresh temporary directory")
    return p


# One oversized body must not buy unbounded JSON parsing on a handler
# thread; 16 MB comfortably fits --max-request-images' worth of pixels.
MAX_BODY_BYTES = 16 << 20


def _estimate_rows(images) -> int:
    """Cheap row-count estimate for admission pricing only: a multi-image
    request is a list whose first element is a 2-D image."""
    if isinstance(images, list) and images \
            and isinstance(images[0], list) \
            and images[0] and isinstance(images[0][0], list):
        return len(images)
    return 1


class _HTTPServer(ThreadingHTTPServer):
    # Overload must reach admission control (a 503 with Retry-After), not
    # the kernel's accept backlog.
    request_queue_size = 128


class ModelPlane:
    """One model's serving stack: engine (or pool, or canary), batcher,
    reload watcher, delta fetcher, optional canary and autoscaler, its
    own :class:`ServeLog` and warm-up record. The single-model server is
    one plane; ``--model-set`` boots one per model, each with its own
    watcher, canary and layout gate, sharing the devices through the
    weighted-fair gate."""

    def __init__(self, model_name: str, engine, batcher, watcher,
                 serve_log, boot_path: Optional[str], *, device,
                 warmup_log: WarmupLog, pool=None, canary=None,
                 autoscaler=None, checkpoint_dir: Optional[str] = None,
                 fetcher=None) -> None:
        self.model_name = model_name
        self.engine = engine
        self.batcher = batcher
        self.watcher = watcher
        self.serve_log = serve_log
        self.boot_path = boot_path
        self.device = device
        self.warmup_log = warmup_log
        self.pool = pool
        self.canary = canary
        self.autoscaler = autoscaler
        self.checkpoint_dir = checkpoint_dir
        self.fetcher = fetcher

    @property
    def checkpoint_path(self) -> Optional[str]:
        if self.watcher is not None:
            return self.watcher.current_path
        return self.boot_path

    def close(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.watcher is not None:
            self.watcher.stop()
        self.batcher.close()


class ServeContext:
    """Everything one serving process owns; built by :func:`create_server`
    and shared with the HTTP handlers through the server object.

    ``planes`` maps model name -> :class:`ModelPlane`; ``default_model``
    names the plane a request without a ``model`` field routes to (the
    sole plane of a single-model server, whose requests never need the
    field). The flat attributes (``engine``, ``pool``, ``batcher``, ...)
    alias the default plane."""

    def __init__(self, planes, default_model: str, sink,
                 max_request_images: int = 1024, max_inflight: int = 1,
                 serve_precision: str = "f32", quotas=None,
                 fair_gate=None, fused: bool = True, cache=None,
                 price_admission: bool = False) -> None:
        self.planes = planes
        self.default_model = default_model
        self.sink = sink
        self.max_request_images = max_request_images
        self.max_inflight = max_inflight
        self.serve_mode = REPLICATED
        self.serve_precision = serve_precision
        self.quotas = quotas
        self.fair_gate = fair_gate
        self.fused = fused
        self.cache = cache
        self.price_admission = bool(price_admission)
        self.t_start = time.time()
        # Drain gate: while draining, /predict rejects new work and
        # in-flight requests finish; `draining && active_requests == 0`
        # means nothing can still be executing.
        self.draining = False
        self._drain_lock = threading.Lock()
        self._active_predicts = 0
        # Fleet registration (--register-dir): the record announcing this
        # backend to a router's --backends-dir poller. Written on boot,
        # removed while draining (a draining backend leaves the
        # discovered set before the next health sweep routes to it),
        # written again on undrain, removed on close.
        self._register_path: Optional[str] = None
        self._register_url: Optional[str] = None
        default = planes[default_model]
        self.model_name = default.model_name
        self.engine = default.engine
        self.pool = default.pool
        self.canary = default.canary
        self.batcher = default.batcher
        self.watcher = default.watcher
        self.serve_log = default.serve_log
        self.fetcher = default.fetcher
        self.boot_path = default.boot_path

    @property
    def multi_model(self) -> bool:
        return len(self.planes) > 1

    @property
    def checkpoint_path(self) -> Optional[str]:
        return self.planes[self.default_model].checkpoint_path

    def plane_for(self, model: Optional[str]) -> ModelPlane:
        """Route one request's ``model`` field to its plane. ``None``
        routes to the default only on a single-model server: a
        multi-model server requires the field."""
        if model is None:
            if self.multi_model:
                raise ValueError(
                    f"multi-model server: the request body must name "
                    f"'model' (one of {sorted(self.planes)})")
            return self.planes[self.default_model]
        plane = self.planes.get(model)
        if plane is None:
            raise ValueError(f"unknown model {model!r}; this server "
                             f"serves {sorted(self.planes)}")
        return plane

    def chunk_dirs(self) -> list:
        """Every plane's checkpoint directory, whose chunk stores ``GET
        /chunks/<sha256>`` searches in plane order (a digest names its
        bytes, so a hit in any store is the chunk)."""
        return [p.checkpoint_dir for p in self.planes.values()
                if p.checkpoint_dir]

    def predict_begin(self) -> None:
        with self._drain_lock:
            self._active_predicts += 1

    def predict_end(self) -> None:
        with self._drain_lock:
            self._active_predicts -= 1

    def active_requests(self) -> int:
        with self._drain_lock:
            return self._active_predicts

    def set_draining(self, draining: bool) -> bool:
        """Flip the drain gate; returns the previous state (idempotent).
        The registration record follows the gate (file IO outside the
        lock)."""
        with self._drain_lock:
            prev, self.draining = self.draining, bool(draining)
        if prev != draining and self._register_path is not None:
            if draining:
                _remove_register_record(self._register_path)
            else:
                _write_register_record(self._register_path,
                                       self._register_url)
        return prev

    def enable_registration(self, register_dir: str, url: str) -> None:
        os.makedirs(register_dir, exist_ok=True)
        safe = url.split("//", 1)[-1].replace(":", "_").replace("/", "_")
        self._register_path = os.path.join(register_dir,
                                           f"backend_{safe}.json")
        self._register_url = url
        _write_register_record(self._register_path, url)
        print(f"registered backend {url} in {register_dir}", flush=True)

    def write_stats(self, **extra) -> None:
        if self.cache is not None:
            extra.setdefault("cache", self.cache.snapshot())
        for plane in self.planes.values():
            plane.serve_log.write_stats(**extra)

    def close(self) -> None:
        if self._register_path is not None:
            _remove_register_record(self._register_path)
            self._register_path = None
        for plane in self.planes.values():
            plane.close()
        if self.sink is not None:
            self.write_stats(final=True)


def _write_register_record(path: str, url: Optional[str]) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"url": url}, f)
    os.replace(tmp, path)


def _remove_register_record(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass  # already gone (a second drain, shutdown after a drain)


def kernel_launches() -> dict:
    """Launch counts of the port's CUDA kernels (``/stats``)."""
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import matmul_i8

    return {"matmul_i8": matmul_i8.launches}


class _Handler(BaseHTTPRequestHandler):
    # Per-request stderr lines would swamp the log at serving rates.
    def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
        pass

    @property
    def ctx(self) -> ServeContext:
        return self.server.ctx  # type: ignore[attr-defined]

    def _reply(self, code: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, str(value))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass  # the client gave up and closed the socket

    def _plane_stats(self, plane: ModelPlane) -> dict:
        """One plane's /stats payload (the single-model schema)."""
        ctx = self.ctx
        stats = plane.serve_log.snapshot()
        stats["warmup"] = plane.warmup_log.stats()
        stats["buckets"] = list(plane.engine.buckets)
        stats["model_epoch"] = plane.engine.params_epoch
        stats["serve_mode"] = ctx.serve_mode
        stats["serve_precision"] = ctx.serve_precision
        stats["fused"] = ctx.fused
        stats["device"] = str(plane.device)
        stats["staging_allocated"] = plane.engine.staging_allocated()
        stats["kernel_launches"] = kernel_launches()
        if plane.fetcher is not None:
            stats["delta_fetch"] = {"last": dict(plane.fetcher.last),
                                    "total": dict(plane.fetcher.total)}
        if ctx.cache is not None:
            cache_block = ctx.cache.snapshot()
            cache_block["collapsed"] = plane.batcher.collapsed
            stats["cache"] = cache_block
        if ctx.price_admission and plane.batcher.cost_model is not None:
            stats["cost_model"] = plane.batcher.cost_model.snapshot()
        if plane.canary is not None:
            stats["canary"] = plane.canary.snapshot()
        if plane.autoscaler is not None:
            stats["autoscaler"] = plane.autoscaler.snapshot()
        if plane.pool is not None:
            stats["serve_devices"] = plane.pool.n_devices
            stats["max_inflight"] = ctx.max_inflight
            # Read live from the pool: a /resize or a regroup shows on
            # the next fetch.
            topo = plane.pool.topology()
            for key in ("topology_generation", "groups", "active_groups",
                        "quarantined_groups", "regroups", "failovers"):
                stats[key] = topo[key]
        return stats

    def _stats(self) -> dict:
        """The default plane's schema at the top level; a multi-model
        server adds ``model_set``, one ``models`` block per plane and the
        ``fair_dispatch`` block."""
        ctx = self.ctx
        stats = self._plane_stats(ctx.planes[ctx.default_model])
        if ctx.multi_model:
            stats["model_set"] = sorted(ctx.planes)
            stats["models"] = {name: self._plane_stats(plane)
                               for name, plane in sorted(ctx.planes.items())}
            if ctx.fair_gate is not None:
                stats["fair_dispatch"] = ctx.fair_gate.snapshot()
        if ctx.quotas is not None:
            stats["quota"] = ctx.quotas.snapshot()
        stats["draining"] = ctx.draining
        stats["active_requests"] = ctx.active_requests()
        return stats

    def do_GET(self) -> None:  # noqa: N802 - stdlib name
        ctx = self.ctx
        if self.path == "/healthz":
            payload = {
                "ok": True,
                "model": ctx.model_name,
                "model_epoch": ctx.engine.params_epoch,
                "checkpoint": ctx.checkpoint_path,
                "uptime_s": round(time.time() - ctx.t_start, 3),
                "draining": ctx.draining,
            }
            if ctx.multi_model:
                payload["models"] = {
                    name: plane.engine.params_epoch
                    for name, plane in sorted(ctx.planes.items())}
            self._reply(200, payload)
        elif self.path == "/stats":
            self._reply(200, self._stats())
        elif self.path.startswith("/chunks/"):
            self._do_chunk(self.path[len("/chunks/"):])
        else:
            self._reply(404, {"error": f"no route {self.path!r}"})

    def _do_chunk(self, digest: str) -> None:
        """``GET /chunks/<sha256>``: one chunk of the local store, so peers
        fetch a publish's bytes from each other rather than all from the
        source. ``Range: bytes=N-`` resumes a torn fetch from byte N (206
        with a Content-Range; 416 past the end); any other Range is
        ignored (200, the whole chunk)."""
        from pytorch_distributed_mnist_tpu_torch.distrib.cas import (
            CHUNK_DIR,
            is_digest,
        )

        if not is_digest(digest):
            self._reply(404, {"error": "malformed chunk digest"})
            return
        for directory in self.ctx.chunk_dirs():
            try:
                with open(os.path.join(directory, CHUNK_DIR, digest),
                          "rb") as f:
                    data = f.read()
            except OSError:
                continue
            start = 0
            match = re.fullmatch(r"bytes=(\d+)-",
                                 (self.headers.get("Range") or "").strip())
            if match:
                start = int(match.group(1))
                if start >= len(data):
                    self._reply(416, {"error": f"range start {start} past "
                                               f"chunk end {len(data)}"},
                                headers={"Content-Range":
                                         f"bytes */{len(data)}"})
                    return
            body = data[start:]
            try:
                self.send_response(206 if start else 200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                if start:
                    self.send_header(
                        "Content-Range",
                        f"bytes {start}-{len(data) - 1}/{len(data)}")
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                pass  # the client went away mid-transfer
            return
        self._reply(404, {"error": f"no chunk {digest}"})

    def do_POST(self) -> None:  # noqa: N802 - stdlib name
        if self.path == "/resize":
            self._do_resize()
            return
        if self.path == "/drain":
            self._do_drain()
            return
        if self.path != "/predict":
            self._reply(404, {"error": f"no route {self.path!r}"})
            return
        ctx = self.ctx
        # The active counter brackets the whole predict path and the
        # drain gate sits inside it, so a drain observer that sees
        # `draining && active_requests == 0` cannot race a request.
        ctx.predict_begin()
        try:
            if ctx.draining:
                self._reject_draining()
                return
            self._do_predict()
        finally:
            ctx.predict_end()

    def _reject_draining(self) -> None:
        ctx = self.ctx
        length = int(self.headers.get("Content-Length", 0))
        if 0 < length <= MAX_BODY_BYTES:
            self.rfile.read(length)
        depth = sum(p.batcher.queue_depth() for p in ctx.planes.values())
        rate = max(p.batcher.drain_rps() for p in ctx.planes.values())
        retry_after = min(30.0, max(1.0, depth / rate if rate > 0 else 1.0))
        self._reply(
            503,
            {"error": "draining", "draining": True,
             "retry_after_s": round(retry_after, 3)},
            headers={"Retry-After": max(1, round(retry_after))})

    def _do_drain(self) -> None:
        ctx = self.ctx
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            self._reply(413, {"error": "oversized /drain body"})
            return
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            drain = payload.get("drain", True)
            if not isinstance(drain, bool):
                raise ValueError("'drain' must be a boolean")
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        prev = ctx.set_draining(drain)
        if prev != drain:
            ctx.serve_log.record_pool_event(
                "serve_drain", draining=drain,
                active_requests=ctx.active_requests())
        self._reply(200, {"ok": True, "draining": drain,
                          "was_draining": prev,
                          "active_requests": ctx.active_requests()})

    def _do_predict(self) -> None:
        ctx = self.ctx
        t0 = time.perf_counter()
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            self._reply(413, {"error": f"body over {MAX_BODY_BYTES} bytes;"
                                       f" batch client-side"})
            return
        raw_body = self.rfile.read(length) or b"{}"
        try:
            payload = json.loads(raw_body)
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            plane = ctx.plane_for(payload.get("model"))
            klass = payload.get("priority") or None
            if klass is not None:
                priority_rank(klass)  # 400 on an unknown class
            client_id = payload.get("client_id")
            if client_id is not None and not isinstance(client_id, str):
                raise ValueError("client_id must be a string")
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        # Response-cache probe: the key is the raw request bytes plus what
        # else shapes the answer; the probe snapshots the invalidation
        # generation so an insert after a concurrent swap is dropped.
        cache = ctx.cache
        if cache is not None and plane.canary is not None \
                and plane.canary.state == CANARY_SHADOW:
            # A shadowing canary judges dispatched traffic only: answering
            # repeats from the cache (or collapsing them, the key is also
            # the collapse key) would starve its comparison stream.
            cache = None
        ckey, hit_value, gen = None, None, 0
        if cache is not None:
            ckey = request_key(raw_body, plane.model_name, ctx.serve_mode,
                               ctx.serve_precision)
            hit_value, _hit_epoch, gen = cache.get(ckey)
        if ctx.quotas is not None:
            cost = 1.0
            if ctx.price_admission:
                if hit_value is not None:
                    cost = HIT_COST
                elif plane.batcher.cost_model is not None:
                    cost = plane.batcher.cost_model.price(
                        _estimate_rows(payload.get("images")))
            admitted, retry_after = ctx.quotas.admit(
                client_id, klass or PRIORITY_CLASSES[0], cost=cost)
            if not admitted:
                plane.serve_log.record_rejection(klass=klass, quota=True)
                self._reply(
                    429,
                    {"error": "quota exceeded",
                     "priority": klass or PRIORITY_CLASSES[0],
                     "retry_after_s": retry_after},
                    headers={"Retry-After": max(1, round(retry_after))})
                return
        if hit_value is not None:
            predictions, hit_epoch = hit_value
            latency_s = time.perf_counter() - t0
            plane.serve_log.record_request(
                latency_s, queue_wait_s=0.0,
                images=len(predictions), klass=klass)
            reply = {
                "predictions": list(predictions),
                "model_epoch": hit_epoch,
                "latency_ms": round(latency_s * 1e3, 3),
            }
            if ctx.multi_model:
                reply["model"] = plane.model_name
            self._reply(200, reply, headers={"X-Cache": "hit"})
            return
        try:
            images = payload.get("images")
            if images is None:
                raise ValueError("body must be JSON {\"images\": ...}")
            arr = np.asarray(images, dtype=np.float32)
            # Raw 0-255 pixels over the wire; quantize to the exact uint8
            # domain training reads from disk.
            raw = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
            batch = plane.engine.preprocess(raw)
            if batch.shape[0] > ctx.max_request_images:
                raise ValueError(
                    f"{batch.shape[0]} images in one request (max "
                    f"{ctx.max_request_images}); batch client-side")
        except (ValueError, TypeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        try:
            # Each output row is (label, epoch of the params that computed
            # it), so a reply never names a checkpoint installed after its
            # batch ran. The cache key doubles as the collapse key.
            submit_cost = 1.0
            if ctx.price_admission and plane.batcher.cost_model is not None:
                submit_cost = plane.batcher.cost_model.price(
                    int(batch.shape[0]))
            out = plane.batcher.predict(batch, klass=klass,
                                        collapse_key=ckey, cost=submit_cost)
        except Overloaded as exc:
            payload = {"error": "overloaded", "detail": str(exc),
                       "priority": klass or PRIORITY_CLASSES[0]}
            headers = None
            if exc.retry_after_s is not None:
                payload["retry_after_s"] = exc.retry_after_s
                headers = {"Retry-After": max(1, round(exc.retry_after_s))}
            self._reply(503, payload, headers=headers)
            return
        except TimeoutError as exc:
            self._reply(504, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - a request never kills the server
            self._reply(500, {"error": repr(exc)})
            return
        epoch = int(out[0, 1])
        model_epoch = None if epoch < 0 else epoch
        predictions = [int(v) for v in out[:, 0]]
        reply = {
            "predictions": predictions,
            "model_epoch": model_epoch,
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
        if ctx.multi_model:
            reply["model"] = plane.model_name
        headers = None
        if cache is not None:
            cache.put(ckey, (predictions, model_epoch),
                      len(raw_body) + 16 * len(predictions) + 64,
                      epoch=model_epoch, generation=gen)
            headers = {"X-Cache": "miss"}
        self._reply(200, reply, headers=headers)

    def _do_resize(self) -> None:
        """``POST /resize``: ``{"serve_devices": N, "model": ...?}``
        re-shapes a plane's pool under live traffic (the new layout built
        and warmed while the old one serves, an atomic swap, in-flight
        batches finish on the old engines: zero dropped requests). Replies
        with the old and new topology. Refused (400) without a pool and
        under a canary; 409 while another resize runs."""
        ctx = self.ctx
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            self._reply(413, {"error": "oversized /resize body"})
            return
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
            plane = ctx.plane_for(
                payload.get("model") if isinstance(payload, dict) else None)
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        if plane.pool is None:
            self._reply(400, {
                "error": "resize needs the pooled data plane; start with "
                         "--serve-devices/--max-inflight (the default "
                         "single-engine server has no pool to re-shape)"})
            return
        if plane.canary is not None:
            # A resize mid-canary would re-shape the baseline pool only,
            # and the two planes' capacity would diverge under the
            # comparison: refused.
            self._reply(400, {
                "error": "resize is not supported while a precision "
                         "canary is active (--canary-fraction); the "
                         "baseline and shadow planes must keep the same "
                         "topology — restart to change it"})
            return
        try:
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object with "
                                 "serve_devices and/or serve_mesh")
            n_devices = payload.get("serve_devices")
            mesh_size = payload.get("serve_mesh")
            if n_devices is None and mesh_size is None:
                raise ValueError("body must be JSON with serve_devices "
                                 "and/or serve_mesh")
            if n_devices is not None:
                n_devices = int(n_devices)
            if mesh_size is not None:
                mesh_size = int(mesh_size)
        except (ValueError, TypeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        t0 = time.perf_counter()
        try:
            result = plane.pool.resize(n_devices=n_devices,
                                       mesh_size=mesh_size)
        except ValueError as exc:  # an invalid target: nothing changed
            self._reply(400, {"error": str(exc)})
            return
        except RuntimeError as exc:  # one resize at a time
            self._reply(409, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - an admin op never kills serving
            self._reply(500, {"error": repr(exc)})
            return
        self._reply(200, {"ok": True, **result,
                          "warm_s": round(time.perf_counter() - t0, 3)})


def _parse_buckets(spec: str):
    try:
        buckets = tuple(int(tok) for tok in spec.split(",") if tok.strip())
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints, "
                         f"got {spec!r}") from None
    if not buckets or min(buckets) < 1:
        raise SystemExit(f"--buckets needs at least one positive size, "
                         f"got {spec!r}")
    return buckets


def _parse_model_set(spec: str, list_models) -> dict:
    """``--model-set NAME=DIR[,NAME=DIR...]`` -> ordered ``{model:
    checkpoint_dir}``; flag-language exits on unknown models, duplicates
    or a malformed pair."""
    entries: dict = {}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, directory = tok.partition("=")
        name, directory = name.strip(), directory.strip()
        if not sep or not name or not directory:
            raise SystemExit(f"--model-set: expected MODEL=CHECKPOINT_DIR, "
                             f"got {tok!r}")
        if name not in list_models():
            raise SystemExit(f"--model-set names unknown model {name!r}; "
                             f"available: {list_models()}")
        if name in entries:
            raise SystemExit(f"--model-set names {name!r} twice (one plane "
                             f"per model; point retrains at one directory)")
        entries[name] = directory
    if not entries:
        raise SystemExit("--model-set needs at least one MODEL=DIR pair")
    return entries


def _parse_watermarks(spec: Optional[str]) -> ShedPolicy:
    if not spec:
        return ShedPolicy()
    marks = {}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        klass, sep, frac = tok.partition("=")
        if not sep:
            raise SystemExit(
                f"--shed-watermarks: expected CLASS=FRACTION, got {tok!r}")
        try:
            marks[klass.strip()] = float(frac)
        except ValueError:
            raise SystemExit(
                f"--shed-watermarks: {frac!r} is not a number") from None
    try:
        return ShedPolicy(marks)
    except ValueError as exc:
        raise SystemExit(f"--shed-watermarks: {exc}") from None


def _restore(args, model_name: str, checkpoint_dir: str, loader):
    """Boot restore, newest -> oldest, each checkpoint through ``loader``
    (the delta fetcher's: a manifest's chunks may come from peers): one
    corrupt or mismatched latest checkpoint must not turn a restart into
    an outage. Returns ``(path, params, epoch)``; seeded fresh params
    (path and epoch None) when nothing is loadable, unless
    ``--require-checkpoint``."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import init_params
    from pytorch_distributed_mnist_tpu_torch.serve.programs import (
        check_checkpoint_layout,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        _epoch_checkpoints,
        checkpoint_parallel_layout,
    )

    layout_rejection = None
    for _, candidate in reversed(_epoch_checkpoints(checkpoint_dir)):
        try:
            try:
                layout = checkpoint_parallel_layout(candidate)
            except Exception:  # noqa: BLE001 - let the load classify it
                layout = None
            check_checkpoint_layout(layout, REPLICATED, model_name)
        except ValueError as exc:
            if layout_rejection is None:
                layout_rejection = (candidate, str(exc))
            print(f"WARNING: cannot serve checkpoint {candidate!r} "
                  f"({exc}); trying the next-older epoch", flush=True)
            continue
        try:
            params, epoch = loader(candidate, model_name)
        except Exception as exc:  # noqa: BLE001 - keep walking older epochs
            print(f"WARNING: cannot serve checkpoint {candidate!r} "
                  f"({exc!r}); trying the next-older epoch", flush=True)
            continue
        print(f"serving checkpoint {candidate!r} (epoch {epoch})",
              flush=True)
        return candidate, params, epoch
    if layout_rejection is not None:
        raise SystemExit(f"{layout_rejection[0]!r}: {layout_rejection[1]}")
    if args.require_checkpoint:
        raise SystemExit(
            f"--require-checkpoint: no loadable published checkpoint in "
            f"{checkpoint_dir!r}")
    print(f"WARNING: no loadable checkpoint in {checkpoint_dir!r}; "
          f"serving fresh params (seed {args.seed}) until one is "
          f"published", flush=True)
    return None, init_params(model_name, args.seed), None


def _build_plane(args, model_name: str, checkpoint_dir: str, *,
                 shape: dict, sink, shed_policy, fair_gate,
                 multi_model: bool) -> ModelPlane:
    """One model's serving stack over the resolved data-plane ``shape``:
    the single-model server builds one, ``--model-set`` one per model
    (each with its own ServeLog, fetcher, watcher, canary and, when
    autoscaling, its own controller over its own pool)."""
    import functools

    import torch

    from pytorch_distributed_mnist_tpu_torch.distrib.fetch import (
        DeltaFetcher,
    )
    from pytorch_distributed_mnist_tpu_torch.models import (
        get_model,
        model_accepts,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.pool import EnginePool
    from pytorch_distributed_mnist_tpu_torch.serve.programs import (
        check_checkpoint_layout,
        get_precision,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        checkpoint_parallel_layout,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.device import device_name

    device, devices = shape["device"], shape["devices"]
    n_devices, pooled = shape["n_devices"], shape["pooled"]
    max_inflight = shape["max_inflight"]
    precision = args.serve_precision
    canary_fraction = float(args.canary_fraction or 0.0)
    fuse = not args.no_fuse
    buckets = _parse_buckets(args.buckets)
    model_kwargs = {}
    if args.dtype:
        model_kwargs["compute_dtype"] = {
            "bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]

    def _model_factory(plane_precision: str):
        """Fresh model modules for one precision plane: the int8 plane
        (and only it) runs the Dense layers through the int8 matmul
        kernel, so a canary's f32 baseline never runs the kernel it
        referees. One module per engine: the forward swaps a module's
        parameters for the length of a call."""
        kwargs = dict(model_kwargs)
        if plane_precision == "int8" and model_accepts(model_name, "matmul"):
            from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
                int8_linear,
            )

            kwargs["matmul"] = int8_linear
        return functools.partial(get_model, model_name, **kwargs)

    # The delta-distribution loader, at boot and for every reload. It
    # quantizes in the fetcher only when one plane owns its output: a
    # canary's f32 baseline must never receive quantized leaves.
    fetcher = DeltaFetcher(
        checkpoint_dir,
        precision=get_precision(precision) if not canary_fraction else None,
        peers=[u.strip() for u in (args.chunk_peers or "").split(",")
               if u.strip()],
        source_dir=args.chunk_source, workers=args.workers)
    boot_path, params, epoch = _restore(args, model_name, checkpoint_dir,
                                        fetcher.load)
    serve_log = ServeLog(window_s=args.stats_window_s)
    if sink is not None:
        serve_log.set_sink(
            sink, source=f"serve/{model_name}" if multi_model else "serve")
    warmup_log = WarmupLog()
    # Multi-model names: the model is the first dotted segment of every
    # engine and replica name ('cnn.r0', 'vit.int8').
    name_prefix = f"{model_name}." if multi_model else ""

    def _make_plane(plane_precision: str):
        """One data plane at ``plane_precision``: the direct path and the
        canary's two planes go through here, so they cannot drift."""
        factory = _model_factory(plane_precision)
        if pooled:
            return EnginePool(
                factory, params, devices=devices[:n_devices],
                buckets=buckets, serve_log=serve_log, params_epoch=epoch,
                workers=args.workers,
                quarantine_after=args.quarantine_after,
                precision=plane_precision, name_prefix=name_prefix,
                fuse=fuse, warmup_log=warmup_log)
        return InferenceEngine(
            factory(), params, buckets=buckets, serve_log=serve_log,
            params_epoch=epoch, precision=plane_precision,
            name=precision_engine_name(model_name if multi_model else None,
                                       plane_precision),
            fuse=fuse, device=device, workers=args.workers,
            warmup_log=warmup_log)

    def _tag(labels, epoch):
        # Row-tagged outputs (label, epoch): the epoch is captured with the
        # params inside the engine, so a reply names the checkpoint that
        # really computed it.
        tag = np.full_like(labels, -1 if epoch is None else epoch)
        return np.stack([labels, tag], axis=1)

    def _gated(dispatch_fn):
        """The weighted-fair grant on the batcher's dispatch thread, then
        the dispatch, outside the gate's lock."""
        if fair_gate is None:
            return dispatch_fn

        def gated(images):
            fair_gate.grant(model_name, int(images.shape[0]))
            return dispatch_fn(images)

        return gated

    batcher_kw = dict(max_wait_s=args.max_wait_ms / 1e3,
                      max_queue=args.max_queue, serve_log=serve_log,
                      shed_policy=shed_policy,
                      cost_model=CostModel(buckets),
                      priced=args.price_admission)
    t0 = time.perf_counter()
    pool = canary = None
    if canary_fraction:
        baseline = _make_plane("f32")
        candidate = _make_plane(precision)
        pool = baseline if pooled else None
        if pooled:
            # The baseline answers by default: its replica rows are the
            # ones /stats shows (the candidate registered last).
            serve_log.set_replicas_probe(baseline.snapshot)
        canary = engine = ShadowCanary(
            baseline, candidate, precision, fraction=canary_fraction,
            promote_after=args.canary_promote_after,
            budget=args.canary_budget, serve_log=serve_log)
        canary.warmup()
        batcher = MicroBatcher(
            None, max_batch=canary.max_batch,
            dispatch_fn=_gated(canary.dispatch),
            complete_fn=lambda handle: _tag(*canary.predict_complete(handle)),
            max_inflight=max_inflight, **batcher_kw).start()
    elif pooled:
        pool = engine = _make_plane(precision)
        pool.warmup()
        batcher = MicroBatcher(
            None, max_batch=pool.max_batch, dispatch_fn=_gated(pool.dispatch),
            complete_fn=lambda handle: _tag(*pool.predict_complete(handle)),
            max_inflight=max_inflight, **batcher_kw).start()
    else:
        engine = _make_plane(precision)
        engine.warmup()

        def infer(images):
            return _tag(*engine.predict_with_epoch(images))

        batcher = MicroBatcher(_gated(infer), max_batch=engine.max_batch,
                               **batcher_kw).start()
    warm_ms = warmup_log.stats()["totals"]["wall_ms"]
    words = []
    if canary is not None:
        words.append(f"f32 baseline + {precision} shadow canary (fraction "
                     f"{canary_fraction}, promote after "
                     f"{args.canary_promote_after} rows, budget "
                     f"{args.canary_budget})")
    elif precision != "f32":
        words.append(precision)
    if pooled:
        words.append(f"{n_devices} replica(s), in-flight window "
                     f"{max_inflight},")
    if fuse:
        words.append("fused")
    plane = "".join(w + " " for w in words)
    print(f"{model_name}: warmed {plane}bucket forwards "
          f"{list(engine.buckets)} on {device_name(device)} in "
          f"{time.perf_counter() - t0:.1f}s (warm-up wall {warm_ms:.0f} ms)",
          flush=True)

    watcher = None
    if not args.no_reload:
        def _validate_reload(path: str) -> None:
            check_checkpoint_layout(checkpoint_parallel_layout(path),
                                    REPLICATED, model_name)

        # A pool or canary's swap_params is the fan-out: one host-side
        # load, an atomic and stale-refusing install per replica.
        watcher = CheckpointWatcher(
            checkpoint_dir, model_name, engine.swap_params,
            poll_interval_s=args.poll_interval, serve_log=serve_log,
            current_path=boot_path, validate_fn=_validate_reload,
            loader=fetcher.load,
        ).start()

    autoscaler = None
    if args.autoscale:
        # The SLO loop over this plane's pool: its rolling-window p95 and
        # queue depth in, its resize out, one replica a step. Validated
        # in create_server before any plane was built.
        max_devices = args.autoscale_max_devices or len(devices)
        queue_high = max(1, int(args.autoscale_queue_high * args.max_queue))
        autoscaler = AutoScaler(
            pool, serve_log.window_stats, slo_p95_ms=args.slo_p95_ms,
            queue_high=queue_high,
            min_devices=args.autoscale_min_devices,
            max_devices=max_devices,
            interval_s=args.autoscale_interval_s,
            cooldown_s=args.autoscale_cooldown_s,
            down_after=args.autoscale_down_after,
            dry_run=args.autoscale_dry_run, serve_log=serve_log,
            model=model_name if multi_model else None,
        ).start()
        print(f"autoscaler: SLO p95 {autoscaler.slo_p95_ms}ms, queue high "
              f"{queue_high}, {autoscaler.min_devices}..{max_devices} "
              f"device(s), cooldown {autoscaler.cooldown_s}s"
              + (" [dry run]" if autoscaler.dry_run else ""), flush=True)

    return ModelPlane(
        model_name, engine, batcher, watcher, serve_log, boot_path,
        device=device, warmup_log=warmup_log, pool=pool, canary=canary,
        autoscaler=autoscaler, checkpoint_dir=checkpoint_dir,
        fetcher=fetcher)


def create_server(args) -> ThreadingHTTPServer:
    """Build the model plane(s) (engine or pool, batcher, watcher, and a
    canary and an autoscaler where asked, per model) and bind the HTTP
    server (socket bound, not yet serving: callers run ``serve_forever``
    themselves, so tests can boot on port 0 in-process).
    ``server.ctx.close()`` tears the serving stack down."""
    from pytorch_distributed_mnist_tpu_torch.models import list_models
    from pytorch_distributed_mnist_tpu_torch.utils import compile_cache
    from pytorch_distributed_mnist_tpu_torch.utils.device import (
        local_devices,
        resolve_device,
    )

    # The model set: --model-set wins, else --model/--checkpoint-dir is a
    # one-plane set.
    if args.model_set:
        model_dirs = _parse_model_set(args.model_set, list_models)
    else:
        if args.model not in list_models():
            raise SystemExit(f"unknown --model {args.model!r}; "
                             f"available: {list_models()}")
        model_dirs = {args.model: args.checkpoint_dir}
    multi_model = len(model_dirs) > 1
    if args.model_weights and not multi_model:
        raise SystemExit("--model-weights shapes multi-model dispatch; it "
                         "requires --model-set with >= 2 models")
    device = resolve_device(args.device)
    print(f"build directory: "
          f"{compile_cache.configure(getattr(args, 'compile_cache', None))}",
          flush=True)

    # The data plane's shape, shared by every model plane: N models serve
    # from one set of devices. The default (1 device, window 1) is the
    # single-engine plane.
    devices = local_devices(device.type)
    n_devices = args.serve_devices
    if n_devices == 0:
        n_devices = len(devices)
    if n_devices < 0 or n_devices > len(devices):
        raise SystemExit(f"--serve-devices {n_devices}: this host has "
                         f"{len(devices)} local device(s)")
    max_inflight = args.max_inflight
    if max_inflight < 0:
        raise SystemExit(f"--max-inflight {max_inflight}: must be >= 0")
    if max_inflight == 0:
        # One in-flight batch per replica plus one forming.
        max_inflight = n_devices + 1 if n_devices > 1 else 1
    pooled = n_devices > 1 or max_inflight > 1
    shape = {"device": device, "devices": devices, "n_devices": n_devices,
             "max_inflight": max_inflight, "pooled": pooled}

    # Control-plane flags, validated before any plane is built, so a bad
    # flag dies in milliseconds, not after the warm-ups.
    _parse_buckets(args.buckets)
    shed_policy = _parse_watermarks(args.shed_watermarks)
    quotas = None
    if args.quota_rps:
        try:
            quotas = ClientQuotas(parse_quota_spec(args.quota_rps),
                                  burst_s=args.quota_burst_s)
        except ValueError as exc:
            raise SystemExit(f"--quota-rps: {exc}") from None
        if not quotas.enabled:
            quotas = None
    canary_fraction = float(args.canary_fraction or 0.0)
    if canary_fraction:
        if args.serve_precision == "f32":
            raise SystemExit(
                "--canary-fraction shadows a quantized plane against the "
                "f32 baseline; pass a quantized --serve-precision "
                f"({serve_precisions()[1:]}) or drop the flag")
        if not 0.0 < canary_fraction <= 1.0:
            raise SystemExit(
                f"--canary-fraction {canary_fraction}: must be in (0, 1]")
        if args.canary_promote_after < 1:
            raise SystemExit(f"--canary-promote-after "
                             f"{args.canary_promote_after}: must be >= 1")
        if args.canary_budget < 0:
            raise SystemExit(
                f"--canary-budget {args.canary_budget}: must be >= 0")
    if args.autoscale_dry_run and not args.autoscale:
        raise SystemExit("--autoscale-dry-run modifies --autoscale; pass "
                         "both")
    if args.autoscale:
        if not pooled:
            raise SystemExit(
                "--autoscale actuates the pool's resize path; start the "
                "pooled data plane (--serve-devices N / --max-inflight) — "
                "the single-engine server has no topology to scale")
        if canary_fraction:
            raise SystemExit(
                "--autoscale cannot run under an active precision canary "
                "(--canary-fraction): a resize would re-shape only the "
                "baseline pool and the two planes' topology must not "
                "diverge")
        if args.autoscale_min_devices < 1:
            raise SystemExit("--autoscale-min-devices must be >= 1")
        max_dev = args.autoscale_max_devices
        if max_dev and max_dev > len(devices):
            raise SystemExit(
                f"--autoscale-max-devices {max_dev}: this host has "
                f"{len(devices)} local device(s)")
    fair_gate = None
    if multi_model:
        try:
            weights = parse_weight_spec(args.model_weights or "",
                                        list(model_dirs))
        except ValueError as exc:
            raise SystemExit(str(exc)) from None
        fair_gate = WeightedFairGate(weights)
    sink = JsonlSink(args.metrics_file) if args.metrics_file else None

    planes = {}
    for model_name, checkpoint_dir in model_dirs.items():
        planes[model_name] = _build_plane(
            args, model_name, checkpoint_dir, shape=shape, sink=sink,
            shed_policy=shed_policy, fair_gate=fair_gate,
            multi_model=multi_model)
    # One response cache for the process (keys carry the model name); its
    # invalidation hook on every plane's answering engine, pool or canary.
    cache_mb = 0.0 if args.no_cache else max(0.0, float(args.cache_mb))
    resp_cache = ResponseCache(int(cache_mb * (1 << 20)))
    if resp_cache.enabled:
        for plane in planes.values():
            plane.engine.add_swap_hook(resp_cache.bump_generation)
    if multi_model:
        print(f"multi-model serving: {sorted(planes)} from one "
              f"{n_devices}-device budget (weighted-fair dispatch "
              f"{fair_gate.weights}); requests route on their 'model' "
              f"field", flush=True)

    httpd = _HTTPServer((args.host, args.port), _Handler)
    httpd.daemon_threads = True
    httpd.ctx = ServeContext(  # type: ignore[attr-defined]
        planes, next(iter(model_dirs)), sink,
        max_request_images=args.max_request_images,
        max_inflight=max_inflight, serve_precision=args.serve_precision,
        quotas=quotas, fair_gate=fair_gate, fused=not args.no_fuse,
        cache=resp_cache if resp_cache.enabled else None,
        price_admission=args.price_admission)
    if args.register_dir:
        # Announced after the socket is bound (the real port is known,
        # port 0 included) and the planes are warm: a router that
        # discovers the record can route to it at once.
        port = httpd.server_address[1]
        adv_host = args.host if args.host not in ("", "0.0.0.0", "::") \
            else "127.0.0.1"
        httpd.ctx.enable_registration(args.register_dir,
                                      f"http://{adv_host}:{port}")
    return httpd


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    httpd = create_server(args)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port}  (/predict, /healthz, /stats)",
          flush=True)
    stop = threading.Event()
    if httpd.ctx.sink is not None and args.stats_interval > 0:
        def _periodic():
            while not stop.wait(args.stats_interval):
                httpd.ctx.write_stats()

        threading.Thread(target=_periodic, daemon=True,
                         name="serve-stats").start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", flush=True)
    finally:
        stop.set()
        httpd.ctx.close()
        httpd.server_close()


if __name__ == "__main__":
    main()
