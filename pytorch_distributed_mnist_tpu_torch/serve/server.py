"""The ``serve`` subcommand: a stdlib HTTP JSON inference endpoint.

Counterpart of the single-model, single-device path of
``pytorch_distributed_mnist_tpu/serve/server.py``.
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

Endpoints (one handler thread per connection, all funneling into the
batcher's worker, which owns device submission):

- ``POST /predict`` — body ``{"images": ...}``: one 28x28 image or a list
  of them, raw 0-255 pixel values. Replies ``{"predictions": [...],
  "model_epoch": e, "latency_ms": t}``; 503 under admission control.
- ``GET /healthz`` — liveness + which checkpoint epoch is serving.
- ``GET /stats`` — the ServeLog snapshot (latency quantiles, queue,
  batch-size histogram, reloads, rejections), the per-bucket warm-up
  record, the cache block and the kernels' launch counts.
- ``POST /drain`` — ``{"drain": true|false}`` closes/reopens /predict
  admission (503 + Retry-After) while in-flight requests complete.
- ``GET /chunks/<sha256>`` — the gossip plane of delta distribution: one
  chunk of this server's store (``<checkpoint-dir>/chunks/``), whole
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

Not ported yet: multi-device pools, sharded and pipeline serve modes,
the precision canary, multi-model serving, the autoscaler and fleet
registration. Their flags are absent from the parser rather than
accepted and ignored.
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
from pytorch_distributed_mnist_tpu_torch.serve.control import (
    PRIORITY_CLASSES,
    ClientQuotas,
    ShedPolicy,
    parse_quota_spec,
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
from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
    JsonlSink,
    ServeLog,
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


class ServeContext:
    """Everything one serving process owns; built by :func:`create_server`
    and shared with the HTTP handlers through the server object."""

    def __init__(self, model_name: str, engine, batcher, watcher,
                 serve_log, boot_path: Optional[str], sink,
                 max_request_images: int = 1024,
                 serve_precision: str = "f32", quotas=None,
                 fused: bool = True, cache=None,
                 price_admission: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 fetcher=None) -> None:
        self.model_name = model_name
        self.checkpoint_dir = checkpoint_dir
        self.fetcher = fetcher
        self.engine = engine
        self.batcher = batcher
        self.watcher = watcher
        self.serve_log = serve_log
        self.boot_path = boot_path
        self.sink = sink
        self.max_request_images = max_request_images
        self.serve_mode = REPLICATED
        self.serve_precision = serve_precision
        self.quotas = quotas
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

    @property
    def checkpoint_path(self) -> Optional[str]:
        if self.watcher is not None:
            return self.watcher.current_path
        return self.boot_path

    def chunk_dirs(self) -> list:
        """The checkpoint directories whose chunk stores ``GET
        /chunks/<sha256>`` searches (a digest names its bytes, so a hit in
        any store is the chunk)."""
        return [self.checkpoint_dir] if self.checkpoint_dir else []

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
        """Flip the drain gate; returns the previous state (idempotent)."""
        with self._drain_lock:
            prev, self.draining = self.draining, bool(draining)
        return prev

    def write_stats(self, **extra) -> None:
        if self.cache is not None:
            extra.setdefault("cache", self.cache.snapshot())
        self.serve_log.write_stats(**extra)

    def close(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        self.batcher.close()
        if self.sink is not None:
            self.write_stats(final=True)


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

    def _stats(self) -> dict:
        ctx = self.ctx
        stats = ctx.serve_log.snapshot()
        stats["warmup"] = ctx.engine.warmup_log.stats()
        stats["buckets"] = list(ctx.engine.buckets)
        stats["model_epoch"] = ctx.engine.params_epoch
        stats["serve_mode"] = ctx.serve_mode
        stats["serve_precision"] = ctx.serve_precision
        stats["fused"] = ctx.fused
        stats["device"] = str(ctx.engine.device)
        stats["staging_allocated"] = ctx.engine.staging_allocated()
        stats["kernel_launches"] = kernel_launches()
        if ctx.fetcher is not None:
            stats["delta_fetch"] = {"last": dict(ctx.fetcher.last),
                                    "total": dict(ctx.fetcher.total)}
        if ctx.cache is not None:
            cache_block = ctx.cache.snapshot()
            cache_block["collapsed"] = ctx.batcher.collapsed
            stats["cache"] = cache_block
        if ctx.price_admission and ctx.batcher.cost_model is not None:
            stats["cost_model"] = ctx.batcher.cost_model.snapshot()
        if ctx.quotas is not None:
            stats["quota"] = ctx.quotas.snapshot()
        stats["draining"] = ctx.draining
        stats["active_requests"] = ctx.active_requests()
        return stats

    def do_GET(self) -> None:  # noqa: N802 - stdlib name
        ctx = self.ctx
        if self.path == "/healthz":
            self._reply(200, {
                "ok": True,
                "model": ctx.model_name,
                "model_epoch": ctx.engine.params_epoch,
                "checkpoint": ctx.checkpoint_path,
                "uptime_s": round(time.time() - ctx.t_start, 3),
                "draining": ctx.draining,
            })
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
        depth = ctx.batcher.queue_depth()
        rate = ctx.batcher.drain_rps()
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
            model = payload.get("model")
            if model is not None and model != ctx.model_name:
                raise ValueError(f"unknown model {model!r}; this server "
                                 f"serves {[ctx.model_name]}")
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
        ckey, hit_value, gen = None, None, 0
        if cache is not None:
            ckey = request_key(raw_body, ctx.model_name, ctx.serve_mode,
                               ctx.serve_precision)
            hit_value, _hit_epoch, gen = cache.get(ckey)
        if ctx.quotas is not None:
            cost = 1.0
            if ctx.price_admission:
                if hit_value is not None:
                    cost = HIT_COST
                elif ctx.batcher.cost_model is not None:
                    cost = ctx.batcher.cost_model.price(
                        _estimate_rows(payload.get("images")))
            admitted, retry_after = ctx.quotas.admit(
                client_id, klass or PRIORITY_CLASSES[0], cost=cost)
            if not admitted:
                ctx.serve_log.record_rejection(klass=klass, quota=True)
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
            ctx.serve_log.record_request(
                latency_s, queue_wait_s=0.0,
                images=len(predictions), klass=klass)
            self._reply(200, {
                "predictions": list(predictions),
                "model_epoch": hit_epoch,
                "latency_ms": round(latency_s * 1e3, 3),
            }, headers={"X-Cache": "hit"})
            return
        try:
            images = payload.get("images")
            if images is None:
                raise ValueError("body must be JSON {\"images\": ...}")
            arr = np.asarray(images, dtype=np.float32)
            # Raw 0-255 pixels over the wire; quantize to the exact uint8
            # domain training reads from disk.
            raw = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
            batch = ctx.engine.preprocess(raw)
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
            if ctx.price_admission and ctx.batcher.cost_model is not None:
                submit_cost = ctx.batcher.cost_model.price(
                    int(batch.shape[0]))
            out = ctx.batcher.predict(batch, klass=klass,
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
        headers = None
        if cache is not None:
            cache.put(ckey, (predictions, model_epoch),
                      len(raw_body) + 16 * len(predictions) + 64,
                      epoch=model_epoch, generation=gen)
            headers = {"X-Cache": "miss"}
        self._reply(200, reply, headers=headers)


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


def _restore(args, model_name: str, loader):
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
    for _, candidate in reversed(_epoch_checkpoints(args.checkpoint_dir)):
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
            f"{args.checkpoint_dir!r}")
    print(f"WARNING: no loadable checkpoint in {args.checkpoint_dir!r}; "
          f"serving fresh params (seed {args.seed}) until one is "
          f"published", flush=True)
    return None, init_params(model_name, args.seed), None


def create_server(args) -> ThreadingHTTPServer:
    """Build engine + batcher + watcher and bind the HTTP server (socket
    bound, not yet serving: callers run ``serve_forever`` themselves, so
    tests can boot on port 0 in-process). ``server.ctx.close()`` tears the
    serving stack down."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.models import (
        get_model,
        list_models,
        model_accepts,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.programs import (
        check_checkpoint_layout,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        checkpoint_parallel_layout,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.device import (
        device_name,
        resolve_device,
    )

    from pytorch_distributed_mnist_tpu_torch.utils import compile_cache

    model_name = args.model
    if model_name not in list_models():
        raise SystemExit(f"unknown --model {model_name!r}; "
                         f"available: {list_models()}")
    device = resolve_device(args.device)
    print(f"build directory: "
          f"{compile_cache.configure(getattr(args, 'compile_cache', None))}",
          flush=True)
    buckets = _parse_buckets(args.buckets)
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
    sink = JsonlSink(args.metrics_file) if args.metrics_file else None

    model_kwargs = {}
    if args.dtype:
        model_kwargs["compute_dtype"] = {
            "bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    precision = args.serve_precision
    if precision == "int8" and model_accepts(model_name, "matmul"):
        # The int8 plane (and only it) runs the Dense layers through the
        # hand-written int8 matmul kernel.
        from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
            int8_linear,
        )

        model_kwargs["matmul"] = int8_linear
    model = get_model(model_name, **model_kwargs)

    # The delta-distribution loader, at boot and for every reload: a
    # manifest's missing chunks come from the peers, then the source, and
    # only its changed leaves are rebuilt and quantized again; npz files
    # and .ckpt directories take the whole-file load.
    from pytorch_distributed_mnist_tpu_torch.distrib.fetch import (
        DeltaFetcher,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.programs import (
        get_precision,
    )

    fetcher = DeltaFetcher(
        args.checkpoint_dir, precision=get_precision(precision),
        peers=[u.strip() for u in (args.chunk_peers or "").split(",")
               if u.strip()],
        source_dir=args.chunk_source, workers=args.workers)
    boot_path, params, epoch = _restore(args, model_name, fetcher.load)
    serve_log = ServeLog(window_s=args.stats_window_s)
    if sink is not None:
        serve_log.set_sink(sink, source="serve")
    fuse = not args.no_fuse
    t0 = time.perf_counter()
    engine = InferenceEngine(
        model, params, buckets=buckets, serve_log=serve_log,
        params_epoch=epoch, precision=precision,
        name=precision_engine_name(None, precision), fuse=fuse,
        device=device, workers=args.workers)
    engine.warmup()
    warm_ms = engine.warmup_log.stats()["totals"]["wall_ms"]
    plane = f"{precision} " if precision != "f32" else ""
    plane += "fused " if fuse else ""
    print(f"{model_name}: warmed {plane}bucket forwards "
          f"{list(engine.buckets)} on {device_name(device)} in "
          f"{time.perf_counter() - t0:.1f}s (warm-up wall {warm_ms:.0f} ms)",
          flush=True)

    def _tag(labels, epoch):
        # Row-tagged outputs (label, epoch): the epoch is captured with the
        # params inside the engine, so a reply names the checkpoint that
        # really computed it.
        tag = np.full_like(labels, -1 if epoch is None else epoch)
        return np.stack([labels, tag], axis=1)

    def infer(images):
        return _tag(*engine.predict_with_epoch(images))

    batcher = MicroBatcher(
        infer, max_batch=engine.max_batch,
        max_wait_s=args.max_wait_ms / 1e3, max_queue=args.max_queue,
        serve_log=serve_log, shed_policy=shed_policy,
        cost_model=CostModel(buckets), priced=args.price_admission,
    ).start()

    watcher = None
    if not args.no_reload:
        def _validate_reload(path: str) -> None:
            check_checkpoint_layout(checkpoint_parallel_layout(path),
                                    REPLICATED, model_name)

        watcher = CheckpointWatcher(
            args.checkpoint_dir, model_name, engine.swap_params,
            poll_interval_s=args.poll_interval, serve_log=serve_log,
            current_path=boot_path, validate_fn=_validate_reload,
            loader=fetcher.load,
        ).start()

    cache_mb = 0.0 if args.no_cache else max(0.0, float(args.cache_mb))
    resp_cache = ResponseCache(int(cache_mb * (1 << 20)))
    if resp_cache.enabled:
        engine.add_swap_hook(resp_cache.bump_generation)

    httpd = _HTTPServer((args.host, args.port), _Handler)
    httpd.daemon_threads = True
    httpd.ctx = ServeContext(  # type: ignore[attr-defined]
        model_name, engine, batcher, watcher, serve_log, boot_path, sink,
        max_request_images=args.max_request_images,
        serve_precision=precision, quotas=quotas, fused=fuse,
        cache=resp_cache if resp_cache.enabled else None,
        price_admission=args.price_admission,
        checkpoint_dir=args.checkpoint_dir, fetcher=fetcher)
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
