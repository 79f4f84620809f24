"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build: the card's name and power limit (``nvidia-smi``) and
   the build of every hand-written kernel from ``csrc/`` (``nvcc``,
   ``sm_90a``);
2. kernel against plain: ``matmul_i8`` against ``matmul_i8_plain`` on the
   card at every shape of the int8 serving path plus ragged ones; the int32
   outputs must be exactly equal;
3. timings: per path shape, the device time per call (``torch.profiler``'s
   CUDA trace) and the host's time between back-to-back calls (CUDA
   events) of the kernel's wrapper, its plain version and, where
   ``torch._int_mm`` takes the shape, that library call (timed here as a
   yardstick only; the port never calls it), beside the least time the
   card could take;
4. server: the port's server (``--model cnn --serve-precision int8``,
   fused plane, default buckets) boots in-process over a seeded checkpoint,
   answers concurrent and sequential ``/predict`` requests, ``/healthz`` and
   ``/stats``, and hot-reloads a newer checkpoint. Its replies are held
   against the same engine run with ``matmul_i8_plain`` on the card, and
   the kernel's launch count over this phase must rise;
5. forward profile: the device time of one int8 fused forward per bucket,
   by part (convs, pooling, the int8 products, elementwise work,
   reductions, copies), beside
   the host's wall time per forward;
6. the ``{"kernels": [...]}`` line, then the card's name and power limit,
   then ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises and exits non-zero. Without a CUDA card, or run from a
directory that does not hold the port's package beside this file, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

SEED = 0
PATH_BUCKETS = (1, 8, 32, 128)  # the server's default buckets
# The cnn's two Dense layers at the int8 plane: (K, N).
FC1 = (12544, 128)
FC2 = (128, 10)
# Shapes held against the plain version: every path shape plus ragged
# ones and linear's fc.
CHECK_SHAPES = ([(m,) + FC1 for m in PATH_BUCKETS]
                + [(m,) + FC2 for m in PATH_BUCKETS]
                + [(5, 784, 10), (33, 12544, 128), (3, 7, 5), (130, 200, 70)])
# Peak rates of the part nvidia-smi names (data sheets, dense): device
# memory bytes/s and int8 tensor-core operations/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 1513e12),
    "H100 NVL": (3.9e12, 1671e12),
    "H100": (3.35e12, 1979e12),  # SXM
    "H200": (4.8e12, 1979e12),
}
TPU_KERNEL = "pytorch_distributed_mnist_tpu/ops/pallas/matmul_i8.py:66"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def import_port():
    """The port's package, which must lie beside this file: a copy of the
    script alone must fail, not find an installed package elsewhere."""
    import pytorch_distributed_mnist_tpu_torch as pkg

    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != _HERE:
        raise SystemExit(f"chip_smoke.py: the port's package was found at "
                         f"{where}, not beside this script in {_HERE}")
    return pkg


def smi_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for part, rates in PEAKS.items():
        if part in name:
            return part, rates
    return "H100", PEAKS["H100"]


def bound_ms(m: int, k: int, n: int, peaks) -> tuple:
    """(least ms, what bounds it): operands read once (int8), the int32
    output written once, and 2*M*N*K int8 operations."""
    bytes_moved = m * k + k * n + 4 * m * n
    ops = 2 * m * n * k
    t_bytes = bytes_moved / peaks[0] * 1e3
    t_ops = ops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def call_ms(fn, iters: int = 50) -> float:
    """Mean ms between back-to-back calls of ``fn``: CUDA events around
    ``iters`` calls after a warm-up. At these shapes the host's launch
    work is longer than the device's, so this is the call's cost to the
    host thread, not the device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> dict:
    """Device time per call of ``fn``: every kernel, fill and copy it runs
    on the card, from the profiler's CUDA trace over ``iters`` calls.
    Returns ``{kernel name: ms per call}``; raises when the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per[evt.name] = (per.get(evt.name, 0.0)
                             + evt.time_range.elapsed_us() / iters / 1e3)
    if not per or sum(per.values()) <= 0:
        raise AssertionError("the profiler recorded no device time")
    return per


def int_mm_takes(m: int, k: int, n: int) -> bool:
    """``torch._int_mm``'s shape rules on CUDA: M > 16, K and N multiples
    of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def random_i8(shape, gen, device):
    import torch

    return torch.randint(-128, 128, shape, dtype=torch.int8, device=device,
                         generator=gen)


def phase_kernel_vs_plain(device) -> float:
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        matmul_i8,
        matmul_i8_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = 0
    for m, k, n in CHECK_SHAPES:
        a, b = random_i8((m, k), gen, device), random_i8((k, n), gen, device)
        got = matmul_i8(a, b)
        want = matmul_i8_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"matmul_i8 disagrees with its plain "
                                 f"version at {m}x{k}x{n}: max |err| {err}")
    # Extremes: the largest sum fc1 can reach, and a strided view of A.
    a = torch.full((4, FC1[0]), -128, dtype=torch.int8, device=device)
    b = torch.full(FC1, -128, dtype=torch.int8, device=device)
    if int(matmul_i8(a, b)[0, 0]) != 128 * 128 * FC1[0]:
        raise AssertionError("matmul_i8 worst-case sum is wrong")
    wide = random_i8((9, 800), gen, device)
    bb = random_i8((784, 10), gen, device)
    if not torch.equal(matmul_i8(wide[:, :784], bb),
                       matmul_i8_plain(wide[:, :784], bb)):
        raise AssertionError("matmul_i8 disagrees on a strided operand")
    torch.cuda.synchronize()
    emit("kernel_vs_plain", kernel="matmul_i8",
         shapes=[list(s) for s in CHECK_SHAPES], exact=True,
         max_abs_err=worst)
    return float(worst)


def phase_timings(device, peaks) -> list:
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        matmul_i8,
        matmul_i8_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = []
    for layer, (k, n) in (("fc1", FC1), ("fc2", FC2)):
        for m in PATH_BUCKETS:
            a, b = random_i8((m, k), gen, device), random_i8((k, n), gen,
                                                             device)
            calls = {"kernel": lambda: matmul_i8(a, b),
                     "plain": lambda: matmul_i8_plain(a, b)}
            if int_mm_takes(m, k, n):
                calls["library"] = lambda: torch._int_mm(a, b)
                # cuBLAS's fast int8 layout wants B column-major.
                b_cm = b.t().contiguous().t()
                calls["library_colmajor"] = lambda: torch._int_mm(a, b_cm)
            least, by = bound_ms(m, k, n, peaks)
            row = {"layer": layer, "m": m, "k": k, "n": n,
                   "bound_ms": least, "bound_us": least * 1e3,
                   "bound_by": by, "library_ms": None}
            for what, fn in calls.items():
                per = device_ms(fn)
                row[f"{what}_ms"] = sum(per.values())
                row[f"{what}_call_ms"] = call_ms(fn)
                if what == "kernel":
                    row["gemm_ms"] = sum(v for name, v in per.items()
                                         if "matmul_i8_kernel" in name)
            rows.append(row)
            emit("timing", kernel="matmul_i8", **row)
    return rows


class _Client:
    def __init__(self, port: int) -> None:
        self.base = f"http://127.0.0.1:{port}"

    def get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return json.loads(r.read())

    def post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())


def _requests(n_requests: int, seed: int):
    """``n_requests`` distinct batches of 1-40 synthetic images."""
    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.data.mnist import (
        synthetic_dataset,
    )

    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 41, size=n_requests)
    images, _ = synthetic_dataset(int(sizes.sum()), seed=seed)
    out, start = [], 0
    for size in sizes:
        out.append(images[start:start + size])
        start += size
    return out


def _engine(params, device, matmul):
    """The server's engine configuration (cnn, int8, fused, default
    buckets) with ``matmul`` as the int8 product."""
    import functools

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import int8_linear
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
    )

    model = get_model("cnn", matmul=functools.partial(int8_linear,
                                                      matmul=matmul))
    return InferenceEngine(model, params, precision="int8", fuse=True,
                           device=device)


def _kind(kernel: str) -> str:
    """A device kernel's part of the forward, by its name."""
    if "matmul_i8" in kernel:
        return "matmul_i8"
    if "conv" in kernel or "xmma" in kernel or "cudnn" in kernel:
        return "conv"
    if "pool" in kernel:
        return "pool"
    if "Memcpy" in kernel or "memcpy" in kernel:
        return "copy"
    if "reduce" in kernel:
        return "reduce"
    return "elementwise"


def phase_forward_profile(device) -> None:
    """Where one forward's device time goes, per bucket: the engine's
    fused int8 forward (H2D copy, normalize, quantize, dequantize, convs,
    the two int8 products, D2H copy) under the profiler, beside the host's
    wall time per forward."""
    import numpy as np
    import torch

    from pytorch_distributed_mnist_tpu_torch.models.convert import init_params
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import matmul_i8

    engine = _engine(init_params("cnn", SEED), device, matmul_i8)
    engine.warmup()
    for bucket in PATH_BUCKETS:
        raw = _requests(1, seed=SEED + 20)[0]
        raw = np.resize(raw, (bucket,) + raw.shape[1:])
        per = device_ms(lambda: engine.logits(raw))
        by_kind = {}
        for name, ms in per.items():
            by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
        iters = 50
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.logits(raw)
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
        device_total = sum(per.values())
        emit("forward_profile", bucket=bucket, wall_ms=wall_ms,
             device_ms=device_total, device_busy=device_total / wall_ms,
             by_kind_ms=by_kind,
             distinct_kernels=len(per), top=sorted(
                 ((ms, name[:90]) for name, ms in per.items()),
                 reverse=True)[:6])


def phase_server(device_flag: str = "cuda") -> int:
    """Boot, drive and reload the server; returns the kernel's launch
    count over the run. ``device_flag`` is the server's ``--device``."""
    import shutil

    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
        params_to_jax,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        matmul_i8,
        matmul_i8_plain,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.server import (
        build_parser,
        create_server,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        save_params_checkpoint,
    )

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    params0 = init_params("cnn", SEED)
    save_params_checkpoint(params_to_jax(params0), epoch=0,
                           directory=ckpt_dir)
    args = build_parser().parse_args([
        "--model", "cnn", "--serve-precision", "int8", "--port", "0",
        "--device", device_flag, "--checkpoint-dir", ckpt_dir,
        "--require-checkpoint", "--poll-interval", "0.5"])

    matmul_i8.launches = 0  # the main path's run starts here
    t_boot = time.perf_counter()
    httpd = create_server(args)
    boot_s = time.perf_counter() - t_boot
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    try:
        client = _Client(httpd.server_address[1])
        # Record every batch the engine runs (the batcher coalesces
        # requests), so each can be replayed through the reference.
        engine = httpd.ctx.engine
        batches = []
        served = engine.predict_with_epoch

        def recording(images):
            labels, epoch = served(images)
            batches.append((np.array(images), labels.copy()))
            return labels, epoch

        engine.predict_with_epoch = recording
        # Concurrent burst: requests from several threads share batches.
        burst = _requests(64, seed=SEED + 10)
        replies = [None] * len(burst)

        def worker(idx):
            for i in range(idx, len(burst), 4):
                replies[i] = client.post(
                    "/predict", {"images": burst[i].tolist()})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t0
        # Sequential requests: each is a batch of its own.
        sequential = _requests(12, seed=SEED + 11)
        seq_replies = [client.post("/predict", {"images": x.tolist()})
                       for x in sequential]
        health = client.get("/healthz")
        stats = client.get("/stats")
        launches = matmul_i8.launches  # the main path's run ends here

        if launches == 0:
            raise AssertionError("the int8 serving path launched no "
                                 "matmul_i8 kernel")
        if not health.get("ok") or health.get("model_epoch") != 0:
            raise AssertionError(f"/healthz: {health}")
        if stats.get("kernel_launches", {}).get("matmul_i8", 0) <= 0:
            raise AssertionError(f"/stats kernel_launches: "
                                 f"{stats.get('kernel_launches')}")
        for reply, x in zip(replies + seq_replies, burst + sequential):
            if (reply is None or len(reply["predictions"]) != len(x)
                    or reply["model_epoch"] != 0):
                raise AssertionError(f"bad /predict reply: {reply}")

        # Reference: the same engine with the plain int8 product on the
        # card. The int8 plane quantizes each Dense input per tensor over
        # its whole batch, so the reference replays the batches the
        # server formed; every one must give equal predictions.
        engine.predict_with_epoch = served
        ref = _engine(params0, engine.device, matmul_i8_plain)
        for images, labels in batches:
            want = ref.predict(images)
            if not np.array_equal(labels, want):
                raise AssertionError(
                    f"a served batch of {len(images)} disagrees with the "
                    f"plain reference on {int(np.sum(labels != want))} rows")
        for reply, x in zip(seq_replies, sequential):
            if reply["predictions"] != ref.predict(x).tolist():
                raise AssertionError("a sequential reply disagrees with "
                                     "the plain reference")
        rows = sum(len(x) for x in burst)
        if sum(len(x) for x, _ in batches) != rows + sum(
                len(x) for x in sequential):
            raise AssertionError("the recorded batches miss requests")
        logits = httpd.ctx.engine.logits(sequential[0])
        if logits.shape != (len(sequential[0]), 10) \
                or not np.all(np.isfinite(logits)):
            raise AssertionError(f"bad logits {logits.shape}")

        # Hot reload: publish epoch 1 and wait for the server to take it.
        save_params_checkpoint(params_to_jax(init_params("cnn", SEED + 1)),
                               epoch=1, directory=ckpt_dir)
        deadline = time.monotonic() + 10.0
        while client.get("/healthz")["model_epoch"] != 1:
            if time.monotonic() > deadline:
                raise AssertionError("model_epoch did not flip to 1")
            time.sleep(0.1)
        after = client.post("/predict", {"images": sequential[1].tolist()})
        if after["model_epoch"] != 1:
            raise AssertionError(f"reply after reload: {after}")
        lat = stats["latency_ms"]
        emit("server", requests=len(burst) + len(sequential),
             rows=rows + sum(len(x) for x in sequential),
             boot_s=boot_s, burst_s=burst_s, burst_rows_per_s=rows / burst_s,
             p50_ms=lat["p50"], p99_ms=lat["p99"],
             batch_histogram=stats["batch_histogram"],
             batches=len(batches), replies_exact=True,
             reload_epoch=1, launches=launches)
        return launches
    finally:
        httpd.shutdown()
        httpd.ctx.close()
        httpd.server_close()
        serving.join(timeout=30)
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main() -> int:
    import_port()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card is visible", file=sys.stderr)
        return 1
    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_name_and_limit()
    part, peaks = peaks_for(name)
    t0 = time.perf_counter()
    info = cuda_build.build()
    emit("device_build", device=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, peaks_of=part,
         build_s=time.perf_counter() - t0,
         kernels={k: {"build_s": v["seconds"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in info.items()})

    max_err = phase_kernel_vs_plain(device)
    rows = phase_timings(device, peaks)
    launches = phase_server()
    phase_forward_profile(device)

    main_row = next(r for r in rows if r["layer"] == "fc1" and r["m"] == 128)
    kernels = [{
        "name": "matmul_i8",
        "route": "cuda",
        "source": "pytorch_distributed_mnist_tpu_torch/csrc/matmul_i8.cu",
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max_err,
        "matched": max_err == 0,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "gemm_ms": main_row["gemm_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": "fc1 128x12544x128",
        "shapes": rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
