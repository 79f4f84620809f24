"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build: the card's name and power limit (``nvidia-smi``) and
   the build of every hand-written kernel from ``csrc/`` (``nvcc``,
   ``sm_90a``, one process per source, all at once);
2. kernel against plain: ``matmul_i8`` against ``matmul_i8_plain`` on the
   card at every shape of the int8 serving path plus ragged ones (exactly
   equal, and the same bits on a second call), with the split-K plan of
   each shape; the cross-entropy kernels against ``xent_fwd_plain`` /
   ``xent_bwd_plain`` at B in {1, 7, 256, 300} and C in {10, 128} with
   saturated tie rows (``rtol=atol=1e-6``: the sum of exp is taken in
   another order); the Adam kernel against ``adam_leaf_plain`` at every
   cnn leaf shape and two ragged sizes, for steps 1, 2 and 10 (bitwise);
3. timings: per path shape, the device time per call (``torch.profiler``'s
   CUDA trace) and the host's time between back-to-back calls (CUDA
   events) of each kernel's wrapper, its plain version and one PyTorch
   call computing the same function (``torch._int_mm``,
   ``F.cross_entropy`` and its backward, ``torch.optim.Adam(fused=True)``;
   timed here as yardsticks only, the port never calls them), beside the
   least time the card could take; Adam also over the ViT's 31 leaves;
4. server: the port's server (``--model cnn --serve-precision int8``,
   fused plane, default buckets) boots in-process over a seeded checkpoint,
   answers concurrent and sequential ``/predict`` requests, ``/healthz`` and
   ``/stats``, and hot-reloads a newer checkpoint. Its replies are held
   against the same engine run with ``matmul_i8_plain`` on the card, and
   the kernel's launch count over this phase must rise;
5. forward profile: the device time of one int8 fused forward per bucket,
   by part (convs, pooling, the int8 products, elementwise work,
   reductions, copies), beside the host's wall time per forward;
6. train: the port's CLI ``run()`` in-process, ``--model cnn --loss fused
   --optimizer adam_pallas``, 2 epochs of 8192 synthetic images at batch
   256: both epoch lines, a falling train loss, test accuracy >= 90%,
   exact launch counts of the three training kernels, 32-leaf
   checkpoints, a resume from ``checkpoint_0.npz`` that repeats epoch 1's
   line, and ``-e`` on ``model_best.npz``;
7. train profile: the device time of one train step by part (convs, the
   fc products, the cross-entropy kernels, Adam, other elementwise work,
   copies), beside the host's wall time per step and its time per part
   (batch copy, forward, loss, backward, optimizer, metrics);
8. flash against plain: the forward, dQ and dK/dV kernels against
   ``flash_fwd_plain`` / ``flash_dq_plain`` / ``flash_dkv_plain``, and
   ``flash_bwd`` (the fused backward kernel, or the dQ and dK/dV kernels,
   as its route says) against ``flash_bwd_plain``, twice, for the same
   bits, at the ViT's shape (256, 49, 4, 16) and at T in {1, 16, 70, 100,
   128, 130, 196, 200}, D in {8, 16, 32, 48, 64, 128}, float32 and
   bfloat16, causal and not (``flash_tolerance`` states each tolerance
   and why), with the route each forward and backward took and the share
   of its tolerance each used; in bf16 also the CUDA-core forward;
9. flash timings: device ms per call of the kernels at the ViT's shape in
   bf16 (the tensor-core forward beside the CUDA-core one, which is also
   timed in float32, its route's dtype), their plain versions,
   ``F.scaled_dot_product_attention`` forward and backward as the
   yardstick, and each kernel's bound;
10. the split backward route on the attention path: ``flash_attention``
   forward and backward at (32, 196, 4, 16) bf16 and at the ViT's shape in
   float32 launch the dQ and dK/dV kernels (and not the fused one), with
   gradients held against ``flash_bwd_plain`` (the float32 case's forward
   takes the CUDA-core route);
11. train the ViT: as phase 6 with ``--model vit --attention flash``:
   test accuracy >= 88% after epoch 1, exact launch counts (flash_fwd
   160, all on the tensor-core route, flash_bwd 128, flash_dq and flash_dkv
   0, xent 80/64, adam 1984),
   101-leaf checkpoints, resume and ``-e``;
12. ViT train profile: as phase 7 for one ViT step (flash kernels, GEMMs,
   LayerNorm/GELU and other elementwise work, xent, Adam, copies);
13. the ``{"kernels": [...]}`` line, then the card's name and power limit,
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
# memory bytes/s, int8 tensor-core operations/s, float32 operations/s
# outside the tensor cores, bf16 tensor-core operations/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 1513e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 1671e12, 60e12, 835e12),
    "H100": (3.35e12, 1979e12, 67e12, 989e12),  # SXM
    "H200": (4.8e12, 1979e12, 67e12, 989e12),
}
TPU_KERNEL = "pytorch_distributed_mnist_tpu/ops/pallas/matmul_i8.py:66"
TPU_XENT_FWD = "pytorch_distributed_mnist_tpu/ops/pallas/xent.py:124"
TPU_XENT_BWD = "pytorch_distributed_mnist_tpu/ops/pallas/xent.py:154"
TPU_ADAM = "pytorch_distributed_mnist_tpu/ops/pallas/adam.py:64"
TPU_FLASH_FWD = "pytorch_distributed_mnist_tpu/ops/pallas/flash.py:147"
TPU_FLASH_BWD = "pytorch_distributed_mnist_tpu/ops/pallas/flash.py:274"
ADAM_BYTES = 28  # per param: p, g, m, v read; p, m, v written (float32)
CSRC = "pytorch_distributed_mnist_tpu_torch/csrc"
# The training path: batch 256 of cnn's 10 classes; the smoke's run.
TRAIN_BATCH = 256
CLASSES = 10
TRAIN_ARGS = ["--model", "cnn", "--loss", "fused", "--optimizer",
              "adam_pallas", "--dataset", "synthetic",
              "--synthetic-train-size", "8192", "--synthetic-test-size",
              "2048", "--batch-size", str(TRAIN_BATCH), "--seed", str(SEED)]
TRAIN_EPOCHS = 2
# The ViT's training path (--attention flash): its defaults (patch 4, 49
# tokens, embed 64, 4 heads of 16, depth 2), the same data and batch.
VIT_TRAIN_ARGS = ["--model", "vit", "--attention", "flash", "--loss",
                  "fused", "--optimizer", "adam_pallas", "--dataset",
                  "synthetic", "--synthetic-train-size", "8192",
                  "--synthetic-test-size", "2048", "--batch-size",
                  str(TRAIN_BATCH), "--seed", str(SEED)]
VIT_SHAPE = (TRAIN_BATCH, 49, 4, 16)  # (B, T, H, D) of each attention
VIT_DEPTH = 2
# What each training run's checks need: its flags, the train state's
# leaf count, the params the optimizer walks, the attention layers, and
# the test-accuracy floor after epoch 1. The ViT's floor sits a few
# points under the CPU rehearsal of the same command (92.68%, plain
# versions; README).
TRAIN_RUNS = {
    "cnn": {"args": TRAIN_ARGS, "leaves": 32, "params": 8, "depth": 0,
            "floor": 0.90},
    "vit": {"args": VIT_TRAIN_ARGS, "leaves": 101, "params": 31,
            "depth": VIT_DEPTH, "floor": 0.88},
}
# Shapes the flash kernels are held against their plain versions at: the
# ViT's, then T in {1, 16, 196, 200} and D in {16, 32, 64, 128} at small
# B*H, D = 8 (below one thread's 16 dims), and for the fused backward
# (bf16, T <= 128) its widest case T = 128, D = 128 and a D of 48 that its
# 16-wide tiles pad.
FLASH_CHECK_SHAPES = [VIT_SHAPE, (2, 1, 2, 16), (2, 16, 2, 16),
                      (2, 196, 2, 16), (2, 200, 2, 64), (1, 200, 2, 128),
                      (3, 130, 2, 32), (1, 70, 1, 8), (2, 128, 2, 128),
                      (3, 100, 3, 48)]
# The split backward route's cases on the attention path: a T above the
# fused kernel's 128 (the ViT at --patch-size 2 has 196 tokens) in bf16,
# and the ViT's shape in float32.
SPLIT_ROUTE_CASES = [((32, 196, 4, 16), "bfloat16"), (VIT_SHAPE, "float32")]


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
    Returns ``{kernel name: ms per call}``. Now and then a trace comes back
    without its device events although the calls ran; such a trace is
    taken again, up to three times in all, then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {}
        for evt in prof.events():
            # A named range (``Optimizer.step#...``) is mirrored onto the
            # device's timeline as an annotation spanning its kernels: it
            # is not device work of its own.
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(evt, "is_user_annotation", False)
                    and not evt.name.startswith("Optimizer.")):
                per[evt.name] = (per.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / iters / 1e3)
        if per and sum(per.values()) > 0:
            return per
        print("chip_smoke.py: a profiler trace held no device time; taking "
              "it again", file=sys.stderr, flush=True)
    raise AssertionError("the profiler recorded no device time")


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
        _sm_count,
        matmul_i8,
        matmul_i8_plain,
        split_k,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = 0
    plans = {}
    for m, k, n in CHECK_SHAPES:
        a, b = random_i8((m, k), gen, device), random_i8((k, n), gen, device)
        got = matmul_i8(a, b)
        again = matmul_i8(a, b)
        want = matmul_i8_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"matmul_i8 disagrees with its plain "
                                 f"version at {m}x{k}x{n}: max |err| {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"matmul_i8 gave other bits on a second "
                                 f"call at {m}x{k}x{n}")
        plans[f"{m}x{k}x{n}"] = split_k(m, n, k, _sm_count(device.index))
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
         same_bits_twice=True, max_abs_err=worst,
         split_k_plans={key: {"splits": sp, "cluster": cl}
                        for key, (sp, cl) in plans.items()})
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


def ulps(a, b) -> int:
    """Largest distance in float32 units in the last place between two
    tensors (their int32 bit patterns; 0 when bitwise equal)."""
    import torch

    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def xent_inputs(b: int, c: int, gen, device):
    """Logits (scale 3) with saturated rows: row 0 at the exact tie
    (``lse == picked`` in float32), row 1 ``[1e4, 0, ...]``; labels and an
    upstream gradient."""
    import torch

    logits = torch.randn(b, c, device=device, generator=gen) * 3
    labels = torch.randint(0, c, (b,), device=device, generator=gen)
    logits[0] = 0.0
    logits[0, 0] = 20.0
    labels[0] = 0
    if b > 1:
        logits[1] = 0.0
        logits[1, 1] = 1e4
        labels[1] = 1
    g = torch.rand(b, device=device, generator=gen)
    return logits, labels, g


def adam_hyper_scalars(device):
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops.adam import ADAM_DEFAULTS

    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in {"learning_rate": 1e-3, **ADAM_DEFAULTS}.items()}


def leaf_shapes(model: str = "cnn"):
    """The model's param shapes (cnn: 8, vit: 31), in the order the
    optimizer walks them."""
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        jax_param_order,
    )

    params = dict(get_model(model).named_parameters())
    return [(n, tuple(params[n].shape)) for n in jax_param_order(params)]


def phase_train_kernels_vs_plain(device) -> dict:
    """The cross-entropy and Adam kernels against their plain versions on
    the card; returns each kernel's largest error."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import adam, xent

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    worst = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    for b in (1, 7, 256, 300):
        for c in (10, 128):
            logits, labels, g = xent_inputs(b, c, gen, device)
            loss, lse = xent.xent_fwd(logits, labels)
            want_loss, want_lse = xent.xent_fwd_plain(logits, labels)
            # Both backwards from the kernel's lse, so they gate alike.
            dl = xent.xent_bwd(logits, labels, lse, g)
            want_dl = xent.xent_bwd_plain(logits, labels, lse, g)
            torch.cuda.synchronize()
            for got, want in ((loss, want_loss), (lse, want_lse),
                              (dl, want_dl)):
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            if float(loss[0]) != 0.0:
                raise AssertionError("the tie row's loss is not clamped to 0")
            worst["xent_fwd"] = max(worst["xent_fwd"], float(max(
                (loss - want_loss).abs().max(), (lse - want_lse).abs().max())))
            worst["xent_bwd"] = max(worst["xent_bwd"],
                                    float((dl - want_dl).abs().max()))
    hyper = adam_hyper_scalars(device)
    sizes = [s for _, s in leaf_shapes()] + [(1,), (1000003,)]
    adam_err, adam_ulps = 0.0, 0
    for shape in sizes:
        for t in (1, 2, 10):
            h = adam.adam_hypers(hyper, torch.tensor(float(t),
                                                     device=device))
            p, g = (torch.randn(shape, device=device, generator=gen)
                    for _ in range(2))
            m = torch.randn(shape, device=device, generator=gen) * 0.1
            v = torch.rand(shape, device=device, generator=gen) * 0.01
            got = [p.clone(), m.clone(), v.clone()]
            want = [p.clone(), m.clone(), v.clone()]
            adam.adam_leaf(got[0], g, got[1], got[2], h)
            adam.adam_leaf_plain(want[0], g, want[1], want[2], h)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                adam_err = max(adam_err, float((a - b).abs().max()))
                adam_ulps = max(adam_ulps, ulps(a, b))
    if adam_ulps > 2:
        raise AssertionError(f"adam kernel is {adam_ulps} ulp from its "
                             f"plain version (at most 2 allowed)")
    emit("kernel_vs_plain", kernel="xent_fwd+xent_bwd",
         batches=[1, 7, 256, 300], classes=[10, 128], rtol=1e-6, atol=1e-6,
         max_abs_err_fwd=worst["xent_fwd"], max_abs_err_bwd=worst["xent_bwd"])
    emit("kernel_vs_plain", kernel="adam", shapes=[list(s) for s in sizes],
         steps=[1, 2, 10], bitwise=adam_ulps == 0, max_ulp=adam_ulps,
         max_abs_err=adam_err)
    return {**worst, "adam": adam_err}


def _kernel_ms(per: dict, name: str) -> float:
    return sum(v for k, v in per.items() if name in k)


def phase_train_timings(device, peaks) -> dict:
    """Device and host ms of each training kernel at the path's shapes:
    xent at 256 x 10, Adam per cnn leaf and over all 8."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_mnist_tpu_torch.ops import adam, xent

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    bw, _, f32_rate, _ = peaks
    b, c = TRAIN_BATCH, CLASSES
    logits, labels, g = xent_inputs(b, c, gen, device)
    _, lse = xent.xent_fwd(logits, labels)
    rows = {}

    # Bytes: each input read once, each output written once; operations:
    # about 4 float32 operations per logit (max, subtract, exp, add) and 5
    # in the backward (subtract, exp, subtract, two multiplies).
    fwd_bytes = 4 * b * c + 8 * b + 4 * b + 4 * b
    bwd_bytes = 4 * b * c + 8 * b + 4 * b + 4 * b + 4 * b * c
    x_lib = logits.clone().requires_grad_(True)
    out_lib = F.cross_entropy(x_lib, labels, reduction="none")
    for name, bytes_moved, ops, calls in (
            ("xent_fwd", fwd_bytes, 4 * b * c, {
                "kernel": lambda: xent.xent_fwd(logits, labels),
                "plain": lambda: xent.xent_fwd_plain(logits, labels),
                "library": lambda: F.cross_entropy(logits, labels,
                                                   reduction="none")}),
            ("xent_bwd", bwd_bytes, 5 * b * c, {
                "kernel": lambda: xent.xent_bwd(logits, labels, lse, g),
                "plain": lambda: xent.xent_bwd_plain(logits, labels, lse, g),
                "library": lambda: torch.autograd.grad(
                    out_lib, x_lib, g, retain_graph=True)})):
        t_bytes, t_ops = bytes_moved / bw * 1e3, ops / f32_rate * 1e3
        row = {"shape": [b, c], "bytes": bytes_moved,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        for what, fn in calls.items():
            row[f"{what}_ms"] = sum(device_ms(fn).values())
            row[f"{what}_call_ms"] = call_ms(fn)
        rows[name] = row
        emit("timing", kernel=name, **row)

    # Adam: one launch per cnn leaf, and one optimizer step over all 8
    # (the kernels plus the hypers vector's few scalar ops).
    hyper = adam_hyper_scalars(device)
    h = adam.adam_hypers(hyper, torch.tensor(3.0, device=device))
    leaves = []
    for name, shape in leaf_shapes():
        p = torch.randn(shape, device=device, generator=gen)
        p.grad = torch.randn(shape, device=device, generator=gen) * 1e-3
        leaves.append((name, p))
    per_leaf, total = [], {"kernel_ms": 0.0, "plain_ms": 0.0,
                           "kernel_call_ms": 0.0, "bound_ms": 0.0}
    for name, p in leaves:
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        n = p.numel()
        t_bytes = ADAM_BYTES * n / bw * 1e3
        t_ops = 15 * n / f32_rate * 1e3
        kper = device_ms(lambda: adam.adam_leaf(p, p.grad, m, v, h))
        row = {"leaf": name, "numel": n, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "kernel_ms": _kernel_ms(kper, "adam_kernel"),
               "kernel_call_ms": call_ms(
                   lambda: adam.adam_leaf(p, p.grad, m, v, h)),
               "plain_ms": sum(device_ms(lambda: adam.adam_leaf_plain(
                   p, p.grad, m, v, h)).values())}
        per_leaf.append(row)
        for key in total:
            total[key] += row[key]
    params = [p for _, p in leaves]
    fused = adam.FusedAdam(params, lr=1e-3)
    library = torch.optim.Adam(params, lr=1e-3, fused=True)
    step_per = device_ms(fused.step)
    total.update(numel=sum(r["numel"] for r in per_leaf),
                 step_ms=sum(step_per.values()),
                 step_call_ms=call_ms(fused.step),
                 library_ms=sum(device_ms(library.step).values()),
                 library_call_ms=call_ms(library.step))
    rows["adam"] = {"leaves": per_leaf, "all_8": total,
                    "vit_31": _adam_vit_timing(device, gen, h, bw, f32_rate)}
    emit("timing", kernel="adam", leaves=per_leaf, all_8=total,
         vit_31=rows["adam"]["vit_31"])
    return rows


def _adam_vit_timing(device, gen, h, bw, f32_rate) -> dict:
    """Adam over the ViT's 31 leaves (its ``--optimizer adam_pallas``
    step): the port's optimizer step (one kernel launch per leaf), the
    plain version on the same leaves, and ``torch.optim.Adam(fused=True)``
    (the yardstick, never called by the port), beside the byte bound."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import adam

    params = []
    for _, shape in leaf_shapes("vit"):
        p = torch.randn(shape, device=device, generator=gen)
        p.grad = torch.randn(shape, device=device, generator=gen) * 1e-3
        params.append(p)
    if len(params) != TRAIN_RUNS["vit"]["params"]:
        raise AssertionError(f"the ViT has {len(params)} leaves")
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]

    def plain():
        for p, (m, v) in zip(params, moments):
            adam.adam_leaf_plain(p, p.grad, m, v, h)

    fused = adam.FusedAdam(params, lr=1e-3)
    library = torch.optim.Adam(params, lr=1e-3, fused=True)
    numel = sum(p.numel() for p in params)
    t_bytes = ADAM_BYTES * numel / bw * 1e3
    t_ops = 15 * numel / f32_rate * 1e3
    per = device_ms(fused.step)
    return {"leaves": len(params), "numel": numel,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel_ms": _kernel_ms(per, "adam_kernel"),
            "step_ms": sum(per.values()), "step_call_ms": call_ms(fused.step),
            "plain_ms": sum(device_ms(plain).values()),
            "library_ms": sum(device_ms(library.step).values()),
            "library_call_ms": call_ms(library.step)}


def flash_tolerance(dtype) -> dict:
    """Kernel against plain version, per output. float32: the same
    products summed in another order (FMA chains over D and over keys with
    an online max, against torch's batched products after the row max),
    so ``rtol 1e-4`` with ``atol 1e-5`` times the output's largest value.
    bfloat16: both sum in float32 from the same bf16 inputs and round once
    at the output, where float32 noise can cross a rounding boundary: one
    bf16 step, ``rtol 2**-7``, with ``atol 2**-8`` times the largest value.
    lse and delta stay float32 in both."""
    import torch

    if dtype == torch.bfloat16:
        return {"rtol": 2.0 ** -7, "atol_scale": 2.0 ** -8}
    return {"rtol": 1e-4, "atol_scale": 1e-5}


def _close(name, got, want, tol, where) -> float:
    """Raises unless ``got`` is within ``tol`` of ``want``; returns the
    largest absolute error."""
    import torch

    got, want = got.float(), want.float()
    atol = tol["atol_scale"] * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=tol["rtol"], atol=atol,
                               msg=lambda m: f"{name} at {where}: {m}")
    return float((got - want).abs().max())


def tolerance_used(got, want, tol) -> float:
    """The largest share of ``tol``'s allowance (``atol + rtol * |want|``)
    that any element of ``got`` uses: at most 1 when ``_close`` passes."""
    got, want = got.float(), want.float()
    atol = tol["atol_scale"] * max(1.0, float(want.abs().max()))
    return float(((got - want).abs() / (atol + tol["rtol"] * want.abs()))
                 .max())


def flash_inputs(shape, dtype, gen, device):
    """q, k, v as the ViT hands them over (slices of one (B, T, 3, H, D)
    product) and an upstream gradient dO."""
    import torch

    b, t, h, d = shape
    qkv = torch.randn(b, t, 3, h, d, device=device, generator=gen).to(dtype)
    do = torch.randn(b, t, h, d, device=device, generator=gen).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do


def _bwd_counts(flash) -> tuple:
    return (flash.flash_bwd.launches, flash.flash_dq.launches,
            flash.flash_dkv.launches)


def phase_flash_vs_plain(device) -> dict:
    """The flash kernels against their plain versions on the card, at
    every shape of ``FLASH_CHECK_SHAPES``, float32 and bfloat16, causal and
    not; O, lse, dQ, delta, dK and dV all compared. Each backward kernel
    takes the plain forward's O and lse (and the dK/dV kernel the plain
    delta), so each is held against its plain version on the same inputs.
    ``flash_bwd`` runs twice on the same inputs: both calls must give the
    same bits, and only its route's counters may move (the fused kernel's,
    or the dQ and dK/dV kernels'). ``flash_fwd`` takes its route (the
    tensor-core kernel in bf16, the CUDA-core kernel in float32); in bf16
    the CUDA-core forward is held to the plain version too. Returns each
    kernel's largest error (``flash_fwd``: the tensor-core forward,
    ``flash_fwd_cuda_core``: the CUDA-core one)."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    worst = {"flash_fwd": 0.0, "flash_fwd_cuda_core": 0.0, "flash_dq": 0.0,
             "flash_dkv": 0.0, "flash_bwd": 0.0}
    routes, used, fwd_routes, fwd_used = {}, {}, {}, {}
    f32 = flash_tolerance(torch.float32)
    for shape in FLASH_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tol = flash_tolerance(dtype)
            for causal in (False, True):
                where = f"{shape} {dtype} causal={causal}"
                key = f"{'x'.join(map(str, shape))} {dtype}".replace(
                    "torch.", "")
                q, k, v, do = flash_inputs(shape, dtype, gen, device)
                fwd_route = flash._fwd_route(shape, dtype)
                before = dict(flash.flash_fwd.route_launches)
                o, lse = flash.flash_fwd(q, k, v, causal=causal)
                want_o, want_lse = flash.flash_fwd_plain(q, k, v,
                                                         causal=causal)
                if fwd_route == "tensor":
                    o_cc, lse_cc = flash.flash_fwd(q, k, v, causal=causal,
                                                   route="cuda_core")
                dq, delta = flash.flash_dq(q, k, v, want_o, want_lse, do,
                                           causal=causal)
                want_dq, want_delta = flash.flash_dq_plain(
                    q, k, v, want_o, want_lse, do, causal=causal)
                dk, dv = flash.flash_dkv(q, k, v, want_lse, want_delta, do,
                                         causal=causal)
                want_dk, want_dv = flash.flash_dkv_plain(
                    q, k, v, want_lse, want_delta, do, causal=causal)
                torch.cuda.synchronize()
                if o.dtype != dtype or dq.dtype != dtype \
                        or lse.dtype != torch.float32:
                    raise AssertionError(f"flash output dtypes at {where}")
                moved = {r: n - before[r]
                         for r, n in flash.flash_fwd.route_launches.items()}
                want_moved = ({"tensor": 1, "cuda_core": 1}
                              if fwd_route == "tensor"
                              else {"tensor": 0, "cuda_core": 1})
                if moved != want_moved:
                    raise AssertionError(f"flash_fwd's routes moved by "
                                         f"{moved} at {where}")
                fwd_key = ("flash_fwd" if fwd_route == "tensor"
                           else "flash_fwd_cuda_core")
                worst[fwd_key] = max(
                    worst[fwd_key],
                    _close(f"O ({fwd_route})", o, want_o, tol, where),
                    _close(f"lse ({fwd_route})", lse, want_lse, f32, where))
                if fwd_route == "tensor":
                    worst["flash_fwd_cuda_core"] = max(
                        worst["flash_fwd_cuda_core"],
                        _close("O (cuda_core)", o_cc, want_o, tol, where),
                        _close("lse (cuda_core)", lse_cc, want_lse, f32,
                               where))
                fwd_routes[key] = fwd_route
                fwd_used[key] = max(fwd_used.get(key, 0.0),
                                    tolerance_used(o, want_o, tol),
                                    tolerance_used(lse, want_lse, f32))
                worst["flash_dq"] = max(
                    worst["flash_dq"], _close("dQ", dq, want_dq, tol, where),
                    _close("delta", delta, want_delta, f32, where))
                worst["flash_dkv"] = max(
                    worst["flash_dkv"], _close("dK", dk, want_dk, tol, where),
                    _close("dV", dv, want_dv, tol, where))

                route = flash._bwd_route(shape, dtype)
                before = _bwd_counts(flash)
                got = flash.flash_bwd(q, k, v, want_o, want_lse, do,
                                      causal=causal)
                again = flash.flash_bwd(q, k, v, want_o, want_lse, do,
                                        causal=causal)
                torch.cuda.synchronize()
                moved = tuple(b - a for a, b in zip(before,
                                                    _bwd_counts(flash)))
                if moved != ((2, 0, 0) if route == "fused" else (0, 2, 2)):
                    raise AssertionError(f"flash_bwd on the {route} route "
                                         f"moved (bwd, dq, dkv) by {moved} "
                                         f"at {where}")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"flash_bwd gave other bits on a "
                                         f"second call at {where}")
                worst["flash_bwd"] = max(
                    worst["flash_bwd"],
                    *(_close(f"flash_bwd {name}", a, b, tol, where)
                      for name, a, b in zip(("dQ", "dK", "dV"), got,
                                            (want_dq, want_dk, want_dv))))
                routes[key] = route
                used[key] = max(used.get(key, 0.0), *(
                    tolerance_used(a, b, tol) for a, b in zip(
                        got, (want_dq, want_dk, want_dv))))
    emit("flash_vs_plain", shapes=[list(s) for s in FLASH_CHECK_SHAPES],
         dtypes=["float32", "bfloat16"], causal=[False, True],
         tolerance={"float32": flash_tolerance(torch.float32),
                    "bfloat16": flash_tolerance(torch.bfloat16)},
         max_abs_err=worst, flash_fwd_routes=fwd_routes,
         flash_fwd_tolerance_used=fwd_used, flash_bwd_routes=routes,
         flash_bwd_tolerance_used=used, flash_bwd_same_bits=True)
    return worst


def flash_bound_ms(kernel: str, shape, elem_bytes: int, peaks) -> tuple:
    """(least ms, what bounds it, bytes, operations) of one flash kernel:
    each input read once and each output written once (q, k, v, O, dO,
    dQ, dK, dV of ``elem_bytes`` each; lse and delta float32), against the
    products' 2 operations per multiply-add (two products in the forward,
    three in dQ, four in dK/dV, five in the fused backward) at the card's
    bf16 tensor-core rate (float32 problems at the card's float32 rate
    outside the tensor cores)."""
    b, t, h, d = shape
    tensor = b * t * h * d * elem_bytes
    row = b * h * t * 4
    bytes_moved, products = {
        # q, k, v in; O, lse out
        "flash_fwd": (3 * tensor + tensor + row, 2),
        "flash_fwd_cuda_core": (3 * tensor + tensor + row, 2),
        # q, k, v, O, dO, lse in; dQ, delta out
        "flash_dq": (5 * tensor + row + tensor + row, 3),
        # q, k, v, dO, lse, delta in; dK, dV out
        "flash_dkv": (4 * tensor + 2 * row + 2 * tensor, 4),
        # q, k, v, O, dO, lse in; dQ, dK, dV out (delta stays on chip)
        "flash_bwd": (5 * tensor + row + 3 * tensor, 5),
    }[kernel]
    ops = products * 2 * b * h * t * t * d
    t_bytes = bytes_moved / peaks[0] * 1e3
    t_ops = ops / (peaks[3] if elem_bytes == 2 else peaks[2]) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, bytes_moved, ops


# Each flash row's own kernel, by the name the profiler gives it.
FLASH_KERNEL_NAMES = {"flash_fwd": "flash_fwd_mma_kernel",
                      "flash_fwd_cuda_core": "flash_fwd_kernel",
                      "flash_dq": "flash_dq_kernel",
                      "flash_dkv": "flash_dkv_kernel",
                      "flash_bwd": "flash_bwd_kernel"}


def phase_flash_timings(device, peaks) -> dict:
    """Device ms per call of each flash kernel at the ViT's training shape
    in bf16, beside its plain version, its bound and the library yardstick
    (``F.scaled_dot_product_attention``'s forward, and its backward, which
    computes dQ, dK and dV in one call; timed here only, the port never
    calls it). The backward's yardstick is set against the fused kernel,
    and against the split pair (dQ then dK/dV) as one: neither split
    kernel alone computes what it computes. The tensor-core forward is
    timed beside the CUDA-core one at the same inputs (``cuda_core_ms``);
    the CUDA-core forward also has a row of its own in float32, the dtype
    its route takes on the attention path."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    q, k, v, do = flash_inputs(VIT_SHAPE, torch.bfloat16, gen, device)
    o, lse = flash.flash_fwd(q, k, v)
    _, delta = flash.flash_dq(q, k, v, o, lse, do)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt)
    lib_do = do.transpose(1, 2)
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), lib_do,
                                          retain_graph=True)
    qf, kf, vf, _ = flash_inputs(VIT_SHAPE, torch.float32, gen, device)
    calls = {
        "flash_fwd": {
            "kernel": lambda: flash.flash_fwd(q, k, v),
            "cuda_core": lambda: flash.flash_fwd(q, k, v, route="cuda_core"),
            "plain": lambda: flash.flash_fwd_plain(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))},
        "flash_fwd_cuda_core": {
            "kernel": lambda: flash.flash_fwd(qf, kf, vf),
            "plain": lambda: flash.flash_fwd_plain(qf, kf, vf),
            "library": lambda: F.scaled_dot_product_attention(
                qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2))},
        "flash_dq": {
            "kernel": lambda: flash.flash_dq(q, k, v, o, lse, do),
            "plain": lambda: flash.flash_dq_plain(q, k, v, o, lse, do)},
        "flash_dkv": {
            "kernel": lambda: flash.flash_dkv(q, k, v, lse, delta, do),
            "plain": lambda: flash.flash_dkv_plain(q, k, v, lse, delta, do)},
        "flash_bwd": {
            "kernel": lambda: flash.flash_bwd(q, k, v, o, lse, do),
            "plain": lambda: flash.flash_bwd_plain(q, k, v, o, lse, do),
            "library": lib_bwd},
    }
    rows = {}
    for name, fns in calls.items():
        dtype = "float32" if name == "flash_fwd_cuda_core" else "bfloat16"
        least, by, bytes_moved, ops = flash_bound_ms(
            name, VIT_SHAPE, 4 if dtype == "float32" else 2, peaks)
        row = {"shape": list(VIT_SHAPE), "dtype": dtype,
               "bytes": bytes_moved, "operations": ops, "bound_ms": least,
               "bound_by": by, "library_ms": None,
               "library_call": {
                   "flash_fwd": "F.scaled_dot_product_attention",
                   "flash_fwd_cuda_core": "F.scaled_dot_product_attention",
                   "flash_bwd": "its backward (dQ, dK and dV in one call)",
               }.get(name)}
        for what, fn in fns.items():
            per = device_ms(fn)
            row[f"{what}_ms"] = sum(per.values())
            row[f"{what}_call_ms"] = call_ms(fn)
            if what == "kernel":
                row["kernel_only_ms"] = _kernel_ms(per,
                                                   FLASH_KERNEL_NAMES[name])
            if what == "library":
                row["library_kernels"] = sorted(k[:60] for k in per)
        if name == "flash_bwd":
            # The split route's pair at the same inputs, in this call.
            row["split_pair_ms"] = (rows["flash_dq"]["kernel_ms"]
                                    + rows["flash_dkv"]["kernel_ms"])
        rows[name] = row
        emit("timing", kernel=name, **row)
    return rows


def phase_flash_split_route(device) -> dict:
    """``flash_attention``'s forward and backward on the split route
    (``SPLIT_ROUTE_CASES``): the dQ and dK/dV kernels must each launch once
    per case and the fused kernel never; the gradients are held against
    ``flash_bwd_plain`` on the forward kernel's O and lse. The forwards
    take their routes too: the bf16 case the tensor-core kernel, the
    float32 case the CUDA-core one (``flash_fwd_cuda_core``). Returns the
    launch counts of that run."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    cases = []
    for shape, dtype_name in SPLIT_ROUTE_CASES:
        dtype = getattr(torch, dtype_name)
        if flash._bwd_route(shape, dtype) != "split":
            raise AssertionError(f"{shape} {dtype_name} is not on the split "
                                 f"route")
        q, k, v, do = flash_inputs(shape, dtype, gen, device)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        cases.append((shape, dtype, leaves, do))
    # The split route's run starts here.
    flash.flash_bwd.launches = 0
    flash.flash_dq.launches = 0
    flash.flash_dkv.launches = 0
    flash.flash_fwd.route_launches.update(tensor=0, cuda_core=0)
    for _, _, leaves, do in cases:
        flash.flash_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    launches = {"flash_bwd": flash.flash_bwd.launches,
                "flash_dq": flash.flash_dq.launches,
                "flash_dkv": flash.flash_dkv.launches,
                "flash_fwd_tensor": flash.flash_fwd.route_launches["tensor"],
                "flash_fwd_cuda_core":
                    flash.flash_fwd.route_launches["cuda_core"]}
    # ... and ends here.
    fwd_routes = [flash._fwd_route(shape, dtype)
                  for shape, dtype, _, _ in cases]
    want = {"flash_bwd": 0, "flash_dq": len(cases),
            "flash_dkv": len(cases),
            "flash_fwd_tensor": fwd_routes.count("tensor"),
            "flash_fwd_cuda_core": fwd_routes.count("cuda_core")}
    if launches != want:
        raise AssertionError(f"split route launch counts {launches}, "
                             f"expected {want}")
    worst = 0.0
    for shape, dtype, leaves, do in cases:
        where = f"{shape} {dtype} (split route)"
        q, k, v = (x.detach() for x in leaves)
        o, lse = flash.flash_fwd(q, k, v)
        want_grads = flash.flash_bwd_plain(q, k, v, o, lse, do)
        for name, x, w in zip(("dQ", "dK", "dV"), leaves, want_grads):
            worst = max(worst, _close(name, x.grad, w,
                                      flash_tolerance(dtype), where))
    emit("flash_split_route",
         cases=[[list(s), d] for s, d in SPLIT_ROUTE_CASES],
         launches=launches, expected_launches=want, max_abs_err=worst)
    return launches


def _train_lines(text: str, prefix: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def _run_cli(argv: list):
    """The port's CLI ``run()`` in-process; returns (summary, stdout)."""
    import contextlib
    import io

    from pytorch_distributed_mnist_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = cli.run(cli.build_parser().parse_args(argv))
    return summary, out.getvalue()


def _launch_counters(model: str) -> dict:
    """The wrappers whose kernels the ``model`` training run launches,
    looked up when called (a CPU rehearsal swaps in counting plain
    versions)."""
    from pytorch_distributed_mnist_tpu_torch.ops import adam, flash, xent

    counters = {"xent_fwd": xent.xent_fwd, "xent_bwd": xent.xent_bwd,
                "adam": adam.adam_leaf}
    if TRAIN_RUNS[model]["depth"]:
        counters.update(flash_fwd=flash.flash_fwd, flash_bwd=flash.flash_bwd,
                        flash_dq=flash.flash_dq, flash_dkv=flash.flash_dkv)
    return counters


def phase_train(device_flag: str = "cuda", model: str = "cnn") -> dict:
    """Train ``model`` (``TRAIN_RUNS``) through the CLI, resume and
    evaluate; returns its kernels' launch counts over the training run."""
    import math
    import shutil

    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        read_checkpoint_arrays,
    )

    run_cfg = TRAIN_RUNS[model]
    args = run_cfg["args"]
    phase = "train" if model == "cnn" else f"train_{model}"
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ckpt = os.path.join(root, "run")
    base = args + ["--device", device_flag]
    try:
        # The main path's run starts here.
        for wrapper in _launch_counters(model).values():
            wrapper.launches = 0
            if hasattr(wrapper, "route_launches"):  # flash_fwd
                wrapper.route_launches.update(
                    dict.fromkeys(wrapper.route_launches, 0))
        t0 = time.perf_counter()
        summary, out = _run_cli(base + ["--epochs", str(TRAIN_EPOCHS),
                                        "--checkpoint-dir", ckpt])
        wall_s = time.perf_counter() - t0
        launches = {name: wrapper.launches
                    for name, wrapper in _launch_counters(model).items()}
        if "flash_fwd" in launches:
            launches["flash_fwd_routes"] = dict(
                _launch_counters(model)["flash_fwd"].route_launches)
        # ... and ends here.
        lines = _train_lines(out, "Epoch: ")
        hist = summary["history"]
        if len(lines) != TRAIN_EPOCHS or len(hist) != TRAIN_EPOCHS:
            raise AssertionError(f"expected {TRAIN_EPOCHS} epoch lines:\n{out}")
        if not hist[1]["train_loss"] < hist[0]["train_loss"]:
            raise AssertionError(f"train loss did not fall: {lines}")
        if hist[1]["test_acc"] < run_cfg["floor"]:
            raise AssertionError(f"test accuracy {hist[1]['test_acc']:.4f} "
                                 f"< {run_cfg['floor']:.2f} after epoch 1")
        train_size = int(args[args.index("--synthetic-train-size") + 1])
        test_size = int(args[args.index("--synthetic-test-size") + 1])
        steps = TRAIN_EPOCHS * (train_size // TRAIN_BATCH)
        evals = TRAIN_EPOCHS * math.ceil(test_size / TRAIN_BATCH)
        want = {"xent_fwd": steps + evals, "xent_bwd": steps,
                "adam": run_cfg["params"] * steps}
        depth = run_cfg["depth"]
        if depth:
            # bf16 at T = 49: every forward takes the tensor-core route,
            # every backward the fused one.
            want.update(flash_fwd=depth * (steps + evals),
                        flash_fwd_routes={"tensor": depth * (steps + evals),
                                          "cuda_core": 0},
                        flash_bwd=depth * steps, flash_dq=0, flash_dkv=0)
        if launches != want:
            raise AssertionError(f"launch counts {launches}, expected {want}")
        files = sorted(os.listdir(ckpt))
        if files != ["checkpoint_0.npz", "checkpoint_1.npz",
                     "model_best.npz"]:
            raise AssertionError(f"checkpoint files: {files}")
        for name in files:
            _, leaves = read_checkpoint_arrays(os.path.join(ckpt, name))
            if len(leaves) != run_cfg["leaves"]:
                raise AssertionError(f"{name} holds {len(leaves)} leaves")

        _, resumed_out = _run_cli(base + [
            "--epochs", str(TRAIN_EPOCHS), "--checkpoint-dir",
            os.path.join(root, "resumed"), "--resume",
            os.path.join(ckpt, "checkpoint_0.npz")])
        resumed = _train_lines(resumed_out, "Epoch: ")
        if resumed != lines[1:]:
            raise AssertionError(f"resume did not repeat epoch 1:\n"
                                 f"{lines[1:]}\n{resumed}")
        _, eval_out = _run_cli(base + [
            "-e", "--checkpoint-dir", os.path.join(root, "eval"),
            "--resume", os.path.join(ckpt, "model_best.npz")])
        test_lines = _train_lines(eval_out, "Test Loss: ")
        if len(test_lines) != 1 or _train_lines(eval_out, "Epoch: "):
            raise AssertionError(f"-e printed:\n{eval_out}")
        emit(phase, epoch_lines=lines, resumed_epoch_lines=resumed,
             eval_line=test_lines[0], launches=launches,
             expected_launches=want, train_steps=steps, eval_batches=evals,
             images_per_sec=[r["images_per_sec"] for r in hist],
             test_acc=[r["test_acc"] for r in hist],
             test_acc_floor=run_cfg["floor"], wall_s=wall_s,
             resume_repeats_epoch_1=True)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _train_kind(kernel: str) -> str:
    """A device kernel's part of a train step, by its name."""
    name = kernel.lower()
    for ours in ("xent_fwd", "xent_bwd", "adam", "flash_fwd", "flash_bwd",
                 "flash_dq", "flash_dkv"):
        if f"{ours}_kernel" in name or f"{ours}_mma_kernel" in name:
            return ours
    if "memcpy" in name or "memset" in name:
        return "copy"
    if any(s in name for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                               "implicit", "winograd")):
        return "conv"
    if any(s in name for s in ("gemm", "gemv", "nvjet", "cutlass", "cublas")):
        return "fc_gemm"
    return "other_elementwise"


def phase_train_profile(device, model: str = "cnn") -> dict:
    """Where one train step's device time goes (``model`` at batch 256,
    fused loss and Adam, the ViT with flash attention, the host-to-device
    copy of the batch included), beside the host's wall time per step."""
    import numpy as np
    import torch

    from pytorch_distributed_mnist_tpu_torch.data.loader import to_device
    from pytorch_distributed_mnist_tpu_torch.data.mnist import (
        normalize_images,
        synthetic_dataset,
    )
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
    from pytorch_distributed_mnist_tpu_torch.ops.loss import (
        cross_entropy,
        set_loss_impl,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.metrics import (
        metrics_init,
        metrics_update,
    )
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )
    from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

    set_loss_impl("fused")
    kwargs = {"attention_fn": flash_attention} if model == "vit" else {}
    state = create_train_state(get_model(model, **kwargs), SEED, device,
                               optimizer="adam_pallas")
    images, labels = synthetic_dataset(TRAIN_BATCH, seed=SEED + 30)
    host = {"image": normalize_images(images),
            "label": labels.astype(np.int64),
            "mask": np.ones(TRAIN_BATCH, np.float32)}

    def step():
        return train_step(state, to_device(host, device))

    per = device_ms(step)
    by_kind = {}
    for name, ms in per.items():
        by_kind[_train_kind(name)] = by_kind.get(_train_kind(name), 0.0) + ms
    iters = 50
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3

    # The host's time per part: train_step's calls, in its order, each
    # timed on the host's clock. The device runs behind, so each span is
    # the Python and launch work of the part, not its device time.
    parts = ("to_device", "forward", "loss", "backward", "optimizer",
             "metrics")
    host_ms = dict.fromkeys(parts, 0.0)
    for _ in range(iters):
        stamps = [time.perf_counter()]
        batch = to_device(host, device)
        stamps.append(time.perf_counter())
        logits = state.model(batch["image"])
        stamps.append(time.perf_counter())
        loss = cross_entropy(logits, batch["label"], batch["mask"])
        stamps.append(time.perf_counter())
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        stamps.append(time.perf_counter())
        state.optimizer.step()
        stamps.append(time.perf_counter())
        state.step.add_(1)
        metrics_update(metrics_init(device), loss.detach(), logits.detach(),
                       batch["label"], batch["mask"])
        stamps.append(time.perf_counter())
        for part, a, b in zip(parts, stamps, stamps[1:]):
            host_ms[part] += (b - a) / iters * 1e3
    torch.cuda.synchronize()
    device_total = sum(per.values())
    row = {"batch": TRAIN_BATCH, "wall_ms": wall_ms, "device_ms": device_total,
           "device_busy": device_total / wall_ms, "by_kind_ms": by_kind,
           "host_ms": host_ms,
           "images_per_sec_steady": TRAIN_BATCH / wall_ms * 1e3,
           "distinct_kernels": len(per),
           "top": sorted(((ms, name[:90]) for name, ms in per.items()),
                         reverse=True)[:10]}
    emit("train_profile" if model == "cnn" else f"train_{model}_profile",
         model=model, **row)
    return row


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
    train_err = phase_train_kernels_vs_plain(device)
    rows = phase_timings(device, peaks)
    train_rows = phase_train_timings(device, peaks)
    launches = phase_server()
    phase_forward_profile(device)
    train_launches = phase_train()
    phase_train_profile(device)
    flash_err = phase_flash_vs_plain(device)
    flash_rows = phase_flash_timings(device, peaks)
    split_launches = phase_flash_split_route(device)
    vit_launches = phase_train(model="vit")
    phase_train_profile(device, model="vit")

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
    for kname, replaces in (("xent_fwd", TPU_XENT_FWD),
                            ("xent_bwd", TPU_XENT_BWD)):
        row = train_rows[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"{CSRC}/xent.cu",
            "replaces": replaces, "launches": train_launches[kname],
            "max_abs_err": train_err[kname], "ms": row["kernel_ms"],
            "call_ms": row["kernel_call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "at": f"{TRAIN_BATCH}x{CLASSES}"})
    all_8 = train_rows["adam"]["all_8"]
    kernels.append({
        "name": "adam", "route": "cuda", "source": f"{CSRC}/adam.cu",
        "replaces": TPU_ADAM, "launches": train_launches["adam"],
        "max_abs_err": train_err["adam"], "ms": all_8["kernel_ms"],
        "call_ms": all_8["kernel_call_ms"], "step_ms": all_8["step_ms"],
        "plain_ms": all_8["plain_ms"], "bound_ms": all_8["bound_ms"],
        "bound_by": "bytes", "library_ms": all_8["library_ms"],
        "at": f"the 8 cnn leaves, {all_8['numel']} params, one launch each",
        "vit_31": train_rows["adam"]["vit_31"]})
    # flash_fwd (the tensor-core forward) and flash_bwd run on the bf16 ViT
    # path (train_vit); the CUDA-core forward (float32) and the split pair
    # on the split route's path (flash_split_route).
    vit_launches = {**vit_launches,
                    "flash_fwd": vit_launches["flash_fwd_routes"]["tensor"]}
    for kname, replaces, source, launched in (
            ("flash_fwd", TPU_FLASH_FWD, "flash_fwd.cu", vit_launches),
            ("flash_fwd_cuda_core", TPU_FLASH_FWD, "flash.cu",
             split_launches),
            ("flash_bwd", TPU_FLASH_BWD, "flash_bwd.cu", vit_launches),
            ("flash_dq", TPU_FLASH_BWD, "flash.cu", split_launches),
            ("flash_dkv", TPU_FLASH_BWD, "flash.cu", split_launches)):
        row = flash_rows[kname]
        entry = {
            "name": kname, "route": "cuda", "source": f"{CSRC}/{source}",
            "replaces": replaces, "launches": launched[kname],
            "max_abs_err": flash_err[kname], "ms": row["kernel_ms"],
            "call_ms": row["kernel_call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_call": row["library_call"],
            "at": "x".join(map(str, VIT_SHAPE)) + f" (B, T, H, D) "
                  f"{row['dtype']}"}
        if kname == "flash_bwd":
            entry["split_pair_ms"] = row["split_pair_ms"]
        if kname == "flash_fwd":
            entry["cuda_core_ms"] = row["cuda_core_ms"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
