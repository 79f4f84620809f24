"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build: the card's name and power limit (``nvidia-smi``) and
   the build of every hand-written kernel from ``csrc/`` (``nvcc``,
   ``sm_90a``, one process per source, all at once), with each kernel
   instantiation's registers and spills from ``ptxas -v`` (the 3xTF32
   kernels' 30 must all be there and none may spill); before them,
   alone, the native host library (``native_vs_plain``): built from
   ``native/tpumnist_native.cpp`` into the build directory (its seconds,
   version 4, its path), each entry point bitwise equal to its NumPy
   expression at the smoke's sizes (the normalize and gather of the
   8192-image epoch, the pad at buckets 1/8/32/128, the int8 quantize and
   the float64 cast) with its host ms both ways;
2. kernel against plain: ``matmul_i8`` against ``matmul_i8_plain`` on the
   card at every shape of the int8 serving paths (the cnn's and the
   ViT's, M up to 6272 at K = 16, 64 and 256) plus ragged ones (exactly
   equal, and the same bits on a second call), with the split-K plan of
   each shape; the cross-entropy kernels against ``xent_fwd_plain`` /
   ``xent_bwd_plain`` at B in {1, 7, 128, 256, 300} and C in {1, 10, 16,
   32, 33, 128} (a group of lanes per row up to 32 classes, a warp
   above) with saturated tie rows (``rtol=atol=1e-6``: the sum of exp is
   taken in another order), the fused loss's backward from a sum's
   broadcast cotangent (stride 0) equal to the kernel's from ones, and
   both kernels the same bits on a second call; the Adam kernel against
   ``adam_leaf_plain`` one leaf at a time (every cnn leaf shape and two
   ragged sizes, steps 1, 2 and 10), and as one launch over the cnn's 8
   and the ViT's 31 leaves against
   ``adam_leaves_plain`` for 200 steps, with the hypers it forms in the
   launch equal to ``adam_hypers`` on the card at t = 1..3000 (all bit for
   bit);
3. timings: per path shape, the device time per call (``torch.profiler``'s
   CUDA trace) and the host's time between back-to-back calls (CUDA
   events) of each kernel's wrapper, its plain version and one PyTorch
   call computing the same function (``torch._int_mm``,
   ``F.cross_entropy`` and its backward, ``torch.optim.Adam(fused=True)``;
   timed here as yardsticks only, the port never calls them), beside the
   least time the card could take; ``matmul_i8`` also at the int8 ViT's
   six shapes at bucket 128; Adam as one ``FusedAdam.step`` over the
   cnn's 8 and the ViT's 31 leaves, with its launches per step;
4. server: the port's server (``--model cnn --serve-precision int8``,
   fused plane, default buckets) boots in-process over a seeded checkpoint,
   answers concurrent and sequential ``/predict`` requests, ``/healthz`` and
   ``/stats``, and hot-reloads a newer checkpoint. Its replies are held
   against the same engine run with ``matmul_i8_plain`` on the card, and
   the kernel's launch count over this phase must rise; then the same
   server on the split plane (``--no-fuse``) at ``-j 4``
   (``server_split_native``): the host normalizes and quantizes every
   batch through the native library (its calls counted), and every reply
   equals the same plane's with ``matmul_i8_plain`` and NumPy staging
   (``TPUMNIST_NATIVE=0``), with the kernel's launch count;
5. forward profile: the device time of one int8 fused forward per bucket,
   by part (convs, pooling, the int8 products, elementwise work,
   reductions, copies), beside the host's wall time per forward; then
   the ViT served (``server_vit``): the server on ``--model vit`` at
   ``f32``, ``bf16``, ``int8w`` and ``int8`` (fused plane, default
   buckets), each booted over a seeded ViT checkpoint and driven as in
   phase 4; on ``int8`` every served batch's predictions equal the same
   engine's with ``matmul_i8_plain``, the kernel launches exactly 10
   times per forward (from the counter, and from a trace of one forward
   per bucket) and the server hot-reloads epoch 1; the other precisions
   run no int8 product; one int8 ViT forward's device ms per bucket
   beside the host's wall;
6. train: the port's CLI ``run()`` in-process, ``--model cnn --loss fused
   --optimizer adam_pallas`` in its default ``--trainer-mode scan`` (each
   epoch one captured CUDA graph of the train step, and one of the eval
   step, replayed per batch), 2 epochs of 8192 synthetic images at batch
   256 (the epochs gathered by the native library): both epoch lines, a
   falling train loss, test accuracy >= 90%,
   exact launch counts of the three training kernels (Adam once per
   step), checked from the wrappers' counters over the run and from a
   profiler trace of epoch 1 (replays only), 32-leaf checkpoints, a resume
   from ``checkpoint_0.npz`` that repeats epoch 1's line, and ``-e`` on
   ``model_best.npz``; then the same run with ``--trainer-mode stepwise``
   (``train_stepwise``), with ``TPUMNIST_NATIVE=0`` (``train_native_off``:
   NumPy gathers; the staging log's host-gather ms both ways) and with
   ``--epoch-gather device``
   (``train_epoch_gather_device``), whose epoch lines must equal the scan
   run's character for character; stepwise at ``--feed-window 2`` and 1
   in 10 back-to-back pairs (``train_feed_window``: the same lines, each
   window's host ms per step, each pair's difference and the staging
   log's wait); the run with
   ``--grad-accum 2`` (``train_grad_accum``: 2 cross-entropy launches
   each way a step, 1 Adam; the floors, resume and ``-e``) and its
   stepwise twin, which must print its lines; the train run makes no
   collective call and leaves no process group. Then data parallelism:
   the same run, resume and ``-e`` through the explicit rendezvous of a
   world of one (``train_dp_world1``: NCCL, the count and gradient
   all-reduces inside the replayed step, 64 of each and 4 metric
   all-reduces counted, its
   epoch lines equal to ``train``'s, checkpoints stamped 1x1, and whether
   NCCL launched a kernel in epoch 1's trace), ``--trainer-mode
   explicit`` in that world (``train_explicit``: ``train_stepwise``'s
   lines), and ``--spawn 2`` (``dp_spawn``: on fewer than 2 cards the
   exit 2 with the one-card-per-rank message, on 2 or more the 2-rank
   NCCL world held to one process; then a gloo world of 2 on the CPU,
   rank 0's lines and one checkpoint per epoch stamped 2x2). Before the
   data-parallel phases, the weight-distribution path: the cnn run with
   ``--publish delta --chunk-mb 1 --async-checkpoint --keep-last 1``
   (``train_publish``: ``train``'s epoch lines and launch counts, a
   manifest per epoch and exactly the chunks they name, a resume from
   ``checkpoint_0.manifest`` and ``-e`` on ``model_best.manifest``, the
   async drains' ms, and one epoch's publish ms full against delta); two
   int8 servers on it (``server_delta``: A on the trainer's directory, B
   with ``--chunk-peers`` A and an empty watch directory, into which the
   manifest is copied: B fetches every params chunk from A and none from
   a source; both servers' replies equal the plain-product engine's on
   the params loaded whole; a publish with one moved leaf reloads both
   with 1 dirty leaf, B from A; the ``--keep-last`` window's prune and
   chunk GC; the int8 kernel's launches rise, and a trace names it);
   ``--debug-nans`` in scan, stepwise and explicit (``train_debug_nans``:
   ``train``'s lines and counts with the flag, its extra wall, a
   ``FloatingPointError`` naming the aten op on a run resumed from a
   checkpoint with a NaN weight, and the xent and Adam wrappers' own
   checks); ``--profile-dir`` (``train_profile_dir``: a trace holding the
   train, eval and checkpoint spans and the xent and Adam kernels);
7. train profile: the kernels' launches over 4 steps, then the device time
   of one train step by part (convs, the fc products, the cross-entropy
   kernels, Adam, other elementwise work, copies), beside the host's wall
   time per step and its time per part (batch copy, forward, loss,
   backward, optimizer, metrics);
8. flash against plain (first asserting that torch runs float32 products
   in full float32, the yardstick's precision): the forward, dQ and dK/dV
   kernels against ``flash_fwd_plain`` / ``flash_dq_plain`` /
   ``flash_dkv_plain``, and ``flash_bwd`` (the fused kernel, the tiled
   pair or the 3xTF32 pair, as its route says) against
   ``flash_bwd_plain``, twice, for the same bits, at the ViT's shape (256,
   49, 4, 16) and at T in {1, 16, 30, 33, 40, 57, 70, 90, 100, 128, 130,
   196, 200}, D in {4, 7, 8, 10, 12, 16, 20, 32, 48, 64, 100, 128},
   float32 and bfloat16, causal and not, and the tiled pair in bf16 and
   the 3xTF32 forward and pair in float32 also at (32, 196, 4, 16), (256,
   196, 4, 16) and (32, 196, 4, 12) (``flash_tolerance`` states each
   tolerance and why), with the route
   each forward and backward took, each shape's copy width, and the share
   of its tolerance each used, worst per route and path (16-byte or
   narrow); the tensor-core forwards (bf16 and 3xTF32) twice for the same
   bits, and beside them the CUDA-core forward, named;
9. flash timings: device ms per call of the kernels at the ViT's shape in
   bf16 (the tensor-core forward beside the CUDA-core one; the fused
   backward beside the split pair), the CUDA-core forward and split pair
   in float32 (named), the 3xTF32 forward and pair (float32's route) at
   (256, 49, 4, 16) and (256, 196, 4, 16) beside the CUDA-core ones named
   in the same call, each 3xTF32 kernel alone at the ViT's shape, the
   tiled pair at (256, 196, 4, 16) and, named, at the ViT's shape beside
   the bf16 split pair (named), the bf16 forward at T = 196, the ViT's
   D = 12 shapes (256, 49|196, 4, 12) in bf16 and float32 (the default
   routes beside the CUDA-core forward and split pair named in the same
   call, and the SDPA backend that served each), their plain versions,
   ``F.scaled_dot_product_attention`` forward and backward (in the
   problem's dtype) as the yardstick, and each kernel's bound (a 3xTF32
   kernel's operations at a third of the TF32 rate); then tensor and
   sequence parallelism's per-rank shapes (``flash_rank_shapes``,
   ``RANK_SHAPES``: TP's (256, 49, 2|1, 16) and (128, 49, 2, 16),
   Ulysses's (256, 196, 2|1, 16)), bf16 and float32, causal and not: the
   forward and backward against their plain versions and against the
   head slice of the whole 4-head call (same bits or not, and by how
   much), their device ms beside the plain versions, SDPA and the bound,
   and ``sharded_flash_attention`` and Ulysses's local attention on the
   card, each call's launches counted from 0 (one forward and one
   backward of its route); then pipeline parallelism's per-microbatch
   shapes (``pipeline_shapes``, ``PIPELINE_SHAPES``: (128, 49, 4, 16),
   (64, 49, 4, 16) and (128, 49, 2, 16)), bf16 and float32, the same
   checks against the rows (and heads) of the whole batch's call, the
   same timings, and ``flash_attention`` as the stage body calls it;
10. the other backward routes on the attention path: ``flash_attention``
   forward and backward at (32, 196, 4, 16) bf16 launch the tiled pair, at
   the ViT's shape and at (2, 33, 2, 12) in float32 the 3xTF32 pair (and
   not the fused one), and ``flash_fwd`` named ``route="cuda_core"`` with
   ``flash_bwd`` named ``route="split"`` at (32, 196, 4, 16) bf16, at the
   ViT's shape in float32 and at (256, 49, 4, 12) in both the CUDA-core
   kernels, all held against the plain versions;
11. train the ViT: as phase 6 with ``--model vit --attention flash``:
   test accuracy >= 88% after epoch 1, exact launch counts (flash_fwd
   160, all on the tensor-core route, flash_bwd 128, all fused, flash_dq
   and flash_dkv 0, xent 80/64, adam 64) from the counters and the trace,
   101-leaf checkpoints, resume and ``-e``, its stepwise twin, and the
   same run in a world of one (``train_dp_vit_world1``); then with
   ``--grad-accum 2`` (``train_grad_accum_vit``: per step 2 cross-entropy
   launches each way, 2 flash forwards and backwards a block, 1 Adam)
   and with ``--remat`` (``train_vit_remat``: ``train_vit``'s epoch lines
   character for character, one more flash forward a block a step, the
   same backwards), and the peak device memory of one train step with
   and without remat at patch 4 and 2 (``train_vit_remat_memory``); then
   the pipelined ViT (``train_pipeline``: ``create_pipelined_vit_state``
   on a one-rank ``('data', 'stage')`` mesh, at 2 and 4 microbatches, 8
   steps stepwise and as the scan mode's replayed graph, flash, fused
   loss and Adam: each step held to the unpipelined ViT's on the same
   batches, the scan run to its stepwise twin, and per step m * depth
   flash forwards and backwards, one cross-entropy each way, one Adam);
12. ViT train profiles: as phase 7 for one ViT step (flash kernels, GEMMs,
   LayerNorm/GELU and other elementwise work, xent, Adam, copies), at the
   default patch 4 (49 tokens) and at ``--patch-size 2`` (196 tokens),
   where each step must launch the tiled backward twice and no other;
13. the float32 ViT: phase 11 again with ``--dtype f32`` (every flash
   forward and backward on the 3xTF32 route, no other flash kernel), then
   its train profile (exactly 2 3xTF32 forwards and 2 pairs per step);
14. the ViT at D = 12 (``embed_dim=48``, 4 heads, patch 4, bf16): its
   train profile, exactly 2 tensor-core forwards and 2 fused backwards per
   step and no CUDA-core or split launch (``train_vit_d12_profile``);
15. the two trainer modes on one epoch of 32 train steps in one call
   (``train_scan_profile``, ``_vit``, ``_vit_p2``: the cnn and the bf16
   ViT at T = 49 and 196): host wall per step, device ms per step, busy
   share and images/s of stepwise's eager steps against scan's replays,
   the capture's wall time, the graph pool's and the staged epoch's
   bytes, and the cross-entropy and Adam kernels' device ms per call
   inside the replay beside their eager times; and, in the same turns,
   the cnn's replay in an NCCL world of one (``train_scan_profile_dp``:
   what the all-reduce in the graph adds to the host wall and device ms
   per step);
16. one serve process at full breadth (after every phase that times a
   trace, before any NCCL group), each phase's K3 launches counted from
   0 over its traffic: ``server_pool`` (two int8 cnn
   replicas sharing the card, ``serve/pool.py``, under traffic with
   replica 0 made to die after 5 batches: zero drops, failover,
   quarantine and a regroup on the card, every batch equal to the same
   pool with ``matmul_i8_plain``, K3 counted per replica; ``resize`` 2 ->
   1 -> 2 under traffic; requests/s and p50/p99 of one replica against
   two, in turns; the CLI's ``--serve-devices`` past the host's devices
   refused), ``server_canary`` (``--canary-fraction 1.0
   --canary-promote-after 256``: f32 replies and 2 K3 launches per
   shadowed batch, int8-plain replies once promoted, at the default
   budget; under
   ``TPUMNIST_CANARY_FAULT=disagree`` a rollback and f32 replies),
   ``server_multimodel`` (``--model-set cnn=A,vit=B --model-weights
   cnn=2``: each model's replies equal its plain engine's, 2 and 10 K3
   launches a forward, a publish to A leaves B alone, ``tools/loadgen.py
   --expect-models 2``) and ``server_autoscale`` (the SLO autoscaler
   over a pool on the card at an SLO of 1 ms: dry scale-up decisions in
   its ``/stats`` block and the sink, the pool unmoved; then actuating
   1 -> 2 replicas sharing the card under traffic, zero drops,
   plain-equal batches; the CLI's ``--autoscale-max-devices`` past the
   host's devices refused); then the fleet: ``fleet_router`` (the port's
   router, ``create_router``, in this process over two in-process int8
   cnn backends on the card: the ``server`` phase's requests from 4
   client threads through it, a backend shut down under traffic with
   zero drops, quarantined, restarted on its port and readmitted through
   probation, a ``POST /rollout`` of epoch 1 under traffic, a fleet
   canary rolled back under ``TPUMNIST_FLEET_FAULT=canary_disagree`` with
   the baseline's weights republished, every batch equal to the plain
   product's on its epoch's params, the aggregated ``/stats``, the K3
   count rising; requests/s and p50 through the router against one
   backend direct, printed) and ``fleet_chaos`` (``runtime/chaos.py
   --fleet 2 --kill-backend 1 --device cuda --serve-model cnn``: a
   router process, which imports no torch, over two backend processes
   sharing the card, a real SIGKILL, zero drops, each backend's K3 count
   from its own ``/stats`` above 0);
17. run supervision and the build directory: the cnn run as a process
   SIGKILLed at epoch 1's entry (``TPUMNIST_FAULT``), then resumed with
   ``--resume auto`` in this process (``train_fault_resume``: epoch 1's
   line equal to ``train``'s, exactly one epoch's launches of the three
   training kernels), and stepwise in an NCCL world of one with an
   injected raise at step 5 (exit 1, ``InjectedFault`` in phase
   ``train@0`` on stderr and in the metrics file, run beside the killed
   run); gloo worlds on the CPU, run beside the kernel builds of phase 1
   (``chaos_cpu``: a rank killed at the checkpoint publish agreement ends
   its peer with ``PeerFailure`` and exit 75 within 60 s, the twin with no
   fault exits 0; a 3-rank ``--elastic`` world shrinks to 2 ranks resumed
   from ``checkpoint_0`` with ``world_shrunk`` recorded, its epoch-1 line
   equal to a direct 2-rank world's), and beside them tensor and sequence
   parallelism's gloo worlds (``tp_sp_spawn``: the ViT at patch 7 in
   float32 on 1024 images with ``--tensor-parallel 2`` plain, with the
   flash, cross-entropy and Adam kernels' flags and with ``--tp-overlap``,
   ``--sequence-parallel 2`` ring and Ulysses with flash, ``--tensor-parallel
   2 --sequence-parallel 2`` and ``--tensor-parallel 2
   --optimizer-sharding zero1`` in worlds of 4, each epoch line held to
   one process's run of the same flags, the overlap to the plain TP
   world's), and in the same pool pipeline parallelism's (``pp_spawn``:
   ``--pipeline-stages 2`` with ``--data`` 2 and the kernels' flags,
   with ``--tensor-parallel 2``, with ``--optimizer-sharding zero1`` and
   with ``--remat --grad-accum 2``, each held to one process's run of
   the same flags); the cnn run for 1 epoch as a process
   on fresh ``--compile-cache`` directories (``cold_start``: by default
   and with ``--no-precompile`` each library it launches built once, then
   0 built on the warm directory; the seconds to the first epoch line);
18. the MoE family and ZeRO: ``--model moe_mlp`` (8 experts, embed 64,
   hidden 128, float32, dense dispatch) trained as phase 6 with the fused
   cross-entropy and Adam (``train_moe``: 1 Adam launch a step over its
   10 leaves, resume, ``-e``) and its stepwise twin; the capacity
   dispatch and ``--moe-aux-weight 0.01`` runs (``train_moe_capacity``,
   ``train_moe_aux``), each held to the same flags on the plain versions,
   as ``train_moe`` is (``train_moe_plain``); Adam's multi-leaf launch
   held bit for bit over the MoE's leaves too (``kernel_vs_plain``);
   a scan-profile row (``train_scan_profile_moe_mlp``); the int8 server on
   ``train_moe``'s checkpoint (``server_moe``, with the serving phases: no
   int8 product runs, the replies equal the engine's replay). After the
   NCCL phases, the cnn run unsharded, then with ``--optimizer-sharding
   zero1``, ``zero3`` and ``zero1 --zero-overlap`` in the world of one
   (``train_zero_none``, ``train_zero1``, ``train_zero3``,
   ``train_zero1_overlap``): one rank's ZeRO prints the unsharded run's
   lines, Adam once a step on the shards, each run's peak device memory
   printed. In ``dp_spawn``,
   gloo worlds of 2 and 4 on the CPU for ``--expert-parallel 2`` (dense,
   and capacity on a 2 x 2 mesh) and ZeRO-1 and ZeRO-3, each held to a
   run of one process: the only place EP and ZeRO run across ranks, the
   card's machine having one card. The two-tier ``('dcn', 'ici')`` mesh
   (``train_hier``, after the ZeRO runs): the cnn with ZeRO-1, ZeRO-1
   overlapped and ZeRO-3 overlapped and the ViT (flash) with ZeRO-1,
   ``adam_pallas``, ``--loss xla``, on a (1, 1) ``make_hier_mesh`` in an
   NCCL world of one through the CLI's epoch loop, each held to the
   CLI's flat run of the same flags: equal epoch lines, Adam exactly once
   a step on the ``ici`` shards, the flash pair ``depth`` times a step
   each way, no collective on the (1, 1) mesh; ``--dcn-slices 2`` over
   the one card refused ("split into"). In ``tp_sp_spawn``'s pool
   (``hier_spawn``): ``--dcn-slices 2`` over 4 gloo ranks, the linear
   model under ZeRO-1 overlapped with ``--zero-bucket-mb-dcn 1`` against
   the flat world of 4, TP 2 x ZeRO-1 nested in the slices against the
   flat ``tp2_zero1``, and the DCN tier's buckets counted through the
   API at two budgets (1 and 2 all-reduces a step); in
   ``chaos_cpu``, ``--kill-slice 1`` of 2 emulated slices, the survivor
   continuing on the flat mesh (``dcn_flat_fallback``);
19. the smoke's seconds (``smoke``), the ``{"kernels": [...]}`` line,
   then the card's name and power limit, then ``{"ok": true, "device":
   {...}}`` as the last line.

Any failure raises and exits non-zero. Without a CUDA card, or run from a
directory that does not hold the port's package beside this file, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
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
# The ViT's Dense layers at the int8 plane (its registered defaults:
# patch 4, 49 tokens, embed 64, MLP 256): (K, N), and whether the layer
# runs on every token (M = 49 b) or on the pooled row (M = b).
VIT_TOKENS = 49
VIT_DENSE = {"embed": (16, 64, True), "qkv": (64, 192, True),
             "proj": (64, 64, True), "mlp1": (64, 256, True),
             "mlp2": (256, 64, True), "head": (64, 10, False)}


def vit_dense_shapes(bucket: int) -> dict:
    """``{layer: (M, K, N)}`` of the ViT's int8 products at ``bucket``."""
    return {layer: ((VIT_TOKENS * bucket if tokens else bucket), k, n)
            for layer, (k, n, tokens) in VIT_DENSE.items()}


# Shapes held against the plain version: every path shape (the cnn's and
# the ViT's) plus ragged ones and linear's fc.
CHECK_SHAPES = ([(m,) + FC1 for m in PATH_BUCKETS]
                + [(m,) + FC2 for m in PATH_BUCKETS]
                + sorted({s for b in PATH_BUCKETS
                          for s in vit_dense_shapes(b).values()})
                + [(5, 784, 10), (33, 12544, 128), (3, 7, 5), (130, 200, 70)])
# Peak rates of the part nvidia-smi names (data sheets, dense): device
# memory bytes/s, int8 tensor-core operations/s, float32 operations/s
# outside the tensor cores, bf16 tensor-core operations/s, TF32
# tensor-core operations/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 1513e12, 51e12, 756e12, 378e12),
    "H100 NVL": (3.9e12, 1671e12, 60e12, 835e12, 418e12),
    "H100": (3.35e12, 1979e12, 67e12, 989e12, 495e12),  # SXM
    "H200": (4.8e12, 1979e12, 67e12, 989e12, 495e12),
}
# TF32 products per float32-accurate product on the 3xTF32 route.
TF32_PER_PRODUCT = 3
TPU_KERNEL = "pytorch_distributed_mnist_tpu/ops/pallas/matmul_i8.py:66"
TPU_XENT_FWD = "pytorch_distributed_mnist_tpu/ops/pallas/xent.py:124"
TPU_XENT_BWD = "pytorch_distributed_mnist_tpu/ops/pallas/xent.py:154"
TPU_ADAM = "pytorch_distributed_mnist_tpu/ops/pallas/adam.py:64"
TPU_FLASH_FWD = "pytorch_distributed_mnist_tpu/ops/pallas/flash.py:147"
TPU_FLASH_BWD = "pytorch_distributed_mnist_tpu/ops/pallas/flash.py:274"
ADAM_BYTES = 28  # per param: p, g, m, v read; p, m, v written (float32)
ADAM_STEPS = 200  # multi-leaf steps held bit for bit against the plain one
ADAM_HYPER_STEPS = 3000  # steps whose in-launch hypers are checked
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
# The MoE classifier's training path at its registered widths, the cnn
# run's data, batch and cut.
MOE_TRAIN_ARGS = ["--model", "moe_mlp", "--loss", "fused", "--optimizer",
                  "adam_pallas", "--dataset", "synthetic",
                  "--synthetic-train-size", "8192", "--synthetic-test-size",
                  "2048", "--batch-size", str(TRAIN_BATCH), "--seed",
                  str(SEED)]
VIT_SHAPE = (TRAIN_BATCH, 49, 4, 16)  # (B, T, H, D) of each attention
# --grad-accum 2's micro-batch: the rows each cross-entropy and flash
# launch of the accumulating runs takes.
ACCUM_MICRO = TRAIN_BATCH // 2
# Batch sizes the cross-entropy kernels are held against their plain
# versions at: the full batch, --grad-accum 2's micro-batch, and sizes
# around them.
XENT_CHECK_BATCHES = (1, 7, ACCUM_MICRO, TRAIN_BATCH, 300)
# Class counts they are held at: both layouts (a group of lanes per row
# up to 32, a warp above) and their edges; the paths' C is 10.
XENT_CHECK_CLASSES = (1, 10, 16, 32, 33, 128)
PROFILE_STEPS = 4  # train steps whose kernel launches a profile counts
VIT_DEPTH = 2
# K3 launches per int8 ViT forward: embed and head, and 4 Dense a block.
VIT_I8_PER_FORWARD = 2 + 4 * VIT_DEPTH
# What each training run's checks need: its flags, the train state's
# leaf count, the params the optimizer walks, the attention layers, the
# test-accuracy floor after epoch 1, and its compute dtype. The ViT's
# floors sit a few points under the CPU rehearsals of the same commands
# (92.68% in bf16, 92.87% in float32, plain versions; README).
TRAIN_RUNS = {
    "cnn": {"args": TRAIN_ARGS, "leaves": 32, "params": 8, "depth": 0,
            "floor": 0.90, "dtype": "bf16"},
    "vit": {"args": VIT_TRAIN_ARGS, "leaves": 101, "params": 31,
            "depth": VIT_DEPTH, "floor": 0.88, "dtype": "bf16"},
    # The slice's float32 path: the ViT under --dtype f32, both flash
    # kernels on the 3xTF32 route.
    "vit_f32": {"args": VIT_TRAIN_ARGS + ["--dtype", "f32"], "leaves": 101,
                "params": 31, "depth": VIT_DEPTH, "floor": 0.88,
                "dtype": "f32"},
    # Gradient accumulation: 2 micro-batches of 128 a step (accum: the
    # cross-entropy and flash kernels' launches a step are per
    # micro-batch).
    "cnn_accum": {"args": TRAIN_ARGS + ["--grad-accum", "2"], "leaves": 32,
                  "params": 8, "depth": 0, "floor": 0.90, "dtype": "bf16",
                  "accum": 2, "phase": "train_grad_accum"},
    "vit_accum": {"args": VIT_TRAIN_ARGS + ["--grad-accum", "2"],
                  "leaves": 101, "params": 31, "depth": VIT_DEPTH,
                  "floor": 0.88, "dtype": "bf16", "accum": 2,
                  "phase": "train_grad_accum_vit"},
    # --remat: each block's forward runs again in the backward pass
    # (remat: one more flash forward per block a step).
    "vit_remat": {"args": VIT_TRAIN_ARGS + ["--remat"], "leaves": 101,
                  "params": 31, "depth": VIT_DEPTH, "floor": 0.88,
                  "dtype": "bf16", "remat": True,
                  "phase": "train_vit_remat"},
    # The MoE family at full width (8 experts, embed 64, hidden 128),
    # float32 as its CLI default, dense dispatch: 38 leaves (10 params).
    "moe": {"args": MOE_TRAIN_ARGS, "leaves": 38, "params": 10, "depth": 0,
            "floor": 0.85, "dtype": "f32", "phase": "train_moe"},
}
# Shapes the flash kernels are held against their plain versions at: the
# ViT's, its micro-batch under --grad-accum 2, then T in {1, 16, 196,
# 200} and D in {16, 32, 64, 128} at small B*H, D = 8 (below one
# thread's 16 dims), for the fused backward (bf16, T <= 128) its widest
# case T = 128, D = 128 and a D of 48 that its 16-wide tiles pad; then
# head dims that are not a multiple of 8, which the tensor-core kernels
# take in their narrow instantiation (the copy width of flash_inputs' qkv
# slices in bf16 / float32): D = 12 at T = 33 and at T = 196 (8 / 16
# bytes, as the ViT's D = 12 slices), D = 4 (8 / 16), D = 7 (2 / 4),
# D = 10 (4 / 8), D = 20 (8 / 16) and D = 100 (8 / 16).
FLASH_CHECK_SHAPES = [VIT_SHAPE, (ACCUM_MICRO,) + VIT_SHAPE[1:],
                      (2, 1, 2, 16), (2, 16, 2, 16),
                      (2, 196, 2, 16), (2, 200, 2, 64), (1, 200, 2, 128),
                      (3, 130, 2, 32), (1, 70, 1, 8), (2, 128, 2, 128),
                      (3, 100, 3, 48), (2, 33, 2, 12), (2, 196, 2, 12),
                      (2, 40, 2, 4), (2, 57, 3, 7), (1, 30, 2, 10),
                      (2, 90, 2, 20), (1, 100, 2, 100)]
# The ViT at D = 12 (embed 48 in 4 heads), patch 4 and patch 2.
D12_SHAPE = (TRAIN_BATCH, 49, 4, 12)
D12_P2_SHAPE = (TRAIN_BATCH, 196, 4, 12)
# The backward routes other than the fused one, on the attention path:
# (shape, dtype, route). A T above the fused kernel's 128 (the ViT at
# --patch-size 2 has 196 tokens) in bf16 takes the tiled pair, float32
# the 3xTF32 pair, at the ViT's D = 16 and at a D of 12.
SPLIT_ROUTE_CASES = [((32, 196, 4, 16), "bfloat16", "tiled"),
                     (VIT_SHAPE, "float32", "tf32x3"),
                     ((2, 33, 2, 12), "float32", "tf32x3")]
# The ViT at --patch-size 2: 196 tokens of embed 64 in 4 heads of 16.
P2_SHAPE = (TRAIN_BATCH, 196, 4, 16)
# Shapes the tiled backward is also held at, beyond FLASH_CHECK_SHAPES.
TILED_CHECK_SHAPES = [(32, 196, 4, 16), P2_SHAPE, (32, 196, 4, 12)]
# The CUDA-core kernels, which no problem takes by default, named: the
# forward as route="cuda_core" and the backward as route="split", in bf16,
# at the ViT's shape in float32, and at the ViT's D = 12 shape (the one
# they served by default before the tensor-core kernels took every D) in
# both dtypes.
FORCED_CUDA_CORE_CASES = [((32, 196, 4, 16), "bfloat16"),
                          (VIT_SHAPE, "float32"),
                          (D12_SHAPE, "bfloat16"), (D12_SHAPE, "float32")]

# Tensor and sequence parallelism's per-rank attention blocks (ROADMAP
# Queue 1 item 16 parts 3-4), at the ViT's D = 16 and the smoke's batch:
# under --tensor-parallel each rank runs the kernels on its (B/dp, 49,
# 4/tp, 16) heads (sharded_flash_attention), under Ulysses on the full
# 196 tokens of --patch-size 2 with 4/sp heads (its local attention).
# Each is held against the head slice of the whole (B, T, 4, 16) call.
RANK_SHAPES = [("tp2", (TRAIN_BATCH, 49, 2, 16)),
               ("tp4", (TRAIN_BATCH, 49, 1, 16)),
               ("dp2_tp2", (TRAIN_BATCH // 2, 49, 2, 16)),
               ("ulysses2", (TRAIN_BATCH, 196, 2, 16)),
               ("ulysses4", (TRAIN_BATCH, 196, 1, 16))]
# Pipeline parallelism's per-microbatch attention blocks (ROADMAP Queue 1
# item 16 part 5), at the ViT's D = 16 and the smoke's batch with the
# default m = S microbatches: each stage runs its blocks on (B/(dp*m), 49,
# 4/tp, 16) (pp2: 2 stages; dp2_pp2: 2 data slices of 2 stages; pp2_tp2:
# 2 stages of the Megatron body's local heads). Each is held against the
# rows (and heads) of the whole (B, 49, 4, 16) call it cuts.
PIPELINE_SHAPES = [("pp2", (TRAIN_BATCH // 2, 49, 4, 16)),
                   ("dp2_pp2", (TRAIN_BATCH // 4, 49, 4, 16)),
                   ("pp2_tp2", (TRAIN_BATCH // 2, 49, 2, 16))]


_STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started
    (``at_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - _STARTED}), flush=True)


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


# Spin kernels that open every profiler trace (``lead_in``).
TRACE_LEAD = 32
LEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
RETAKEN = {"traces": 0}  # traces taken again, over the whole script


def lead_in() -> None:
    """Open a profiler trace with ``TRACE_LEAD`` spin kernels. Once a
    process has run long enough (here, after the training phases), the
    profiler on an H100 with torch 2.11 drops the first device records of
    every trace it takes, in launch order, the same ones in every retake;
    the spins take that loss, and the traced calls keep every record.
    Counts of the traced work skip ``LEAD_KERNEL``."""
    import torch

    for _ in range(TRACE_LEAD):
        torch.cuda._sleep(100)


@contextlib.contextmanager
def device_trace():
    """A profiler trace of the host and the card, opened by ``lead_in``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in()
        yield prof


def device_ms(fn, iters: int = 20) -> dict:
    """Device time per call of ``fn``: every kernel, fill and copy it runs
    on the card, from the profiler's CUDA trace over ``iters`` calls
    (``device_trace``). Returns ``{kernel name: ms per call}``. Now and
    then a trace comes back without its device events although the calls
    ran, or without some of them (a name recorded a number of times that
    is not a multiple of ``iters``); such a trace is taken again, up to
    three times in all. With no device time then, this raises; a name
    whose count is still not a multiple of ``iters`` is taken to vary from
    call to call, and the last trace is used."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with device_trace() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for evt in prof.events():
            # A named range (``Optimizer.step#...``) is mirrored onto the
            # device's timeline as an annotation spanning its kernels: it
            # is not device work of its own.
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(evt, "is_user_annotation", False)
                    and not evt.name.startswith("Optimizer.")
                    and LEAD_KERNEL not in evt.name):
                total[evt.name] = (total.get(evt.name, 0.0)
                                   + evt.time_range.elapsed_us() / 1e3)
                count[evt.name] = count.get(evt.name, 0) + 1
        per = {name: ms / iters for name, ms in total.items()}
        lost = {name[:60]: n for name, n in count.items() if n % iters}
        if per and sum(per.values()) > 0 and (not lost or attempt == 2):
            return per
        RETAKEN["traces"] += 1
        print(f"chip_smoke.py: a profiler trace held no device time, or "
              f"these counts of {iters} calls' events: {lost}; taking it "
              f"again", file=sys.stderr, flush=True)
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


def phase_vit_i8_timings(device, peaks) -> list:
    """K3 alone at the int8 ViT's shapes at bucket 128 (M = 6272 on the
    token axis): the kernel's device ms beside its bound, its plain
    version and ``torch._int_mm`` where that takes the shape (B row- and
    column-major)."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        _sm_count,
        matmul_i8,
        matmul_i8_plain,
        split_k,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rows = []
    for layer, (m, k, n) in vit_dense_shapes(PATH_BUCKETS[-1]).items():
        a, b = random_i8((m, k), gen, device), random_i8((k, n), gen, device)
        calls = {"kernel": lambda: matmul_i8(a, b),
                 "plain": lambda: matmul_i8_plain(a, b)}
        if int_mm_takes(m, k, n):
            calls["library"] = lambda: torch._int_mm(a, b)
            b_cm = b.t().contiguous().t()
            calls["library_colmajor"] = lambda: torch._int_mm(a, b_cm)
        least, by = bound_ms(m, k, n, peaks)
        splits, cluster = split_k(m, n, k, _sm_count(device.index))
        row = {"layer": f"vit.{layer}", "m": m, "k": k, "n": n,
               "bound_ms": least, "bound_by": by, "library_ms": None,
               "splits": splits, "cluster": cluster}
        for what, fn in calls.items():
            per = device_ms(fn)
            row[f"{what}_ms"] = sum(per.values())
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


def _engine(params, device, matmul, model: str = "cnn", fuse: bool = True):
    """The server's engine configuration (``model``, int8, fused unless
    ``fuse`` is false, default buckets) with ``matmul`` as the int8
    product."""
    import functools

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import int8_linear
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
    )

    net = get_model(model, matmul=functools.partial(int8_linear,
                                                    matmul=matmul))
    return InferenceEngine(net, params, precision="int8", fuse=fuse,
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


# The native staging calls the split plane makes per dispatched batch.
NATIVE_STAGING = ("normalize_images", "quant_i8", "pad_into", "cast_f32")


def phase_server(device_flag: str = "cuda", split: bool = False) -> int:
    """Boot, drive and reload the server; returns the kernel's launch
    count over the run. ``device_flag`` is the server's ``--device``.
    With ``split`` (``server_split_native``) the server runs the split
    plane (``--no-fuse``) at ``-j 4``: the host normalizes and quantizes
    each batch through the native library (its calls counted), and every
    reply must equal the plain engine's, the same plane with
    ``matmul_i8_plain`` and the NumPy staging (``TPUMNIST_NATIVE=0``)."""
    import shutil

    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.data import native

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
        "--require-checkpoint", "--poll-interval", "0.5"]
        + (["--no-fuse", "-j", "4"] if split else []))
    native_calls = dict.fromkeys(NATIVE_STAGING, 0)
    originals = {name: getattr(native, name) for name in NATIVE_STAGING}

    def counting(name):
        def wrapper(*a, **k):
            native_calls[name] += 1
            return originals[name](*a, **k)
        return wrapper

    if split:
        for name in NATIVE_STAGING:
            setattr(native, name, counting(name))
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
        for name in NATIVE_STAGING:
            setattr(native, name, originals[name])
        if split and not (native_calls["normalize_images"]
                          and native_calls["quant_i8"]):
            raise AssertionError(f"the split plane's staging made native "
                                 f"calls {native_calls}")

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
        ref = _engine(params0, engine.device, matmul_i8_plain,
                      fuse=not split)
        saved_native = os.environ.get("TPUMNIST_NATIVE")
        if split:  # the reference stages through NumPy
            os.environ["TPUMNIST_NATIVE"] = "0"
        try:
            for images, labels in batches:
                want = ref.predict(images)
                if not np.array_equal(labels, want):
                    raise AssertionError(
                        f"a served batch of {len(images)} disagrees with "
                        f"the plain reference on "
                        f"{int(np.sum(labels != want))} rows")
            for reply, x in zip(seq_replies, sequential):
                if reply["predictions"] != ref.predict(x).tolist():
                    raise AssertionError("a sequential reply disagrees "
                                         "with the plain reference")
        finally:
            if saved_native is None:
                os.environ.pop("TPUMNIST_NATIVE", None)
            else:
                os.environ["TPUMNIST_NATIVE"] = saved_native
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
        extra = ({"plane": "split (--no-fuse)", "workers": 4,
                  "native_staging_calls": native_calls} if split else {})
        emit("server_split_native" if split else "server",
             requests=len(burst) + len(sequential),
             rows=rows + sum(len(x) for x in sequential),
             boot_s=boot_s, burst_s=burst_s, burst_rows_per_s=rows / burst_s,
             p50_ms=lat["p50"], p99_ms=lat["p99"],
             batch_histogram=stats["batch_histogram"],
             batches=len(batches), replies_exact=True,
             reload_epoch=1, launches=launches, **extra)
        return launches
    finally:
        for name in NATIVE_STAGING:
            setattr(native, name, originals[name])
        httpd.shutdown()
        httpd.ctx.close()
        httpd.server_close()
        serving.join(timeout=30)
        shutil.rmtree(ckpt_dir, ignore_errors=True)


SERVE_PRECISIONS = ("f32", "bf16", "int8w", "int8")


def _count_kernel(fn, part: str, iters: int = 5) -> float:
    """Device launches per call of ``fn`` of the kernels whose names hold
    ``part``, from a profiler trace of ``iters`` calls (taken again, up to
    three times, while it holds none)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with device_trace() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for evt in prof.events()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and part in evt.name)
        if n:
            return n / iters
    return 0.0


def _serve_vit(ckpt_dir: str, precision: str, device_flag: str,
               params0) -> dict:
    """Boot the server on the ViT at ``precision`` (fused plane, default
    buckets), drive it and check its replies; returns the phase's row.
    On ``int8`` every served batch's predictions must equal the same
    engine's with ``matmul_i8_plain``, and the kernel must launch exactly
    ``VIT_I8_PER_FORWARD`` times per forward the engine ran; the others
    run no int8 product. The int8 run also hot-reloads epoch 1."""
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

    args = build_parser().parse_args([
        "--model", "vit", "--serve-precision", precision, "--port", "0",
        "--device", device_flag, "--checkpoint-dir", ckpt_dir,
        "--require-checkpoint", "--poll-interval", "0.5"])
    t_boot = time.perf_counter()
    httpd = create_server(args)
    boot_s = time.perf_counter() - t_boot
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    try:
        client = _Client(httpd.server_address[1])
        engine = httpd.ctx.engine
        batches, forwards = [], [0]
        served = engine.predict_with_epoch

        def recording(images):
            labels, epoch = served(images)
            batches.append((np.array(images), labels.copy()))
            return labels, epoch

        def count_forward(module, inputs, output):
            forwards[0] += 1

        engine.predict_with_epoch = recording
        hook = engine.model.register_forward_hook(count_forward)
        # The main path's run starts here (the warm-up is done).
        matmul_i8.launches = 0
        burst = _requests(64, seed=SEED + 30)
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
        sequential = _requests(8, seed=SEED + 31)
        seq_replies = [client.post("/predict", {"images": x.tolist()})
                       for x in sequential]
        health = client.get("/healthz")
        stats = client.get("/stats")
        launches, served_forwards = matmul_i8.launches, forwards[0]
        # ... and ends here.
        hook.remove()
        engine.predict_with_epoch = served
        if not health.get("ok") or health.get("model") != "vit" \
                or health.get("model_epoch") != 0:
            raise AssertionError(f"/healthz: {health}")
        if stats.get("serve_precision") != precision:
            raise AssertionError(f"/stats serve_precision: "
                                 f"{stats.get('serve_precision')}")
        for reply, x in zip(replies + seq_replies, burst + sequential):
            if (reply is None or len(reply["predictions"]) != len(x)
                    or reply["model_epoch"] != 0):
                raise AssertionError(f"bad /predict reply: {reply}")
        rows = sum(len(x) for x in burst + sequential)
        if sum(len(x) for x, _ in batches) != rows:
            raise AssertionError("the recorded batches miss requests")
        want_launches = (VIT_I8_PER_FORWARD * served_forwards
                         if precision == "int8" else 0)
        if served_forwards < len(batches) or launches != want_launches:
            raise AssertionError(
                f"{precision}: {launches} matmul_i8 launches over "
                f"{served_forwards} forwards, expected {want_launches}")
        logits = engine.logits(sequential[0])
        if logits.shape != (len(sequential[0]), CLASSES) \
                or not np.all(np.isfinite(logits)):
            raise AssertionError(f"bad logits {logits.shape}")
        row = {"precision": precision, "fused": True,
               "requests": len(burst) + len(sequential), "rows": rows,
               "batches": len(batches), "forwards": served_forwards,
               "launches": launches, "launches_per_forward":
                   launches / served_forwards, "boot_s": boot_s,
               "burst_s": burst_s, "burst_rows_per_s":
                   sum(len(x) for x in burst) / burst_s,
               "p50_ms": stats["latency_ms"]["p50"],
               "p99_ms": stats["latency_ms"]["p99"],
               "batch_histogram": stats["batch_histogram"]}
        if precision != "int8":
            return row
        # The plain int8 product on the same batches: equal predictions.
        ref = _engine(params0, engine.device, matmul_i8_plain, model="vit")
        for images, labels in batches:
            want = ref.predict(images)
            if not np.array_equal(labels, want):
                raise AssertionError(
                    f"a served ViT batch of {len(images)} disagrees with "
                    f"the plain reference on {int(np.sum(labels != want))}"
                    f" rows")
        for reply, x in zip(seq_replies, sequential):
            if reply["predictions"] != ref.predict(x).tolist():
                raise AssertionError("a sequential ViT reply disagrees "
                                     "with the plain reference")
        save_params_checkpoint(params_to_jax(init_params("vit", SEED + 1)),
                               epoch=1, directory=ckpt_dir)
        deadline = time.monotonic() + 10.0
        while client.get("/healthz")["model_epoch"] != 1:
            if time.monotonic() > deadline:
                raise AssertionError("the ViT's model_epoch did not flip")
            time.sleep(0.1)
        after = client.post("/predict", {"images": sequential[1].tolist()})
        if after["model_epoch"] != 1:
            raise AssertionError(f"reply after reload: {after}")
        row.update(replies_exact=True, reload_epoch=1)
        return row
    finally:
        httpd.shutdown()
        httpd.ctx.close()
        httpd.server_close()
        serving.join(timeout=30)


def phase_server_vit(device_flag: str = "cuda") -> dict:
    """The server on ``--model vit`` at every precision (fused plane,
    default buckets), each over a fresh seeded checkpoint (``_serve_vit``);
    then, on the card, one int8 forward per bucket profiled: the kernel's
    launches per forward from the trace (``VIT_I8_PER_FORWARD``), its
    device ms, the forward's device ms and the host's wall per forward.
    Returns ``{"launches": int8 run's count, "rows": ...}``."""
    import shutil

    import numpy as np
    import torch

    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
        params_to_jax,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import matmul_i8
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        save_params_checkpoint,
    )

    params0 = init_params("vit", SEED)
    rows = {}
    for precision in SERVE_PRECISIONS:
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_vit_ckpt_")
        try:
            save_params_checkpoint(params_to_jax(params0), epoch=0,
                                   directory=ckpt_dir)
            rows[precision] = _serve_vit(ckpt_dir, precision, device_flag,
                                         params0)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    profiles = []
    if device_flag == "cuda":
        engine = _engine(params0, torch.device("cuda", 0), matmul_i8,
                         model="vit")
        engine.warmup()
        for bucket in PATH_BUCKETS:
            raw = np.resize(_requests(1, seed=SEED + 32)[0],
                            (bucket, 28, 28))
            per_call = _count_kernel(lambda: engine.logits(raw),
                                     "matmul_i8_kernel")
            if per_call != VIT_I8_PER_FORWARD:
                raise AssertionError(
                    f"a traced int8 ViT forward at bucket {bucket} "
                    f"launched {per_call} matmul_i8 kernels, expected "
                    f"{VIT_I8_PER_FORWARD}")
            per = device_ms(lambda: engine.logits(raw))
            iters = 50
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                engine.logits(raw)
            wall_ms = (time.perf_counter() - t0) / iters * 1e3
            device_total = sum(per.values())
            profiles.append({
                "bucket": bucket, "traced_i8_per_forward": per_call,
                "device_ms": device_total, "wall_ms": wall_ms,
                "device_busy": device_total / wall_ms,
                "matmul_i8_ms": sum(v for k, v in per.items()
                                    if "matmul_i8_kernel" in k),
                "top": sorted(((ms, name[:90]) for name, ms in per.items()),
                              reverse=True)[:5]})
    emit("server_vit", runs=rows, forward_profiles=profiles,
         i8_per_forward=VIT_I8_PER_FORWARD)
    return {"launches": rows["int8"]["launches"], "rows": rows,
            "profiles": profiles}


# -- one serve process at full breadth: the pool, the canary, a model set,
# -- the autoscaler -----------------------------------------------------------

POOL_FAULT = "0:5"  # replica 0 dies after 5 batches (TPUMNIST_SERVE_FAULT)
POOL_REQUESTS = 96  # requests of 1-40 images per traffic run
POOL_CLIENTS = 4  # client threads of a traffic run
POOL_TIMED_REQUESTS = 240  # per timed run, 8 clients
CNN_I8_PER_FORWARD = 2  # the cnn's int8 products: fc1 and fc2


def _pool_traffic(pool, requests: list, clients: int = POOL_CLIENTS,
                  record: list = None, serve_log=None) -> dict:
    """Closed-loop traffic through the pipelined batcher over ``pool``
    (window: replicas + 1): ``clients`` threads submit ``requests``.
    Appends ``(rows, labels)`` per completed batch to ``record``; the
    batcher records each request's latency into ``serve_log``. Returns
    the replies' labels, each request's latency, the wall and the errors
    (a dropped request is an error)."""
    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.serve.batcher import (
        MicroBatcher,
    )

    lock = threading.Lock()

    def complete(handle):
        labels, epoch = pool.predict_complete(handle)
        if record is not None:
            with lock:
                record.append((np.array(handle.images), labels.copy()))
        return np.stack([labels, np.full_like(labels, epoch or 0)], axis=1)

    replies, latency, errors = [None] * len(requests), [], []
    with MicroBatcher(None, max_batch=pool.max_batch, max_wait_s=0.002,
                      serve_log=serve_log, dispatch_fn=pool.dispatch,
                      complete_fn=complete,
                      max_inflight=pool.n_replicas + 1) as batcher:
        def client(idx):
            for i in range(idx, len(requests), clients):
                t0 = time.perf_counter()
                try:
                    out = batcher.predict(pool.preprocess(requests[i]),
                                          timeout=120.0)
                except Exception as exc:  # noqa: BLE001 - counted as a drop
                    errors.append(repr(exc))
                    continue
                with lock:
                    latency.append(time.perf_counter() - t0)
                replies[i] = out[:, 0]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
        wall = time.perf_counter() - t0
    dropped = [i for i, r in enumerate(replies)
               if r is None or len(r) != len(requests[i])]
    if errors or dropped:
        raise AssertionError(f"pool traffic dropped {len(dropped)} of "
                             f"{len(requests)} requests: {errors[:3]}")
    lat = sorted(latency)
    return {"replies": replies, "wall_s": wall,
            "rps": len(requests) / wall,
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3}


def _same_as_plain(plain, batches: list, who: str) -> None:
    """Every served batch's labels equal the plain-product pool's on the
    same rows (the int8 plane quantizes a Dense input over its whole
    batch, so the reference replays the batches the pool formed)."""
    import numpy as np

    for rows, labels in batches:
        want, _ = plain.predict_complete(plain.dispatch(rows))
        if not np.array_equal(labels, want):
            raise AssertionError(
                f"{who}: a batch of {len(rows)} disagrees with the plain "
                f"int8 pool on {int(np.sum(labels != want))} rows")


def _wait_healed(pool, seconds: float = 120.0) -> dict:
    deadline = time.monotonic() + seconds
    while True:
        topo = pool.topology()
        if topo["regroups"] >= 1 and not topo["quarantined_groups"]:
            return topo
        if time.monotonic() > deadline:
            raise AssertionError(f"the pool never healed: {topo}")
        time.sleep(0.05)


def phase_server_pool(device_flag: str = "cuda") -> dict:
    """The replica pool (``serve/pool.py``) at the cnn's full width, int8,
    fused plane, buckets 1/8/32/128: two replicas sharing the one card
    (``EnginePool(devices=[cuda:0, cuda:0])``), live traffic from 4
    client threads through the pipelined batcher with replica 0 made to
    die after 5 batches (``TPUMNIST_SERVE_FAULT=0:5``). No request may be
    dropped; the pool must fail over, quarantine and regroup replica 0
    (generation 1, rebuilt on the card); every served batch must equal
    the same pool built with ``matmul_i8_plain``; the K3 launches are
    counted per replica (each engine's model counts its int8 products)
    and must sum to the wrapper's count. Then ``resize`` 2 -> 1 -> 2
    under traffic, again with zero drops and plain-equal batches; then
    requests/s and p50/p99 of one replica against two sharing the card,
    in turns (1, 2, 2, 1); then the CLI's ``--serve-devices`` one past the
    host's device count must exit with the device-count refusal."""
    import functools
    import shutil

    import torch

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        int8_linear,
        matmul_i8,
        matmul_i8_plain,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.pool import (
        SERVE_FAULT_ENV,
        EnginePool,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.server import (
        build_parser,
        create_server,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.device import (
        local_devices,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import ServeLog

    device = torch.device(device_flag, 0) if device_flag == "cuda" \
        else torch.device("cpu")
    devices = [device, device]
    params0 = init_params("cnn", SEED)
    built, count_lock = [], threading.Lock()

    def counting_model():
        """A cnn whose int8 Dense layers count their products: one K3
        launch each on the card."""
        calls = [0]

        def counted(x, w, out_dtype=None):
            with count_lock:
                calls[0] += 1
            return int8_linear(x, w, out_dtype)

        model = get_model("cnn", matmul=counted)
        built.append((model, calls))
        return model

    common = dict(buckets=PATH_BUCKETS, precision="int8", fuse=True)
    saved = os.environ.get(SERVE_FAULT_ENV)
    os.environ[SERVE_FAULT_ENV] = POOL_FAULT
    try:
        pool = EnginePool(counting_model, params0, devices=devices,
                          serve_log=ServeLog(), **common)
    finally:
        if saved is None:
            os.environ.pop(SERVE_FAULT_ENV, None)
        else:
            os.environ[SERVE_FAULT_ENV] = saved
    plain = EnginePool(functools.partial(
        get_model, "cnn", matmul=functools.partial(
            int8_linear, matmul=matmul_i8_plain)), params0,
        devices=devices, **common)
    t0 = time.perf_counter()
    pool.warmup()
    plain.warmup()
    warm_s = time.perf_counter() - t0
    boot_models = {r.name: r.engine.model for r in pool.replicas}

    # The main path's run starts here (both pools warm).
    matmul_i8.launches = 0
    for _, calls in built:
        calls[0] = 0
    served = []
    fault_run = _pool_traffic(pool, _requests(POOL_REQUESTS, SEED + 40),
                              record=served)
    topo = _wait_healed(pool)
    launches = matmul_i8.launches  # ... and ends here.
    r0 = pool.replicas[0]
    if r0.generation != 1 or r0.engine.device != device \
            or topo["failovers"] < 1 or topo["active_groups"] != 2:
        raise AssertionError(f"the pool's heal: generation {r0.generation} "
                             f"on {r0.engine.device}, {topo}")
    per_replica = {}
    for model, calls in built:
        for name, boot in boot_models.items():
            if model is boot:
                per_replica[f"{name} (generation 0)"] = calls[0]
        if model is r0.engine.model:
            per_replica[f"{r0.name} (generation 1)"] = calls[0]
    if launches == 0 or sum(calls[0] for _, calls in built) != launches:
        raise AssertionError(f"K3 launches {launches} against the replicas' "
                             f"int8 products {per_replica}")
    _same_as_plain(plain, served, "server_pool")
    # resize 2 -> 1 -> 2 under traffic.
    resized = []
    during = []
    traffic = threading.Thread(target=lambda: during.append(_pool_traffic(
        pool, _requests(POOL_REQUESTS, SEED + 41), record=resized)))
    traffic.start()
    time.sleep(0.2)
    shrink = pool.resize(n_devices=1, devices=devices)
    time.sleep(0.2)
    grow = pool.resize(n_devices=2, devices=devices)
    traffic.join(600.0)
    if not during or pool.n_replicas != 2:
        raise AssertionError("the resize run under traffic did not finish")
    _same_as_plain(plain, resized, "server_pool resize")
    # One replica against two sharing the card, in turns.
    timed = []
    for n in (1, 2, 2, 1):
        pool.resize(n_devices=n, devices=devices)
        run = _pool_traffic(pool, _requests(POOL_TIMED_REQUESTS,
                                            SEED + 42 + n), clients=8)
        timed.append({"replicas": n, "requests": POOL_TIMED_REQUESTS,
                      "rps": run["rps"], "p50_ms": run["p50_ms"],
                      "p99_ms": run["p99_ms"]})
    # The CLI refuses more replicas than the host has devices.
    n_local = len(local_devices(device.type))
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_pool_cli_")
    try:
        create_server(build_parser().parse_args([
            "--model", "cnn", "--serve-precision", "int8", "--port", "0",
            "--device", device_flag, "--checkpoint-dir", ckpt,
            "--serve-devices", str(n_local + 1)]))
    except SystemExit as exc:
        refusal = str(exc)
    else:
        raise AssertionError("--serve-devices past the host's devices booted")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if f"this host has {n_local} local device(s)" not in refusal:
        raise AssertionError(f"the --serve-devices refusal: {refusal}")
    label = smi_name_and_limit() if device_flag == "cuda" else "cpu"
    emit("server_pool", device=label, replicas=len(devices),
         fault=POOL_FAULT, warm_s=warm_s, requests=POOL_REQUESTS,
         batches=len(served), dropped=0, topology=topo,
         launches=launches, launches_per_replica=per_replica,
         replies_exact=True, fault_run_rps=fault_run["rps"],
         resize={"shrink": shrink["new"]["groups"],
                 "grow": grow["new"]["groups"], "batches": len(resized),
                 "dropped": 0, "replies_exact": True,
                 "rps": during[0]["rps"]},
         timed=timed, cli_refusal=refusal)
    return {"launches": launches, "per_replica": per_replica,
            "timed": timed}


def _sequential(client, requests: list, model: str = None) -> list:
    out = []
    for x in requests:
        body = {"images": x.tolist()}
        if model is not None:
            body["model"] = model
        out.append(client.post("/predict", body))
    return out


def phase_server_canary(device_flag: str = "cuda") -> dict:
    """``serve --model cnn --serve-precision int8 --canary-fraction 1.0
    --canary-promote-after 256``, at the default budget: sequential
    requests (each its own batch). While the canary shadows, every reply
    equals the f32 engine's and K3 launches twice per shadowed batch (the
    candidate's fc1 and fc2); once it promotes, every reply equals the
    int8 engine's with ``matmul_i8_plain``. A second boot under
    ``TPUMNIST_CANARY_FAULT=disagree`` rolls back (``/stats`` says so)
    and keeps answering with the f32 replies."""
    import shutil

    import torch

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
        params_to_jax,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        matmul_i8,
        matmul_i8_plain,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.canary import (
        CANARY_FAULT_ENV,
        PRIMARY,
        ROLLED_BACK,
        SHADOW,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        save_params_checkpoint,
    )

    device = torch.device(device_flag, 0) if device_flag == "cuda" \
        else torch.device("cpu")
    params0 = init_params("cnn", SEED)
    f32_ref = InferenceEngine(get_model("cnn"), params0, fuse=True,
                              device=device)
    i8_ref = _engine(params0, device, matmul_i8_plain)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_canary_")
    save_params_checkpoint(params_to_jax(params0), epoch=0, directory=ckpt)
    argv = ["--model", "cnn", "--serve-precision", "int8",
            "--canary-fraction", "1.0", "--canary-promote-after", "256",
            "--port", "0", "--device", device_flag, "--checkpoint-dir",
            ckpt, "--require-checkpoint", "--no-reload"]
    out = {}
    try:
        for fault in (False, True):
            saved = os.environ.get(CANARY_FAULT_ENV)
            if fault:
                os.environ[CANARY_FAULT_ENV] = "disagree"
            try:
                httpd, client, thread = _boot(argv)
            finally:
                if saved is None:
                    os.environ.pop(CANARY_FAULT_ENV, None)
                else:
                    os.environ[CANARY_FAULT_ENV] = saved
            try:
                canary = httpd.ctx.canary
                matmul_i8.launches = 0  # the main path's run starts here
                shadowed = promoted = launches_shadow = 0
                requests = _requests(48, SEED + 50 + fault)
                for i, x in enumerate(requests):
                    state, before = canary.state, matmul_i8.launches
                    reply = client.post("/predict", {"images": x.tolist()})
                    ref = i8_ref if state == PRIMARY else f32_ref
                    if reply["predictions"] != ref.predict(x).tolist():
                        raise AssertionError(
                            f"canary ({'fault' if fault else 'clean'}, "
                            f"{state}): reply {i} disagrees with the "
                            f"{'int8 plain' if ref is i8_ref else 'f32'} "
                            f"engine")
                    if state == SHADOW:
                        shadowed += 1
                        launches_shadow += matmul_i8.launches - before
                    elif state == PRIMARY:
                        promoted += 1
                    if (promoted >= 8 and not fault) or (
                            fault and canary.state == ROLLED_BACK
                            and i >= shadowed + 8):
                        break
                launches = matmul_i8.launches  # ... and ends here.
                stats = client.get("/stats")["canary"]
                want = ROLLED_BACK if fault else PRIMARY
                if stats["state"] != want \
                        or stats["shadow_batches"] != shadowed \
                        or launches_shadow != CNN_I8_PER_FORWARD * shadowed:
                    raise AssertionError(
                        f"canary ({'fault' if fault else 'clean'}): "
                        f"{stats}, {shadowed} shadowed batches launched "
                        f"K3 {launches_shadow} times")
                if not fault and promoted < 8:
                    raise AssertionError(f"the canary never promoted: "
                                         f"{stats}")
                out["rollback" if fault else "promote"] = {
                    "state": stats["state"], "shadowed_batches": shadowed,
                    "compared_rows": stats["compared_rows"],
                    "disagreed_rows": stats["disagreed_rows"],
                    "logit_delta": stats["logit_delta"],
                    "promoted_batches": promoted,
                    "launches_while_shadowing": launches_shadow,
                    "launches": launches}
            finally:
                httpd.shutdown()
                httpd.ctx.close()
                httpd.server_close()
                thread.join(timeout=30)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit("server_canary", promote=out["promote"], rollback=out["rollback"],
         replies_exact=True)
    return {"launches": out["promote"]["launches"]
            + out["rollback"]["launches"], **out}


def phase_server_multimodel(device_flag: str = "cuda") -> dict:
    """``--model-set cnn=A,vit=B --model-weights cnn=2``, int8, fused:
    every model's sequential replies equal its own engine's with
    ``matmul_i8_plain`` (K3: 2 launches a cnn forward, 10 a ViT one); a
    publish to A moves cnn to epoch 1 and leaves B's ``/healthz`` epoch
    and replies unchanged; ``tools/loadgen.py --smoke --model cnn
    --expect-models 2`` (a process of its own, no torch) passes."""
    import shutil

    import torch

    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
        params_to_jax,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        matmul_i8,
        matmul_i8_plain,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        save_params_checkpoint,
    )

    device = torch.device(device_flag, 0) if device_flag == "cuda" \
        else torch.device("cpu")
    root = tempfile.mkdtemp(prefix="chip_smoke_models_")
    dirs = {m: os.path.join(root, m) for m in ("cnn", "vit")}
    params = {m: init_params(m, SEED + 60) for m in dirs}
    for m, d in dirs.items():
        save_params_checkpoint(params_to_jax(params[m]), epoch=0,
                               directory=d)
    refs = {m: _engine(params[m], device, matmul_i8_plain, model=m)
            for m in dirs}
    per_forward = {"cnn": CNN_I8_PER_FORWARD, "vit": VIT_I8_PER_FORWARD}
    httpd, client, thread = _boot([
        "--model-set", f"cnn={dirs['cnn']},vit={dirs['vit']}",
        "--model-weights", "cnn=2", "--serve-precision", "int8",
        "--port", "0", "--device", device_flag, "--poll-interval", "0.2"])
    try:
        matmul_i8.launches = 0  # the main path's run starts here
        requests = _requests(8, SEED + 61)
        replies, counts = {}, {}
        for m in dirs:
            counts[m] = []
            replies[m] = []
            for x in requests:
                before = matmul_i8.launches
                replies[m] += _sequential(client, [x], model=m)
                counts[m].append(matmul_i8.launches - before)
            for x, reply in zip(requests, replies[m]):
                if reply["model"] != m or reply["model_epoch"] != 0 or \
                        reply["predictions"] != refs[m].predict(x).tolist():
                    raise AssertionError(f"{m}: a reply disagrees with its "
                                         f"plain int8 engine: {reply}")
            if set(counts[m]) != {per_forward[m]}:
                raise AssertionError(f"{m}: K3 launches per request "
                                     f"{counts[m]}, expected "
                                     f"{per_forward[m]}")
        new_cnn = init_params("cnn", SEED + 62)
        save_params_checkpoint(params_to_jax(new_cnn), epoch=1,
                               directory=dirs["cnn"])
        deadline = time.monotonic() + 30.0
        while client.get("/healthz")["models"]["cnn"] != 1:
            if time.monotonic() > deadline:
                raise AssertionError("the cnn plane never reloaded")
            time.sleep(0.05)
        health = client.get("/healthz")
        if health["models"] != {"cnn": 1, "vit": 0}:
            raise AssertionError(f"/healthz after a publish to A: {health}")
        vit_after = _sequential(client, requests, model="vit")
        if [r["predictions"] for r in vit_after] != \
                [r["predictions"] for r in replies["vit"]]:
            raise AssertionError("a publish to A moved B's replies")
        ref_new = _engine(new_cnn, device, matmul_i8_plain)
        for x, reply in zip(requests, _sequential(client, requests, "cnn")):
            if reply["model_epoch"] != 1 or \
                    reply["predictions"] != ref_new.predict(x).tolist():
                raise AssertionError(f"cnn after its reload: {reply}")
        launches = matmul_i8.launches  # ... and ends here.
        proc = subprocess.run(
            [sys.executable, os.path.join(_HERE, "tools", "loadgen.py"),
             "--smoke", "--url", client.base, "--requests", "100",
             "--concurrency", "4", "--model", "cnn", "--expect-models", "2"],
            capture_output=True, text=True, timeout=300)
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        if proc.returncode != 0 or not report.get("smoke_ok"):
            raise AssertionError(f"loadgen --expect-models 2: "
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        stats = client.get("/stats")
        emit("server_multimodel", models=sorted(dirs),
             weights=stats["fair_dispatch"]["weights"],
             fair_grants=stats["fair_dispatch"]["grants"],
             launches=launches, launches_per_request=counts,
             healthz_after_publish=health["models"], replies_exact=True,
             loadgen={k: report.get(k) for k in (
                 "ok", "models_served", "smoke_ok")})
        return {"launches": launches}
    finally:
        httpd.shutdown()
        httpd.ctx.close()
        httpd.server_close()
        thread.join(timeout=30)
        shutil.rmtree(root, ignore_errors=True)


class _OnDevices:
    """The pool as the autoscaler sees it, its resize kept to the pool's
    own device list: on one card, two replicas sharing it."""

    def __init__(self, pool, devices: list):
        self.pool = pool
        self.devices = devices

    @property
    def n_devices(self) -> int:
        return self.pool.n_devices

    def resize(self, n_devices: int) -> dict:
        return self.pool.resize(n_devices=n_devices, devices=self.devices)


def phase_server_autoscale(device_flag: str = "cuda") -> dict:
    """The SLO autoscaler (``serve/control.py``'s ``AutoScaler``, sampling
    the pool's ``ServeLog.window_stats`` as the server wires it) over an
    int8 cnn pool of one replica on the card (fused plane, buckets
    1/8/32/128), whose resize may place a second replica on the same card
    (``devices=[cuda:0, cuda:0]``, as in ``server_pool``), with an SLO p95
    of 1 ms and a ceiling of 2, under traffic from 4 client threads.
    First a dry run: scale-up decisions in the controller's snapshot
    (the server's ``/stats`` block) and as ``serve_autoscale`` lines in a
    ``--metrics-file`` sink, every one dry, the pool still one replica. Then the same settings actuating:
    the pool grows 1 -> 2 replicas sharing the card under the traffic,
    with zero drops and every batch equal to the plain pool's. Last, the
    CLI's ``--autoscale-max-devices`` one past the host's device count
    exits with the device-count refusal, as the reference's does."""
    import functools
    import shutil

    import torch

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        int8_linear,
        matmul_i8,
        matmul_i8_plain,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.control import AutoScaler
    from pytorch_distributed_mnist_tpu_torch.serve.pool import EnginePool
    from pytorch_distributed_mnist_tpu_torch.serve.server import (
        build_parser,
        create_server,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.device import (
        local_devices,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        JsonlSink,
        ServeLog,
    )

    device = torch.device(device_flag, 0) if device_flag == "cuda" \
        else torch.device("cpu")
    devices = [device, device]
    params0 = init_params("cnn", SEED)
    common = dict(buckets=PATH_BUCKETS, precision="int8", fuse=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_autoscale_")
    metrics = os.path.join(root, "metrics.jsonl")
    log = ServeLog()
    log.set_sink(JsonlSink(metrics))
    pool = EnginePool(functools.partial(get_model, "cnn",
                                        matmul=int8_linear), params0,
                      devices=devices[:1], serve_log=log, **common)
    plain = EnginePool(functools.partial(
        get_model, "cnn", matmul=functools.partial(
            int8_linear, matmul=matmul_i8_plain)), params0,
        devices=devices[:1], **common)
    pool.warmup()
    plain.warmup()
    # The CLI's controller settings, at its defaults but for the SLO and
    # a quick loop.
    cli = build_parser().parse_args(["--model", "cnn"])
    scaler_args = dict(
        slo_p95_ms=1.0,
        queue_high=max(1, int(cli.autoscale_queue_high * cli.max_queue)),
        min_devices=1, max_devices=len(devices), interval_s=0.2,
        cooldown_s=0.5, down_after=cli.autoscale_down_after,
        serve_log=log)

    def drive(scaler, until, record=None):
        """Traffic from 4 clients, run after run, until ``until()``
        holds (bounded); the runs' wall and drops."""
        scaler.start()
        runs = []
        deadline = time.monotonic() + 120.0
        try:
            while not until():
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"the autoscaler never acted: {scaler.snapshot()}")
                runs.append(_pool_traffic(
                    pool, _requests(POOL_REQUESTS, SEED + 70 + len(runs)),
                    record=record, serve_log=log))
        finally:
            scaler.stop()
        return runs

    try:
        matmul_i8.launches = 0  # the main path's run starts here
        served = []
        dry = AutoScaler(_OnDevices(pool, devices), log.window_stats,
                         dry_run=True, **scaler_args)
        drive(dry, lambda: dry.snapshot()["scale_ups"] >= 1, record=served)
        snap = dry.snapshot()
        ups = [d for d in snap["decisions"] if d["action"] == "scale_up"]
        if not ups or len(ups) != len(snap["decisions"]) \
                or not all(d["dry_run"] for d in ups) \
                or pool.n_replicas != 1:
            raise AssertionError(f"the dry run actuated: {pool.n_replicas} "
                                 f"replicas, {snap}")
        live = AutoScaler(_OnDevices(pool, devices), log.window_stats,
                          **scaler_args)
        runs = drive(live, lambda: pool.n_replicas == 2, record=served)
        launches = matmul_i8.launches  # ... and ends here.
        acted = live.snapshot()["decisions"]
        decision = acted[0]
        if len(acted) != 1 or decision["action"] != "scale_up" \
                or decision["dry_run"] or "error" in decision \
                or pool.n_replicas != 2:
            raise AssertionError(f"the autoscaler's actuation: {decision}")
        # One forward a served batch, and the warm-up of the grown pool
        # (a resize builds its new layout whole: two replicas, each one
        # forward a bucket on each plane).
        forwards = len(served) + 2 * 2 * len(PATH_BUCKETS)
        if launches != CNN_I8_PER_FORWARD * forwards:
            raise AssertionError(f"K3 launches {launches} for {forwards} "
                                 f"forwards")
        _same_as_plain(plain, served, "server_autoscale")
        with open(metrics) as f:
            events = [json.loads(line) for line in f
                      if '"serve_autoscale"' in line]
        if [e["dry_run"] for e in events] != [True] * len(ups) + [False]:
            raise AssertionError(f"the sink's serve_autoscale lines: "
                                 f"{events}")
        # The CLI refuses a ceiling past the host's devices.
        n_local = len(local_devices(device.type))
        try:
            create_server(build_parser().parse_args([
                "--model", "cnn", "--serve-precision", "int8", "--port",
                "0", "--device", device_flag, "--checkpoint-dir", root,
                "--serve-devices", "1", "--max-inflight", "2",
                "--autoscale", "--autoscale-dry-run", "--slo-p95-ms", "1",
                "--autoscale-max-devices", str(n_local + 1)]))
        except SystemExit as exc:
            refusal = str(exc)
        else:
            raise AssertionError("--autoscale-max-devices past the host's "
                                 "devices booted")
        if f"this host has {n_local} local device(s)" not in refusal:
            raise AssertionError(f"the --autoscale-max-devices refusal: "
                                 f"{refusal}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("server_autoscale", scale_up_decisions=len(ups), first=ups[0],
         actuated=decision, traffic_runs=len(runs), batches=len(served),
         dropped=0, replies_exact=True, sink_events=len(events),
         launches=launches, cli_refusal=refusal)
    return {"launches": launches}


# -- the fleet: the port's router over port backends ------------------------

FLEET_FAULT_ENV = "TPUMNIST_FLEET_FAULT"  # as serve/router.py spells it
FLEET_REQUESTS = 64  # the server phase's burst, per traffic run
FLEET_CLIENTS = 4
FLEET_TIMED_REQUESTS = 96  # per timed run (router, direct, in turns)


def _fleet_traffic(client, requests: list, clients: int = FLEET_CLIENTS,
                   during=None, body_extra=None) -> dict:
    """``clients`` threads post ``requests`` through ``client``; after a
    moment ``during()`` runs on this thread while they do. Returns the
    replies, each request's latency, the wall and the requests/s; a
    dropped request (any failure) raises."""
    replies, latency, errors = [None] * len(requests), [], []
    lock = threading.Lock()

    def worker(idx):
        for i in range(idx, len(requests), clients):
            body = {"images": requests[i].tolist(), **(body_extra or {})}
            t0 = time.perf_counter()
            try:
                reply = client.post("/predict", body)
            except Exception as exc:  # noqa: BLE001 - counted as a drop
                with lock:
                    errors.append(repr(exc))
                continue
            with lock:
                latency.append(time.perf_counter() - t0)
            replies[i] = reply

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    event = None
    if during is not None:
        time.sleep(0.2)
        event = during()
    for t in threads:
        t.join(300.0)
    wall = time.perf_counter() - t0
    dropped = [i for i, r in enumerate(replies)
               if r is None or len(r["predictions"]) != len(requests[i])]
    if errors or dropped:
        raise AssertionError(f"fleet traffic dropped {len(dropped)} of "
                             f"{len(requests)} requests: {errors[:3]}")
    lat = sorted(latency)
    return {"replies": replies, "event": event, "wall_s": wall,
            "rps": len(requests) / wall,
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3}


def _wait_until(check, what: str, seconds: float = 60.0):
    deadline = time.monotonic() + seconds
    while True:
        got = check()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: timed out waiting for {what}")
        time.sleep(0.05)


def phase_fleet_router(device_flag: str = "cuda") -> dict:
    """The port's router (``serve/router.py``, ``create_router``) in this
    process over two in-process port backends on the card (``serve
    --model cnn --serve-precision int8``, fused plane, buckets
    1/8/32/128), each on its own checkpoint directory at epoch 0, every
    batch each backend runs recorded with the epoch it ran at. Under the
    ``server`` phase's request set from 4 client threads through the
    router: one backend shut down, with zero dropped requests, then
    quarantined, restarted on its port and walked back through probation
    to healthy; ``POST /rollout`` of epoch 1 with zero drops and both
    backends' ``/healthz`` at 1 after it; a fleet canary of epoch 2 on
    backend 0 under ``TPUMNIST_FLEET_FAULT=canary_disagree`` rolled back,
    the baseline's weights republished there as epoch 3 and backend 1
    still at 1. Every recorded batch must equal the plain-product
    engine's on the params of its epoch, and every sequential reply
    through the router the plain engine's on its own. The aggregated
    ``/stats`` must have a row per backend and merged quantiles, and the
    process's K3 count (both backends share it) must rise over the phase.
    Printed, not gated: requests/s and p50 through the router against
    the same traffic straight to one backend, in turns."""
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
    from pytorch_distributed_mnist_tpu_torch.serve.router import (
        build_parser as router_parser,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.router import (
        create_router,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        save_params_checkpoint,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    # The params each epoch's checkpoint carries; epoch 3 is the canary's
    # rollback, the baseline's (epoch 1's) weights republished.
    params = {e: init_params("cnn", SEED + e) for e in (0, 1, 2)}
    params[3] = params[1]
    dirs = [os.path.join(root, f"b{i}") for i in range(2)]
    for d in dirs:
        save_params_checkpoint(params_to_jax(params[0]), epoch=0,
                               directory=d)
    staging = os.path.join(root, "staging")
    for e in (1, 2):
        save_params_checkpoint(params_to_jax(params[e]), epoch=e,
                               directory=staging)
    batches, lock = [], threading.Lock()

    def boot(i, port=0):
        httpd, client, thread = _boot([
            "--model", "cnn", "--serve-precision", "int8", "--port",
            str(port), "--device", device_flag, "--checkpoint-dir",
            dirs[i], "--require-checkpoint", "--poll-interval", "0.2",
            "--max-wait-ms", "2"])
        engine = httpd.ctx.engine
        served = engine.predict_with_epoch

        def recording(images):
            labels, epoch = served(images)
            with lock:
                batches.append((np.array(images), labels.copy(), epoch))
            return labels, epoch

        engine.predict_with_epoch = recording
        return {"httpd": httpd, "client": client, "thread": thread,
                "name": f"127.0.0.1:{httpd.server_address[1]}"}

    def stop(b, close=True):
        b["httpd"].shutdown()
        b["httpd"].server_close()
        b["thread"].join(timeout=30)
        if close:
            b["httpd"].ctx.close()

    backends = [boot(0), boot(1)]
    router_httpd = create_router(router_parser().parse_args([
        "--backends", ",".join(b["name"] for b in backends), "--host",
        "127.0.0.1", "--port", "0", "--health-interval", "0.1",
        "--quarantine-after", "2", "--probation-successes", "2",
        "--connect-timeout", "2.0"]))
    router_thread = threading.Thread(target=router_httpd.serve_forever,
                                     daemon=True)
    router_thread.start()
    router = _Client(router_httpd.server_address[1])
    saved_fault = os.environ.pop(FLEET_FAULT_ENV, None)
    try:
        _wait_until(lambda: router.get("/healthz")["routable"] == 2,
                    "both backends healthy")
        k3_before = backends[0]["client"].get("/stats")[
            "kernel_launches"]["matmul_i8"]
        matmul_i8.launches = 0  # the main path's run starts here
        burst = _fleet_traffic(router, _requests(FLEET_REQUESTS,
                                                 SEED + 10))
        sequential = _requests(12, seed=SEED + 11)
        seq_replies = [router.post("/predict", {"images": x.tolist()})
                       for x in sequential]

        # Backend loss: backend 1 shut down under traffic.
        def victim_row():
            return {r["name"]: r for r in router.get("/stats")["backends"]
                    }[backends[1]["name"]]

        loss = _fleet_traffic(router, _requests(FLEET_REQUESTS, SEED + 50),
                              during=lambda: stop(backends[1], close=False))
        backends[1]["httpd"].ctx.close()
        _wait_until(lambda: victim_row()["state"] == "quarantined",
                    "the shut-down backend quarantined")
        port = int(backends[1]["name"].rsplit(":", 1)[1])
        backends[1] = boot(1, port=port)
        healed = _wait_until(lambda: (lambda r: r if r["state"] == "healthy"
                                      else None)(victim_row()),
                             "the restarted backend healthy")
        if not healed["readmissions"]:
            raise AssertionError(f"no readmission: {healed}")

        # Rolling reload of epoch 1 under traffic.
        roll = _fleet_traffic(
            router, _requests(FLEET_REQUESTS, SEED + 51),
            during=lambda: router.post("/rollout", {
                "source": os.path.join(staging, "checkpoint_1.npz")}))
        rollout = roll["event"]
        epochs = [b["client"].get("/healthz") for b in backends]
        if not rollout["ok"] or sorted(rollout["updated"]) != sorted(
                b["name"] for b in backends) or any(
                h["model_epoch"] != 1 or h["draining"] for h in epochs):
            raise AssertionError(f"the rollout: {rollout}, {epochs}")

        # A fleet canary of epoch 2 on backend 0, every cohort reply made
        # a disagreement: rolled back, the baseline's weights republished
        # on backend 0 as epoch 3, backend 1 still serving epoch 1.
        os.environ[FLEET_FAULT_ENV] = "canary_disagree"
        try:
            started = router.post("/rollout", {
                "source": os.path.join(staging, "checkpoint_2.npz"),
                "canary": {"fraction": 1.0, "budget": 0.0,
                           "promote_after": 100000,
                           "backends": [backends[0]["name"]]}})
        finally:
            os.environ.pop(FLEET_FAULT_ENV, None)
        if not started["ok"]:
            raise AssertionError(f"the canary's publish: {started}")
        canary_run = _fleet_traffic(router, _requests(16, SEED + 52),
                                    body_extra={"client_id":
                                                "canary-probe"})
        canary = _wait_until(lambda: (lambda c: c if c.get("state") ==
                                      "rolled_back" else None)(
            router.get("/stats").get("fleet_canary") or {}),
            "the fleet canary's rollback")
        _wait_epoch(backends[0]["client"], 3, "the canary's rollback")
        after = _fleet_traffic(router, _requests(16, SEED + 53))
        if backends[1]["client"].get("/healthz")["model_epoch"] != 1:
            raise AssertionError("backend 1 left the baseline epoch")
        stats = router.get("/stats")
        launches = matmul_i8.launches  # ... and ends here.
        k3_after = backends[0]["client"].get("/stats")[
            "kernel_launches"]["matmul_i8"]

        rows = {r["name"]: r for r in stats["backends"]}
        window = stats["fleet"]["window"]
        if set(rows) != {b["name"] for b in backends} \
                or window["count"] <= 0 \
                or not window["p99_ms"] >= window["p50_ms"] > 0:
            raise AssertionError(f"the aggregated /stats: {stats}")
        if launches == 0 or k3_after <= k3_before:
            raise AssertionError(f"K3 launches {launches}, /stats "
                                 f"{k3_before} -> {k3_after}")
        for run in (burst, loss, roll, canary_run, after):
            for reply in run["replies"]:
                if reply["model_epoch"] not in params:
                    raise AssertionError(f"a reply at epoch "
                                         f"{reply['model_epoch']}")

        # Printed, not gated: the router hop against one backend direct.
        timed = []
        for via in ("router", "direct", "direct", "router"):
            client = router if via == "router" else backends[1]["client"]
            run = _fleet_traffic(client, _requests(FLEET_TIMED_REQUESTS,
                                                   SEED + 54))
            timed.append({"via": via, "requests": FLEET_TIMED_REQUESTS,
                          "rps": run["rps"], "p50_ms": run["p50_ms"],
                          "p99_ms": run["p99_ms"]})

        # Every recorded batch against the plain product on the params
        # of its epoch; every sequential reply (a batch of its own).
        device = backends[0]["httpd"].ctx.engine.device
        refs = {e: _engine(p, device, matmul_i8_plain)
                for e, p in params.items() if e != 3}
        refs[3] = refs[1]
        with lock:
            recorded = list(batches)
        for images, labels, epoch in recorded:
            want = refs[epoch].predict(images)
            if not np.array_equal(labels, want):
                raise AssertionError(
                    f"a batch of {len(images)} at epoch {epoch} disagrees "
                    f"with the plain int8 engine on "
                    f"{int(np.sum(labels != want))} rows")
        for reply, x in zip(seq_replies, sequential):
            if reply["model_epoch"] != 0 or \
                    reply["predictions"] != refs[0].predict(x).tolist():
                raise AssertionError("a sequential reply through the "
                                     "router disagrees with the plain "
                                     "engine")
        by_epoch = {}
        for _, _, epoch in recorded:
            by_epoch[epoch] = by_epoch.get(epoch, 0) + 1
    finally:
        if saved_fault is not None:
            os.environ[FLEET_FAULT_ENV] = saved_fault
        router_httpd.shutdown()
        router_httpd.ctx.close()
        router_httpd.server_close()
        router_thread.join(timeout=30)
        for b in backends:
            try:
                stop(b)
            except Exception:  # noqa: BLE001 - the shut-down one
                pass
        shutil.rmtree(root, ignore_errors=True)
    label = smi_name_and_limit() if device_flag == "cuda" else "cpu"
    emit("fleet_router", device=label, backends=2, clients=FLEET_CLIENTS,
         requests={"burst": FLEET_REQUESTS, "sequential": len(sequential),
                   "loss": FLEET_REQUESTS, "rollout": FLEET_REQUESTS,
                   "canary": 16, "after": 16},
         dropped=0, replies_exact=True, batches=len(recorded),
         batches_by_epoch={str(k): v for k, v in sorted(by_epoch.items())},
         loss={"victim": healed["name"], "quarantines":
               healed["quarantines"], "readmissions":
               healed["readmissions"], "rps": loss["rps"]},
         rollout=rollout, rollout_rps=roll["rps"],
         canary={k: canary[k] for k in ("state", "compared_rows",
                                        "disagreed_rows", "rollbacks")},
         fleet={k: stats["fleet"][k] for k in (
             "routable", "failovers", "retries", "fleet_503s", "window")},
         launches=launches, kernel_launches_stats=[k3_before, k3_after],
         timed=timed)
    return {"launches": launches, "timed": timed}


def phase_fleet_chaos(device_flag: str = "cuda") -> dict:
    """``runtime/chaos.py --fleet 2 --kill-backend 1 --device cuda
    --serve-model cnn`` as a process: the port's router (``route``, a
    process of its own) over two int8 cnn backend processes sharing the
    card, backend 1 SIGKILLed under open-loop traffic (once it has
    drawn a request, frozen until one waits unread in its socket) and
    restarted, then the no-fault twin. Passes only on the tool's exit 0 and its
    ``chaos`` line: zero dropped requests, the victim quarantined and
    readmitted, every backend's ``kernel_launches.matmul_i8`` (read from
    its own ``/stats`` before the kill) above 0 on the card, and no
    torch, numpy or JAX among the router's imports (``-X
    importtime``)."""
    env = dict(os.environ, PYTHONPATH=_HERE)
    env.pop(FLEET_FAULT_ENV, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch."
         "runtime.chaos", "--fleet", "2", "--kill-backend", "1",
         "--device", device_flag, "--serve-model", "cnn", "--timeout",
         "300"], capture_output=True, text=True, timeout=900, cwd=_HERE,
        env=env)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])["chaos"] if lines else {}
    faulted, twin = result.get("faulted") or {}, result.get("twin") or {}
    per_backend = {run: (r.get("k3_launches_before_kill") or {})
                   for run, r in (("faulted", faulted), ("twin", twin))}
    imports = [(r.get("router") or {}).get("imports") for r in
               (faulted, twin)]
    if (proc.returncode != 0 or not result.get("ok")
            or not faulted.get("victim_readmissions")
            or any(i != {"torch": False, "numpy": False, "jax": False}
                   for i in imports)
            or (device_flag == "cuda" and not all(
                len(v) == 2 and all(v.values())
                for v in per_backend.values()))):
        # The verdict last, where the end of the output shows it.
        raise AssertionError(f"fleet_chaos: rc {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}\n{result}")
    emit("fleet_chaos", wall_s=wall, seconds=result["seconds"],
         load={run: r["load"] for run, r in (("faulted", faulted),
                                              ("twin", twin))},
         failovers=faulted["failovers"],
         victim_requests_before_kill=faulted["victim_requests_before_kill"],
         victim_unread_bytes_at_kill=faulted["victim_unread_bytes_at_kill"],
         victim_readmissions=faulted["victim_readmissions"],
         launches_per_backend=per_backend,
         router={run: r["router"] for run, r in (("faulted", faulted),
                                                  ("twin", twin))})
    return {"launches_per_backend": per_backend}


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
        hot = min(1, c - 1)
        logits[1] = 0.0
        logits[1, hot] = 1e4
        labels[1] = hot
    g = torch.rand(b, device=device, generator=gen)
    return logits, labels, g


def adam_hyper_scalars(device):
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops.adam import ADAM_DEFAULTS

    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in {"learning_rate": 1e-3, **ADAM_DEFAULTS}.items()}


def leaf_shapes(model: str = "cnn"):
    """The model's param shapes (cnn: 8, vit: 31, moe_mlp: 10, its expert
    weights 3-D), in the order the optimizer walks them."""
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
    for b in XENT_CHECK_BATCHES:
        for c in XENT_CHECK_CLASSES:
            logits, labels, g = xent_inputs(b, c, gen, device)
            loss, lse = xent.xent_fwd(logits, labels)
            loss2, lse2 = xent.xent_fwd(logits, labels)
            want_loss, want_lse = xent.xent_fwd_plain(logits, labels)
            # Both backwards from the kernel's lse, so they gate alike.
            dl = xent.xent_bwd(logits, labels, lse, g)
            dl2 = xent.xent_bwd(logits, labels, lse, g)
            want_dl = xent.xent_bwd_plain(logits, labels, lse, g)
            # A sum's cotangent reaches the backward broadcast (stride 0).
            x = logits.clone().requires_grad_(True)
            xent.fused_cross_entropy_per_example(x, labels).sum().backward()
            ones = torch.ones_like(g)
            dl0 = xent.xent_bwd(logits, labels, lse, ones)
            want_dl0 = xent.xent_bwd_plain(logits, labels, lse, ones)
            torch.cuda.synchronize()
            for got, want in ((loss, want_loss), (lse, want_lse),
                              (dl, want_dl), (dl0, want_dl0)):
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            if not (torch.equal(loss, loss2) and torch.equal(lse, lse2)
                    and torch.equal(dl, dl2)):
                raise AssertionError(f"xent gave other bits on a second "
                                     f"call at {b}x{c}")
            if not torch.equal(x.grad, dl0):
                raise AssertionError(f"the fused loss's gradient from a "
                                     f"stride-0 cotangent differs from the "
                                     f"kernel's from ones at {b}x{c}")
            if float(loss[0]) != 0.0:
                raise AssertionError("the tie row's loss is not clamped to 0")
            worst["xent_fwd"] = max(worst["xent_fwd"], float(max(
                (loss - want_loss).abs().max(), (lse - want_lse).abs().max())))
            worst["xent_bwd"] = max(worst["xent_bwd"],
                                    float((dl - want_dl).abs().max()),
                                    float((dl0 - want_dl0).abs().max()))
    hyper = adam_hyper_scalars(device)
    sizes = [s for _, s in leaf_shapes()] + [(1,), (1000003,)]
    adam_err, adam_ulps = 0.0, 0
    # The one-leaf case, from a given hypers vector.
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
    # The multi-leaf launch over each model's leaves, its hypers formed in
    # the launch, for ADAM_STEPS steps (through t = 31 and t = 168, where
    # torch's vectorized pow rounds apart from its scalar one).
    for model in ("cnn", "vit", "moe_mlp"):
        err, most = _adam_leaves_vs_plain(device, model, hyper, gen)
        adam_err, adam_ulps = max(adam_err, err), max(adam_ulps, most)
    # The hypers the launch forms, against adam_hypers on the card.
    p, m, v, g = (torch.zeros(3, device=device) for _ in range(4))
    formed = torch.empty(9, device=device)
    hyper_misses = []
    for t in range(1, ADAM_HYPER_STEPS + 1):
        count = torch.tensor(t, dtype=torch.int32, device=device)
        adam.adam_leaves([p], [g], [m], [v], hyper, count,
                         hypers_out=formed)
        if not torch.equal(formed, adam.adam_hypers(hyper, count.float())):
            hyper_misses.append(t)
    if hyper_misses:
        raise AssertionError(f"the adam kernel's hypers differ from "
                             f"adam_hypers at t = {hyper_misses[:10]} "
                             f"({len(hyper_misses)} steps)")
    if adam_ulps:
        raise AssertionError(f"adam kernel is {adam_ulps} ulp from its "
                             f"plain version (bit for bit required)")
    emit("kernel_vs_plain", kernel="xent_fwd+xent_bwd",
         batches=list(XENT_CHECK_BATCHES), classes=list(XENT_CHECK_CLASSES),
         cotangent_strides=[1, 0], same_bits_twice=True, rtol=1e-6, atol=1e-6,
         max_abs_err_fwd=worst["xent_fwd"], max_abs_err_bwd=worst["xent_bwd"])
    emit("kernel_vs_plain", kernel="adam", shapes=[list(s) for s in sizes],
         steps=[1, 2, 10], multi_leaf_models=["cnn", "vit", "moe_mlp"],
         multi_leaf_steps=ADAM_STEPS, hypers_equal_steps=ADAM_HYPER_STEPS,
         bitwise=True, max_ulp=adam_ulps, max_abs_err=adam_err)
    return {**worst, "adam": adam_err}


def _adam_leaves_vs_plain(device, model, hyper, gen) -> tuple:
    """``adam_leaves`` over ``model``'s leaf shapes against
    ``adam_leaves_plain`` on the card for ``ADAM_STEPS`` steps; p, m and v
    compared after every step. Returns (largest error, largest ulps)."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import adam

    shapes = [s for _, s in leaf_shapes(model)]
    got = [[torch.randn(s, device=device, generator=gen) for _ in range(3)]
           for s in shapes]
    for _, m, v in got:
        m.mul_(0.1)
        v.abs_().mul_(0.01)
    want = [[x.clone() for x in leaf] for leaf in got]
    ps, ms, vs = ([leaf[i] for leaf in got] for i in range(3))
    wps, wms, wvs = ([leaf[i] for leaf in want] for i in range(3))
    table = adam.LeafTable(ps, ms, vs)
    count = torch.zeros((), dtype=torch.int32, device=device)
    err, most = 0.0, 0
    for step in range(ADAM_STEPS):
        count.add_(1)
        grads = [torch.randn(s, device=device, generator=gen) * 1e-2
                 for s in shapes]
        adam.adam_leaves(ps, grads, ms, vs, hyper, count, table=table)
        adam.adam_leaves_plain(wps, grads, wms, wvs, hyper, count)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                if not torch.equal(x, y):
                    err = max(err, float((x - y).abs().max()))
                    most = max(most, ulps(x, y))
        if most:
            raise AssertionError(f"adam_leaves over the {model}'s leaves is "
                                 f"{most} ulp from its plain version at "
                                 f"step {step + 1}")
    return err, most


def _kernel_ms(per: dict, name: str) -> float:
    return sum(v for k, v in per.items() if name in k)


def phase_train_timings(device, peaks) -> dict:
    """Device and host ms of each training kernel at the path's shapes:
    xent at 256 x 10, Adam's optimizer step over the cnn's 8 leaves and
    over the ViT's 31."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_mnist_tpu_torch.ops import xent

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    bw, _, f32_rate = peaks[:3]
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

    rows["adam"] = {"all_8": _adam_step_timing(device, gen, "cnn", peaks),
                    "vit_31": _adam_step_timing(device, gen, "vit", peaks)}
    emit("timing", kernel="adam", all_8=rows["adam"]["all_8"],
         vit_31=rows["adam"]["vit_31"])
    return rows


def _adam_step_timing(device, gen, model, peaks) -> dict:
    """One ``FusedAdam.step`` over ``model``'s leaves (its ``--optimizer
    adam_pallas`` step: the two count increments and one kernel launch),
    beside the plain version on the same leaves,
    ``torch.optim.Adam(fused=True)`` (the yardstick, never called by the
    port) and the byte bound. ``kernel_ms`` is the kernel's device time
    per step, ``step_ms`` everything the step runs on the card, and
    ``step_call_ms`` the host's time between back-to-back steps."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import adam

    bw, _, f32_rate = peaks[:3]
    params = []
    for _, shape in leaf_shapes(model):
        p = torch.randn(shape, device=device, generator=gen)
        p.grad = torch.randn(shape, device=device, generator=gen) * 1e-3
        params.append(p)
    if len(params) != TRAIN_RUNS[model]["params"]:
        raise AssertionError(f"the {model} has {len(params)} leaves")
    fused = adam.FusedAdam(params, lr=1e-3)
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    count = torch.ones((), dtype=torch.int32, device=device)

    def plain():
        adam.adam_leaves_plain(params, [p.grad for p in params],
                               [m for m, _ in moments],
                               [v for _, v in moments], fused.hyperparams,
                               count)

    library = torch.optim.Adam(params, lr=1e-3, fused=True)
    numel = sum(p.numel() for p in params)
    t_bytes = ADAM_BYTES * numel / bw * 1e3
    t_ops = 15 * numel / f32_rate * 1e3
    before = adam.adam_leaves.launches
    fused.step()
    launches_per_step = adam.adam_leaves.launches - before
    per = device_ms(fused.step)
    return {"leaves": len(params), "numel": numel,
            "launches_per_step": launches_per_step,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel_ms": _kernel_ms(per, "adam_leaves_kernel"),
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
    """(fused kernel, tiled pair, 3xTF32 pair, dQ kernel, dK/dV kernel)
    launches."""
    return (flash.flash_bwd.launches, flash.flash_bwd.route_launches["tiled"],
            flash.flash_bwd.route_launches["tf32x3"],
            flash.flash_dq.launches, flash.flash_dkv.launches)


# What one flash_bwd call moves in _bwd_counts, per route.
BWD_MOVES = {"fused": (1, 0, 0, 0, 0), "tiled": (0, 1, 0, 0, 0),
             "tf32x3": (0, 0, 1, 0, 0), "split": (0, 0, 0, 1, 1)}
# Each route's key in phase_flash_vs_plain's largest errors.
FWD_KEYS = {"tensor": "flash_fwd", "tf32x3": "flash_fwd_tf32",
            "cuda_core": "flash_fwd_cuda_core"}
BWD_KEYS = {"fused": "flash_bwd", "tiled": "flash_bwd_tiled",
            "tf32x3": "flash_bwd_tf32", "split": "flash_bwd_split"}


def require_full_float32() -> None:
    """Raises unless torch runs float32 matrix products in full float32:
    the plain versions are the float32 yardstick, and a plain version whose
    products ran in TF32 would make every float32 comparison meaningless."""
    import torch

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError(
            f"float32 products run in TF32 (allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, precision "
            f"{torch.get_float32_matmul_precision()!r}): the float32 "
            f"yardstick would not be float32")


def phase_flash_vs_plain(device) -> dict:
    """The flash kernels against their plain versions on the card, at
    every shape of ``FLASH_CHECK_SHAPES``, float32 and bfloat16, causal and
    not; O, lse, dQ, delta, dK and dV all compared. Each backward kernel
    takes the plain forward's O and lse (and the dK/dV kernel the plain
    delta), so each is held against its plain version on the same inputs.
    ``flash_bwd`` runs twice on the same inputs: both calls must give the
    same bits, and only its route's counters may move (the fused kernel's,
    the tiled or the 3xTF32 pair's). ``flash_fwd`` takes its route (the
    bf16 tensor-core kernel or the 3xTF32 one) twice for the same bits,
    and the CUDA-core forward, named, is held to the plain version beside
    it. The head dims that are not a multiple of 8 run the tensor-core
    kernels' narrow instantiation: each shape's copy width
    (``flash._copy_width``) is printed, and the ViT's D = 12 slices must
    take 8 bytes in bf16. ``TILED_CHECK_SHAPES`` hold the tiled pair in
    bf16 and the 3xTF32 forward and pair in float32, each twice for the
    same bits. Returns each kernel's largest error, keyed by
    ``FWD_KEYS`` and ``BWD_KEYS`` (and ``flash_dq``, ``flash_dkv``: the
    CUDA-core dQ and dK/dV kernels called directly)."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    require_full_float32()
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    worst = {**dict.fromkeys(FWD_KEYS.values(), 0.0),
             **dict.fromkeys(BWD_KEYS.values(), 0.0),
             "flash_dq": 0.0, "flash_dkv": 0.0}
    routes, used, fwd_routes, fwd_used, widths = {}, {}, {}, {}, {}
    # The largest share of its tolerance each route used, on the 16-byte
    # path and the narrow one.
    fwd_route_used, bwd_route_used = {}, {}
    f32 = flash_tolerance(torch.float32)
    for shape in FLASH_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tol = flash_tolerance(dtype)
            for causal in (False, True):
                where = f"{shape} {dtype} causal={causal}"
                key = f"{'x'.join(map(str, shape))} {dtype}".replace(
                    "torch.", "")
                q, k, v, do = flash_inputs(shape, dtype, gen, device)
                width = flash._copy_width(q, k, v)
                widths[key] = width
                if shape[-1] == 12 and dtype == torch.bfloat16 \
                        and width != 8:
                    raise AssertionError(f"the ViT's D = 12 slices copy "
                                         f"{width} bytes at {where}")
                path = "16-byte" if width == 16 and shape[-1] % 8 == 0 \
                    else "narrow"
                fwd_route = flash._fwd_route(shape, dtype)
                before = dict(flash.flash_fwd.route_launches)
                o, lse = flash.flash_fwd(q, k, v, causal=causal)
                want_o, want_lse = flash.flash_fwd_plain(q, k, v,
                                                         causal=causal)
                o2, lse2 = flash.flash_fwd(q, k, v, causal=causal)
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
                want_moved = dict.fromkeys(moved, 0)
                want_moved["cuda_core"] = 1
                want_moved[fwd_route] = 2
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                    raise AssertionError(f"flash_fwd ({fwd_route}) gave "
                                         f"other bits on a second call at "
                                         f"{where}")
                if moved != want_moved:
                    raise AssertionError(f"flash_fwd's routes moved by "
                                         f"{moved} at {where}")
                fwd_key = FWD_KEYS[fwd_route]
                worst[fwd_key] = max(
                    worst[fwd_key],
                    _close(f"O ({fwd_route})", o, want_o, tol, where),
                    _close(f"lse ({fwd_route})", lse, want_lse, f32, where))
                worst["flash_fwd_cuda_core"] = max(
                    worst["flash_fwd_cuda_core"],
                    _close("O (cuda_core)", o_cc, want_o, tol, where),
                    _close("lse (cuda_core)", lse_cc, want_lse, f32, where))
                fwd_routes[key] = fwd_route
                share = max(tolerance_used(o, want_o, tol),
                            tolerance_used(lse, want_lse, f32))
                fwd_used[key] = max(fwd_used.get(key, 0.0), share)
                at = f"{fwd_route} {path}"
                fwd_route_used[at] = max(fwd_route_used.get(at, 0.0), share)
                worst["flash_dq"] = max(
                    worst["flash_dq"], _close("dQ", dq, want_dq, tol, where),
                    _close("delta", delta, want_delta, f32, where))
                worst["flash_dkv"] = max(
                    worst["flash_dkv"], _close("dK", dk, want_dk, tol, where),
                    _close("dV", dv, want_dv, tol, where))

                route = flash._bwd_route(shape, dtype)
                err, share = _bwd_twice(flash, route, (q, k, v, want_o,
                                                       want_lse, do),
                                        (want_dq, want_dk, want_dv), causal,
                                        tol, where)
                worst[BWD_KEYS[route]] = max(worst[BWD_KEYS[route]], err)
                routes[key] = route
                used[key] = max(used.get(key, 0.0), share)
                at = f"{route} {path}"
                bwd_route_used[at] = max(bwd_route_used.get(at, 0.0), share)
    # The tiled route at the ViT's --patch-size 2 shapes in bf16.
    tol = flash_tolerance(torch.bfloat16)
    for shape in TILED_CHECK_SHAPES:
        for causal in (False, True):
            where = f"{shape} bfloat16 causal={causal}"
            key = f"{'x'.join(map(str, shape))} bfloat16"
            q, k, v, do = flash_inputs(shape, torch.bfloat16, gen, device)
            widths[key] = flash._copy_width(q, k, v)
            path = "16-byte" if widths[key] == 16 else "narrow"
            o, lse = flash.flash_fwd_plain(q, k, v, causal=causal)
            want = flash.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
            route = flash._bwd_route(shape, torch.bfloat16)
            if route != "tiled":
                raise AssertionError(f"{where} takes the {route} route")
            err, share = _bwd_twice(flash, route, (q, k, v, o, lse, do),
                                    want, causal, tol, where)
            worst["flash_bwd_tiled"] = max(worst["flash_bwd_tiled"], err)
            routes[key] = route
            used[key] = max(used.get(key, 0.0), share)
            at = f"{route} {path}"
            bwd_route_used[at] = max(bwd_route_used.get(at, 0.0), share)
    # The 3xTF32 route at the same shapes in float32: the forward twice for
    # the same bits, the pair through _bwd_twice.
    for shape in TILED_CHECK_SHAPES:
        for causal in (False, True):
            where = f"{shape} float32 causal={causal}"
            key = f"{'x'.join(map(str, shape))} float32"
            q, k, v, do = flash_inputs(shape, torch.float32, gen, device)
            widths[key] = flash._copy_width(q, k, v)
            path = "16-byte" if widths[key] == 16 and shape[-1] % 8 == 0 \
                else "narrow"
            for route in (flash._fwd_route(shape, torch.float32),
                          flash._bwd_route(shape, torch.float32)):
                if route != "tf32x3":
                    raise AssertionError(f"{where} takes the {route} route")
            o, lse = flash.flash_fwd(q, k, v, causal=causal)
            o2, lse2 = flash.flash_fwd(q, k, v, causal=causal)
            want_o, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(f"flash_fwd (tf32x3) gave other bits on "
                                     f"a second call at {where}")
            worst["flash_fwd_tf32"] = max(
                worst["flash_fwd_tf32"],
                _close("O (tf32x3)", o, want_o, f32, where),
                _close("lse (tf32x3)", lse, want_lse, f32, where))
            share = max(tolerance_used(o, want_o, f32),
                        tolerance_used(lse, want_lse, f32))
            fwd_routes[key] = "tf32x3"
            fwd_used[key] = max(fwd_used.get(key, 0.0), share)
            at = f"tf32x3 {path}"
            fwd_route_used[at] = max(fwd_route_used.get(at, 0.0), share)
            want = flash.flash_bwd_plain(q, k, v, want_o, want_lse, do,
                                         causal=causal)
            err, share = _bwd_twice(flash, "tf32x3",
                                    (q, k, v, want_o, want_lse, do), want,
                                    causal, f32, where)
            worst["flash_bwd_tf32"] = max(worst["flash_bwd_tf32"], err)
            routes[key] = "tf32x3"
            used[key] = max(used.get(key, 0.0), share)
            bwd_route_used[at] = max(bwd_route_used.get(at, 0.0), share)
    emit("flash_vs_plain", shapes=[list(s) for s in FLASH_CHECK_SHAPES],
         tiled_shapes=[list(s) for s in TILED_CHECK_SHAPES],
         tiled_dtypes=["bfloat16", "float32"],
         dtypes=["float32", "bfloat16"], causal=[False, True],
         tolerance={"float32": flash_tolerance(torch.float32),
                    "bfloat16": flash_tolerance(torch.bfloat16)},
         max_abs_err=worst, flash_fwd_routes=fwd_routes,
         flash_fwd_tolerance_used=fwd_used, flash_bwd_routes=routes,
         flash_bwd_tolerance_used=used, copy_width_bytes=widths,
         flash_fwd_worst_share_by_route=fwd_route_used,
         flash_bwd_worst_share_by_route=bwd_route_used,
         flash_fwd_same_bits=True, flash_bwd_same_bits=True)
    return worst


def _bwd_twice(flash, route, operands, want, causal, tol, where) -> tuple:
    """``flash_bwd`` twice on ``operands`` (q, k, v, O, lse, dO): only its
    route's counters may move, both calls must give the same bits, and dQ,
    dK and dV must lie within ``tol`` of ``want``. Returns (largest error,
    largest share of the tolerance used)."""
    import torch

    before = _bwd_counts(flash)
    got = flash.flash_bwd(*operands, causal=causal)
    again = flash.flash_bwd(*operands, causal=causal)
    torch.cuda.synchronize()
    moved = tuple(b - a for a, b in zip(before, _bwd_counts(flash)))
    if moved != tuple(2 * n for n in BWD_MOVES[route]):
        raise AssertionError(f"flash_bwd on the {route} route moved (fused, "
                             f"tiled, dq, dkv) by {moved} at {where}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_bwd gave other bits on a second call "
                             f"at {where}")
    err = max(_close(f"flash_bwd {name} ({route})", a, b, tol, where)
              for name, a, b in zip(("dQ", "dK", "dV"), got, want))
    return err, max(tolerance_used(a, b, tol) for a, b in zip(got, want))


def flash_bound_ms(kernel: str, shape, elem_bytes: int, peaks) -> tuple:
    """(least ms, what bounds it, bytes, operations) of one flash kernel:
    each input read once and each output written once (q, k, v, O, dO,
    dQ, dK, dV of ``elem_bytes`` each; lse and delta float32), against the
    products' 2 operations per multiply-add (two products in the forward,
    three in dQ, four in dK/dV, five in the fused backward) at the card's
    bf16 tensor-core rate. Float32 problems: the 3xTF32 kernels (named
    ``<kernel>_tf32``) at the TF32 tensor-core rate over
    ``TF32_PER_PRODUCT``, the others at the card's float32 rate outside the
    tensor cores."""
    tf32 = kernel.endswith("_tf32")
    if tf32:
        kernel = kernel[:-len("_tf32")]
    b, t, h, d = shape
    tensor = b * t * h * d * elem_bytes
    row = b * h * t * 4
    bytes_moved, products = {
        # q, k, v in; O, lse out
        "flash_fwd": (3 * tensor + tensor + row, 2),
        "flash_fwd_cuda_core": (3 * tensor + tensor + row, 2),
        # q, k, v, O, dO, lse in; dQ, delta out
        "flash_dq": (5 * tensor + row + tensor + row, 3),
        "flash_dq_tiled": (5 * tensor + row + tensor + row, 3),
        # q, k, v, dO, lse, delta in; dK, dV out
        "flash_dkv": (4 * tensor + 2 * row + 2 * tensor, 4),
        "flash_dkv_tiled": (4 * tensor + 2 * row + 2 * tensor, 4),
        # q, k, v, O, dO, lse in; dQ, dK, dV out (delta stays on chip)
        "flash_bwd": (5 * tensor + row + 3 * tensor, 5),
    }[kernel]
    ops = products * 2 * b * h * t * t * d
    rate = (peaks[3] if elem_bytes == 2
            else peaks[4] / TF32_PER_PRODUCT if tf32 else peaks[2])
    t_bytes = bytes_moved / peaks[0] * 1e3
    t_ops = ops / rate * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, bytes_moved, ops


def pair_bound_ms(pair: tuple, shape, elem_bytes: int, peaks) -> tuple:
    """(least ms, what bounds it) of kernels that run one after the other:
    the sum of their bounds, bound by bytes when each of them is."""
    bounds = [flash_bound_ms(k, shape, elem_bytes, peaks) for k in pair]
    by = "bytes" if all(b[1] == "bytes" for b in bounds) else "operations"
    return sum(b[0] for b in bounds), by


# Each flash row's own kernel, by the name the profiler gives it.
FLASH_KERNEL_NAMES = {"flash_fwd": "flash_fwd_mma_kernel",
                      "flash_fwd_cuda_core": "flash_fwd_kernel",
                      "flash_dq": "flash_dq_kernel",
                      "flash_dkv": "flash_dkv_kernel",
                      "flash_bwd": "flash_bwd_kernel",
                      "flash_dq_tiled": "flash_dq_tiled_kernel",
                      "flash_dkv_tiled": "flash_dkv_tiled_kernel",
                      "flash_fwd_tf32": "flash_fwd_tf32_kernel",
                      "flash_dq_tf32": "flash_dq_tf32_kernel",
                      "flash_dkv_tf32": "flash_dkv_tf32_kernel"}


# The 3xTF32 pair by its kernels' names in FLASH_KERNEL_NAMES.
TF32_PAIR = ("flash_dq_tf32", "flash_dkv_tf32")


def _sdpa_backward(q, k, v, do):
    """A call of ``F.scaled_dot_product_attention``'s backward (dQ, dK and
    dV in one call) on (B, T, H, D) operands: the library yardstick of the
    backward routes, timed here only."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    grad = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), grad,
                                       retain_graph=True)


def _timed_row(fns: dict, **fields) -> dict:
    """Device ms (``<what>_ms``) and host ms between back-to-back calls
    (``<what>_call_ms``) of each function, with ``<kernel>_only_ms`` for
    each own kernel named in ``fields["kernels"]`` from the ``kernel``
    call's trace."""
    row = {"library_ms": None, **fields}
    for what, fn in fns.items():
        per = device_ms(fn)
        row[f"{what}_ms"] = sum(per.values())
        row[f"{what}_call_ms"] = call_ms(fn)
        if what == "kernel":
            for name in fields.get("kernels", ()):
                row[f"{name}_only_ms"] = _kernel_ms(
                    per, FLASH_KERNEL_NAMES[name])
        if what == "library":
            row["library_kernels"] = sorted(k[:60] for k in per)
    return row


def phase_flash_timings(device, peaks) -> dict:
    """Device ms per call of each flash kernel, beside its plain version,
    its bound and the library yardstick (``F.scaled_dot_product_attention``'s
    forward, and its backward, which computes dQ, dK and dV in one call;
    timed here only, the port never calls it). At the ViT's training shape
    in bf16: the tensor-core forward beside the CUDA-core one
    (``cuda_core_ms``), the split pair's dQ and dK/dV kernels, and the
    fused backward beside the split pair. In float32, at the ViT's shape
    and at --patch-size 2 (T = 196): the 3xTF32 forward and pair (the
    route's default) beside the CUDA-core forward and split pair named in
    the same call, and each beside SDPA in float32; each 3xTF32 kernel
    alone at the ViT's shape; the CUDA-core forward and split pair (named)
    at the ViT's shape in rows of their own. The tiled pair at the ViT's
    --patch-size 2 shape and, named, at the ViT's shape, beside the bf16
    split pair (named) and SDPA's backward at each; the bf16 forward at
    T = 196 beside SDPA. A backward yardstick is set against a whole route:
    no one kernel of a pair computes what it computes."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    require_full_float32()
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    q, k, v, do = flash_inputs(VIT_SHAPE, torch.bfloat16, gen, device)
    o, lse = flash.flash_fwd(q, k, v)
    _, delta = flash.flash_dq(q, k, v, o, lse, do)
    qf, kf, vf, dof = flash_inputs(VIT_SHAPE, torch.float32, gen, device)
    of, lsef = flash.flash_fwd(qf, kf, vf)
    sdpa = {"flash_fwd": "F.scaled_dot_product_attention",
            "backward": "its backward (dQ, dK and dV in one call)"}
    rows = {}

    def add(name, fns, shape, dtype, bound, by, **fields):
        rows[name] = _timed_row(fns, shape=list(shape), dtype=dtype,
                                bound_ms=bound, bound_by=by, **fields)
        emit("timing", kernel=name, **rows[name])

    for name, fns, dtype in (
            ("flash_fwd", {
                "kernel": lambda: flash.flash_fwd(q, k, v),
                "cuda_core": lambda: flash.flash_fwd(q, k, v,
                                                     route="cuda_core"),
                "plain": lambda: flash.flash_fwd_plain(q, k, v),
                "library": lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2))}, "bfloat16"),
            ("flash_fwd_cuda_core", {
                "kernel": lambda: flash.flash_fwd(qf, kf, vf,
                                                  route="cuda_core"),
                "plain": lambda: flash.flash_fwd_plain(qf, kf, vf),
                "library": lambda: F.scaled_dot_product_attention(
                    qf.transpose(1, 2), kf.transpose(1, 2),
                    vf.transpose(1, 2))}, "float32"),
            ("flash_dq", {
                "kernel": lambda: flash.flash_dq(q, k, v, o, lse, do),
                "plain": lambda: flash.flash_dq_plain(q, k, v, o, lse, do)},
             "bfloat16"),
            ("flash_dkv", {
                "kernel": lambda: flash.flash_dkv(q, k, v, lse, delta, do),
                "plain": lambda: flash.flash_dkv_plain(q, k, v, lse, delta,
                                                       do)}, "bfloat16"),
            ("flash_bwd", {
                "kernel": lambda: flash.flash_bwd(q, k, v, o, lse, do),
                "plain": lambda: flash.flash_bwd_plain(q, k, v, o, lse, do),
                "library": _sdpa_backward(q, k, v, do)}, "bfloat16")):
        least, by, bytes_moved, ops = flash_bound_ms(
            name, VIT_SHAPE, 4 if dtype == "float32" else 2, peaks)
        add(name, fns, VIT_SHAPE, dtype, least, by, bytes=bytes_moved,
            operations=ops, kernels=(name,),
            library_call={"flash_fwd": sdpa["flash_fwd"],
                          "flash_fwd_cuda_core": sdpa["flash_fwd"],
                          "flash_bwd": sdpa["backward"]}.get(name))
    rows["flash_bwd"]["split_pair_ms"] = (rows["flash_dq"]["kernel_ms"]
                                          + rows["flash_dkv"]["kernel_ms"])

    # The float32 split pair (named) beside SDPA's float32 backward.
    add("flash_split_f32", {
        "kernel": lambda: flash.flash_bwd(qf, kf, vf, of, lsef, dof,
                                          route="split"),
        "plain": lambda: flash.flash_bwd_plain(qf, kf, vf, of, lsef, dof),
        "library": _sdpa_backward(qf, kf, vf, dof)}, VIT_SHAPE, "float32",
        *pair_bound_ms(("flash_dq", "flash_dkv"), VIT_SHAPE, 4, peaks),
        kernels=("flash_dq", "flash_dkv"), library_call=sdpa["backward"])

    # The 3xTF32 route (float32's default) at T = 49 and T = 196, beside
    # the CUDA-core kernels named in the same call.
    def tf32_rows(suffix, shape, ops):
        fq, fk, fv, _, _, fdo = ops
        least, by, bytes_moved, n_ops = flash_bound_ms("flash_fwd_tf32",
                                                       shape, 4, peaks)
        add(f"flash_fwd_tf32{suffix}", {
            "kernel": lambda: flash.flash_fwd(fq, fk, fv),
            "cuda_core": lambda: flash.flash_fwd(fq, fk, fv,
                                                 route="cuda_core"),
            "plain": lambda: flash.flash_fwd_plain(fq, fk, fv),
            "library": lambda: F.scaled_dot_product_attention(
                fq.transpose(1, 2), fk.transpose(1, 2), fv.transpose(1, 2))},
            shape, "float32", least, by, bytes=bytes_moved,
            operations=n_ops, kernels=("flash_fwd_tf32",),
            library_call=sdpa["flash_fwd"])
        add(f"flash_bwd_tf32{suffix}", {
            "kernel": lambda: flash.flash_bwd(*ops),
            "split": lambda: flash.flash_bwd(*ops, route="split"),
            "plain": lambda: flash.flash_bwd_plain(*ops),
            "library": _sdpa_backward(fq, fk, fv, fdo)}, shape, "float32",
            *pair_bound_ms(TF32_PAIR, shape, 4, peaks), kernels=TF32_PAIR,
            library_call=sdpa["backward"])

    q2f, k2f, v2f, do2f = flash_inputs(P2_SHAPE, torch.float32, gen, device)
    o2f, lse2f = flash.flash_fwd(q2f, k2f, v2f)
    tf32_rows("", VIT_SHAPE, (qf, kf, vf, of, lsef, dof))
    tf32_rows("_p2", P2_SHAPE, (q2f, k2f, v2f, o2f, lse2f, do2f))
    # Each 3xTF32 kernel of the pair alone at the ViT's shape.
    deltaf = flash._delta_plain(of, dof)
    for name, plain in (
            ("flash_dq_tf32",
             lambda: flash.flash_dq_plain(qf, kf, vf, of, lsef, dof)),
            ("flash_dkv_tf32",
             lambda: flash.flash_dkv_plain(qf, kf, vf, lsef, deltaf, dof))):
        least, by, _, _ = flash_bound_ms(name, VIT_SHAPE, 4, peaks)
        rows[name] = {"shape": list(VIT_SHAPE), "dtype": "float32",
                      "bound_ms": least, "bound_by": by,
                      "kernel_ms": rows["flash_bwd_tf32"][f"{name}_only_ms"],
                      "plain_ms": sum(device_ms(plain).values()),
                      "library_ms": None}
        emit("timing", kernel=name, **rows[name])

    # The tiled pair at T = 196 (its route) and at T = 49 (named).
    tiled = ("flash_dq_tiled", "flash_dkv_tiled")
    q2, k2, v2, do2 = flash_inputs(P2_SHAPE, torch.bfloat16, gen, device)
    o2, lse2 = flash.flash_fwd(q2, k2, v2)
    _, delta2 = flash.flash_dq(q2, k2, v2, o2, lse2, do2)
    for name, shape, ops in (
            ("flash_bwd_tiled", P2_SHAPE, (q2, k2, v2, o2, lse2, do2)),
            ("flash_bwd_tiled_t49", VIT_SHAPE, (q, k, v, o, lse, do))):
        fns = {"kernel": lambda ops=ops: flash.flash_bwd(*ops,
                                                         route="tiled"),
               "split": lambda ops=ops: flash.flash_bwd(*ops, route="split"),
               "plain": lambda ops=ops: flash.flash_bwd_plain(*ops),
               "library": _sdpa_backward(ops[0], ops[1], ops[2], ops[5])}
        if shape == VIT_SHAPE:
            fns["fused"] = lambda: flash.flash_bwd(q, k, v, o, lse, do)
        add(name, fns, shape, "bfloat16", *pair_bound_ms(tiled, shape, 2,
                                                          peaks),
            kernels=tiled, library_call=sdpa["backward"])
    # Each tiled kernel alone at T = 196: its plain version and bound.
    for name, plain in (
            ("flash_dq_tiled",
             lambda: flash.flash_dq_plain(q2, k2, v2, o2, lse2, do2)),
            ("flash_dkv_tiled",
             lambda: flash.flash_dkv_plain(q2, k2, v2, lse2, delta2, do2))):
        least, by, _, _ = flash_bound_ms(name, P2_SHAPE, 2, peaks)
        rows[name] = {"shape": list(P2_SHAPE), "dtype": "bfloat16",
                      "bound_ms": least, "bound_by": by,
                      "kernel_ms": rows["flash_bwd_tiled"][f"{name}_only_ms"],
                      "plain_ms": sum(device_ms(plain).values()),
                      "library_ms": None}
        emit("timing", kernel=name, **rows[name])
    # The bf16 tensor-core forward at T = 196 beside SDPA.
    least, by, bytes_moved, n_ops = flash_bound_ms("flash_fwd", P2_SHAPE, 2,
                                                   peaks)
    add("flash_fwd_p2", {
        "kernel": lambda: flash.flash_fwd(q2, k2, v2),
        "plain": lambda: flash.flash_fwd_plain(q2, k2, v2),
        "library": lambda: F.scaled_dot_product_attention(
            q2.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2))},
        P2_SHAPE, "bfloat16", least, by, bytes=bytes_moved,
        operations=n_ops, kernels=("flash_fwd",),
        library_call=sdpa["flash_fwd"])

    # The ViT at D = 12 (embed 48 in 4 heads) at T = 49 and 196, bf16 and
    # float32: the default tensor-core routes (the narrow instantiation)
    # beside the CUDA-core forward and split pair named in the same call,
    # which served D = 12 by default before, and SDPA, with the SDPA
    # backend that served each call and the backends that take the shape.
    for shape, suffix in ((D12_SHAPE, ""), (D12_P2_SHAPE, "_p2")):
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            elem = dtype.itemsize
            tag = f"d12{suffix}_{'bf16' if elem == 2 else 'f32'}"
            dq_, dk_, dv_, ddo = flash_inputs(shape, dtype, gen, device)
            do_, dlse = flash.flash_fwd(dq_, dk_, dv_)
            ops = (dq_, dk_, dv_, do_, dlse, ddo)
            fwd_route = flash._fwd_route(shape, dtype)
            bwd_route = flash._bwd_route(shape, dtype)
            fwd_kernel = FWD_KEYS[fwd_route]
            pair = {"fused": ("flash_bwd",), "tiled": tiled,
                    "tf32x3": TF32_PAIR}[bwd_route]
            heads = [x.transpose(1, 2) for x in (dq_, dk_, dv_)]
            least, by, bytes_moved, n_ops = flash_bound_ms(fwd_kernel, shape,
                                                           elem, peaks)
            add(f"flash_fwd_{tag}", {
                "kernel": lambda ops=ops: flash.flash_fwd(*ops[:3]),
                "cuda_core": lambda ops=ops: flash.flash_fwd(
                    *ops[:3], route="cuda_core"),
                "plain": lambda ops=ops: flash.flash_fwd_plain(*ops[:3]),
                "library": lambda heads=heads:
                    F.scaled_dot_product_attention(*heads)},
                shape, dtype_name, least, by, bytes=bytes_moved,
                operations=n_ops, kernels=(fwd_kernel,), route=fwd_route,
                copy_width=flash._copy_width(dq_, dk_, dv_),
                cuda_core_bound_ms=flash_bound_ms(
                    "flash_fwd_cuda_core", shape, elem, peaks)[0],
                library_call=sdpa["flash_fwd"],
                library_backends_that_take=sdpa_backends_that_take(*heads))
            add(f"flash_bwd_{tag}", {
                "kernel": lambda ops=ops: flash.flash_bwd(*ops),
                "split": lambda ops=ops: flash.flash_bwd(*ops,
                                                         route="split"),
                "plain": lambda ops=ops: flash.flash_bwd_plain(*ops),
                "library": _sdpa_backward(dq_, dk_, dv_, ddo)},
                shape, dtype_name, *pair_bound_ms(pair, shape, elem, peaks),
                kernels=pair, route=bwd_route,
                split_bound_ms=pair_bound_ms(("flash_dq", "flash_dkv"),
                                             shape, elem, peaks)[0],
                library_call=sdpa["backward"])
            for name in (f"flash_fwd_{tag}", f"flash_bwd_{tag}"):
                rows[name]["library_backend"] = sdpa_backend(
                    rows[name]["library_kernels"])
    return rows


def sdpa_backend(kernels) -> str:
    """The backend of ``F.scaled_dot_product_attention`` that ran, from its
    kernels' names in a profiler trace: ``"flash"``, ``"efficient"``
    (memory-efficient, CUTLASS's fmha), ``"cudnn"`` or ``"math"`` (plain
    products and a softmax)."""
    names = " ".join(kernels).lower()
    if "cudnn" in names:
        return "cudnn"
    if "pytorch_flash" in names or "flash_fwd" in names \
            or "flash_bwd" in names:
        return "flash"
    if "fmha" in names or "mem_eff" in names or "attention_kernel" in names:
        return "efficient"
    return "math"


def sdpa_backends_that_take(q, k, v) -> dict:
    """Which of SDPA's backends run (B, H, T, D) q, k and v when each is
    the only one allowed (the flash backend needs D a multiple of 8)."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    takes = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(q, k, v)
            takes[name.lower()] = True
        except RuntimeError:
            takes[name.lower()] = False
    return takes


def phase_flash_split_route(device) -> dict:
    """The backward routes other than the fused one on the attention path:
    ``flash_attention``'s forward and backward at each
    ``SPLIT_ROUTE_CASES`` entry must launch its route's kernels once (the
    tiled pair or the 3xTF32 pair, at D = 16 and at D = 12) and no other
    backward, and at each ``FORCED_CUDA_CORE_CASES`` entry ``flash_fwd``
    named ``route="cuda_core"`` and ``flash_bwd`` named ``route="split"``
    launch the CUDA-core kernels, which no problem takes unnamed. The
    forwards take their routes too: bf16 the tensor-core kernel, float32
    the 3xTF32 one. Gradients are held against ``flash_bwd_plain`` on the
    forward kernel's O and lse, and the named forwards against
    ``flash_fwd_plain``. Returns the launch counts of that run."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    require_full_float32()
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    cases = []
    for shape, dtype_name, route in SPLIT_ROUTE_CASES:
        dtype = getattr(torch, dtype_name)
        if flash._bwd_route(shape, dtype) != route:
            raise AssertionError(f"{shape} {dtype_name} is not on the "
                                 f"{route} route")
        q, k, v, do = flash_inputs(shape, dtype, gen, device)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        cases.append((shape, dtype, route, leaves, do))
    forced = [(shape, getattr(torch, name),
               flash_inputs(shape, getattr(torch, name), gen, device))
              for shape, name in FORCED_CUDA_CORE_CASES]
    fwd_counts = flash.flash_fwd.route_launches
    bwd_counts = flash.flash_bwd.route_launches
    # The routes' run starts here.
    flash.flash_bwd.launches = 0
    bwd_counts.update(dict.fromkeys(bwd_counts, 0))
    flash.flash_dq.launches = 0
    flash.flash_dkv.launches = 0
    fwd_counts.update(dict.fromkeys(fwd_counts, 0))
    for _, _, _, leaves, do in cases:
        flash.flash_attention(*leaves).backward(do)
    forced_out = []
    for _, _, (q, k, v, do) in forced:
        o, lse = flash.flash_fwd(q, k, v, route="cuda_core")
        forced_out.append((o, lse, flash.flash_bwd(q, k, v, o, lse, do,
                                                   route="split")))
    torch.cuda.synchronize()
    launches = {"flash_bwd": flash.flash_bwd.launches,
                **{f"flash_bwd_{r}": n for r, n in bwd_counts.items()},
                "flash_dq": flash.flash_dq.launches,
                "flash_dkv": flash.flash_dkv.launches,
                **{f"flash_fwd_{r}": n for r, n in fwd_counts.items()}}
    # ... and ends here.
    routes = [route for _, _, route, _, _ in cases] + ["split"] * len(forced)
    fwd_routes = [flash._fwd_route(shape, dtype)
                  for shape, dtype, _, _, _ in cases] \
        + ["cuda_core"] * len(forced)
    want = {"flash_bwd": routes.count("fused"),
            **{f"flash_bwd_{r}": routes.count(r) for r in bwd_counts},
            "flash_dq": routes.count("split"),
            "flash_dkv": routes.count("split"),
            **{f"flash_fwd_{r}": fwd_routes.count(r) for r in fwd_counts}}
    if launches != want:
        raise AssertionError(f"backward route launch counts {launches}, "
                             f"expected {want}")
    errors = {}
    f32 = flash_tolerance(torch.float32)
    for shape, dtype, route, leaves, do in cases:
        where = f"{shape} {dtype} ({route} route)"
        q, k, v = (x.detach() for x in leaves)
        o, lse = flash.flash_fwd(q, k, v)
        want_grads = flash.flash_bwd_plain(q, k, v, o, lse, do)
        errors[where] = max(
            _close(name, x.grad, w, flash_tolerance(dtype), where)
            for name, x, w in zip(("dQ", "dK", "dV"), leaves, want_grads))
    for (shape, dtype, (q, k, v, do)), (o, lse, grads) in zip(forced,
                                                            forced_out):
        where = f"{shape} {dtype} (cuda_core and split, named)"
        tol = flash_tolerance(dtype)
        want_o, want_lse = flash.flash_fwd_plain(q, k, v)
        want_grads = flash.flash_bwd_plain(q, k, v, o, lse, do)
        errors[where] = max(
            _close("O", o, want_o, tol, where),
            _close("lse", lse, want_lse, f32, where),
            *(_close(name, x, w, tol, where)
              for name, x, w in zip(("dQ", "dK", "dV"), grads, want_grads)))
    emit("flash_split_route",
         cases=[[list(s), d, r] for s, d, r in SPLIT_ROUTE_CASES],
         forced_cuda_core=[[list(s), d] for s, d in FORCED_CUDA_CORE_CASES],
         launches=launches, expected_launches=want, max_abs_err=errors)
    return launches


def _rank_block(whole, heads):
    """Rank heads ``heads`` of the whole problem ``whole`` (q, k, v, dO),
    laid out as the rank's model hands them over: slices of its own
    (B, T, 3, H/n, D) product."""
    import torch

    q, k, v, do = whole
    qkv = torch.stack([x[:, :, heads] for x in (q, k, v)], dim=2)
    qkv = qkv.contiguous()
    return (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
            do[:, :, heads].contiguous())


def _rank_paths(device, shapes) -> dict:
    """The slice's entry points on the card, counted from 0: for each TP
    shape ``sharded_flash_attention`` (the ``--tensor-parallel
    --attention flash`` attention) on rank 0's block, and for each
    Ulysses shape ``ulysses_attention_local`` with ``flash_attention`` as
    its local attention on a seq axis of one rank (on one card no
    all-to-all can run; the local attention takes the block it is
    handed), each forward and backward through autograd, bf16. Each call
    must launch one tensor-core forward and one backward of its route."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import flash
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
        DataAxis,
        GridMesh,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.ulysses import (
        ulysses_attention_local,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    calls = []
    for tag, shape in shapes:
        q, k, v, do = flash_inputs(shape, torch.bfloat16, gen, device)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        if tag.startswith("ulysses"):
            seq = DataAxis(1, 0, device, None, "seq")
            call = (lambda leaves=leaves, seq=seq: ulysses_attention_local(
                *leaves, axis=seq, local_attention=flash.flash_attention))
        else:
            tp = VIT_SHAPE[2] // shape[2]
            dp = TRAIN_BATCH // shape[0]
            mesh = GridMesh(dp * tp, 0, device, (
                DataAxis(dp, 0, device, None, "data"),
                DataAxis(tp, 0, device, None, "model"),
                DataAxis(1, 0, device, None, "seq")))
            call = (lambda leaves=leaves, mesh=mesh:
                    flash.sharded_flash_attention(
                        *leaves, mesh=mesh, batch_axis="data",
                        head_axis="model"))
        calls.append((tag, shape, call, do))
    fwd, bwd = flash.flash_fwd, flash.flash_bwd
    out = {}
    for tag, shape, call, do in calls:
        # This path's run starts here ...
        fwd.launches = 0
        fwd.route_launches.update(dict.fromkeys(fwd.route_launches, 0))
        bwd.launches = 0
        bwd.route_launches.update(dict.fromkeys(bwd.route_launches, 0))
        call().backward(do)
        torch.cuda.synchronize()
        # ... and ends here.
        got = {"flash_fwd": dict(fwd.route_launches),
               "flash_bwd": dict(bwd.route_launches)}
        route = flash._bwd_route(shape, torch.bfloat16)
        want = {"flash_fwd": {r: int(r == "tensor")
                              for r in fwd.route_launches},
                "flash_bwd": {r: int(r == route)
                              for r in bwd.route_launches}}
        if got != want:
            raise AssertionError(f"{tag} {shape}: launches {got}, expected "
                                 f"{want}")
        out[tag] = {"entry": ("ulysses_attention_local" if
                              tag.startswith("ulysses")
                              else "sharded_flash_attention"),
                    "flash_fwd": 1, "flash_bwd": 1, "bwd_route": route}
    return out


def phase_flash_rank_shapes(device, peaks) -> dict:
    """The flash kernels at tensor and sequence parallelism's per-rank
    shapes (``RANK_SHAPES``), bf16 and float32, causal and not: the
    forward and ``flash_bwd`` (its route's kernels) against their plain
    versions within ``flash_tolerance``, and against the head slice of
    the whole (B, T, 4, 16) call at the same B and T (first and last
    rank's heads): attention is independent per head, and whether each
    output matches bit for bit, and by how much if not, is printed. Then
    their device ms beside the plain versions, SDPA's forward and
    backward and the bound (non-causal, as the ViT calls them), and the
    slice's entry points' launches counted from 0 (``_rank_paths``).
    Returns the rows, the largest errors and the launches."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    require_full_float32()
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    heads = VIT_SHAPE[2]
    worst = {**dict.fromkeys(FWD_KEYS.values(), 0.0),
             **dict.fromkeys(BWD_KEYS.values(), 0.0)}
    checks = {}
    f32 = flash_tolerance(torch.float32)
    for tag, shape in RANK_SHAPES:
        b, t, hl, d = shape
        for dtype in (torch.bfloat16, torch.float32):
            tol = flash_tolerance(dtype)
            fwd_route = flash._fwd_route(shape, dtype)
            bwd_route = flash._bwd_route(shape, dtype)
            for causal in (False, True):
                where = f"{tag} {shape} {dtype} causal={causal}"
                whole = flash_inputs((b, t, heads, d), dtype, gen, device)
                o_w, lse_w = flash.flash_fwd(*whole[:3], causal=causal)
                g_w = flash.flash_bwd(*whole[:3], o_w, lse_w, whole[3],
                                      causal=causal)
                same, diff = True, 0.0
                for r in (0, heads // hl - 1):
                    cut = slice(r * hl, (r + 1) * hl)
                    q, k, v, do = _rank_block(whole, cut)
                    o, lse = flash.flash_fwd(q, k, v, causal=causal)
                    want_o, want_lse = flash.flash_fwd_plain(q, k, v,
                                                             causal=causal)
                    got = flash.flash_bwd(q, k, v, want_o, want_lse, do,
                                          causal=causal)
                    want = flash.flash_bwd_plain(q, k, v, want_o, want_lse,
                                                 do, causal=causal)
                    mine = flash.flash_bwd(q, k, v, o, lse, do,
                                           causal=causal)
                    fk, bk = FWD_KEYS[fwd_route], BWD_KEYS[bwd_route]
                    worst[fk] = max(
                        worst[fk], _close("O", o, want_o, tol, where),
                        _close("lse", lse, want_lse, f32, where))
                    worst[bk] = max(worst[bk], *(
                        _close(name, x, w, tol, where) for name, x, w in
                        zip(("dQ", "dK", "dV"), got, want)))
                    pairs = [(o, o_w[:, :, cut]),
                             (lse, lse_w[:, cut]),
                             *zip(mine, (x[:, :, cut] for x in g_w))]
                    same = same and all(torch.equal(a, w) for a, w in pairs)
                    diff = max(diff, *(float((a.float() - w.float()).abs()
                                             .max()) for a, w in pairs))
                checks[where] = {"fwd_route": fwd_route,
                                 "bwd_route": bwd_route,
                                 "whole_head_slice_same_bits": same,
                                 "whole_head_slice_max_abs_diff": diff}
    torch.cuda.synchronize()

    rows = {}
    for tag, shape in RANK_SHAPES:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            elem = dtype.itemsize
            q, k, v, do = flash_inputs(shape, dtype, gen, device)
            o, lse = flash.flash_fwd(q, k, v)
            ops = (q, k, v, o, lse, do)
            heads_t = [x.transpose(1, 2) for x in (q, k, v)]
            fwd_kernel = FWD_KEYS[flash._fwd_route(shape, dtype)]
            bwd_route = flash._bwd_route(shape, dtype)
            pair = {"fused": ("flash_bwd",),
                    "tiled": ("flash_dq_tiled", "flash_dkv_tiled"),
                    "tf32x3": TF32_PAIR}[bwd_route]
            key = f"{tag}_{'bf16' if elem == 2 else 'f32'}"
            least, by, _, _ = flash_bound_ms(fwd_kernel, shape, elem, peaks)
            fwd_row = _timed_row({
                "kernel": lambda q=q, k=k, v=v: flash.flash_fwd(q, k, v),
                "plain": lambda q=q, k=k, v=v: flash.flash_fwd_plain(q, k,
                                                                     v),
                "library": lambda h=heads_t:
                    F.scaled_dot_product_attention(*h)},
                shape=list(shape), dtype=dtype_name, bound_ms=least,
                bound_by=by, route=fwd_kernel)
            bwd_row = _timed_row({
                "kernel": lambda ops=ops: flash.flash_bwd(*ops),
                "plain": lambda ops=ops: flash.flash_bwd_plain(*ops),
                "library": _sdpa_backward(q, k, v, do)},
                shape=list(shape), dtype=dtype_name,
                **dict(zip(("bound_ms", "bound_by"),
                           pair_bound_ms(pair, shape, elem, peaks))),
                route=bwd_route)
            for row in (fwd_row, bwd_row):
                row["library_backend"] = sdpa_backend(row["library_kernels"])
            rows[f"flash_fwd_{key}"] = fwd_row
            rows[f"flash_bwd_{key}"] = bwd_row
            emit("timing", kernel=f"flash_fwd_{key}", **fwd_row)
            emit("timing", kernel=f"flash_bwd_{key}", **bwd_row)
    launches = _rank_paths(device, RANK_SHAPES)
    same = {w: c["whole_head_slice_same_bits"] for w, c in checks.items()}
    emit("flash_rank_shapes", shapes={t: list(s) for t, s in RANK_SHAPES},
         tolerance={"float32": flash_tolerance(torch.float32),
                    "bfloat16": flash_tolerance(torch.bfloat16)},
         max_abs_err=worst, checks=checks,
         all_same_bits_as_whole_slice=all(same.values()),
         entry_launches=launches)
    return {"rows": rows, "max_abs_err": worst, "launches": launches,
            "checks": checks}


def _pipeline_paths(device, shapes) -> dict:
    """The pipeline's attention entry point on the card, counted from 0:
    the stage body hands each microbatch's block straight to the model's
    ``attention_fn`` (``flash_attention``; under PP x TP its local
    heads), forward and backward through autograd, bf16. Each call must
    launch one tensor-core forward and one backward of its route."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    fwd, bwd = flash.flash_fwd, flash.flash_bwd
    out = {}
    for tag, shape in shapes:
        q, k, v, do = flash_inputs(shape, torch.bfloat16, gen, device)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        # This path's run starts here ...
        fwd.launches = 0
        fwd.route_launches.update(dict.fromkeys(fwd.route_launches, 0))
        bwd.launches = 0
        bwd.route_launches.update(dict.fromkeys(bwd.route_launches, 0))
        flash.flash_attention(*leaves).backward(do)
        torch.cuda.synchronize()
        # ... and ends here.
        got = {"flash_fwd": dict(fwd.route_launches),
               "flash_bwd": dict(bwd.route_launches)}
        route = flash._bwd_route(shape, torch.bfloat16)
        want = {"flash_fwd": {r: int(r == "tensor")
                              for r in fwd.route_launches},
                "flash_bwd": {r: int(r == route)
                              for r in bwd.route_launches}}
        if got != want:
            raise AssertionError(f"{tag} {shape}: launches {got}, expected "
                                 f"{want}")
        out[tag] = got
    return out


def phase_pipeline_shapes(device, peaks) -> dict:
    """The flash kernels at pipeline parallelism's per-microbatch shapes
    (``PIPELINE_SHAPES``), bf16 and float32, as the ViT calls them (not
    causal): the forward and ``flash_bwd`` against their plain versions
    within ``flash_tolerance``, and against the rows (and, under TP, the
    heads) of the whole (B, 49, 4, 16) call, for the first and the last
    microbatch: attention is independent per example and per head, and
    whether each output matches bit for bit, and by how much if not, is
    printed. Then their device ms beside the plain versions, SDPA's
    forward and backward and the bound, and the entry point's launches
    counted from 0 (``_pipeline_paths``). Returns the rows, the largest
    errors and the launches."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    require_full_float32()
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    worst = {**dict.fromkeys(FWD_KEYS.values(), 0.0),
             **dict.fromkeys(BWD_KEYS.values(), 0.0)}
    checks = {}
    f32 = flash_tolerance(torch.float32)
    for tag, shape in PIPELINE_SHAPES:
        b, t, hl, d = shape
        heads = VIT_SHAPE[2]
        for dtype in (torch.bfloat16, torch.float32):
            tol = flash_tolerance(dtype)
            fwd_route = flash._fwd_route(shape, dtype)
            bwd_route = flash._bwd_route(shape, dtype)
            where = f"{tag} {shape} {dtype}"
            whole = flash_inputs((TRAIN_BATCH, t, heads, d), dtype, gen,
                                 device)
            o_w, lse_w = flash.flash_fwd(*whole[:3])
            g_w = flash.flash_bwd(*whole[:3], o_w, lse_w, whole[3])
            same, diff = True, 0.0
            for first in (0, TRAIN_BATCH - b):
                rows = slice(first, first + b)
                cut = slice(0, hl) if first == 0 else slice(heads - hl, heads)
                q, k, v, do = _rank_block([x[rows] for x in whole], cut)
                o, lse = flash.flash_fwd(q, k, v)
                want_o, want_lse = flash.flash_fwd_plain(q, k, v)
                got = flash.flash_bwd(q, k, v, want_o, want_lse, do)
                want = flash.flash_bwd_plain(q, k, v, want_o, want_lse, do)
                mine = flash.flash_bwd(q, k, v, o, lse, do)
                fk, bk = FWD_KEYS[fwd_route], BWD_KEYS[bwd_route]
                worst[fk] = max(worst[fk], _close("O", o, want_o, tol, where),
                                _close("lse", lse, want_lse, f32, where))
                worst[bk] = max(worst[bk], *(
                    _close(name, x, w, tol, where) for name, x, w in
                    zip(("dQ", "dK", "dV"), got, want)))
                pairs = [(o, o_w[rows][:, :, cut]),
                         (lse, lse_w[rows][:, cut]),
                         *zip(mine, (x[rows][:, :, cut] for x in g_w))]
                same = same and all(torch.equal(a, w) for a, w in pairs)
                diff = max(diff, *(float((a.float() - w.float()).abs()
                                         .max()) for a, w in pairs))
            checks[where] = {"fwd_route": fwd_route, "bwd_route": bwd_route,
                             "whole_rows_same_bits": same,
                             "whole_rows_max_abs_diff": diff}
    torch.cuda.synchronize()

    rows = {}
    for tag, shape in PIPELINE_SHAPES:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            elem = dtype.itemsize
            q, k, v, do = flash_inputs(shape, dtype, gen, device)
            o, lse = flash.flash_fwd(q, k, v)
            ops = (q, k, v, o, lse, do)
            heads_t = [x.transpose(1, 2) for x in (q, k, v)]
            fwd_kernel = FWD_KEYS[flash._fwd_route(shape, dtype)]
            bwd_route = flash._bwd_route(shape, dtype)
            pair = {"fused": ("flash_bwd",),
                    "tiled": ("flash_dq_tiled", "flash_dkv_tiled"),
                    "tf32x3": TF32_PAIR}[bwd_route]
            key = f"{tag}_{'bf16' if elem == 2 else 'f32'}"
            least, by, _, _ = flash_bound_ms(fwd_kernel, shape, elem, peaks)
            fwd_row = _timed_row({
                "kernel": lambda q=q, k=k, v=v: flash.flash_fwd(q, k, v),
                "plain": lambda q=q, k=k, v=v: flash.flash_fwd_plain(q, k,
                                                                     v),
                "library": lambda h=heads_t:
                    F.scaled_dot_product_attention(*h)},
                shape=list(shape), dtype=dtype_name, bound_ms=least,
                bound_by=by, route=fwd_kernel)
            bwd_row = _timed_row({
                "kernel": lambda ops=ops: flash.flash_bwd(*ops),
                "plain": lambda ops=ops: flash.flash_bwd_plain(*ops),
                "library": _sdpa_backward(q, k, v, do)},
                shape=list(shape), dtype=dtype_name,
                **dict(zip(("bound_ms", "bound_by"),
                           pair_bound_ms(pair, shape, elem, peaks))),
                route=bwd_route)
            for row in (fwd_row, bwd_row):
                row["library_backend"] = sdpa_backend(row["library_kernels"])
            rows[f"flash_fwd_{key}"] = fwd_row
            rows[f"flash_bwd_{key}"] = bwd_row
            emit("timing", kernel=f"flash_fwd_{key}", **fwd_row)
            emit("timing", kernel=f"flash_bwd_{key}", **bwd_row)
    launches = _pipeline_paths(device, PIPELINE_SHAPES)
    same = {w: c["whole_rows_same_bits"] for w, c in checks.items()}
    emit("pipeline_shapes",
         shapes={t: list(s) for t, s in PIPELINE_SHAPES},
         tolerance={"float32": flash_tolerance(torch.float32),
                    "bfloat16": flash_tolerance(torch.bfloat16)},
         max_abs_err=worst, checks=checks,
         all_same_bits_as_whole_rows=all(same.values()),
         entry_launches=launches)
    return {"rows": rows, "max_abs_err": worst, "launches": launches,
            "checks": checks}


def _train_lines(text: str, prefix: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def _rendezvous() -> list:
    """The flags of the explicit rendezvous of a world of one on a free
    loopback port: the process joins a process group of its own (NCCL on
    the card, gloo on the CPU)."""
    from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
        free_port,
    )

    return ["--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
            "1", "--process-id", "0"]


def _run_cli(argv: list, epoch_callback=None, dp: bool = False):
    """The port's CLI ``run()`` in-process; returns (summary, stdout).
    ``dp`` adds the rendezvous of a world of one (``_rendezvous``); the
    run destroys its process group on its way out, and a run without
    one must leave none behind."""
    import contextlib
    import io

    import torch.distributed as dist

    from pytorch_distributed_mnist_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = cli.run(cli.build_parser().parse_args(
            argv + (_rendezvous() if dp else [])),
            epoch_callback=epoch_callback)
    if dist.is_initialized():
        raise AssertionError("the CLI run left a process group behind")
    return summary, out.getvalue()


COLLECTIVES = ("count_all_reduce", "grad_all_reduce", "metric_all_reduce")


def _collective_counts() -> dict:
    """The collectives' call counters (``parallel/collectives.py``)."""
    from pytorch_distributed_mnist_tpu_torch.parallel import collectives

    return {name: getattr(collectives, name).launches
            for name in COLLECTIVES}


def _zero_collectives() -> None:
    from pytorch_distributed_mnist_tpu_torch.parallel import collectives

    for name in COLLECTIVES:
        getattr(collectives, name).launches = 0


def _want_collectives(dp: bool, explicit: bool = False,
                      epochs: int = TRAIN_EPOCHS) -> dict:
    """The collectives of ``epochs`` epochs of the smoke's cnn or ViT run:
    none without a process group; in a world, per train step one count
    all-reduce (the global masked mean's divisor; not in the explicit
    mode, whose rule is DDP's per-replica mean) and one gradient
    all-reduce, and one metric all-reduce per pass (per step and eval
    batch in the explicit mode)."""
    import math

    if not dp:
        return dict.fromkeys(COLLECTIVES, 0)
    args = TRAIN_ARGS
    steps = epochs * (int(args[args.index("--synthetic-train-size") + 1])
                      // TRAIN_BATCH)
    evals = epochs * math.ceil(
        int(args[args.index("--synthetic-test-size") + 1]) / TRAIN_BATCH)
    return {"count_all_reduce": 0 if explicit else steps,
            "grad_all_reduce": steps,
            "metric_all_reduce": steps + evals if explicit else 2 * epochs}


def _launch_counters(model: str) -> dict:
    """The wrappers whose kernels the ``model`` training run launches,
    looked up when called (a CPU rehearsal swaps in counting plain
    versions)."""
    from pytorch_distributed_mnist_tpu_torch.ops import adam, flash, xent

    counters = {"xent_fwd": xent.xent_fwd, "xent_bwd": xent.xent_bwd,
                "adam": adam.adam_leaves}
    if TRAIN_RUNS[model]["depth"]:
        counters.update(flash_fwd=flash.flash_fwd, flash_bwd=flash.flash_bwd,
                        flash_dq=flash.flash_dq, flash_dkv=flash.flash_dkv)
    return counters


def _flash_want(dtype: str, tokens: int, fwd: int, bwd: int) -> dict:
    """The flash wrappers' counts after ``fwd`` forward and ``bwd``
    backward calls of the ViT at ``tokens`` tokens in ``dtype``: bf16 takes
    the tensor-core forward and the fused backward up to 128 tokens (the
    tiled pair above), float32 the 3xTF32 forward and pair; no other route
    and no CUDA-core kernel launches."""
    fwd_route = "tf32x3" if dtype == "f32" else "tensor"
    bwd_route = ("tf32x3" if dtype == "f32"
                 else "fused" if tokens <= 128 else "tiled")
    return {"flash_fwd": fwd,
            "flash_fwd_routes": {r: fwd if r == fwd_route else 0
                                 for r in FWD_KEYS},
            "flash_bwd": bwd if bwd_route == "fused" else 0,
            "flash_bwd_routes": {r: bwd if r == bwd_route else 0
                                 for r in BWD_KEYS},
            "flash_dq": 0, "flash_dkv": 0}


def _zero_counters(model: str) -> None:
    for wrapper in _launch_counters(model).values():
        wrapper.launches = 0
        if hasattr(wrapper, "route_launches"):  # flash_fwd, flash_bwd
            wrapper.route_launches.update(
                dict.fromkeys(wrapper.route_launches, 0))


def _read_counters(model: str) -> dict:
    counters = _launch_counters(model)
    got = {name: wrapper.launches for name, wrapper in counters.items()}
    for name in ("flash_fwd", "flash_bwd"):
        if name in counters:
            got[f"{name}_routes"] = dict(counters[name].route_launches)
    return got


def _counter_delta(after: dict, before: dict) -> dict:
    return {k: ({r: n - before[k][r] for r, n in v.items()}
                if isinstance(v, dict) else v - before[k])
            for k, v in after.items()}


def _want_launches(model: str, epochs: int = TRAIN_EPOCHS) -> dict:
    """The launch counts of ``epochs`` epochs of the ``model`` run: per
    train step one cross-entropy forward and backward per micro-batch
    (``accum`` of them) and one Adam launch (per MAX_LEAVES leaves), per
    eval batch one forward, and for the ViT a forward and a backward per
    attention layer and micro-batch on ``_flash_want``'s routes, with
    one more forward under ``remat`` (the block's recompute)."""
    import math

    from pytorch_distributed_mnist_tpu_torch.ops.adam import MAX_LEAVES

    run_cfg = TRAIN_RUNS[model]
    args = run_cfg["args"]
    train_size = int(args[args.index("--synthetic-train-size") + 1])
    test_size = int(args[args.index("--synthetic-test-size") + 1])
    steps = epochs * (train_size // TRAIN_BATCH)
    evals = epochs * math.ceil(test_size / TRAIN_BATCH)
    micro = run_cfg.get("accum", 1) * steps
    want = {"xent_fwd": micro + evals, "xent_bwd": micro,
            "adam": steps * -(-run_cfg["params"] // MAX_LEAVES)}
    depth = run_cfg["depth"]
    if depth:  # the ViT at its default 49 tokens
        forwards = micro * (2 if run_cfg.get("remat") else 1) + evals
        want.update(_flash_want(run_cfg["dtype"], VIT_SHAPE[1],
                                depth * forwards, depth * micro))
    return want


# The counter each of the port's kernels, by its name in a trace, must
# match: (counter, route) with route None for the wrapper's own count. A
# tiled or 3xTF32 backward launches a dQ and a dK/dV kernel per call.
TRACE_OF = {"xent_fwd_kernel": ("xent_fwd", None),
            "xent_bwd_kernel": ("xent_bwd", None),
            "adam_leaves_kernel": ("adam", None),
            "flash_fwd_mma_kernel": ("flash_fwd_routes", "tensor"),
            "flash_fwd_tf32_kernel": ("flash_fwd_routes", "tf32x3"),
            "flash_fwd_kernel": ("flash_fwd_routes", "cuda_core"),
            "flash_bwd_kernel": ("flash_bwd_routes", "fused"),
            "flash_dq_tiled_kernel": ("flash_bwd_routes", "tiled"),
            "flash_dkv_tiled_kernel": ("flash_bwd_routes", "tiled"),
            "flash_dq_tf32_kernel": ("flash_bwd_routes", "tf32x3"),
            "flash_dkv_tf32_kernel": ("flash_bwd_routes", "tf32x3"),
            "flash_dq_kernel": ("flash_dq", None),
            "flash_dkv_kernel": ("flash_dkv", None)}


def _trace_want(delta: dict) -> dict:
    """The port's kernels a trace must show for these counter deltas."""
    want = {}
    for kernel, (counter, route) in TRACE_OF.items():
        if counter in delta:
            n = delta[counter] if route is None else delta[counter][route]
            if n:
                want[kernel] = n
    return want


def _trace_launches(prof) -> tuple:
    """The port's kernels in a profiler trace, counted by name (the first
    name of ``OWN_KERNELS`` that a device event's name holds), and the
    collectives' kernels (NCCL's), by name."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        step_part,
    )

    got, nccl = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if step_part(evt.name) == "collective":
            nccl[evt.name[:80]] = nccl.get(evt.name[:80], 0) + 1
            continue
        for own, _ in OWN_KERNELS:
            if own in evt.name:
                got[own] = got.get(own, 0) + 1
                break
    return got, nccl


def _traced_run(base: list, model: str, ckpt: str, dp: bool = False):
    """The CLI's run of ``base`` (in a world of one with ``dp``) with a
    profiler trace of its epoch 1, in which every tick replays a captured
    graph; returns (summary, stdout, counter deltas over epoch 1, the
    trace's kernel counts, its NCCL kernels by name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box = {}

    def trace_epoch_1(epoch, row):
        if epoch == 0:
            box["before"] = _read_counters(model)
            box["prof"] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            box["prof"].start()
            lead_in()
        return False

    try:
        summary, out = _run_cli(base + ["--epochs", str(TRAIN_EPOCHS),
                                        "--checkpoint-dir", ckpt],
                                epoch_callback=trace_epoch_1, dp=dp)
        torch.cuda.synchronize()
    finally:
        if "prof" in box:
            box["prof"].stop()
    delta = _counter_delta(_read_counters(model), box["before"])
    return (summary, out, delta) + _trace_launches(box["prof"])


def phase_train(device_flag: str = "cuda", model: str = "cnn",
                dp: bool = False, want_lines=None,
                keep_best: bool = False) -> dict:
    """Train ``model`` (``TRAIN_RUNS``) through the CLI in its default
    ``--trainer-mode scan``, resume and evaluate; returns its kernels'
    launch counts over the training run and its epoch lines. The counts
    are checked twice: from the wrappers' counters over the run, and on
    the card from a profiler trace of epoch 1 (every tick a replay of the
    captured graphs), against the counters' deltas over that epoch.
    Without ``dp`` the run makes no collective call. With ``dp`` every run
    (train, resume, ``-e``) goes through the explicit rendezvous of a
    world of one (``train_dp_world1``, ``train_dp_vit_world1``): the
    gradient all-reduce inside the captured step, the metric all-reduce
    once per pass, both counted exactly, and its epoch lines must equal
    ``want_lines`` (the run without a group) character for character.
    ``keep_best`` keeps a copy of the run's last checkpoint (its path
    under ``best``, alone in its directory; the caller removes it)."""
    import shutil

    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        read_checkpoint_arrays,
    )

    run_cfg = TRAIN_RUNS[model]
    args = run_cfg["args"]
    phase = run_cfg.get("phase",
                        "train" if model == "cnn" else f"train_{model}")
    if dp:
        phase = "train_dp_world1" if model == "cnn" else \
            f"train_dp_{model}_world1"
    if run_cfg["dtype"] == "f32":
        require_full_float32()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ckpt = os.path.join(root, "run")
    base = args + ["--device", device_flag]
    traced, nccl = None, None
    try:
        # The main path's run starts here.
        _zero_counters(model)
        _zero_collectives()
        t0 = time.perf_counter()
        if device_flag == "cpu":  # a rehearsal: no trace of the card
            summary, out = _run_cli(base + ["--epochs", str(TRAIN_EPOCHS),
                                            "--checkpoint-dir", ckpt],
                                    dp=dp)
        else:
            summary, out, delta, traced, nccl = _traced_run(base, model,
                                                            ckpt, dp)
        wall_s = time.perf_counter() - t0
        launches = _read_counters(model)
        collectives = _collective_counts()
        # ... and ends here.
        lines = _train_lines(out, "Epoch: ")
        if collectives != _want_collectives(dp):
            raise AssertionError(f"collectives {collectives}, expected "
                                 f"{_want_collectives(dp)}")
        if want_lines is not None and lines != want_lines:
            raise AssertionError(f"{phase} printed\n{lines}\nwhere the run "
                                 f"it must repeat printed\n{want_lines}")
        hist = summary["history"]
        if len(lines) != TRAIN_EPOCHS or len(hist) != TRAIN_EPOCHS:
            raise AssertionError(f"expected {TRAIN_EPOCHS} epoch lines:\n{out}")
        if not hist[1]["train_loss"] < hist[0]["train_loss"]:
            raise AssertionError(f"train loss did not fall: {lines}")
        if hist[1]["test_acc"] < run_cfg["floor"]:
            raise AssertionError(f"test accuracy {hist[1]['test_acc']:.4f} "
                                 f"< {run_cfg['floor']:.2f} after epoch 1")
        want = _want_launches(model)
        if launches != want:
            raise AssertionError(f"launch counts {launches}, expected {want}")
        if traced is not None:
            # Now and then a trace loses device events (``device_ms``):
            # a short trace is taken again from a fresh run, up to three
            # times in all.
            for attempt in range(3):
                trace_want = _trace_want(delta)
                if delta != _want_launches(model, epochs=1):
                    raise AssertionError(f"epoch 1's counters {delta}")
                if traced == trace_want or attempt == 2:
                    break
                RETAKEN["traces"] += 1
                print(f"chip_smoke.py: epoch 1's trace counted {traced}, "
                      f"the counters {trace_want}; taking it again",
                      file=sys.stderr, flush=True)
                _, _, delta, traced, nccl = _traced_run(
                    base, model, os.path.join(root, f"retrace{attempt}"),
                    dp)
            if traced != trace_want:
                raise AssertionError(f"epoch 1's trace counted {traced}, "
                                     f"the counters {trace_want}")
        files = sorted(os.listdir(ckpt))
        if files != ["checkpoint_0.npz", "checkpoint_1.npz",
                     "model_best.npz"]:
            raise AssertionError(f"checkpoint files: {files}")
        for name in files:
            meta, leaves = read_checkpoint_arrays(os.path.join(ckpt, name))
            if len(leaves) != run_cfg["leaves"]:
                raise AssertionError(f"{name} holds {len(leaves)} leaves")
            if meta["world"] != {"processes": 1, "devices": 1}:
                raise AssertionError(f"{name} stamped {meta['world']}")

        _, resumed_out = _run_cli(base + [
            "--epochs", str(TRAIN_EPOCHS), "--checkpoint-dir",
            os.path.join(root, "resumed"), "--resume",
            os.path.join(ckpt, "checkpoint_0.npz")], dp=dp)
        resumed = _train_lines(resumed_out, "Epoch: ")
        if resumed != lines[1:]:
            raise AssertionError(f"resume did not repeat epoch 1:\n"
                                 f"{lines[1:]}\n{resumed}")
        _, eval_out = _run_cli(base + [
            "-e", "--checkpoint-dir", os.path.join(root, "eval"),
            "--resume", os.path.join(ckpt, "model_best.npz")], dp=dp)
        test_lines = _train_lines(eval_out, "Test Loss: ")
        if len(test_lines) != 1 or _train_lines(eval_out, "Epoch: "):
            raise AssertionError(f"-e printed:\n{eval_out}")
        row = {}
        if dp:
            row = {"epoch_lines_equal_without_group": True,
                   "rendezvous": "tcp 127.0.0.1, 1 process, "
                                 + ("nccl" if device_flag == "cuda"
                                    else "gloo"),
                   "epoch_1_nccl_kernels": nccl,
                   "nccl_note": None if nccl or nccl is None else
                   "NCCL launched no kernel for the all-reduces of a "
                   "world of one in epoch 1's trace"}
        emit(phase, run=model, trainer_mode="scan", epoch_lines=lines,
             resumed_epoch_lines=resumed, eval_line=test_lines[0],
             launches=launches, expected_launches=want,
             collectives=collectives, checkpoint_world="1x1",
             epoch_1_trace_launches=traced, **row,
             images_per_sec=[r["images_per_sec"] for r in hist],
             images_per_sec_note="epoch 0 holds the warm-up and capture; "
                                 "epoch 1 ran under the profiler",
             staging=summary["staging"],
             test_acc=[r["test_acc"] for r in hist],
             test_acc_floor=run_cfg["floor"], wall_s=wall_s,
             resume_repeats_epoch_1=True)
        kept = {}
        if keep_best:
            kept_dir = tempfile.mkdtemp(prefix="chip_smoke_best_")
            kept["best"] = shutil.copy(
                os.path.join(ckpt, f"checkpoint_{TRAIN_EPOCHS - 1}.npz"),
                kept_dir)
        return {"launches": launches, "lines": lines,
                "collectives": collectives, "staging": summary["staging"],
                **kept}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train_twin(phase: str, model: str, flags: list, want_lines: list,
                     device_flag: str = "cuda", dp: bool = False) -> dict:
    """The ``model`` run of ``phase_train`` again with ``flags`` (another
    trainer mode or epoch gather; in a world of one with ``dp``): its
    epoch lines must equal ``want_lines`` character for character, and its
    launch counts and collectives the run's (per step and eval batch in
    the explicit mode)."""
    import shutil

    root = tempfile.mkdtemp(prefix="chip_smoke_twin_")
    try:
        _zero_counters(model)
        _zero_collectives()
        t0 = time.perf_counter()
        summary, out = _run_cli(TRAIN_RUNS[model]["args"] + flags + [
            "--device", device_flag, "--epochs", str(TRAIN_EPOCHS),
            "--checkpoint-dir", root], dp=dp)
        wall_s = time.perf_counter() - t0
        launches = _read_counters(model)
        collectives = _collective_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lines = _train_lines(out, "Epoch: ")
    if lines != want_lines:
        raise AssertionError(f"{phase}: {flags} printed\n{lines}\nwhere the "
                             f"scan run printed\n{want_lines}")
    if launches != _want_launches(model):
        raise AssertionError(f"{phase}: launch counts {launches}, expected "
                             f"{_want_launches(model)}")
    want_coll = _want_collectives(dp, explicit="explicit" in flags)
    if collectives != want_coll:
        raise AssertionError(f"{phase}: collectives {collectives}, "
                             f"expected {want_coll}")
    row = {"model": model, "flags": flags, "world_of_one": dp,
           "epoch_lines": lines, "equal_to_scan": True,
           "launches": launches, "collectives": collectives,
           "wall_s": wall_s,
           "images_per_sec": [r["images_per_sec"]
                              for r in summary["history"]],
           "staging": summary["staging"]}
    emit(phase, **row)
    return row


def _lines_close(lines: list, want_lines: list, loss_tol: float,
                 acc_tol: float) -> bool:
    """Epoch lines that agree with ``want_lines`` within ``loss_tol`` on
    the losses and ``acc_tol`` percentage points on the accuracies."""
    got, want = _epoch_numbers(lines), _epoch_numbers(want_lines)
    if len(got) != len(want):
        return False
    for x, y in zip(got, want):
        if x[:3] != y[:3] or abs(x[3] - y[3]) > loss_tol \
                or abs(x[5] - y[5]) > loss_tol \
                or abs(x[4] - y[4]) > acc_tol or abs(x[6] - y[6]) > acc_tol:
            return False
    return True


# The MoE run's variants, each against the same flags on the plain
# versions (``--loss xla --optimizer adam``): float32 on both sides, the
# cross-entropy summed and Adam rounded in other orders.
MOE_VARIANTS = [("train_moe_capacity", ["--moe-dispatch", "capacity"]),
                ("train_moe_aux", ["--moe-aux-weight", "0.01"])]
PLAIN_FLAGS = ["--loss", "xla", "--optimizer", "adam"]


def phase_train_moe_variants(dense_lines: list,
                             device_flag: str = "cuda") -> dict:
    """``train_moe``'s flags on the plain versions (``train_moe_plain``),
    its epoch lines held to ``dense_lines`` (``train_moe``'s); then
    ``MOE_VARIANTS``: the MoE run with capacity dispatch, and with the
    load-balance loss in the objective, through the kernels (exact launch
    counts, as the dense run's) and again on the plain versions. Each
    pair's epoch lines must agree (losses within 1e-4, accuracies within
    0.1 percentage points). Returns each variant's launches."""
    import shutil

    root = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        t0 = time.perf_counter()
        _, plain_text = _run_cli(MOE_TRAIN_ARGS + PLAIN_FLAGS + [
            "--device", device_flag, "--epochs", str(TRAIN_EPOCHS),
            "--checkpoint-dir", os.path.join(root, "p")])
        wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    plain = _train_lines(plain_text, "Epoch: ")
    if not _lines_close(dense_lines, plain, 1e-4, 0.1):
        raise AssertionError(f"train_moe printed\n{dense_lines}\nthe plain "
                             f"versions' run\n{plain}")
    emit("train_moe_plain", epoch_lines=dense_lines, plain_lines=plain,
         plain_flags=PLAIN_FLAGS, plain_wall_s=wall_s)
    out = {}
    for phase, flags in MOE_VARIANTS:
        root = tempfile.mkdtemp(prefix="chip_smoke_moe_")
        try:
            _zero_counters("moe")
            t0 = time.perf_counter()
            summary, text = _run_cli(
                MOE_TRAIN_ARGS + flags + ["--device", device_flag,
                                          "--epochs", str(TRAIN_EPOCHS),
                                          "--checkpoint-dir",
                                          os.path.join(root, "k")])
            wall_s = time.perf_counter() - t0
            launches = _read_counters("moe")
            _, plain_text = _run_cli(
                MOE_TRAIN_ARGS + flags + PLAIN_FLAGS + [
                    "--device", device_flag, "--epochs", str(TRAIN_EPOCHS),
                    "--checkpoint-dir", os.path.join(root, "p")])
        finally:
            shutil.rmtree(root, ignore_errors=True)
        lines = _train_lines(text, "Epoch: ")
        plain = _train_lines(plain_text, "Epoch: ")
        if launches != _want_launches("moe"):
            raise AssertionError(f"{phase}: launch counts {launches}, "
                                 f"expected {_want_launches('moe')}")
        if len(lines) != TRAIN_EPOCHS or not _lines_close(lines, plain,
                                                          1e-4, 0.1):
            raise AssertionError(f"{phase}: the kernels' run printed\n"
                                 f"{lines}\nthe plain versions'\n{plain}")
        hist = summary["history"]
        if hist[1]["test_acc"] < TRAIN_RUNS["moe"]["floor"]:
            raise AssertionError(f"{phase}: test accuracy "
                                 f"{hist[1]['test_acc']:.4f}")
        emit(phase, flags=flags, epoch_lines=lines, plain_lines=plain,
             plain_flags=PLAIN_FLAGS, launches=launches, wall_s=wall_s,
             images_per_sec=[r["images_per_sec"] for r in hist])
        out[phase] = launches
    return out


def phase_server_moe(ckpt: str, device_flag: str = "cuda") -> dict:
    """``serve --model moe_mlp --serve-precision int8`` (the fused plane,
    the default buckets) on ``train_moe``'s last checkpoint: a burst of
    requests, each reply's predictions equal to the same plane's engine
    replayed on the batch the server formed (the int8 plane quantizes
    activations per batch) and the logits finite and close to the f32
    engine's. ``MoEClassifier`` takes no int8 product (as in JAX, the
    int8 plane dequantizes its weights): no ``matmul_i8`` launch."""
    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import matmul_i8
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
        load_params_for_serving,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.server import (
        build_parser,
        create_server,
    )

    args = build_parser().parse_args([
        "--model", "moe_mlp", "--serve-precision", "int8", "--port", "0",
        "--device", device_flag, "--checkpoint-dir", os.path.dirname(ckpt),
        "--require-checkpoint"])
    matmul_i8.launches = 0
    t0 = time.perf_counter()
    httpd = create_server(args)
    boot_s = time.perf_counter() - t0
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    try:
        client = _Client(httpd.server_address[1])
        engine = httpd.ctx.engine
        batches = []
        served = engine.predict_with_epoch

        def recording(images):
            labels, epoch = served(images)
            batches.append((np.array(images), labels.copy()))
            return labels, epoch

        engine.predict_with_epoch = recording
        burst = _requests(32, seed=SEED + 20)
        t1 = time.perf_counter()
        replies = [client.post("/predict", {"images": x.tolist()})
                   for x in burst]
        wall_s = time.perf_counter() - t1
        stats = client.get("/stats")
        engine.predict_with_epoch = served
    finally:
        httpd.shutdown()
        httpd.server_close()
    for reply, x in zip(replies, burst):
        if len(reply["predictions"]) != len(x):
            raise AssertionError(f"bad /predict reply: {reply}")
    params, epoch = load_params_for_serving(ckpt, "moe_mlp")
    ref = InferenceEngine(get_model("moe_mlp"), params, precision="int8",
                          fuse=True, params_epoch=epoch,
                          device=engine.device)
    f32 = InferenceEngine(get_model("moe_mlp"), params, precision="f32",
                          fuse=True, params_epoch=epoch,
                          device=engine.device)
    for images, labels in batches:
        if not np.array_equal(ref.predict(images), labels):
            raise AssertionError("a served batch disagrees with the int8 "
                                 "engine's replay")
    logits = ref.logits(burst[0])
    want = f32.logits(burst[0])
    if logits.shape != (len(burst[0]), 10) or not np.all(
            np.isfinite(logits)):
        raise AssertionError(f"bad logits {logits.shape}")
    agree = float(np.mean(np.concatenate(
        [ref.predict(x) == f32.predict(x) for x in burst])))
    if agree < 0.97:
        raise AssertionError(f"int8 agrees with f32 on {agree:.3f}")
    if matmul_i8.launches:
        raise AssertionError(f"the MoE's int8 plane launched matmul_i8 "
                             f"{matmul_i8.launches} times")
    row = {"model": "moe_mlp", "precision": "int8", "plane": "fused",
           "checkpoint": os.path.basename(ckpt), "boot_s": boot_s,
           "requests": len(burst), "batches": len(batches),
           "wall_s": wall_s, "int8_agrees_with_f32": agree,
           "max_abs_logit_diff_vs_f32": float(np.max(np.abs(logits - want))),
           "matmul_i8_launches": matmul_i8.launches,
           "latency_ms": stats.get("latency_ms")}
    emit("server_moe", **row)
    return row


# -- sharded and pipeline serving: mesh groups and chains on the card ---------

SHARD_MESH = 2  # devices per tensor/expert group, stages per chain
# The int8 products of one forward: a tensor group of m devices runs the
# embed and the head once (on its lead) and each block's four Dense
# layers once per shard; a chain runs the unsplit ViT's ten.
TENSOR_I8_PER_FORWARD = 2 + 4 * SHARD_MESH * VIT_DEPTH
PIPELINE_I8_PER_FORWARD = VIT_I8_PER_FORWARD
SHARD_REQUESTS = 64  # requests of 1-40 images per traffic run
WINDOW_BATCHES = 48  # bucket-128 batches per window drive
WINDOW_TURNS = (1, 3, 3, 1)  # in-flight windows, in turns


def shard_shapes(bucket: int, mesh: int = SHARD_MESH) -> dict:
    """``{layer: (M, K, N)}`` of the int8 products each shard of a tensor
    group runs at ``bucket``: the column products (qkv, mlp1) split N,
    the row products (proj, mlp2) split K."""
    m = VIT_TOKENS * bucket
    return {"qkv": (m, 64, 192 // mesh), "proj": (m, 64 // mesh, 64),
            "mlp1": (m, 64, 256 // mesh), "mlp2": (m, 256 // mesh, 64)}


def _window_drive(engine, raw, window: int, batches: int) -> float:
    """Images/s of ``batches`` dispatches of ``raw`` through ``engine``
    with up to ``window`` batches in flight (dispatch the next before
    completing the oldest)."""
    import collections

    inflight = collections.deque()
    t0 = time.perf_counter()
    for _ in range(batches):
        inflight.append(engine.dispatch_logits(raw))
        if len(inflight) >= window:
            inflight.popleft().complete()
    while inflight:
        inflight.popleft().complete()
    return batches * len(raw) / (time.perf_counter() - t0)


def _shard_timings(device, peaks) -> list:
    """K3 alone at each per-shard shape of a 2-way tensor group at bucket
    128, held against its plain version and timed beside its bound and
    ``torch._int_mm`` (B row- and column-major)."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        _sm_count,
        matmul_i8,
        matmul_i8_plain,
        split_k,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    rows = []
    for layer, (m, k, n) in shard_shapes(PATH_BUCKETS[-1]).items():
        a, b = random_i8((m, k), gen, device), random_i8((k, n), gen, device)
        got, want = matmul_i8(a, b), matmul_i8_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"matmul_i8 disagrees with its plain "
                                 f"version at the shard shape {m}x{k}x{n}: "
                                 f"max |err| {err}")
        calls = {"kernel": lambda: matmul_i8(a, b),
                 "plain": lambda: matmul_i8_plain(a, b)}
        if int_mm_takes(m, k, n):
            calls["library"] = lambda: torch._int_mm(a, b)
            b_cm = b.t().contiguous().t()
            calls["library_colmajor"] = lambda: torch._int_mm(a, b_cm)
        least, by = bound_ms(m, k, n, peaks)
        splits, cluster = split_k(m, n, k, _sm_count(device.index))
        row = {"layer": f"tensor{SHARD_MESH}.{layer}", "m": m, "k": k,
               "n": n, "bound_ms": least, "bound_by": by,
               "library_ms": None, "splits": splits, "cluster": cluster,
               "max_abs_err": err}
        for what, fn in calls.items():
            per = device_ms(fn)
            row[f"{what}_ms"] = sum(per.values())
            if what == "kernel":
                row["gemm_ms"] = sum(v for name, v in per.items()
                                     if "matmul_i8_kernel" in name)
        rows.append(row)
        emit("timing", kernel="matmul_i8", **row)
    return rows


def phase_server_sharded(device_flag: str = "cuda") -> dict:
    """Sharded and pipeline serving (``serve/sharded.py``,
    ``serve/pipeline.py``) through the pool's API on ``[cuda:0, cuda:0]``:
    the int8 ViT (registered widths, fused plane, buckets 1/8/32/128) as
    one ``tensor`` group of 2 shards and as one ``pipeline`` chain of 2
    stages (each stage on its own stream), each under live traffic from
    4 clients: no request dropped, every served batch's labels equal to
    the same pool's with ``matmul_i8_plain``, a replay of the served
    batches bit for bit the plain pool's logits, and exactly
    ``TENSOR_I8_PER_FORWARD`` (``2 + 4 * m * depth``) or
    ``PIPELINE_I8_PER_FORWARD`` (10) K3 launches per forward (the counts
    set to 0 just before each traffic run and read just after). Then K3
    at each per-shard shape, timed; the chain's images/s at in-flight
    window 3 against 1 in turns (printed, not gated) and its per-stage
    step walls; ``moe_mlp`` as one ``expert`` group of 2 against its
    replicated engine (f32 and int8: no K3 launch); and one CLI boot at
    ``--serve-mode tensor --serve-mesh 1`` answering requests."""
    import functools
    import shutil

    import numpy as np
    import torch

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        int8_linear,
        matmul_i8,
        matmul_i8_plain,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
        split_vit_params,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.pool import EnginePool
    from pytorch_distributed_mnist_tpu_torch.serve.server import (
        build_parser,
        create_server,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import ServeLog

    t_phase = time.perf_counter()
    device = torch.device(device_flag, 0) if device_flag == "cuda" \
        else torch.device("cpu")
    devices = [device] * SHARD_MESH
    params0 = init_params("vit", SEED)
    split0 = split_vit_params(params0)
    count_lock = threading.Lock()
    plain_linear = functools.partial(int8_linear, matmul=matmul_i8_plain)
    out = {"launches": {}, "per_forward": {}, "forwards": {}}
    rows = {}
    for mode, params, want_per in (
            ("tensor", params0, TENSOR_I8_PER_FORWARD),
            ("pipeline", split0, PIPELINE_I8_PER_FORWARD)):
        calls = [0]

        def counted(x, w, out_dtype=None, _calls=calls, **kw):
            with count_lock:
                _calls[0] += 1
            return int8_linear(x, w, out_dtype, **kw)

        common = dict(devices=devices, buckets=PATH_BUCKETS,
                      precision="int8", fuse=True, serve_mode=mode,
                      mesh_size=SHARD_MESH, model_name="vit")
        pool = EnginePool(functools.partial(get_model, "vit",
                                            matmul=counted), params,
                          serve_log=ServeLog(), **common)
        plain = EnginePool(functools.partial(get_model, "vit",
                                             matmul=plain_linear), params,
                           **common)
        t0 = time.perf_counter()
        pool.warmup()
        plain.warmup()
        warm_s = time.perf_counter() - t0
        # The main path's run starts here (both pools warm).
        matmul_i8.launches = 0
        calls[0] = 0
        served = []
        run = _pool_traffic(pool, _requests(SHARD_REQUESTS, SEED + 61),
                            record=served)
        launches = matmul_i8.launches  # ... and ends here.
        products = calls[0]
        forwards = len(served)
        if device_flag == "cuda" and (launches == 0
                                      or launches != products):
            raise AssertionError(f"{mode}: K3 launches {launches} against "
                                 f"the model's int8 products {products}")
        if products != want_per * forwards:
            raise AssertionError(
                f"{mode}: {products} int8 products over {forwards} "
                f"forwards, expected {want_per} each")
        _same_as_plain(plain, served, f"server_sharded {mode}")
        for images, _ in served[:8]:
            got = pool.complete(pool.dispatch(images))[0]
            want = plain.complete(plain.dispatch(images))[0]
            if got.tobytes() != want.tobytes():
                raise AssertionError(
                    f"{mode}: a replayed batch of {len(images)} differs "
                    f"from the plain pool's logits by "
                    f"{float(np.abs(got - want).max())}")
            if got.shape != (len(images), 10) or not np.all(
                    np.isfinite(got)):
                raise AssertionError(f"{mode}: bad logits {got.shape}")
        topo = pool.topology()
        out["launches"][mode] = launches
        out["per_forward"][mode] = want_per
        out["forwards"][mode] = forwards
        rows[mode] = {"warm_s": warm_s, "batches": forwards,
                      "requests": SHARD_REQUESTS, "dropped": 0,
                      "launches": launches, "int8_products": products,
                      "per_forward": want_per, "rps": run["rps"],
                      "p50_ms": run["p50_ms"], "p99_ms": run["p99_ms"],
                      "replies_exact": True, "replay_bitwise": True,
                      "topology": {k: topo.get(k) for k in (
                          "serve_mode", "groups", "mesh_devices",
                          "pipeline_stages")}}
        if mode == "pipeline":
            chain = pool.replicas[0].engine
            raw = np.resize(_requests(1, seed=SEED + 62)[0],
                            (PATH_BUCKETS[-1], 28, 28))
            _window_drive(chain, raw, 1, 4)
            turns = [{"window": w,
                      "images_per_s": _window_drive(chain, raw, w,
                                                    WINDOW_BATCHES)}
                     for w in WINDOW_TURNS]
            by_w = {}
            for turn in turns:
                by_w.setdefault(turn["window"], []).append(
                    turn["images_per_s"])
            rows[mode]["window_turns"] = turns
            rows[mode]["window_speedup"] = (
                float(np.mean(by_w[max(by_w)])) / float(np.mean(by_w[1])))
            rows[mode]["stage_step_ms"] = chain.stage_step_ms(
                PATH_BUCKETS[-1])
            rows[mode]["streams"] = [
                None if s.stream is None else int(s.stream.cuda_stream)
                for s in chain._stages]
    # K3 alone at each per-shard shape.
    shard_rows = []
    if device_flag == "cuda":
        _, peaks = peaks_for(torch.cuda.get_device_name(0))
        shard_rows = _shard_timings(device, peaks)
    # moe_mlp: one expert group of 2 against its replicated engine.
    moe_params = init_params("moe_mlp", SEED)
    moe_rows = {}
    burst = _requests(8, seed=SEED + 63)
    for precision in ("f32", "int8"):
        matmul_i8.launches = 0
        pool = EnginePool(functools.partial(get_model, "moe_mlp"),
                          moe_params, devices=devices, buckets=PATH_BUCKETS,
                          precision=precision, fuse=True,
                          serve_mode="expert", mesh_size=SHARD_MESH,
                          model_name="moe_mlp")
        pool.warmup()
        ref = InferenceEngine(get_model("moe_mlp"), moe_params,
                              precision=precision, fuse=True, device=device)
        gap, agree = 0.0, []
        for x in burst:
            got = pool.complete(pool.dispatch(pool.preprocess(x)))[0]
            want = ref.logits(x)
            gap = max(gap, float(np.abs(got - want).max()))
            agree.append(np.mean(got.argmax(-1) == want.argmax(-1)))
        if gap > 1e-4 or min(agree) < 1.0:
            raise AssertionError(f"expert {precision}: the group's logits "
                                 f"differ from the replicated engine's by "
                                 f"{gap} (argmax agreement {min(agree)})")
        if matmul_i8.launches:
            raise AssertionError(f"moe_mlp launched matmul_i8 "
                                 f"{matmul_i8.launches} times")
        moe_rows[precision] = {"max_abs_logit_gap": gap,
                               "requests": len(burst)}
    # One CLI boot: --serve-mode tensor --serve-mesh 1.
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_sharded_cli_")
    matmul_i8.launches = 0
    try:
        httpd = create_server(build_parser().parse_args([
            "--model", "vit", "--serve-precision", "int8", "--port", "0",
            "--device", device_flag, "--checkpoint-dir", ckpt,
            "--serve-mode", "tensor", "--serve-mesh", "1", "--no-reload"]))
        serving = threading.Thread(target=httpd.serve_forever, daemon=True)
        serving.start()
        try:
            client = _Client(httpd.server_address[1])
            replies = [client.post("/predict", {"images": x.tolist()})
                       for x in burst]
            stats = client.get("/stats")
        finally:
            httpd.shutdown()
            httpd.ctx.close()
            httpd.server_close()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if any(len(r["predictions"]) != len(x) for r, x in zip(replies, burst)) \
            or stats["serve_mode"] != "tensor" \
            or stats["mesh_devices"] != 1:
        raise AssertionError(f"the --serve-mode tensor boot: "
                             f"{stats.get('serve_mode')} "
                             f"{stats.get('mesh_devices')}")
    cli_launches = matmul_i8.launches
    if device_flag == "cuda" and cli_launches == 0:
        raise AssertionError("the --serve-mode tensor server launched no K3")
    label = smi_name_and_limit() if device_flag == "cuda" else "cpu"
    emit("server_sharded", device=label, devices=[str(d) for d in devices],
         runs=rows, shard_shapes=shard_rows, expert=moe_rows,
         cli={"requests": len(burst), "launches": cli_launches,
              "serve_mode": stats["serve_mode"],
              "mesh_devices": stats["mesh_devices"]},
         seconds=time.perf_counter() - t_phase)
    out.update(rows=rows, shard_shapes=shard_rows, cli_launches=cli_launches)
    return out


# ZeRO on the cnn run in an NCCL world of one (its explicit rendezvous):
# (phase, flags, whether its lines equal the unsharded run's bit for
# bit). The first run is the unsharded one, for the peak device memory
# the others are read beside. The overlapped plane refuses --loss fused,
# as the JAX CLI does, so it runs the plain cross-entropy and is held to
# the lines within 1e-4 / 0.1 points.
ZERO_RUNS = [("train_zero_none", ["--optimizer-sharding", "none"], True),
             ("train_zero1", ["--optimizer-sharding", "zero1"], True),
             ("train_zero3", ["--optimizer-sharding", "zero3"], True),
             ("train_zero1_overlap", ["--optimizer-sharding", "zero1",
                                      "--zero-overlap", "--loss", "xla"],
              False)]


def phase_train_zero(want_lines: list, device_flag: str = "cuda") -> dict:
    """``ZERO_RUNS``, each the cnn run of ``train`` in a world of one: one
    rank's ZeRO equals no sharding, so the epoch lines must equal
    ``want_lines`` (the run without a group); the fused Adam kernel runs
    once a step on the rank's contiguous shards (every cnn leaf splits
    over an axis of one), the counts exact, the collectives a count
    all-reduce a step and a metric all-reduce a pass (the gradient
    all-reduce is the plane's reduce-scatter). Returns each run's
    launches and each run's epoch lines."""
    import gc
    import shutil

    import torch

    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        read_checkpoint_arrays,
    )

    out, printed = {}, {}
    for phase, flags, exact in ZERO_RUNS:
        want_coll = _want_collectives(True)
        if "none" not in flags:  # the plane's reduce-scatter instead
            want_coll = dict(want_coll, grad_all_reduce=0)
        root = tempfile.mkdtemp(prefix="chip_smoke_zero_")
        try:
            _zero_counters("cnn")
            _zero_collectives()
            on_card = device_flag == "cuda"
            peak = left = None
            if on_card:  # the earlier runs' garbage collected first
                gc.collect()
                torch.cuda.synchronize()
                start = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary, text = _run_cli(TRAIN_ARGS + flags + [
                "--device", device_flag, "--epochs", str(TRAIN_EPOCHS),
                "--checkpoint-dir", root], dp=True)
            wall_s = time.perf_counter() - t0
            if on_card:
                peak = torch.cuda.max_memory_allocated() - start
                gc.collect()
                torch.cuda.synchronize()
                left = torch.cuda.memory_allocated() - start
            launches = _read_counters("cnn")
            collectives = _collective_counts()
            meta, leaves = read_checkpoint_arrays(
                os.path.join(root, "checkpoint_1.npz"))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        lines = _train_lines(text, "Epoch: ")
        want = _want_launches("cnn")
        if "--loss" in flags:
            want = dict(want, xent_fwd=0, xent_bwd=0)
        if launches != want:
            raise AssertionError(f"{phase}: launch counts {launches}, "
                                 f"expected {want}")
        if collectives != want_coll:
            raise AssertionError(f"{phase}: collectives {collectives}, "
                                 f"expected {want_coll}")
        same = lines == want_lines
        if (exact and not same) or not _lines_close(lines, want_lines, 1e-4,
                                                    0.1):
            raise AssertionError(f"{phase} printed\n{lines}\nwhere the "
                                 f"unsharded run printed\n{want_lines}")
        if len(leaves) != TRAIN_RUNS["cnn"]["leaves"] or \
                meta["world"] != {"processes": 1, "devices": 1}:
            raise AssertionError(f"{phase}: checkpoint {len(leaves)} leaves "
                                 f"stamped {meta['world']}")
        emit(phase, flags=flags, world_of_one="nccl" if device_flag ==
             "cuda" else "gloo", epoch_lines=lines,
             equal_to_unsharded=same, launches=launches,
             expected_launches=want, collectives=collectives,
             wall_s=wall_s, peak_device_bytes=peak,
             left_allocated_bytes=left,
             peak_note="torch.cuda.max_memory_allocated over the run less "
                       "the bytes allocated at its start, activations "
                       "included; left: still allocated once the run "
                       "returned; on one rank every ZeRO shard is a whole "
                       "leaf",
             images_per_sec=[r["images_per_sec"]
                             for r in summary["history"]])
        out[phase] = launches
        printed[phase] = lines
    return out, printed


# The two-tier ('dcn', 'ici') mesh on the card: (phase, model, ZeRO level,
# --zero-overlap), each run through the port's API on make_hier_mesh(1) (a
# (1, 1) mesh: one slice of one rank) and on the flat mesh of the same
# NCCL world of one, the cnn's and the ViT's runs with --loss xla (the
# two-tier mesh refuses --loss fused, as the JAX CLI does).
HIER_RUNS = [("train_hier_zero1", "cnn", 1, False),
             ("train_hier_zero1_overlap", "cnn", 1, True),
             ("train_hier_zero3_overlap", "cnn", 3, True),
             ("train_hier_vit_zero1", "vit", 1, False)]
TIER_COLLECTIVES = COLLECTIVES + ("shard_collective", "dcn_all_reduce")


def _tier_counts() -> dict:
    from pytorch_distributed_mnist_tpu_torch.parallel import collectives

    return {name: getattr(collectives, name).launches
            for name in TIER_COLLECTIVES}


def _hier_argv(model: str, level: int, overlap: bool,
               device_flag: str) -> list:
    args = list(TRAIN_RUNS[model]["args"])
    args[args.index("--loss") + 1] = "xla"
    return args + ["--optimizer-sharding", f"zero{level}", "--epochs",
                   str(TRAIN_EPOCHS), "--device", device_flag] + (
        ["--zero-overlap"] if overlap else [])


def _api_epochs(argv: list) -> dict:
    """The training run of ``argv`` (the CLI's flags) on ``make_hier_mesh
    (1)`` in an NCCL world of one (gloo on the CPU), which the CLI cannot
    build (it refuses ``--dcn-slices`` over one device): the set-up of
    ``cli.run`` written out with the mesh swapped, then the CLI's own
    epoch loop (``cli._train_or_evaluate``), whose epoch lines it prints.
    Returns ``{"lines", "launches", "collectives", "mesh", "dcn_plan"}``,
    the counts from 0 over the run."""
    import contextlib
    import io
    import random
    import shutil

    import numpy as np
    import torch

    from pytorch_distributed_mnist_tpu_torch import cli
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops.loss import set_loss_impl
    from pytorch_distributed_mnist_tpu_torch.parallel import (
        collectives,
        distributed,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
        free_port,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
        make_hier_mesh,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
        shard_state_zero,
    )
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )
    from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_mnist_tpu_torch.utils.device import (
        resolve_device,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        StagingLog,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_hier_api_")
    args = cli.build_parser().parse_args(argv + ["--checkpoint-dir", root])
    device = resolve_device(args.device)
    model = "vit" if args.model == "vit" else "cnn"
    distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                       device)
    try:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)
        set_loss_impl(args.loss)
        _zero_counters(model)
        for name in TIER_COLLECTIVES:
            getattr(collectives, name).launches = 0
        mesh = make_hier_mesh(1, device=device)
        state = create_train_state(
            get_model(args.model, **cli._model_kwargs(args)), args.seed,
            device, lr=args.lr, optimizer=args.optimizer,
            momentum=args.momentum, weight_decay=args.weight_decay)
        shard_state_zero(
            state, mesh, level=3 if args.optimizer_sharding == "zero3" else 1,
            bucket_mb=args.zero_bucket_mb if args.zero_overlap else None,
            overlap=args.zero_overlap,
            bucket_mb_dcn=args.zero_bucket_mb_dcn or None)
        train_loader, test_loader, synthesized = cli._build_loaders(
            args, args.seed, mesh.data)
        trainer = Trainer(state, train_loader, test_loader, device,
                          mode=args.trainer_mode,
                          epoch_gather=args.epoch_gather,
                          staging_log=StagingLog(), axis=mesh.data,
                          grad_accum=args.grad_accum,
                          feed_window=args.feed_window,
                          aux_weight=args.moe_aux_weight,
                          zero_overlap=args.zero_overlap,
                          zero_bucket_mb_dcn=args.zero_bucket_mb_dcn)
        out = io.StringIO()
        with contextlib.closing(trainer), contextlib.redirect_stdout(out):
            cli._train_or_evaluate(args, trainer, args.start_epoch, 0.0,
                                   synthesized, None, None)
        return {"lines": _train_lines(out.getvalue(), "Epoch: "),
                "launches": _read_counters(model),
                "collectives": _tier_counts(),
                "mesh": mesh.shape, "dcn_plan": state.zero.dcn_plan}
    finally:
        distributed.teardown()
        shutil.rmtree(root, ignore_errors=True)


def phase_train_hier(zero_lines: dict, device_flag: str = "cuda") -> dict:
    """The two-tier mesh on the card (``HIER_RUNS``): the cnn at full
    width with ZeRO-1, ZeRO-1 overlapped and ZeRO-3 overlapped, and the
    ViT at its registered widths with ``--attention flash`` and ZeRO-1,
    each with ``adam_pallas`` in scan mode, on a (1, 1) ``make_hier_mesh``
    through the CLI's epoch loop (``_api_epochs``). Each run's epoch
    lines must equal, character for character, the CLI's run of the same
    flags on the flat mesh of a world of one: ``zero_lines`` (the lines
    ``phase_train_zero`` printed) where it ran them (ZeRO-1 overlapped is
    ``train_zero1_overlap``), else a CLI run here. Its counts, from 0 over
    the run, exactly Adam once a step on the ``ici`` shards (and the
    ViT's flash forward and backward ``depth`` times a step each way, the
    forward also per eval batch), and no collective at all: every axis of
    a (1, 1) mesh is one rank, so no tier has a group and the two-tier
    schedule runs only in ``hier_spawn``'s worlds. Then the CLI's
    ``--dcn-slices 2`` over this one card, refused ("split into"), as the
    JAX CLI refuses it over one device. Returns each run's launches."""
    import shutil

    same_flags = {"train_hier_zero1_overlap": "train_zero1_overlap"}
    out = {}
    for phase, model, level, overlap in HIER_RUNS:
        argv = _hier_argv(model, level, overlap, device_flag)
        t0 = time.perf_counter()
        if phase in same_flags:
            ref = same_flags[phase]
            flat_lines = zero_lines[ref]
        else:
            ref = "cli"
            root = tempfile.mkdtemp(prefix="chip_smoke_hier_flat_")
            try:
                text = _run_cli(argv + ["--checkpoint-dir", root],
                                dp=True)[1]
            finally:
                shutil.rmtree(root, ignore_errors=True)
            flat_lines = _train_lines(text, "Epoch: ")
        flat_s = time.perf_counter() - t0
        hier = _api_epochs(argv)
        hier_s = time.perf_counter() - t0 - flat_s
        want = dict(_want_launches(model), xent_fwd=0, xent_bwd=0)
        steps = TRAIN_EPOCHS * (8192 // TRAIN_BATCH)
        if hier["launches"] != want or want["adam"] != steps:
            raise AssertionError(f"{phase}: launch counts "
                                 f"{hier['launches']}, expected {want}")
        if any(hier["collectives"].values()):
            raise AssertionError(f"{phase}: collectives on the (1, 1) mesh "
                                 f"{hier['collectives']}")
        if hier["mesh"] != {"dcn": 1, "ici": 1}:
            raise AssertionError(f"{phase}: mesh {hier['mesh']}")
        if hier["lines"] != flat_lines or len(flat_lines) != TRAIN_EPOCHS:
            raise AssertionError(f"{phase} printed\n{hier['lines']}\nwhere "
                                 f"the CLI's flat world of one printed\n"
                                 f"{flat_lines}")
        emit(phase, model=model, zero=level, overlap=overlap,
             mesh=hier["mesh"], epoch_lines=hier["lines"],
             equal_to_cli_flat_world_of_one=True,
             flat_reference="this phase's CLI run" if ref == "cli"
             else ref, launches=hier["launches"],
             expected_launches=want, adam_launches_per_step=1,
             collectives=hier["collectives"],
             dcn_buckets=len(hier["dcn_plan"]), flat_s=flat_s,
             hier_s=hier_s)
        out[phase] = hier["launches"]
    root = tempfile.mkdtemp(prefix="chip_smoke_hier_")
    try:
        _run_cli(_hier_argv("cnn", 1, False, device_flag)
                 + ["--dcn-slices", "2", "--checkpoint-dir", root], dp=True)
    except SystemExit as exc:
        refusal = str(exc.code)
    else:
        raise AssertionError("--dcn-slices 2 trained on one card")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if "split into" not in refusal:
        raise AssertionError(f"--dcn-slices 2 on one card: {refusal}")
    print(f"chip_smoke.py: --dcn-slices 2 on one card: {refusal}",
          file=sys.stderr, flush=True)
    emit("train_hier_refusal", flags=["--dcn-slices", "2"],
         refusal=refusal)
    return out


# Pairs of feed-window runs, each pair one run at --feed-window 2 and one
# at 1 back to back, in the order 2 1, 1 2, 2 1, ...: enough to tell a
# step's wall apart between the windows (a run's epoch is 32 steps).
FEED_WINDOW_PAIRS = 10


def phase_train_feed_window(want_lines: list,
                            device_flag: str = "cuda") -> dict:
    """The cnn run in ``--trainer-mode stepwise`` at ``--feed-window 2``
    (the feeder thread stages batch N+1 while batch N's step runs) and at
    1 (inline), in ``FEED_WINDOW_PAIRS`` pairs of alternating order:
    every run must print ``want_lines`` (the scan run's) character for
    character. Reports each window's host ms per train step (epoch 1's
    timed train pass; epoch 0 holds the first steps' set-up) in each run,
    their mean and median, each pair's difference (window 2 less window
    1) and how many pairs read window 2 slower, and the staging log: the
    consumer's wait per stage, the host gather and the queued copies."""
    import statistics

    order = [w for k in range(FEED_WINDOW_PAIRS)
             for w in ((2, 1) if k % 2 == 0 else (1, 2))]
    turns = {2: [], 1: []}
    for turn, window in enumerate(order):
        row = phase_train_twin(
            f"train_feed_window_{window}_turn{turn}", "cnn",
            ["--trainer-mode", "stepwise", "--feed-window", str(window)],
            want_lines, device_flag=device_flag)
        staging = row["staging"]
        if staging["pipelined_stages"] != (staging["stages"] if window > 1
                                           else 0):
            raise AssertionError(f"--feed-window {window} staged {staging}")
        turns[window].append({
            "host_ms_per_step": TRAIN_BATCH / row["images_per_sec"][1] * 1e3,
            "wait_ms_per_stage": staging["consumer_wait_ms"]
            / max(staging["stages"], 1),
            "gather_ms_per_stage": staging["host_ms"]
            / max(staging["stages"], 1),
            "h2d_ms_per_stage": staging["h2d_ms"]
            / max(staging["stages"], 1),
            "overlap_fraction": staging["overlap_fraction"]})
    keys = ("host_ms_per_step", "wait_ms_per_stage", "gather_ms_per_stage",
            "h2d_ms_per_stage")
    rows = {window: {
        "turns": runs,
        **{f"mean_{key}": statistics.mean(r[key] for r in runs)
           for key in keys},
        **{f"median_{key}": statistics.median(r[key] for r in runs)
           for key in keys}}
        for window, runs in turns.items()}
    diffs = [a["host_ms_per_step"] - b["host_ms_per_step"]
             for a, b in zip(turns[2], turns[1])]
    pairs = {"host_ms_per_step_w2_less_w1": diffs,
             "median_difference_ms": statistics.median(diffs),
             "pairs_w2_slower": sum(d > 0 for d in diffs),
             "pairs": len(diffs)}
    emit("train_feed_window", windows=rows, order=order, pairs=pairs,
         epoch_lines_equal=True)
    return rows


def phase_remat_memory(device) -> dict:
    """Peak device memory of one bf16 flash ViT train step (batch 256,
    the fused loss, Adam's kernel) with and without ``remat``, at patch 4
    (49 tokens) and patch 2 (196): ``torch.cuda.max_memory_allocated``
    over the step less what was allocated before it, after one warm-up
    step; and whether the two models' params after two steps are the
    same bits."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops.flash import (
        flash_attention,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.loss import (
        get_loss_impl,
        set_loss_impl,
    )
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )
    from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    batch = {"image": torch.randn((TRAIN_BATCH, 28, 28, 1), generator=gen,
                                  device=device),
             "label": torch.randint(0, CLASSES, (TRAIN_BATCH,), generator=gen,
                                    device=device),
             "mask": torch.ones(TRAIN_BATCH, device=device)}
    before_impl = get_loss_impl()
    set_loss_impl("fused")
    rows = {}
    try:
        for patch in (4, 2):
            params = {}
            for remat in (False, True):
                state = create_train_state(
                    get_model("vit", attention_fn=flash_attention,
                              patch_size=patch, remat=remat), SEED, device,
                    optimizer="adam_pallas")
                train_step(state, batch)
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
                train_step(state, batch)
                torch.cuda.synchronize(device)
                peak = torch.cuda.max_memory_allocated(device) - base
                rows[f"p{patch}_remat{int(remat)}_peak_mb"] = peak / 2**20
                params[remat] = [p.detach().clone()
                                 for p in state.model.parameters()]
                del state
            rows[f"p{patch}_same_params"] = all(
                torch.equal(a, b) for a, b in zip(params[False],
                                                  params[True]))
            rows[f"p{patch}_saved_share"] = 1.0 - (
                rows[f"p{patch}_remat1_peak_mb"]
                / rows[f"p{patch}_remat0_peak_mb"])
    finally:
        set_loss_impl(before_impl)
    emit("train_vit_remat_memory", batch=TRAIN_BATCH, **rows)
    return rows


# The port's kernels by the names the profiler gives them, and the part of
# a train step each is.
OWN_KERNELS = (("xent_fwd_kernel", "xent_fwd"),
               ("xent_bwd_kernel", "xent_bwd"),
               ("adam_leaves_kernel", "adam"),
               ("flash_fwd_mma_kernel", "flash_fwd"),
               ("flash_fwd_kernel", "flash_fwd"),
               ("flash_bwd_kernel", "flash_bwd"),
               ("flash_dq_tiled_kernel", "flash_dq_tiled"),
               ("flash_dkv_tiled_kernel", "flash_dkv_tiled"),
               ("flash_fwd_tf32_kernel", "flash_fwd_tf32"),
               ("flash_dq_tf32_kernel", "flash_dq_tf32"),
               ("flash_dkv_tf32_kernel", "flash_dkv_tf32"),
               ("flash_dq_kernel", "flash_dq"),
               ("flash_dkv_kernel", "flash_dkv"))


def _train_kind(kernel: str) -> str:
    """A device kernel's part of a train step, by its name
    (``utils/profiling.py::step_part``; NCCL's kernels are
    ``collective``)."""
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        step_part,
    )

    return step_part(kernel, OWN_KERNELS)


def _step_launches(step, model: str, tokens: int, dtype: str) -> dict:
    """The launches per step of each training kernel over
    ``PROFILE_STEPS`` train steps, counted from 0; raises unless they are
    the path's: one cross-entropy forward and backward and one Adam launch
    per step and, for the ViT, a forward and a backward per attention
    layer on the routes ``_flash_want`` names."""
    import torch

    # The counted run starts here.
    _zero_counters(model)
    for _ in range(PROFILE_STEPS):
        step()
    torch.cuda.synchronize()
    got = _read_counters(model)
    # ... and ends here.
    n = PROFILE_STEPS
    want = {"xent_fwd": n, "xent_bwd": n, "adam": n}
    depth = TRAIN_RUNS[model]["depth"]
    if depth:
        want.update(_flash_want(dtype, tokens, depth * n, depth * n))
    if got != want:
        raise AssertionError(f"{model} train step launch counts over {n} "
                             f"steps {got}, expected {want}")
    return got


def phase_train_profile(device, model: str = "cnn", patch_size: int = 4,
                        dtype: str = "bf16", embed_dim: int = 64) -> dict:
    """Where one train step's device time goes (``model`` at batch 256,
    fused loss and Adam, the ViT with flash attention at ``patch_size``
    and ``embed_dim`` in its 4 heads (48: D = 12, the phase
    ``train_vit_d12_profile``), the host-to-device copy of the batch
    included, computing in ``dtype``: bf16, or f32 as ``--dtype f32``
    trains, TF32 off), beside the host's wall time per step; first the
    launches of its kernels over a few steps (``_step_launches``: at any
    head dim the tensor-core routes, no CUDA-core kernel). Returns the
    phase's row."""
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
    if patch_size != 4:
        kwargs["patch_size"] = patch_size
    if embed_dim != 64:
        kwargs["embed_dim"] = embed_dim
    if dtype == "f32":  # as the trainer sets it for a float32 model
        kwargs["compute_dtype"] = torch.float32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        require_full_float32()
    state = create_train_state(get_model(model, **kwargs), SEED, device,
                               optimizer="adam_pallas")
    images, labels = synthetic_dataset(TRAIN_BATCH, seed=SEED + 30)
    host = {"image": normalize_images(images),
            "label": labels.astype(np.int64),
            "mask": np.ones(TRAIN_BATCH, np.float32)}

    def step():
        return train_step(state, to_device(host, device))

    tokens = (28 // patch_size) ** 2
    launches = _step_launches(step, model, tokens, dtype)
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
    row = {"batch": TRAIN_BATCH, "tokens": tokens if model == "vit" else None,
           "head_dim": embed_dim // 4 if model == "vit" else None,
           "wall_ms": wall_ms, "device_ms": device_total,
           "device_busy": device_total / wall_ms, "by_kind_ms": by_kind,
           "host_ms": host_ms,
           "images_per_sec_steady": TRAIN_BATCH / wall_ms * 1e3,
           "distinct_kernels": len(per), "counted_steps": PROFILE_STEPS,
           "launches": launches,
           "top": sorted(((ms, name[:90]) for name, ms in per.items()),
                         reverse=True)[:10]}
    phase = "train" if model == "cnn" else f"train_{model}"
    if patch_size != 4:
        phase += f"_p{patch_size}"
    if embed_dim != 64:
        phase += f"_d{embed_dim // 4}"
    if dtype != "bf16":
        phase += f"_{dtype}"
    emit(f"{phase}_profile", model=model, patch_size=patch_size, dtype=dtype,
         embed_dim=embed_dim, **row)
    return row


SCAN_STEPS = 32  # one epoch of the smoke's run: 8192 images at batch 256


def _scan_setup(device, model: str, patch_size: int):
    """The scan profiles' case: ``SCAN_STEPS`` batches of 256 synthetic
    images (host arrays and the epoch staged on the card) and a factory of
    fresh train states of ``model`` (bf16, fused loss and Adam, the ViT
    with flash attention at ``patch_size``)."""
    import numpy as np
    import torch

    from pytorch_distributed_mnist_tpu_torch.data.mnist import (
        normalize_images,
        synthetic_dataset,
    )
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
    from pytorch_distributed_mnist_tpu_torch.ops.loss import set_loss_impl
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )

    set_loss_impl("fused")
    torch.backends.cudnn.deterministic = True  # as the trainer sets it
    torch.backends.cudnn.benchmark = False
    kwargs = {"attention_fn": flash_attention} if model == "vit" else {}
    if patch_size != 4:
        kwargs["patch_size"] = patch_size
    n, b = SCAN_STEPS, TRAIN_BATCH
    images, labels = synthetic_dataset(n * b, seed=SEED + 40)
    host = {"image": normalize_images(images).reshape(n, b, 28, 28, 1),
            "label": labels.astype(np.int64).reshape(n, b),
            "mask": np.ones((n, b), np.float32)}
    staged = {k: torch.from_numpy(v).to(device) for k, v in host.items()}

    def make_state():
        return create_train_state(get_model(model, **kwargs), SEED, device,
                                  optimizer="adam_pallas")

    return make_state, host, staged


def _epoch_program(device, make_state, staged, axis=None) -> dict:
    """A fresh state's scan epoch program on ``staged``, run once (2 eager
    ticks, the capture, 30 replays): ``{"run", "program", "pool_bytes",
    "grad_buffer_bytes"}``, the pool's bytes a ``memory_allocated`` delta
    net of the flat gradient buffer a world's step allocates."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
    )

    state = make_state()
    epoch = make_train_epoch(state, axis)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    epoch(staged)
    torch.cuda.synchronize()
    grads = state.grad_buffer
    grad_bytes = 0 if grads is None else grads.flat.numel() * 4
    return {"run": lambda: epoch(staged), "program": epoch.program,
            "pool_bytes": torch.cuda.memory_allocated(device) - before
            - grad_bytes, "grad_buffer_bytes": grad_bytes}


def _timed_modes(modes: list, n: int, b: int) -> dict:
    """Each of ``modes`` (name, a function running one epoch of ``n``
    steps of ``b`` images), timed in turns (each mode, then each again in
    reverse order): host wall per step (the better turn), device ms per
    step from the profiler's trace, the device's span per step between
    CUDA events, busy share, images/s, the collectives' device ms, and the
    cross-entropy and Adam kernels' device ms per call."""
    import torch

    rows = {}
    for mode, fn in modes + [(f"{m}_again", fn) for m, fn in modes[::-1]]:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rows[mode] = {"wall_ms": (time.perf_counter() - t0) / n * 1e3}
    for mode, fn in modes:
        per = device_ms(fn, iters=2)
        dev_ms = sum(per.values()) / n
        walls = [rows[mode]["wall_ms"], rows.pop(f"{mode}_again")["wall_ms"]]
        wall = min(walls)
        # The device's span per step, from CUDA events around the epoch:
        # its kernels and the gaps between them, no profiler.
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        collective = {name[:80]: ms / n for name, ms in per.items()
                      if _train_kind(name) == "collective"}
        rows[mode].update(
            wall_ms=wall, wall_ms_both=walls, device_ms=dev_ms,
            device_span_ms=start.elapsed_time(end) / n,
            device_busy=dev_ms / wall, images_per_sec=b / wall * 1e3,
            collective_ms=sum(collective.values()),
            collective_kernels=collective,
            kernel_ms_per_call={
                name: _kernel_ms(per, own) / n for own, name in (
                    ("xent_fwd_kernel", "xent_fwd"),
                    ("xent_bwd_kernel", "xent_bwd"),
                    ("adam_leaves_kernel", "adam"))})
    return rows


def phase_train_scan_profile(device, model: str = "cnn",
                             patch_size: int = 4) -> dict:
    """The two trainer modes on one epoch of ``SCAN_STEPS`` train steps
    (``model`` at batch 256, bf16, fused loss and Adam, the ViT with flash
    attention at ``patch_size``), in this one call: the stepwise trainer's
    steps (each batch copied to the card from pinned host memory, one
    eager step) against the scan trainer's epoch program (the epoch staged
    on the card, one captured graph of the step replayed per batch), as
    ``_timed_modes`` times them; the capture's wall time, the graph
    pool's and the staged epoch's bytes; and the cross-entropy and Adam
    kernels' device ms per call inside the replay beside their eager
    times. Returns the phase's row."""
    from pytorch_distributed_mnist_tpu_torch.data.loader import to_device
    from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

    make_state, host, staged = _scan_setup(device, model, patch_size)
    n, b = SCAN_STEPS, TRAIN_BATCH
    eager = make_state()

    def stepwise():
        for s in range(n):
            train_step(eager, to_device({k: v[s] for k, v in host.items()},
                                        device))

    scan = _epoch_program(device, make_state, staged)
    rows = _timed_modes([("stepwise", stepwise), ("scan", scan["run"])],
                        n, b)
    row = {"model": model, "patch_size": patch_size,
           "tokens": (28 // patch_size) ** 2 if model == "vit" else None,
           "batch": b, "steps": n, "capture_s": scan["program"].capture_s,
           "graph_pool_bytes": scan["pool_bytes"],
           "staged_epoch_bytes": sum(t.numel() * t.element_size()
                                     for t in staged.values()),
           "replays": scan["program"].replays, **rows,
           "host_wall_ratio": rows["stepwise"]["wall_ms"]
           / rows["scan"]["wall_ms"]}
    phase = "train_scan_profile" if model == "cnn" else \
        f"train_scan_profile_{model}" + ("" if patch_size == 4
                                         else f"_p{patch_size}")
    emit(phase, **row)
    return row


# The pipelined ViT on the card: a ('data', 'stage') mesh of one rank
# (NCCL refuses two ranks on one card), at m microbatches, bf16, flash,
# fused loss and Adam, over the scan profiles' batches.
PIPELINE_MICROBATCHES = (2, 4)
PIPELINE_STEPS = 8  # train steps each run takes
# The pipelined step against the unpipelined one on the same batches from
# the same init (bf16; each step's products run at another M): every
# step's loss sum within 1e-3 relative, correct counts within 2 of 256;
# and after the steps the params' distance from the unpipelined run's
# within PIPELINE_PARAM_HOLD of how far that run moved them
# (``_param_gaps``), over all leaves and for the worst leaf. On an H100
# sound runs read at most 1.3e-4 on the losses, 0.024 over all leaves and
# 0.017 for the worst; with a microbatch's gradient lost at least 0.035,
# 0.30 and 0.50. The qkv biases sit out of the worst leaf: their k third
# has no gradient (softmax ignores a shift shared by every key), so Adam
# walks it on rounding noise in either run. A planted fault, one
# microbatch's gradient lost, must break the hold at every m.
PIPELINE_HOLD = (1e-3, 2)
PIPELINE_PARAM_HOLD = 0.1
PIPELINE_NOISE_LEAVES = ("attn.qkv.bias",)


def _param_gaps(got: dict, want: dict, init: dict) -> dict:
    """``{leaf: |got - want| / |want - init|}`` (Frobenius norms): how far
    a run's params lie from the reference run's, against how far the
    reference moved them from ``init``; ``"all"`` over every leaf."""
    gaps, num, den = {}, 0.0, 0.0
    for name, w in want.items():
        w = w.detach().double()
        d = (got[name].detach().double() - w).norm().item()
        moved = (w - init[name].double()).norm().item()
        gaps[name] = d / max(moved, 1e-30)
        num, den = num + d * d, den + moved * moved
    gaps["all"] = (num / max(den, 1e-60)) ** 0.5
    return gaps


def _lose_microbatch(model, m: int):
    """Plant a fault on a pipelined model: the gradient of the logits of
    microbatch 0's rows is zeroed, so that microbatch's gradient is lost,
    as a skipped hop's backward would lose it. Returns the hook's
    handle."""
    import torch

    def zero_rows(g):
        rows = g.shape[0] // m
        return torch.cat([torch.zeros_like(g[:rows]), g[rows:]])

    def hook(module, inputs, out):
        if out.requires_grad:
            out.register_hook(zero_rows)

    return model.register_forward_hook(hook)


def phase_train_pipeline(device) -> dict:
    """``parallel/pipeline_vit.py`` on the card: the ViT's pipelined
    train state (``create_pipelined_vit_state`` on a one-rank stage axis,
    the GPipe tick loop with no hop) at m = 2 and 4 microbatches, in the
    stepwise mode (``train_step`` per batch) and the scan mode (the
    epoch program: one captured graph of the step replayed per batch),
    with ``--attention flash --loss fused --optimizer adam_pallas``. Each
    stepwise run is held to the unpipelined ViT's steps on the same
    batches from the same init, its losses and, after the steps, its
    params (``PIPELINE_HOLD``, ``PIPELINE_PARAM_HOLD``); the scan run to
    its stepwise twin within 1e-6. A stepwise run at each m with one
    microbatch's gradient lost (``_lose_microbatch``) must fail that
    hold. Each run's launches, counted from 0 over the run, must be
    ``(m + S - 1) * depth / S`` flash forwards and backwards a step (S =
    1: m * depth), one cross-entropy each way and one Adam. A scan run's
    first pass holds its warm-up and capture: each scan state (the
    unpipelined one too) then replays one more pass, timed alone."""
    import numpy as np
    import torch

    from pytorch_distributed_mnist_tpu_torch.data.loader import to_device
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops import adam, flash, xent
    from pytorch_distributed_mnist_tpu_torch.ops.flash import (
        flash_attention,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
        create_pipelined_vit_state,
        merge_vit_params,
    )
    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
        train_step,
    )

    make_plain, host, _ = _scan_setup(device, "vit", 4)
    n = PIPELINE_STEPS
    host = {k: v[:n] for k, v in host.items()}
    staged = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    mesh = make_mesh(("data", "stage"), shape=(1, 1), device=device)
    counters = {"flash_fwd": flash.flash_fwd, "flash_bwd": flash.flash_bwd,
                "xent_fwd": xent.xent_fwd, "xent_bwd": xent.xent_bwd,
                "adam": adam.adam_leaves}

    def pipelined(m):
        state, _ = create_pipelined_vit_state(
            get_model("vit", attention_fn=flash_attention), SEED, mesh,
            device, num_microbatches=m, optimizer="adam_pallas")
        return state

    def stepwise(state):
        out = []
        for s in range(n):
            m = train_step(state, to_device({k: v[s] for k, v in
                                             host.items()}, device))
            out.append([float(t) for t in m])
        return out

    def scan(state):
        epoch = make_train_epoch(state)
        return [float(t) for t in epoch(staged)], epoch

    def replay_ms(epoch):
        """Host wall per step of a pass that only replays the captured
        graph (the state trains on; nothing is compared)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch(staged)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def params_of(state):
        return merge_vit_params(state.model.split_params())

    def hold(got, params) -> dict:
        """The losses' and the params' gaps from the unpipelined run, and
        whether they are within the hold."""
        losses = np.array([r[0] for r in got])
        loss_gap = float(np.max(np.abs(losses - ref) / np.abs(ref)))
        gaps = _param_gaps(params, plain_params, init)
        worst = max((k for k in gaps if k != "all"
                     and not k.endswith(PIPELINE_NOISE_LEAVES)),
                    key=gaps.get)
        noise = {k: v for k, v in gaps.items()
                 if k.endswith(PIPELINE_NOISE_LEAVES)}
        return {"loss_gap": loss_gap, "param_gap_all": gaps["all"],
                "param_gap_worst": gaps[worst], "param_gap_worst_leaf": worst,
                "param_gap_noise_leaves": noise,
                "within": loss_gap <= every
                and max(gaps[worst], gaps["all"]) <= PIPELINE_PARAM_HOLD
                and all(abs(a[1] - b[1]) <= correct
                        for a, b in zip(got, plain))}

    plain_state = make_plain()
    init = {k: v.detach().clone()
            for k, v in plain_state.model.named_parameters()}
    t0 = time.perf_counter()
    plain = stepwise(plain_state)
    plain_ms = (time.perf_counter() - t0) / n * 1e3
    plain_params = dict(plain_state.model.named_parameters())
    ref = np.array([r[0] for r in plain])
    _, plain_epoch = scan(make_plain())
    every, correct = PIPELINE_HOLD
    row = {"steps": n, "batch": TRAIN_BATCH, "stages": 1,
           "depth": VIT_DEPTH, "plain_step_metrics": plain,
           "plain_stepwise_wall_ms_per_step": plain_ms,
           "plain_replay_wall_ms_per_step": replay_ms(plain_epoch),
           "runs": {}}
    for m in PIPELINE_MICROBATCHES:
        per_step = {"flash_fwd": m * VIT_DEPTH, "flash_bwd": m * VIT_DEPTH,
                    "xent_fwd": 1, "xent_bwd": 1, "adam": 1}
        for mode in ("stepwise", "scan"):
            state = pipelined(m)
            torch.cuda.synchronize()
            # This path's run starts here ...
            for c in counters.values():
                c.launches = 0
                if hasattr(c, "route_launches"):
                    c.route_launches.update(dict.fromkeys(c.route_launches,
                                                          0))
            t0 = time.perf_counter()
            if mode == "stepwise":
                got = stepwise(state)
            else:
                got, epoch = scan(state)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n * 1e3
            launches = {k: c.launches for k, c in counters.items()}
            routes = {k: dict(counters[k].route_launches)
                      for k in ("flash_fwd", "flash_bwd")}
            # ... and ends here.
            want = {k: v * n for k, v in per_step.items()}
            if launches != want or routes["flash_fwd"]["tensor"] != \
                    want["flash_fwd"] or routes["flash_bwd"]["fused"] != \
                    want["flash_bwd"]:
                raise AssertionError(f"train_pipeline m={m} {mode}: "
                                     f"launches {launches} {routes}, "
                                     f"expected {want}")
            if mode == "stepwise":
                held = hold(got, params_of(state))
                summed = np.sum(np.array(got, np.float64), axis=0)
            else:
                if not np.allclose(got, summed, rtol=1e-6, atol=0):
                    raise AssertionError(f"train_pipeline m={m} scan {got} "
                                         f"against its stepwise {summed}")
            row["runs"][f"m{m}_{mode}"] = {
                "metrics": got, "launches": launches, "routes": routes,
                "launches_per_step": per_step, "wall_ms_per_step": wall}
            if mode == "stepwise":
                row["runs"][f"m{m}_stepwise"].update(held)
            else:
                row["runs"][f"m{m}_scan"]["replay_wall_ms_per_step"] = \
                    replay_ms(epoch)
        # The planted fault, after the counted runs.
        state = pipelined(m)
        handle = _lose_microbatch(state.model, m)
        got = stepwise(state)
        handle.remove()
        row["runs"][f"m{m}_lost_microbatch"] = {
            "metrics": got, **hold(got, params_of(state))}
    emit("train_pipeline", **row)
    for m in PIPELINE_MICROBATCHES:
        sound = row["runs"][f"m{m}_stepwise"]
        planted = row["runs"][f"m{m}_lost_microbatch"]
        if not sound["within"]:
            raise AssertionError(
                f"train_pipeline m={m}: steps {sound['metrics']} against the "
                f"unpipelined {plain}; loss gap {sound['loss_gap']}, param "
                f"gap {sound['param_gap_all']}, worst leaf "
                f"{sound['param_gap_worst']} "
                f"({sound['param_gap_worst_leaf']})")
        if planted["within"]:
            raise AssertionError(
                f"train_pipeline m={m}: the hold does not see a lost "
                f"microbatch (loss gap {planted['loss_gap']}, param gap "
                f"{planted['param_gap_all']}, worst leaf "
                f"{planted['param_gap_worst']})")
    return row


def phase_train_scan_profile_dp(device) -> dict:
    """What the gradient all-reduce in the replayed step costs at world 1:
    in the same call as ``train_scan_profile``, the cnn's scan epoch
    program without a process group against the same program in an NCCL
    world of one (this process joins a group of its own through the
    explicit rendezvous; the all-reduce captured in the graph), timed in
    turns by ``_timed_modes``: host wall, device ms, busy share and
    images/s per step, the NCCL kernels' device ms, and what the world of
    one adds. Returns the phase's row."""
    from pytorch_distributed_mnist_tpu_torch.parallel import distributed
    from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
        free_port,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh

    make_state, _, staged = _scan_setup(device, "cnn", 4)
    n, b = SCAN_STEPS, TRAIN_BATCH
    plain = _epoch_program(device, make_state, staged)
    t0 = time.perf_counter()
    distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                       device)
    try:
        rendezvous_s = time.perf_counter() - t0
        dp = _epoch_program(device, make_state, staged,
                            make_mesh(device=device))
        rows = _timed_modes([("scan", plain["run"]),
                             ("scan_dp", dp["run"])], n, b)
    finally:
        distributed.teardown()
    per_replay = {f"{k[1]}.{k[2]}": v for k, v in
                  dp["program"].launches.per_replay.items()}
    if per_replay.get("grad_all_reduce.launches") != 1:
        raise AssertionError(f"the world-of-one replay holds {per_replay}, "
                             f"not one all-reduce")
    row = {"model": "cnn", "batch": b, "steps": n, "world": 1,
           "backend": "nccl", "scan_without_group": rows["scan"],
           "scan_world_1": rows["scan_dp"],
           "wall_ms_added": rows["scan_dp"]["wall_ms"]
           - rows["scan"]["wall_ms"],
           "device_ms_added": rows["scan_dp"]["device_ms"]
           - rows["scan"]["device_ms"],
           "capture_s": dp["program"].capture_s,
           "capture_s_without_group": plain["program"].capture_s,
           "graph_pool_bytes": dp["pool_bytes"],
           "graph_pool_bytes_without_group": plain["pool_bytes"],
           "grad_buffer_bytes": dp["grad_buffer_bytes"],
           "rendezvous_s": rendezvous_s, "launches_per_replay": per_replay,
           "replays": dp["program"].replays}
    emit("train_scan_profile_dp", **row)
    return row


# ``--spawn 2`` as a user runs it: the cnn run's flags for one epoch on the
# card, and linear on the CPU over gloo.
SPAWN_CPU_ARGS = ["--model", "linear", "--dataset", "synthetic",
                  "--synthetic-train-size", "2048", "--synthetic-test-size",
                  "500", "--batch-size", "256", "--seed", str(SEED),
                  "--epochs", "1", "--device", "cpu"]


def _epoch_numbers(lines: list) -> list:
    import re

    return [[float(x) for x in re.findall(r"-?\d+\.?\d*", ln)]
            for ln in lines]


def phase_dp_spawn() -> dict:
    """``--spawn 2`` as a user's command line runs it (``cli.main``; the
    ranks are processes of their own). On the card: with fewer than 2 cards
    it must exit 2 with the one-card-per-rank message (NCCL refuses two
    ranks on one card, and no rank is moved to the CPU unasked); with 2 or
    more, the cnn run in float32 in a 2-rank NCCL world, rank 0's epoch
    line held to one process's within the CPU tests' bounds (the losses
    within 1e-5, the accuracies within one example). Then ``--device
    cpu --model linear``: a gloo world on this machine's CPU, which must
    print rank 0's lines and the devices line and write one checkpoint
    per epoch (and the best copy) stamped 2x2."""
    import shutil

    import torch

    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        read_checkpoint_arrays,
    )

    def cli(argv, ckpt):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
             *argv, "--checkpoint-dir", ckpt], capture_output=True,
            text=True, timeout=600, cwd=_HERE,
            env=dict(os.environ, PYTHONPATH=_HERE))
        return proc, time.perf_counter() - t0

    def spawn_here(argv, ckpt):
        """``cli.main(argv)`` for ``--spawn`` from this process, as a
        user's command line runs it, without a process of its own for the
        spawner; rank 0, which writes to the inherited standard output,
        writes to a file instead. Returns (exit code, rank 0's output,
        the ranks' errors, seconds)."""
        from pytorch_distributed_mnist_tpu_torch import cli as port_cli

        t0 = time.perf_counter()
        sys.stdout.flush()
        with tempfile.TemporaryFile(mode="w+") as out, \
                tempfile.TemporaryFile(mode="w+") as err:
            saved = os.dup(1), os.dup(2)
            os.dup2(out.fileno(), 1)
            os.dup2(err.fileno(), 2)
            try:
                port_cli.main([*argv, "--checkpoint-dir", ckpt])
                code = 0
            except SystemExit as exit_:
                code = exit_.code
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os.dup2(saved[0], 1)
                os.dup2(saved[1], 2)
                os.close(saved[0])
                os.close(saved[1])
            out.seek(0)
            err.seek(0)
            return code, out.read(), err.read(), time.perf_counter() - t0

    cards = torch.cuda.device_count()
    root = tempfile.mkdtemp(prefix="chip_smoke_spawn_")
    row = {"cards": cards}
    try:
        card_args = TRAIN_ARGS + ["--epochs", "1", "--dtype", "f32"]
        if cards < 2:
            # The CLI refuses before it starts any process: in-process.
            import contextlib
            import io

            from pytorch_distributed_mnist_tpu_torch import cli as port_cli

            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                try:
                    port_cli.main(["--spawn", "2", *card_args,
                                   "--checkpoint-dir", root])
                    code = 0
                except SystemExit as exit_:
                    code = exit_.code
            if code != 2 or "NCCL needs one card per rank" \
                    not in err.getvalue():
                raise AssertionError(f"--spawn 2 on {cards} card: exit "
                                     f"{code}\n{err.getvalue()}")
            row["card_world_2"] = {
                "exit": code, "message": err.getvalue().strip(),
                "nccl_world_of_2": "not run: needs 2 or more cards"}
        else:
            proc, wall = cli(["--spawn", "2", *card_args],
                             os.path.join(root, "card2"))
            one, one_wall = cli(card_args, os.path.join(root, "card1"))
            for p in (proc, one):
                if p.returncode != 0:
                    raise AssertionError(f"cnn run rc {p.returncode}\n"
                                         f"{p.stdout}\n{p.stderr}")
            two_lines = _train_lines(proc.stdout, "Epoch: ")
            one_lines = _train_lines(one.stdout, "Epoch: ")
            for x, y in zip(_epoch_numbers(two_lines),
                            _epoch_numbers(one_lines), strict=True):
                if (x[:3] != y[:3] or abs(x[3] - y[3]) > 1e-5
                        or abs(x[5] - y[5]) > 1e-5
                        or abs(x[4] - y[4]) > 100 / 8192
                        or abs(x[6] - y[6]) > 100 / 2048):
                    raise AssertionError(f"world 2 {two_lines} against "
                                         f"world 1 {one_lines}")
            row["card_world_2"] = {"rc": 0, "wall_s": wall,
                                   "one_process_wall_s": one_wall,
                                   "epoch_lines": two_lines,
                                   "one_process_lines": one_lines}
        ckpt = os.path.join(root, "cpu2")
        code, out, err, wall = spawn_here(["--spawn", "2", *SPAWN_CPU_ARGS],
                                          ckpt)
        lines = _train_lines(out, "Epoch: ")
        devices = _train_lines(out, "devices: ")
        files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
        if (code != 0 or len(lines) != 1 or devices != [
                "devices: 2 (cpu), processes: 2, mesh: {'data': 2}"]
                or files != ["checkpoint_0.npz", "model_best.npz"]):
            raise AssertionError(f"gloo world: exit {code}, files {files}"
                                 f"\n{out}\n{err}")
        meta, _ = read_checkpoint_arrays(os.path.join(ckpt, files[0]))
        if meta["world"] != {"processes": 2, "devices": 2}:
            raise AssertionError(f"stamped {meta['world']}")
        row["cpu_world_2"] = {"exit": 0, "wall_s": wall, "epoch_lines": lines,
                              "devices_line": devices[0], "files": files,
                              "world": meta["world"]}
        row["cpu_worlds_parallel"] = _spawn_parallel_worlds(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("dp_spawn", **row)
    return row


# Expert parallelism and ZeRO across ranks, as gloo worlds on the CPU:
# (name, world size, flags, the mesh its devices line prints, the run its
# epoch line is held to). The card's machine has one card, and NCCL takes
# one card per rank. The 2 x 2 capacity world drops tokens per group of 64
# rows, each data rank's rows interleaved from the epoch's order by the
# sampler; no run of one process groups those rows so, so it is held to
# the one-process capacity run (one group of 256) only loosely
# (``LOOSE_HOLDS``), and to the JAX step by tests/test_torch_moe.py.
SPAWN_MOE_ARGS = ["--model", "moe_mlp", "--dataset", "synthetic",
                  "--synthetic-train-size", "2048", "--synthetic-test-size",
                  "512", "--batch-size", "256", "--seed", str(SEED),
                  "--epochs", "1", "--device", "cpu"]
PARALLEL_WORLDS = [
    ("ep2_dense", 2, SPAWN_MOE_ARGS + ["--expert-parallel", "2"],
     {"data": 1, "expert": 2}, "moe_one"),
    ("ep2_capacity", 4, SPAWN_MOE_ARGS + ["--expert-parallel", "2",
                                          "--moe-dispatch", "capacity"],
     {"data": 2, "expert": 2}, "moe_capacity_one"),
    ("zero1", 2, SPAWN_CPU_ARGS + ["--dtype", "f32",
                                   "--optimizer-sharding", "zero1"],
     {"data": 2}, "linear_one_f32"),
    ("zero3", 4, SPAWN_CPU_ARGS + ["--dtype", "f32",
                                   "--optimizer-sharding", "zero3"],
     {"data": 4}, "linear_one_f32"),
]


# Reference runs held loosely, with the reason: (losses, accuracy points).
LOOSE_HOLDS = {"moe_capacity_one": (5e-3, 1.0, "other token groups: the "
                                    "2 x 2 world's capacity and drops are "
                                    "per 64 interleaved rows")}


def _spawn_parallel_worlds(root: str) -> dict:
    """``PARALLEL_WORLDS`` through ``--spawn`` on the CPU, each a process
    of its own, ``TP_SP_THREADS`` at a time while this process runs the
    one-process references: each must exit 0, print its mesh and one
    epoch line, and hold its line to the same flags' run without EP or
    ZeRO (losses within 1e-5, accuracies within one example;
    ``LOOSE_HOLDS`` names the looser ones): EP and ZeRO are layout
    changes. Only here do EP and ZeRO run across ranks: the card's
    machine has one card."""
    from concurrent.futures import ThreadPoolExecutor

    out = {"note": "expert parallelism and ZeRO across 2 or more ranks run "
                   "here only, as gloo worlds on the CPU: the card's "
                   "machine has one card"}
    with ThreadPoolExecutor(TP_SP_THREADS) as pool:
        worlds = {name: pool.submit(_chaos_run, [
            "--spawn", str(n), *argv, "--checkpoint-dir",
            os.path.join(root, name)])
            for name, n, argv, _, _ in PARALLEL_WORLDS}
        refs = {}
        for ref, argv in (("moe_one", SPAWN_MOE_ARGS),
                          ("moe_capacity_one",
                           SPAWN_MOE_ARGS + ["--moe-dispatch", "capacity"]),
                          ("linear_one_f32",
                           SPAWN_CPU_ARGS + ["--dtype", "f32"])):
            _, text = _run_cli(argv + ["--checkpoint-dir",
                                       os.path.join(root, ref)])
            refs[ref] = _train_lines(text, "Epoch: ")
        for name, n, argv, mesh, ref in PARALLEL_WORLDS:
            proc, wall = worlds[name].result()
            lines = _train_lines(proc.stdout, "Epoch: ")
            devices = _train_lines(proc.stdout, "devices: ")
            want_dev = f"devices: {n} (cpu), processes: {n}, mesh: {mesh}"
            if proc.returncode != 0 or len(lines) != 1 \
                    or devices != [want_dev]:
                raise AssertionError(f"{name}: exit {proc.returncode}\n"
                                     f"{proc.stdout}\n{proc.stderr}")
            loss_tol, acc_tol, why = LOOSE_HOLDS.get(ref, (1e-5, 100 / 2048,
                                                           None))
            if not _lines_close(lines, refs[ref], loss_tol, acc_tol):
                raise AssertionError(f"{name} printed {lines}; {ref} "
                                     f"printed {refs[ref]}")
            out[name] = {"world": n, "wall_s": wall, "epoch_lines": lines,
                         "devices_line": devices[0], "held_to": ref,
                         "reference_lines": refs[ref], "loss_tol": loss_tol,
                         "acc_tol_points": acc_tol, "loose_because": why}
    print("chip_smoke.py: " + out["note"], flush=True)
    return out


# The weight-distribution path (--publish delta, the manifest and its
# chunks, --async-checkpoint) and the servers that fetch it; then
# --debug-nans and --profile-dir.
PUBLISH_FLAGS = ["--publish", "delta", "--chunk-mb", "1",
                 "--async-checkpoint", "--keep-last", "1"]
PUBLISH_CHUNK_MB = 1.0
PUBLISH_REPEATS = 3  # each publish time is the median of this many


def _median_ms(fn, repeats: int = PUBLISH_REPEATS) -> float:
    import statistics

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _publish_timings(ckpt: str, device_flag: str) -> dict:
    """Wall ms of one epoch's publish of the cnn's train state on the card
    (median of ``PUBLISH_REPEATS``), the full npz against the delta
    manifest: a delta publish into an empty store (every chunk new), of
    epoch 1's state after epoch 0's (adjacent epochs of the run: every
    leaf moved), and of an unchanged state (every chunk shared). Each
    includes the copy off the card."""
    import shutil

    import torch

    from pytorch_distributed_mnist_tpu_torch.distrib import publish
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )

    device = torch.device(device_flag)
    states = []
    for epoch in (0, 1):
        state = create_train_state(get_model("cnn"), SEED, device,
                                   optimizer="adam_pallas")
        load_checkpoint(os.path.join(ckpt, f"checkpoint_{epoch}.manifest"),
                        state)
        states.append(state)
    out = os.path.join(os.path.dirname(ckpt), "publish_timing")
    kw = dict(best_acc=0.0, is_best=False, keep_last=0)

    def fresh(mode, state, epoch):
        def run():
            shutil.rmtree(out, ignore_errors=True)
            save_checkpoint(state, epoch=epoch, directory=out, publish=mode,
                            chunk_mb=PUBLISH_CHUNK_MB, **kw)
        return run

    row = {"full_ms": _median_ms(fresh("full", states[1], 1)),
           "delta_cold_ms": _median_ms(fresh("delta", states[1], 1))}
    row["delta_cold"] = dict(publish.last_publish)

    def adjacent():
        shutil.rmtree(out, ignore_errors=True)
        save_checkpoint(states[0], epoch=0, directory=out, publish="delta",
                        chunk_mb=PUBLISH_CHUNK_MB, **kw)
        t0 = time.perf_counter()
        save_checkpoint(states[1], epoch=1, directory=out, publish="delta",
                        chunk_mb=PUBLISH_CHUNK_MB, **kw)
        return (time.perf_counter() - t0) * 1e3

    row["delta_adjacent_ms"] = sorted(adjacent()
                                      for _ in range(PUBLISH_REPEATS))[
        PUBLISH_REPEATS // 2]
    row["delta_adjacent"] = dict(publish.last_publish)
    row["delta_unchanged_ms"] = _median_ms(
        lambda: save_checkpoint(states[1], epoch=2, directory=out,
                                publish="delta", chunk_mb=PUBLISH_CHUNK_MB,
                                **kw))
    row["delta_unchanged"] = dict(publish.last_publish)
    if row["delta_unchanged"]["bytes_new"] != 0:
        raise AssertionError(f"an unchanged state's publish wrote "
                             f"{row['delta_unchanged']}")
    shutil.rmtree(out, ignore_errors=True)
    return row


def phase_train_publish(want_lines: list, device_flag: str = "cuda") -> dict:
    """The cnn run of ``train`` with ``PUBLISH_FLAGS``: delta publish in
    1 MiB chunks, the asynchronous saver, a window of one epoch. Its epoch
    lines must equal ``want_lines`` (``train``'s) character for character
    and its kernels' launch counts ``train``'s; each epoch is a manifest
    with the 32 leaves of the state (no npz anywhere), the chunk store
    holds exactly the chunks the manifests on disk name (the GC ran), a
    resume from ``checkpoint_0.manifest`` repeats epoch 1's line and
    ``-e`` on ``model_best.manifest`` prints one test line. Reports the
    async drains' ms and the publish timings (``_publish_timings``).
    Returns ``{"launches", "dir", "root"}``: the run's directory stays for
    ``server_delta``, and the caller removes ``root``."""
    from pytorch_distributed_mnist_tpu_torch.distrib.cas import (
        ChunkStore,
        manifest_digests,
        read_manifest,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        read_checkpoint_arrays,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_publish_")
    ckpt = os.path.join(root, "run")
    base = TRAIN_ARGS + ["--device", device_flag]
    # The main path's run starts here.
    _zero_counters("cnn")
    t0 = time.perf_counter()
    summary, out = _run_cli(base + PUBLISH_FLAGS + [
        "--epochs", str(TRAIN_EPOCHS), "--checkpoint-dir", ckpt])
    wall_s = time.perf_counter() - t0
    launches = _read_counters("cnn")
    # ... and ends here.
    lines = _train_lines(out, "Epoch: ")
    if lines != want_lines:
        raise AssertionError(f"train_publish printed\n{lines}\nwhere train "
                             f"printed\n{want_lines}")
    if launches != _want_launches("cnn"):
        raise AssertionError(f"train_publish: launch counts {launches}, "
                             f"expected {_want_launches('cnn')}")
    publishes = _train_lines(out, "delta publish: ")
    if len(publishes) != TRAIN_EPOCHS:
        raise AssertionError(f"delta publish lines: {publishes}")
    files = sorted(os.listdir(ckpt))
    want_files = ["checkpoint_0.manifest", "checkpoint_1.manifest", "chunks",
                  "model_best.manifest"]
    if files != want_files:
        raise AssertionError(f"checkpoint files: {files}")
    named = set()
    for name in want_files:
        if name == "chunks":
            continue
        path = os.path.join(ckpt, name)
        named |= manifest_digests(read_manifest(path))
        meta, leaves = read_checkpoint_arrays(path)
        if len(leaves) != TRAIN_RUNS["cnn"]["leaves"]:
            raise AssertionError(f"{name} holds {len(leaves)} leaves")
    stored = ChunkStore(ckpt).digests()
    if stored != named:
        raise AssertionError(f"{len(stored)} chunks stored, the manifests "
                             f"name {len(named)}")
    _, resumed_out = _run_cli(base + [
        "--epochs", str(TRAIN_EPOCHS), "--checkpoint-dir",
        os.path.join(root, "resumed"), "--resume",
        os.path.join(ckpt, "checkpoint_0.manifest")])
    resumed = _train_lines(resumed_out, "Epoch: ")
    if resumed != lines[1:]:
        raise AssertionError(f"resume from the manifest did not repeat "
                             f"epoch 1:\n{lines[1:]}\n{resumed}")
    _, eval_out = _run_cli(base + [
        "-e", "--checkpoint-dir", os.path.join(root, "eval"), "--resume",
        os.path.join(ckpt, "model_best.manifest")])
    test_lines = _train_lines(eval_out, "Test Loss: ")
    if len(test_lines) != 1 or _train_lines(eval_out, "Epoch: "):
        raise AssertionError(f"-e printed:\n{eval_out}")
    timings = _publish_timings(ckpt, device_flag)
    emit("train_publish", flags=PUBLISH_FLAGS, epoch_lines=lines,
         equal_to_train=True, launches=launches, publish_lines=publishes,
         files=files, chunks=len(stored),
         chunk_bytes=sum(os.path.getsize(ChunkStore(ckpt).path(d))
                         for d in stored),
         resumed_epoch_lines=resumed, eval_line=test_lines[0],
         drain_ms=summary["checkpoint_drain_ms"], wall_s=wall_s,
         images_per_sec=[r["images_per_sec"] for r in summary["history"]],
         publish_ms=timings)
    return {"launches": launches, "dir": ckpt, "root": root}


def _boot(argv: list):
    """A port server booted in-process from ``argv`` and serving on a
    thread: ``(httpd, client, thread)``."""
    from pytorch_distributed_mnist_tpu_torch.serve.server import (
        build_parser,
        create_server,
    )

    httpd = create_server(build_parser().parse_args(argv))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, _Client(httpd.server_address[1]), thread


def _wait_epoch(client, epoch: int, what: str) -> None:
    deadline = time.monotonic() + 30.0
    while client.get("/healthz")["model_epoch"] != epoch:
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: model_epoch did not reach {epoch}")
        time.sleep(0.05)


def _copy_manifest(src: str, directory: str) -> None:
    """A manifest placed into a server's watch directory (tmp + rename),
    as a fleet's rollout places it: the chunks stay behind."""
    import shutil

    dest = os.path.join(directory, os.path.basename(src))
    shutil.copyfile(src, dest + ".tmp")
    os.replace(dest + ".tmp", dest)


def _replies_match(client, ref, requests: list, epoch: int,
                   who: str) -> None:
    for x in requests:
        reply = client.post("/predict", {"images": x.tolist()})
        if reply["model_epoch"] != epoch:
            raise AssertionError(f"{who}: reply at epoch "
                                 f"{reply['model_epoch']}, expected {epoch}")
        if reply["predictions"] != ref.predict(x).tolist():
            raise AssertionError(f"{who}: a reply disagrees with the plain "
                                 f"int8 engine at epoch {epoch}")


def phase_server_delta(ckpt: str, device_flag: str = "cuda") -> dict:
    """Two port servers on the trainer's delta publishes (``--serve-precision
    int8``, fused plane): A boots on ``ckpt`` (``train_publish``'s run, from
    its newest manifest through the delta fetcher); B has ``--chunk-peers``
    A and an empty watch directory, into which the manifest is copied:
    B fetches every params chunk from A (none from a source) and only the
    params, never the optimizer's moments. Both servers' sequential
    replies must equal the same engine with ``matmul_i8_plain`` on the
    params loaded whole from ``ckpt``. Then a publish of epoch 1's state
    with its smallest params leaf moved (``--keep-last 1``: epoch 0's
    manifest is pruned and the chunks only it named are collected): A
    reloads it with 1 dirty leaf, B (the manifest copied again) too, from
    A, and the replies again equal the plain engine's on the new params.
    The int8 kernel's launch count rises over the phase and again over
    the reload, and a trace of one int8 forward names it."""
    import shutil

    import numpy as np
    import torch

    from pytorch_distributed_mnist_tpu_torch.distrib import publish
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        matmul_i8,
        matmul_i8_plain,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        load_params_for_serving,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        read_checkpoint_arrays,
    )

    device = torch.device(device_flag)
    b_dir = tempfile.mkdtemp(prefix="chip_smoke_server_b_")
    serve = ["--model", "cnn", "--serve-precision", "int8", "--port", "0",
             "--device", device_flag, "--poll-interval", "0.2"]
    newest = latest_checkpoint(ckpt)
    epoch = int(os.path.basename(newest).split("_")[1].split(".")[0])
    matmul_i8.launches = 0  # the main path's run starts here
    a, client_a, thread_a = _boot(serve + ["--checkpoint-dir", ckpt,
                                           "--require-checkpoint"])
    b = None
    try:
        a_url = f"http://127.0.0.1:{a.server_address[1]}"
        b, client_b, thread_b = _boot(serve + ["--checkpoint-dir", b_dir,
                                               "--chunk-peers", a_url])
        t0 = time.perf_counter()
        _copy_manifest(newest, b_dir)
        _wait_epoch(client_b, epoch, "B")
        b_install_s = time.perf_counter() - t0
        b_first = dict(b.ctx.fetcher.last)
        a_boot = dict(a.ctx.fetcher.last)
        params_bytes = sum(v.nbytes for n, v in
                           read_checkpoint_arrays(newest)[1].items()
                           if n.startswith("['params']"))
        if (b_first["bytes_source"] != 0
                or b_first["dirty_leaves"] != TRAIN_RUNS["cnn"]["params"]
                or b_first["bytes_peer"] != params_bytes):
            raise AssertionError(f"B's first fetch: {b_first}")
        requests = _requests(12, seed=SEED + 30)
        ref = _engine(load_params_for_serving(newest, "cnn")[0], device,
                      matmul_i8_plain)
        _replies_match(client_a, ref, requests, epoch, "A")
        _replies_match(client_b, ref, requests, epoch, "B")
        before_reload = matmul_i8.launches
        if before_reload == 0:
            raise AssertionError("the int8 servers launched no matmul_i8")

        meta, leaves = read_checkpoint_arrays(newest)
        params = [n for n in leaves if n.startswith("['params']")]
        small = min(params, key=lambda n: leaves[n].size)
        leaves = dict(leaves)
        leaves[small] = leaves[small].copy()
        leaves[small].flat[0] += np.float32(0.25)
        t0 = time.perf_counter()
        path = publish.publish_arrays(
            list(leaves.items()), epoch=epoch + 1,
            best_acc=meta["best_acc"], directory=ckpt,
            chunk_mb=PUBLISH_CHUNK_MB, keep_last=1, world=meta["world"],
            parallel_layout=meta.get("parallel_layout"))
        publish_ms = (time.perf_counter() - t0) * 1e3
        gc = dict(publish.last_publish)
        if os.path.exists(os.path.join(ckpt, "checkpoint_0.manifest")) \
                or gc["bytes_freed"] <= 0:
            raise AssertionError(f"the keep-last window's prune and GC: "
                                 f"{os.listdir(ckpt)} {gc}")
        _wait_epoch(client_a, epoch + 1, "A")
        _copy_manifest(path, b_dir)
        _wait_epoch(client_b, epoch + 1, "B")
        a_delta, b_delta = dict(a.ctx.fetcher.last), dict(b.ctx.fetcher.last)
        for who, got in (("A", a_delta), ("B", b_delta)):
            if got["dirty_leaves"] != 1 or got["clean_leaves"] != \
                    TRAIN_RUNS["cnn"]["params"] - 1:
                raise AssertionError(f"{who}'s delta install: {got}")
        if (b_delta["bytes_source"] != 0
                or b_delta["bytes_peer"] != leaves[small].nbytes):
            raise AssertionError(f"B's delta fetch: {b_delta}")
        ref2 = _engine(load_params_for_serving(path, "cnn")[0], device,
                       matmul_i8_plain)
        _replies_match(client_a, ref2, requests, epoch + 1, "A")
        _replies_match(client_b, ref2, requests, epoch + 1, "B")
        launches = matmul_i8.launches  # the main path's run ends here
        if launches <= before_reload:
            raise AssertionError("no matmul_i8 launch after the reload")
        traced = None
        if device.type == "cuda":  # a CPU rehearsal traces no card
            with device_trace() as prof:
                a.ctx.engine.logits(requests[0])
                torch.cuda.synchronize()
            traced = sorted({e.name[:60] for e in prof.events()
                             if e.device_type
                             == torch.autograd.DeviceType.CUDA
                             and "matmul_i8" in e.name})
            if not traced:
                raise AssertionError("a traced int8 forward names no "
                                     "matmul_i8 kernel")
        emit("server_delta", epoch=epoch, b_first_fetch=b_first,
             a_boot=a_boot, b_install_s=b_install_s,
             perturbed_leaf=small, publish_ms=publish_ms, publish=gc,
             a_delta=a_delta, b_delta=b_delta, replies_exact=True,
             requests=len(requests), launches=launches,
             launches_before_reload=before_reload,
             traced_int8_kernels=traced)
        return {"launches": launches}
    finally:
        for httpd in (a, b):
            if httpd is not None:
                httpd.shutdown()
                httpd.ctx.close()
                httpd.server_close()
        shutil.rmtree(b_dir, ignore_errors=True)


def _poisoned_checkpoint(ckpt: str, out: str) -> str:
    """Epoch 0's checkpoint of ``ckpt`` with one element of the first
    params kernel set to NaN, as ``checkpoint_0.npz`` in ``out``."""
    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        _write_npz,
        read_checkpoint_arrays,
    )

    meta, leaves = read_checkpoint_arrays(
        os.path.join(ckpt, "checkpoint_0.npz"))
    name = next(n for n in leaves if n.startswith("['params']")
                and n.endswith("['kernel']"))
    leaves = dict(leaves)
    leaves[name] = leaves[name].copy()
    leaves[name].flat[0] = np.nan
    return _write_npz(list(leaves.items()), epoch=0,
                      best_acc=meta["best_acc"], directory=out)


def _kernel_checks(device) -> dict:
    """The hand-written kernels' own checks under ``--debug-nans``'s mode:
    a NaN logit into the xent forward and backward, and a NaN gradient
    into Adam, each must raise ``FloatingPointError`` naming the kernel
    (a dispatch mode cannot see inside a kernel)."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import adam, xent
    from pytorch_distributed_mnist_tpu_torch.utils import debug_nans

    if device.type != "cuda":
        return {}  # the plain versions on the CPU are the mode's to check
    logits = torch.randn(TRAIN_BATCH, CLASSES, device=device)
    logits[3, 4] = float("nan")
    labels = torch.randint(0, CLASSES, (TRAIN_BATCH,), device=device)
    lse = torch.zeros(TRAIN_BATCH, device=device)
    g = torch.ones(TRAIN_BATCH, device=device)
    p, grad = torch.ones(1000, device=device), torch.ones(1000, device=device)
    grad[7] = float("nan")
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    hyper = {k: torch.tensor(x, device=device) for k, x in (
        ("learning_rate", 1e-3), ("b1", 0.9), ("b2", 0.999), ("eps", 1e-8),
        ("eps_root", 0.0))}
    count = torch.ones((), dtype=torch.int32, device=device)
    calls = {"xent_fwd": lambda: xent.xent_fwd(logits, labels),
             "xent_bwd": lambda: xent.xent_bwd(logits, labels, lse, g),
             "adam": lambda: adam.adam_leaves([p], [grad], [m], [v], hyper,
                                              count)}
    out = {}
    with debug_nans.enabled_for(True):
        for name, call in calls.items():
            try:
                with debug_nans.NanCheckMode():
                    call()
            except FloatingPointError as exc:
                if f"the {name} kernel" not in str(exc):
                    raise
                out[name] = str(exc)
            else:
                raise AssertionError(f"the {name} kernel's NaN went unseen")
    torch.cuda.synchronize()
    return out


DEBUG_MODES = ("scan", "stepwise", "explicit")


def phase_train_debug_nans(want_lines: list,
                           device_flag: str = "cuda") -> dict:
    """``--debug-nans`` on the cnn run. In each trainer mode a run without
    the flag and one with it, back to back: both must print ``want_lines``
    (``train``'s) character for character, with ``train``'s launch
    counts; the flag's extra wall is their difference. Then each mode
    resumes with it from a checkpoint whose first params kernel holds a
    NaN and must raise ``FloatingPointError`` naming the aten op (scan:
    after its eager re-run of the pass). Then the kernels' own checks
    (``_kernel_checks``)."""
    import shutil

    import torch

    root = tempfile.mkdtemp(prefix="chip_smoke_nans_")
    base = TRAIN_ARGS + ["--device", device_flag, "--epochs",
                         str(TRAIN_EPOCHS)]
    rows, launches = {}, None
    try:
        for mode in DEBUG_MODES:
            walls = {}
            for flag in ([], ["--debug-nans"]):
                _zero_counters("cnn")
                t0 = time.perf_counter()
                _, out = _run_cli(base + ["--trainer-mode", mode,
                                          "--checkpoint-dir", os.path.join(
                                              root, f"{mode}{len(flag)}")]
                                  + flag)
                walls[bool(flag)] = time.perf_counter() - t0
                got = _read_counters("cnn")
                lines = _train_lines(out, "Epoch: ")
                if lines != want_lines:
                    raise AssertionError(f"{mode} {flag} printed\n{lines}\n"
                                         f"where train printed\n{want_lines}")
                if got != _want_launches("cnn"):
                    raise AssertionError(f"{mode} {flag}: launch counts "
                                         f"{got}")
                if flag and mode == "scan":
                    launches = got
            bad = _poisoned_checkpoint(os.path.join(root, f"{mode}0"),
                                       os.path.join(root, f"bad_{mode}"))
            t0 = time.perf_counter()
            try:
                _run_cli(base + ["--trainer-mode", mode, "--debug-nans",
                                 "--resume", bad, "--start-epoch", "0",
                                 "--checkpoint-dir",
                                 os.path.join(root, f"poisoned_{mode}")])
            except FloatingPointError as exc:
                error = str(exc)
            else:
                raise AssertionError(f"{mode}: the poisoned run raised "
                                     f"nothing")
            if "aten." not in error:
                raise AssertionError(f"{mode}: {error}")
            rows[mode] = {"wall_s": walls[False],
                          "debug_nans_wall_s": walls[True],
                          "extra_wall_s": walls[True] - walls[False],
                          "poisoned_error": error,
                          "poisoned_wall_s": time.perf_counter() - t0}
        kernels = _kernel_checks(torch.device(device_flag))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("train_debug_nans", modes=rows, epoch_lines_equal=True,
         launches=launches, kernel_checks=kernels)
    return {"launches": launches}


PROFILE_DIR_SPANS = ("train", "eval", "checkpoint")
PROFILE_DIR_KERNELS = ("xent_fwd_kernel", "xent_bwd_kernel",
                       "adam_leaves_kernel")


def phase_train_profile_dir(want_lines: list,
                            device_flag: str = "cuda") -> dict:
    """The cnn run with ``--profile-dir``: ``train``'s epoch lines and
    launch counts, and one non-empty Chrome trace holding the ``train``,
    ``eval`` and ``checkpoint`` spans of each epoch and the xent and Adam
    kernels by name (the captured graph's replays included); the int8
    kernel is not on the training path (``server_delta`` traces it)."""
    import shutil

    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        trace_path,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_profile_dir_")
    try:
        _zero_counters("cnn")
        t0 = time.perf_counter()
        _, out = _run_cli(TRAIN_ARGS + [
            "--device", device_flag, "--epochs", str(TRAIN_EPOCHS),
            "--checkpoint-dir", os.path.join(root, "run"),
            "--profile-dir", os.path.join(root, "trace")])
        wall_s = time.perf_counter() - t0
        launches = _read_counters("cnn")
        lines = _train_lines(out, "Epoch: ")
        if lines != want_lines:
            raise AssertionError(f"train_profile_dir printed\n{lines}\nwhere "
                                 f"train printed\n{want_lines}")
        if launches != _want_launches("cnn"):
            raise AssertionError(f"train_profile_dir: launch counts "
                                 f"{launches}")
        path = trace_path(os.path.join(root, "trace"), 0)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = {}
        kernels = {}
        for evt in events:
            name = evt.get("name", "")
            if (name in PROFILE_DIR_SPANS
                    and evt.get("cat") == "user_annotation"):
                spans[name] = spans.get(name, 0) + 1
            for kernel in PROFILE_DIR_KERNELS:
                if kernel in name and evt.get("cat") == "kernel":
                    kernels[kernel] = kernels.get(kernel, 0) + 1
        if any(spans.get(s, 0) < TRAIN_EPOCHS for s in PROFILE_DIR_SPANS) \
                or (device_flag == "cuda"
                    and set(kernels) != set(PROFILE_DIR_KERNELS)):
            raise AssertionError(f"the trace holds spans {spans} and "
                                 f"kernels {kernels}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("train_profile_dir", epoch_lines_equal=True, launches=launches,
         trace_bytes=size, spans=spans, kernels=kernels, wall_s=wall_s)
    return {"launches": launches}


# -- run supervision and the native host path -------------------------------

# The smoke's own sizes for the native entry points: the 8192-image train
# epoch gathered at batch 256, the server's buckets padded.
NATIVE_EPOCH = 8192
NATIVE_REPEATS = 5  # each host time is the median of this many calls


def _host_ms(fn) -> float:
    """Median wall ms of ``NATIVE_REPEATS`` calls of ``fn`` on the host."""
    import statistics

    times = []
    for _ in range(NATIVE_REPEATS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _same_bits(a, b) -> bool:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def phase_native_vs_plain() -> dict:
    """The native host library (``data/native.py``): built from
    ``native/tpumnist_native.cpp`` into the build directory (its seconds,
    ``tm_version()`` 4, its path), then each entry point against its NumPy
    expression, bitwise, at the smoke's sizes: the normalize and the
    epoch gather of the 8192-image train set at batch 256, the staging pad
    at buckets 1/8/32/128, the int8 quantize and the float64 cast of a
    bucket-128 batch; each one's host ms both ways."""
    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.data import native
    from pytorch_distributed_mnist_tpu_torch.data.loader import (
        MNISTDataLoader,
    )
    from pytorch_distributed_mnist_tpu_torch.data.mnist import (
        MNIST_MEAN,
        MNIST_STD,
        synthetic_dataset,
    )
    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
    from pytorch_distributed_mnist_tpu_torch.serve.programs import ACT_SCALE

    t0 = time.perf_counter()
    lib = native.load()
    load_s = time.perf_counter() - t0
    version = lib.tm_version()
    path = native.build_info["path"]
    if version != native.VERSION or not path.startswith(
            cuda_build.BUILD_ROOT + os.sep):
        raise AssertionError(f"native library {path} version {version}")
    images, labels = synthetic_dataset(NATIVE_EPOCH, seed=SEED)
    rows = {}

    def check(name, got_fn, want_fn):
        got, want = got_fn(), want_fn()
        if isinstance(got, tuple):
            same = all(_same_bits(g, w) for g, w in zip(got, want))
        else:
            same = _same_bits(got, want)
        if not same:
            raise AssertionError(f"native {name} differs from NumPy")
        rows[name] = {"bitwise": True, "native_ms": _host_ms(got_fn),
                      "numpy_ms": _host_ms(want_fn)}

    check("normalize",
          lambda: native.normalize_images(images, MNIST_MEAN, MNIST_STD, 4),
          lambda: ((images.astype(np.float32) / 255.0 - MNIST_MEAN)
                   / MNIST_STD)[..., None])
    x = native.normalize_images(images, MNIST_MEAN, MNIST_STD, 4)
    loader = MNISTDataLoader(x, labels, batch_size=TRAIN_BATCH, train=True,
                             seed=SEED)
    m, _ = loader.epoch_ticks(1)
    labels32 = labels.astype(np.int32)
    check("gather",
          lambda: native.gather_epoch(x, labels32, m, 4),
          lambda: (x[m.reshape(-1)].reshape(m.shape + x.shape[1:]),
                   labels32[m.reshape(-1)].reshape(m.shape)))
    for bucket in PATH_BUCKETS:
        src = x[:max(1, bucket - bucket // 3)]

        def pad_native(src=src, bucket=bucket):
            dst = np.empty((bucket,) + x.shape[1:], np.float32)
            if not native.pad_into(dst, src, workers=4):
                raise AssertionError("pad_into refused a float32 batch")
            return dst

        def pad_numpy(src=src, bucket=bucket):
            dst = np.empty((bucket,) + x.shape[1:], np.float32)
            dst[:len(src)] = src
            dst[len(src):] = 0.0
            return dst

        check(f"pad_copy_b{bucket}", pad_native, pad_numpy)
    batch = np.ascontiguousarray(x[:128])
    inv = np.float32(1.0) / ACT_SCALE
    check("quant_i8", lambda: native.quant_i8(batch, float(ACT_SCALE), 4),
          lambda: np.clip(np.rint(batch * inv), -127, 127).astype(np.int8))
    f64 = batch.astype(np.float64) * 1.25
    check("cast_f32", lambda: native.cast_f32(f64, 4),
          lambda: f64.astype(np.float32))
    row = {"build_s": native.build_info["seconds"], "load_s": load_s,
           "version": version,
           "path": os.path.relpath(path, _HERE), "entry_points": rows,
           "host_note": "host wall ms on the card's host CPU, median of "
                        f"{NATIVE_REPEATS} calls, 4 threads"}
    emit("native_vs_plain", **row)
    return row


def phase_train_native_off(want_lines: list, native_staging: dict,
                           device_flag: str = "cuda") -> dict:
    """The cnn run of ``train`` (whose epochs the native library gathers)
    with ``TPUMNIST_NATIVE=0`` (NumPy normalizes and gathers): its epoch
    lines must equal ``train``'s character for character, and its kernel
    launches ``train``'s counts. The staging log's host-gather ms both
    ways are reported, with no gate."""
    import shutil

    root = tempfile.mkdtemp(prefix="chip_smoke_native_off_")
    saved = os.environ.get("TPUMNIST_NATIVE")
    os.environ["TPUMNIST_NATIVE"] = "0"
    try:
        _zero_counters("cnn")  # the main path's run starts here
        summary, out = _run_cli(TRAIN_ARGS + [
            "--device", device_flag, "--epochs", str(TRAIN_EPOCHS),
            "--checkpoint-dir", root])
        launches = _read_counters("cnn")  # ... and ends here
    finally:
        if saved is None:
            os.environ.pop("TPUMNIST_NATIVE", None)
        else:
            os.environ["TPUMNIST_NATIVE"] = saved
        shutil.rmtree(root, ignore_errors=True)
    lines = _train_lines(out, "Epoch: ")
    if lines != want_lines:
        raise AssertionError(f"TPUMNIST_NATIVE=0 printed\n{lines}\nwhere "
                             f"the native run printed\n{want_lines}")
    if launches != _want_launches("cnn"):
        raise AssertionError(f"launch counts {launches}, expected "
                             f"{_want_launches('cnn')}")
    staging = summary["staging"]
    row = {"epoch_lines_equal": True, "launches": launches,
           "host_gather_ms": {"native": native_staging["host_ms"],
                              "numpy": staging["host_ms"]},
           "stages": {"native": native_staging["stages"],
                      "numpy": staging["stages"]},
           "staging_native": native_staging, "staging_numpy": staging}
    emit("train_native_off", **row)
    return row


def phase_train_fault_resume(want_lines: list,
                             device_flag: str = "cuda") -> dict:
    """The cnn run as a process with ``TPUMNIST_FAULT=train_epoch:0:kill:1``:
    it must die by SIGKILL at epoch 1's entry with ``checkpoint_0``
    written; then the same command with ``--resume auto`` (in this
    process, so the wrappers' counters are read): epoch 1's line must
    equal ``train``'s, and the kernels launch exactly one epoch's counts
    (half of ``train``'s). Then ``--trainer-mode stepwise`` in a world of
    one through the explicit rendezvous (NCCL on the card) with
    ``TPUMNIST_FAULT=train_step:0:raise:5``: it must exit 1, its stderr
    naming ``InjectedFault`` and phase ``train@0``, and its metrics file
    holding the ``run_failed`` event."""
    import shutil

    root = tempfile.mkdtemp(prefix="chip_smoke_fault_")
    ckpt = os.path.join(root, "run")
    argv = TRAIN_ARGS + ["--device", device_flag, "--epochs",
                         str(TRAIN_EPOCHS), "--checkpoint-dir", ckpt]
    env = dict(os.environ, PYTHONPATH=_HERE)
    metrics = os.path.join(root, "raise.jsonl")

    def raising_run():
        # The world of one that raises runs beside the killed run: both
        # are processes of their own, and only their exits are checked.
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
             *TRAIN_ARGS, "--device", device_flag, "--epochs", "1",
             "--trainer-mode", "stepwise", "--checkpoint-dir",
             os.path.join(root, "raise"), "--metrics-file", metrics,
             *_rendezvous()], capture_output=True, text=True, timeout=300,
            cwd=_HERE, env=dict(env, TPUMNIST_FAULT="train_step:0:raise:5"))
        return proc, time.perf_counter() - t0

    raising = _Background(raising_run)
    try:
        t0 = time.perf_counter()
        killed = subprocess.run(
            [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
             *argv], capture_output=True, text=True, timeout=600, cwd=_HERE,
            env=dict(env, TPUMNIST_FAULT="train_epoch:0:kill:1"))
        killed_s = time.perf_counter() - t0
        files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
        if killed.returncode != -9 or files != ["checkpoint_0.npz",
                                                 "model_best.npz"]:
            raise AssertionError(f"the killed run: rc {killed.returncode}, "
                                 f"files {files}\n{killed.stdout}\n"
                                 f"{killed.stderr}")
        if "firing injected fault train_epoch:0:kill" not in killed.stderr \
                or _train_lines(killed.stdout, "Epoch: ") != want_lines[:1]:
            raise AssertionError(f"the killed run:\n{killed.stdout}\n"
                                 f"{killed.stderr}")

        _zero_counters("cnn")  # the main path's run starts here
        summary, out = _run_cli(argv + ["--resume", "auto"])
        launches = _read_counters("cnn")  # ... and ends here
        lines = _train_lines(out, "Epoch: ")
        if lines != want_lines[1:]:
            raise AssertionError(f"the resumed run printed\n{lines}\nwhere "
                                 f"train printed\n{want_lines[1:]}")
        want = _want_launches("cnn", epochs=1)
        if launches != want:
            raise AssertionError(f"resumed launches {launches}, expected "
                                 f"{want}")

        raised, raised_s = raising.result()
        events = []
        if os.path.isfile(metrics):
            with open(metrics) as f:
                events = [json.loads(ln) for ln in f if ln.strip()]
        failed = [e for e in events if e.get("kind") == "run_failed"]
        if (raised.returncode != 1 or "InjectedFault" not in raised.stderr
                or "phase 'train@0'" not in raised.stderr or len(failed) != 1
                or failed[0]["phase"] != "train@0"
                or "InjectedFault" not in failed[0]["detail"]):
            raise AssertionError(f"the raising run: rc {raised.returncode}, "
                                 f"events {events}\n{raised.stderr[-3000:]}")
    finally:
        raising.join()  # its files are under root
        shutil.rmtree(root, ignore_errors=True)
    row = {"killed": {"rc": killed.returncode, "wall_s": killed_s,
                      "files": files},
           "resumed": {"epoch_lines": lines, "equal_to_train": True,
                       "start_epoch": summary["start_epoch"],
                       "launches": launches, "expected_launches": want},
           "raised": {"rc": raised.returncode, "wall_s": raised_s,
                      "rendezvous": "tcp 127.0.0.1, 1 process, "
                                    + ("nccl" if device_flag == "cuda"
                                       else "gloo"),
                      "event": failed[0]}}
    emit("train_fault_resume", **row)
    return {"launches": launches}


# The CPU worlds of the chaos phase: the dp_spawn phase's linear run on
# 2048 synthetic images, 2 epochs.
CHAOS_ARGS = ["--model", "linear", "--dataset", "synthetic",
              "--synthetic-train-size", "2048", "--synthetic-test-size",
              "500", "--seed", str(SEED), "--epochs", "2"]
CHAOS_DEADLINE = "8"  # the agreement timeout of the faulted worlds


class _Background:
    """``fn()`` on a thread of its own, started at once; :meth:`result`
    joins it and returns its value or raises its error."""

    def __init__(self, fn) -> None:
        self._box = {}

        def run():
            try:
                self._box["value"] = fn()
            except BaseException as exc:  # raised by result()
                self._box["error"] = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self) -> None:
        self._thread.join()

    def result(self):
        self.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box["value"]


def _chaos_run(argv, fault=None, module="pytorch_distributed_mnist_tpu_torch"):
    """One process of ``module`` (a CPU world's launcher), its environment
    this one's with ``fault`` as ``TPUMNIST_FAULT``; (process, seconds)."""
    env = dict(os.environ, PYTHONPATH=_HERE, OMP_NUM_THREADS="1")
    env.pop("TPUMNIST_FAULT", None)
    if fault:
        env["TPUMNIST_FAULT"] = fault
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, timeout=600,
                          cwd=_HERE, env=env)
    return proc, time.perf_counter() - t0


def _chaos_kill(root: str) -> dict:
    """(a): the publish-agreement kill through ``runtime/chaos.py``."""
    proc, wall = _chaos_run(
        ["--fault", "ckpt_publish:1:kill", "--nprocs", "2",
         "--agreement-timeout", CHAOS_DEADLINE, "--", *CHAOS_ARGS,
         "--batch-size", "256", "--device", "cpu", "--checkpoint-dir",
         os.path.join(root, "a")],
        module="pytorch_distributed_mnist_tpu_torch.runtime.chaos")
    out = proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])["chaos"]
    faulted = result["faulted"]
    if (proc.returncode != 0 or faulted["returncodes"] != [75, -9]
            or result["twin"]["returncodes"] != [0, 0]
            or faulted["seconds"] > 60 or "PeerFailure" not in out
            or "host(s) [1]" not in out or "'ckpt_publish'" not in out):
        raise AssertionError(f"chaos (a): rc {proc.returncode}, "
                             f"{result}\n{out[-4000:]}")
    return {"fault": result["fault"], "returncodes": faulted["returncodes"],
            "faulted_s": faulted["seconds"],
            "twin_returncodes": result["twin"]["returncodes"],
            "twin_s": result["twin"]["seconds"], "wall_s": wall}


def _chaos_elastic(root: str) -> dict:
    """(b): the 3 -> 2 elastic shrink, then the direct 2-rank world."""
    el = os.path.join(root, "b")
    metrics = os.path.join(root, "b.jsonl")
    proc, wall = _chaos_run(["--spawn", "3", "--elastic", "--min-world", "2",
                             "--agreement-timeout", CHAOS_DEADLINE,
                             "--batch-size", "96", "--device", "cpu",
                             "--metrics-file", metrics, *CHAOS_ARGS,
                             "--checkpoint-dir", el],
                            fault="train_epoch:2:kill:1")
    out = proc.stdout + proc.stderr
    events = []
    if os.path.isfile(metrics):
        with open(metrics) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
    shrunk = [e for e in events if e.get("kind") == "world_shrunk"]
    lines = _train_lines(proc.stdout, "Epoch: ")
    resumed = f"=> loaded checkpoint '{el}/checkpoint_0.npz' (epoch 1)"
    if (proc.returncode != 0 or len(shrunk) != 1
            or shrunk[0]["new_members"] != [0, 1]
            or "generation 1: world size 2 (hosts [0, 1])" not in out
            or resumed not in proc.stdout or len(lines) != 2):
        raise AssertionError(f"chaos (b): rc {proc.returncode}, events "
                             f"{events}\n{out[-4000:]}")
    direct, direct_wall = _chaos_run(
        ["--spawn", "2", "--batch-size", "96", "--device", "cpu",
         *CHAOS_ARGS, "--resume", os.path.join(el, "checkpoint_0.npz"),
         "--checkpoint-dir", os.path.join(root, "direct")])
    direct_lines = _train_lines(direct.stdout, "Epoch: ")
    if direct.returncode != 0 or direct_lines != lines[1:]:
        raise AssertionError(f"the direct 2-rank world printed "
                             f"{direct_lines}, the shrunk one {lines[1:]}"
                             f"\n{direct.stderr[-3000:]}")
    return {"returncode": proc.returncode, "wall_s": wall,
            "world_shrunk": shrunk[0], "epoch_lines": lines,
            "direct_world_2_lines": direct_lines,
            "direct_wall_s": direct_wall, "epoch_1_equal": True}


def _chaos_slice(root: str) -> dict:
    """(c): the slice-loss twin through ``runtime/chaos.py --elastic
    --dcn-slices 2 --kill-slice 1``: 2 ranks as 2 emulated DCN slices,
    ZeRO-1, every rank of slice 1 killed inside epoch 1's step loop; the
    survivor lands on the flat mesh (``dcn_flat_fallback``), reshards the
    two-tier checkpoint and trains epochs 1 and 2."""
    metrics = os.path.join(root, "c.jsonl")
    proc, wall = _chaos_run(
        ["--elastic", "--dcn-slices", "2", "--kill-slice", "1", "--nprocs",
         "2", "--agreement-timeout", CHAOS_DEADLINE, "--no-twin", "--",
         "--device", "cpu", "--model", "linear", "--dataset", "synthetic",
         "--synthetic-train-size", "256", "--synthetic-test-size", "128",
         "--trainer-mode", "stepwise", "--seed", str(SEED), "--resume",
         "auto", "--epochs", "3", "--batch-size", "64",
         "--optimizer-sharding", "zero1", "--metrics-file", metrics,
         "--checkpoint-dir", os.path.join(root, "c")],
        module="pytorch_distributed_mnist_tpu_torch.runtime.chaos")
    out = proc.stdout + proc.stderr
    rows = []
    if os.path.isfile(metrics):
        with open(metrics) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
    kinds = {r.get("kind") for r in rows}
    shrunk = [r for r in rows if r.get("kind") == "world_shrunk"]
    fallback = [r for r in rows if r.get("kind") == "dcn_flat_fallback"]
    after = rows[rows.index(shrunk[0]) + 1:] if shrunk else []
    epochs = [r["epoch"] for r in after if "train_loss" in r]
    if (proc.returncode != 0 or len(shrunk) != 1 or not fallback
            or "flat" not in fallback[0]["detail"]
            or "checkpoint_reshard" not in kinds or epochs != [1, 2]
            or "mesh: {'dcn': 2, 'ici': 1}" not in out):
        raise AssertionError(f"chaos (c): rc {proc.returncode}, events "
                             f"{rows}\n{out[-4000:]}")
    return {"returncode": proc.returncode, "wall_s": wall,
            "world_shrunk": shrunk[0], "dcn_flat_fallback": fallback[0],
            "epochs_after_shrink": epochs}


def start_chaos_cpu() -> dict:
    """Start ``phase_chaos_cpu``'s two worlds, each on a thread (their
    processes run on the CPU only, so they can overlap the kernel builds,
    which leave most cores idle after their first seconds)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    return {"root": root, "t0": time.perf_counter(),
            "kill": _Background(lambda: _chaos_kill(root)),
            "elastic": _Background(lambda: _chaos_elastic(root)),
            "slice": _Background(lambda: _chaos_slice(root))}


def phase_chaos_cpu(started=None) -> dict:
    """Run supervision in gloo worlds on the host's CPU (on a host with
    one card a world of 2 or more ranks is possible only there),
    the two worlds side by side (``start_chaos_cpu``). (a)
    ``runtime/chaos.py``: a world of 2 with rank 1 SIGKILLed at the
    checkpoint publish agreement (``--agreement-timeout 8``): rank 0 must
    exit 75 with ``PeerFailure`` naming host 1 and ``ckpt_publish`` within
    60 s, and the twin with no fault must exit 0. (b) ``--spawn 3
    --elastic --min-world 2 --batch-size 96`` with rank 2 killed at epoch
    1's entry: generation 1 must run on 2 ranks resumed from
    ``checkpoint_0``, ``world_shrunk`` must be recorded, and rank 0's
    epoch-1 line must equal a direct 2-rank world's resumed from the same
    checkpoint. (c) ``--kill-slice 1`` on 2 emulated DCN slices
    (``_chaos_slice``): the survivor continues on the flat mesh."""
    import shutil

    started = started or start_chaos_cpu()
    try:
        row = {"kill_at_publish": started["kill"].result(),
               "elastic_shrink_3_to_2": started["elastic"].result(),
               "slice_loss_flat_fallback": started["slice"].result(),
               "wall_s": time.perf_counter() - started["t0"],
               "note": "both worlds ran side by side, beside the kernel "
                       "builds"}
    finally:
        shutil.rmtree(started["root"], ignore_errors=True)
    emit("chaos_cpu", **row)
    return row


# Tensor and sequence parallelism across ranks, as gloo worlds on the CPU
# (the card's machine has one card, and NCCL takes one card per rank): the
# ViT at --patch-size 7 (16 tokens, the JAX tests' shape) in float32 on
# 1024 images, 1 epoch (half the dp_spawn cut, to make room in the pool
# for hier_spawn's worlds). (name, world size, flags, the
# mesh its devices line prints, the run its epoch line is held to: a run
# of one process of the same flags, or, for the overlap, the unoverlapped
# TP world.)
SPAWN_VIT_ARGS = ["--model", "vit", "--patch-size", "7", "--dtype", "f32",
                  "--dataset", "synthetic", "--synthetic-train-size",
                  "1024", "--synthetic-test-size", "512", "--batch-size",
                  "256", "--seed", str(SEED), "--epochs", "1", "--device",
                  "cpu"]
VIT_KERNEL_FLAGS = ["--attention", "flash", "--loss", "fused",
                    "--optimizer", "adam_pallas"]
TP_SP_REFS = {"vit_one": [],
              "vit_flash_one": ["--attention", "flash"],
              "vit_kernels_one": VIT_KERNEL_FLAGS,
              "vit_remat_accum_one": ["--remat", "--grad-accum", "2"]}
TP_SP_WORLDS = [
    ("tp2", 2, ["--tensor-parallel", "2"],
     {"data": 1, "model": 2, "seq": 1}, "vit_one"),
    ("tp2_kernels", 2, ["--tensor-parallel", "2", *VIT_KERNEL_FLAGS],
     {"data": 1, "model": 2, "seq": 1}, "vit_kernels_one"),
    ("tp2_overlap", 2, ["--tensor-parallel", "2", "--tp-overlap"],
     {"data": 1, "model": 2, "seq": 1}, "tp2"),
    ("sp2_ring", 2, ["--sequence-parallel", "2"],
     {"data": 1, "model": 1, "seq": 2}, "vit_one"),
    ("sp2_ulysses_flash", 2, ["--sequence-parallel", "2",
                              "--sequence-parallel-impl", "ulysses",
                              "--attention", "flash"],
     {"data": 1, "model": 1, "seq": 2}, "vit_flash_one"),
    ("tp2_sp2", 4, ["--tensor-parallel", "2", "--sequence-parallel", "2"],
     {"data": 1, "model": 2, "seq": 2}, "vit_one"),
    ("tp2_zero1", 4, ["--tensor-parallel", "2", "--optimizer-sharding",
                      "zero1"], {"data": 2, "model": 2, "seq": 1},
     "vit_one"),
]
# Pipeline parallelism across ranks (``pp_spawn``), in the same pool: DP 2
# x PP 2 with the kernels' flags, PP 2 x TP 2, PP 2 x ZeRO-1 (moments
# stage x data) and PP 2 with --remat --grad-accum 2, each held to one
# process's run of the same flags (the pipeline is a layout change).
PP_WORLDS = [
    ("pp2_dp2_kernels", 4, ["--pipeline-stages", "2", *VIT_KERNEL_FLAGS],
     {"data": 2, "stage": 2}, "vit_kernels_one"),
    ("pp2_tp2", 4, ["--pipeline-stages", "2", "--tensor-parallel", "2"],
     {"data": 1, "stage": 2, "model": 2}, "vit_one"),
    ("pp2_zero1", 4, ["--pipeline-stages", "2", "--optimizer-sharding",
                      "zero1"], {"data": 2, "stage": 2}, "vit_one"),
    ("pp2_remat_accum", 2, ["--pipeline-stages", "2", "--remat",
                            "--grad-accum", "2"],
     {"data": 1, "stage": 2}, "vit_remat_accum_one"),
]


# The two-tier ('dcn', 'ici') mesh across ranks (``hier_spawn``), in the
# same pool: --dcn-slices 2 over 4 ranks, the linear model under ZeRO-1
# overlapped with its own DCN bucket budget against the flat world of 4
# (HIER_REFS), and TP 2 x ZeRO-1 (dense attention) nested in the slices
# against TP_SP_WORLDS' flat tp2_zero1. (name, world size, the full flags,
# the mesh its devices line prints, the run its epoch line is held to.)
HIER_ZERO_FLAGS = ["--optimizer-sharding", "zero1", "--zero-overlap"]
HIER_REFS = {"linear_zero1_overlap_flat": (4, [*SPAWN_CPU_ARGS,
                                               *HIER_ZERO_FLAGS])}
HIER_WORLDS = [
    ("hier_linear_zero1_overlap", 4,
     [*SPAWN_CPU_ARGS, *HIER_ZERO_FLAGS, "--dcn-slices", "2",
      "--zero-bucket-mb-dcn", "1"], {"dcn": 2, "ici": 2},
     "linear_zero1_overlap_flat"),
    ("hier_tp2_zero1", 4,
     [*SPAWN_VIT_ARGS, "--tensor-parallel", "2", "--optimizer-sharding",
      "zero1", "--dcn-slices", "2"],
     {"dcn": 2, "ici": 1, "model": 2, "seq": 1}, "tp2_zero1"),
]
HIER_LINE = "hierarchical mesh: 2 DCN slice(s) x 2 chip(s)/slice"
# The DCN tier's buckets on the 2 x 2 mesh (``hier_dcn_counts``): the
# linear model under ZeRO-1 overlapped through the port's API, at two
# --zero-bucket-mb-dcn budgets that cut its owner shards (15,680 and 20
# bytes) into 1 and 2 buckets, each step counted, beside the flat world of
# 4 from the same init and batches.
HIER_DCN_BUDGETS = (1.0, 0.01)
HIER_DCN_STEPS = 3
_HIER_COUNT_RANK = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.parallel import collectives as C
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
    make_hier_mesh, make_mesh)
from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
    shard_state_zero)
from pytorch_distributed_mnist_tpu_torch.parallel.zero_overlap import (
    make_overlap_train_step)
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state)

torch.set_num_threads(1)
coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
budgets, steps = json.loads(sys.argv[4]), int(sys.argv[5])
cpu = torch.device("cpu")
distributed.initialize_distributed(coord, 4, rank, cpu)
meshes = [("flat", None, make_mesh(device=cpu))] + [
    (f"dcn_{b:g}", b, make_hier_mesh(2, device=cpu)) for b in budgets]
rng = np.random.default_rng(0)
data = [(rng.normal(size=(64, 28, 28, 1)).astype(np.float32),
         rng.integers(0, 10, size=64)) for _ in range(steps)]
res = {}
for name, budget, mesh in meshes:
    axis = mesh.data
    st = create_train_state(get_model("linear", compute_dtype=torch.float32),
                            0, cpu, optimizer="adam")
    shard_state_zero(st, mesh, level=1, bucket_mb=4.0, overlap=True,
                     bucket_mb_dcn=budget)
    step = make_overlap_train_step(st, axis, bucket_mb_dcn=budget)
    per_step, losses = [], []
    for img, lab in data:
        b = 64 // axis.size
        rows = slice(axis.rank * b, (axis.rank + 1) * b)
        before = C.dcn_all_reduce.launches
        m = step({"image": torch.from_numpy(img[rows]),
                  "label": torch.from_numpy(lab[rows]).long(),
                  "mask": torch.ones(b)})
        per_step.append(C.dcn_all_reduce.launches - before)
        losses.append(float(C.metric_all_reduce(m, axis).loss_sum))
    res[name] = {"dcn_buckets": len(st.zero.dcn_plan),
                 "dcn_all_reduce_per_step": per_step, "loss_sums": losses,
                 "params": [p.detach().numpy().ravel().tolist()
                            for p in st.zero.params]}
if rank == 0:
    with open(out, "w") as f:
        json.dump(res, f)
distributed.teardown()
"""


def _hier_dcn_counts(root: str) -> dict:
    """``_HIER_COUNT_RANK`` in a gloo world of 4 on the CPU: per step,
    exactly one DCN all-reduce per bucket of the plane's plan at each of
    ``HIER_DCN_BUDGETS``, the budgets' plans of different lengths, and
    each budget's loss sums and params within 1e-5 of the flat world's
    (the buckets change the grouping of the collectives, not the sums)."""
    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
        free_port,
    )

    out = os.path.join(root, "hier_dcn_counts.json")
    port = free_port()
    env = dict(os.environ, PYTHONPATH=_HERE, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HIER_COUNT_RANK, f"127.0.0.1:{port}",
         str(r), out, json.dumps(HIER_DCN_BUDGETS), str(HIER_DCN_STEPS)],
        cwd=_HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    try:
        texts = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for p, text in zip(procs, texts):
        if p.returncode != 0:
            raise AssertionError(f"hier_dcn_counts: rc {p.returncode}\n"
                                 f"{text[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    flat = res.pop("flat")
    buckets = {name: r["dcn_buckets"] for name, r in res.items()}
    if sorted(buckets.values()) != [1, 2]:
        raise AssertionError(f"hier_dcn_counts: DCN plans {buckets}, "
                             f"expected 1 and 2 buckets")
    for name, r in res.items():
        if r["dcn_all_reduce_per_step"] != \
                [r["dcn_buckets"]] * HIER_DCN_STEPS:
            raise AssertionError(
                f"hier_dcn_counts {name}: DCN all-reduces per step "
                f"{r['dcn_all_reduce_per_step']}, plan {r['dcn_buckets']}")
        for got, want in zip([r["loss_sums"]] + r["params"],
                             [flat["loss_sums"]] + flat["params"]):
            if not np.allclose(got, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"hier_dcn_counts {name}: apart from "
                                     f"the flat world of 4")
    if flat["dcn_all_reduce_per_step"] != [0] * HIER_DCN_STEPS:
        raise AssertionError(f"hier_dcn_counts: the flat world ran DCN "
                             f"all-reduces {flat}")
    return {"world": 4, "wall_s": wall, "steps": HIER_DCN_STEPS,
            "budgets_mb": list(HIER_DCN_BUDGETS), "dcn_buckets": buckets,
            "dcn_all_reduce_per_step": {
                name: r["dcn_all_reduce_per_step"] for name, r in res.items()},
            "loss_sums": {name: r["loss_sums"] for name, r in res.items()},
            "flat_loss_sums": flat["loss_sums"]}

TP_SP_THREADS = 3  # runs at once: the card machine's 8 cores, beside
# the kernel builds and chaos_cpu's worlds


def _tp_sp_worlds(root: str) -> dict:
    """``TP_SP_WORLDS``, ``PP_WORLDS`` and ``HIER_WORLDS`` through
    ``--spawn`` on the CPU, after the one-process references (and the
    flat world ``HIER_REFS``), ``TP_SP_THREADS`` runs at a time: each
    must exit 0, print its mesh and one epoch line, and hold that line to
    its reference's (losses within 1e-5, accuracies within one example
    of 512): TP, SP, PP and the two-tier mesh are layout changes."""
    from concurrent.futures import ThreadPoolExecutor

    def run(name, argv):
        proc, wall = _chaos_run([*argv, "--checkpoint-dir",
                                 os.path.join(root, name)])
        if proc.returncode != 0:
            raise AssertionError(f"{name}: rc {proc.returncode}\n"
                                 f"{proc.stdout}\n{proc.stderr[-3000:]}")
        return proc, wall

    spawned = [(name, n, [*flags, *SPAWN_VIT_ARGS], mesh, ref)
               for name, n, flags, mesh, ref in TP_SP_WORLDS + PP_WORLDS]
    spawned += HIER_WORLDS
    out = {}
    with ThreadPoolExecutor(TP_SP_THREADS) as pool:
        refs = {ref: pool.submit(run, ref, [*flags, *SPAWN_VIT_ARGS])
                for ref, flags in TP_SP_REFS.items()}
        refs.update({ref: pool.submit(run, ref, ["--spawn", str(n), *argv])
                     for ref, (n, argv) in HIER_REFS.items()})
        worlds = {name: pool.submit(run, name, ["--spawn", str(n), *argv])
                  for name, n, argv, _, _ in spawned}
        counts = pool.submit(_hier_dcn_counts, root)
        lines = {}
        for ref, fut in refs.items():
            proc, wall = fut.result()
            lines[ref] = _train_lines(proc.stdout, "Epoch: ")
            out[ref] = {"wall_s": wall, "epoch_lines": lines[ref]}
        for name, n, argv, mesh, _ in spawned:
            proc, wall = worlds[name].result()
            lines[name] = _train_lines(proc.stdout, "Epoch: ")
            devices = _train_lines(proc.stdout, "devices: ")
            want_dev = f"devices: {n} (cpu), processes: {n}, mesh: {mesh}"
            if len(lines[name]) != 1 or devices != [want_dev] or (
                    "dcn" in mesh and not _train_lines(proc.stdout,
                                                       HIER_LINE)):
                raise AssertionError(f"{name}: {devices}\n{proc.stdout}")
            out[name] = {"world": n, "flags": argv, "wall_s": wall,
                         "epoch_lines": lines[name],
                         "devices_line": devices[0]}
        out["hier_dcn_counts"] = counts.result()
    for name, _, _, _, ref in spawned:
        if not _lines_close(lines[name], lines[ref], 1e-5, 100 / 512):
            raise AssertionError(f"{name} printed {lines[name]}; {ref} "
                                 f"printed {lines[ref]}")
        out[name].update(held_to=ref, reference_lines=lines[ref])
    return out


def start_tp_sp_cpu() -> dict:
    """Start ``phase_tp_sp_spawn``'s worlds on a thread, beside the kernel
    builds (as ``start_chaos_cpu``)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_sp_")
    return {"root": root, "t0": time.perf_counter(),
            "worlds": _Background(lambda: _tp_sp_worlds(root))}


def phase_tp_sp_spawn(started=None) -> dict:
    """Tensor and sequence parallelism in gloo worlds on the host's CPU,
    the dp_spawn family's worlds for this slice (``TP_SP_WORLDS``: TP 2
    plain, with the flash, cross-entropy and Adam kernels' flags, and
    overlapped; SP 2 ring and Ulysses with flash; TP 2 x SP 2; TP 2 x
    ZeRO-1 on a 2 x 2 data x model mesh) and, in the same pool, pipeline
    parallelism's (``PP_WORLDS``, emitted as ``pp_spawn``), each held to
    its reference run; run beside the kernel builds
    (``start_tp_sp_cpu``). On the CPU the kernels' wrappers take their
    plain versions: these worlds launch no card kernel (the per-rank and
    per-microbatch shapes run on the card in ``flash_rank_shapes`` and
    ``pipeline_shapes``)."""
    import shutil

    started = started or start_tp_sp_cpu()
    try:
        worlds = started["worlds"].result()
        wall = time.perf_counter() - started["t0"]
    finally:
        shutil.rmtree(started["root"], ignore_errors=True)
    pp = {name for name, *_ in PP_WORLDS}
    pp_refs = {ref for *_, ref in PP_WORLDS}
    hier = {name for name, *_ in HIER_WORLDS} | set(HIER_REFS) | {
        "hier_dcn_counts"}
    row = {"worlds": {k: v for k, v in worlds.items()
                      if k not in pp | hier},
           "wall_s": wall, "card_kernel_launches": 0,
           "note": "TP and SP across 2 or more ranks run here only, as "
                   "gloo worlds on the CPU: the card's machine has one "
                   "card; the worlds ran beside the kernel builds"}
    emit("tp_sp_spawn", **row)
    pp_row = {"worlds": {k: v for k, v in worlds.items()
                         if k in pp or k in pp_refs},
              "wall_s": wall, "card_kernel_launches": 0,
              "note": "pipeline parallelism across 2 or more ranks runs "
                      "here only, as gloo worlds on the CPU, in "
                      "tp_sp_spawn's pool: the card runs the one-rank "
                      "stage axis (train_pipeline) and the kernels at the "
                      "per-microbatch shapes (pipeline_shapes)"}
    emit("pp_spawn", **pp_row)
    hier_row = {"worlds": {k: v for k, v in worlds.items()
                           if k in hier or k == "tp2_zero1"},
                "wall_s": wall, "card_kernel_launches": 0,
                "note": "the two-tier ('dcn', 'ici') mesh of 2 slices runs "
                        "here only, as gloo worlds on the CPU, in "
                        "tp_sp_spawn's pool: the card runs the (1, 1) mesh "
                        "(train_hier); whether NCCL collectives of two "
                        "groups capture in one CUDA graph across cards is "
                        "not measured"}
    emit("hier_spawn", **hier_row)
    return {**row, "pp": pp_row, "hier": hier_row}


def _cold_run(argv: list) -> dict:
    """One CLI process of ``argv``: its exit code, the seconds to its
    first epoch line, and its ``build[...]`` lines as counts."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=_HERE,
        env=dict(os.environ, PYTHONPATH=_HERE))
    first_epoch_s, out = None, []
    try:
        for line in proc.stdout:
            out.append(line)
            if first_epoch_s is None and line.startswith("Epoch: "):
                first_epoch_s = time.perf_counter() - t0
        err = proc.stderr.read()
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    builds = {}
    for line in out:
        m = re.match(r"build\[(\w+)\]: (\d+) built \(([\d.]+) s\), (\d+) "
                     r"reused", line)
        if m:
            builds[m.group(1)] = {"built": int(m.group(2)),
                                  "seconds": float(m.group(3)),
                                  "reused": int(m.group(4))}
    if proc.returncode != 0:
        raise AssertionError(f"{argv}: rc {proc.returncode}\n"
                             f"{''.join(out)}\n{err[-3000:]}")
    return {"first_epoch_s": first_epoch_s,
            "wall_s": time.perf_counter() - t0, "builds": builds,
            "built": sorted(k for k, v in builds.items() if v["built"])}


def phase_cold_start(device_flag: str = "cuda") -> dict:
    """The cnn run, 1 epoch, as a process on a fresh empty
    ``--compile-cache`` directory, by default (every kernel library it
    launches built on a thread while its data stages) and with
    ``--no-precompile`` (each built at its first launch): each must build
    the native library and each CUDA kernel library it launches once;
    then again on the first run's (warm) directory, which must build
    nothing. The seconds to the first epoch line of each, with no
    gate."""
    import shutil

    root = tempfile.mkdtemp(prefix="chip_smoke_cold_")
    # Off the card (a rehearsal) the kernels take their plain versions:
    # only the native library is built.
    want = ["adam", "native", "xent"] if device_flag == "cuda" else ["native"]
    argv = TRAIN_ARGS + ["--device", device_flag, "--epochs", "1"]
    rows = {}
    try:
        for name, flags, cache in (
                ("precompile", [], "a"), ("no_precompile",
                                          ["--no-precompile"], "b"),
                ("warm", [], "a")):
            rows[name] = _cold_run(argv + flags + [
                "--compile-cache", os.path.join(root, cache),
                "--checkpoint-dir", os.path.join(root, f"ck_{name}")])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("precompile", "no_precompile"):
        builds = rows[name]["builds"]
        if rows[name]["built"] != want or any(
                builds[k]["built"] != 1 for k in want):
            raise AssertionError(f"{name} built {builds}, expected each of "
                                 f"{want} once")
    if rows["warm"]["built"]:
        raise AssertionError(f"the warm run built {rows['warm']['builds']}")
    emit("cold_start", **rows, built_once=want, warm_built=0)
    return rows


def kernel_of(mangled: str) -> str:
    """``name<args>`` of a kernel from its mangled name: the identifier
    that ends in ``_kernel`` (a length-prefixed name whose length digits may
    follow other digits) and its integer and bool template arguments."""
    import re

    for run in re.finditer(r"\d+", mangled):
        for start in range(run.start(), run.end()):
            size = int(mangled[start:run.end()])
            name = mangled[run.end():run.end() + size]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*",
                                                         name):
                args = re.match(r"I((?:L[ib]\d+E)+)E",
                                mangled[run.end() + size:])
                if not args:
                    return name
                values = re.findall(r"L([ib])(\d+)E", args.group(1))
                return name + "<" + ", ".join(
                    v if t == "i" else str(bool(int(v))).lower()
                    for t, v in values) + ">"
    return mangled


def ptxas_counts(log: str) -> dict:
    """Per kernel of a build (``kernel_of``): its registers and spilled
    bytes, from ``nvcc -Xptxas -v``'s lines."""
    import re

    counts, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = kernel_of(entry.group(1))
            counts[current] = {}
        elif current is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                counts[current]["spill_stores"] = int(spill.group(1))
                counts[current]["spill_loads"] = int(spill.group(2))
            if regs:
                counts[current]["registers"] = int(regs.group(1))
    return counts


# Instantiations of csrc/flash_tf32.cu: three kernels at five head-dim
# capacities, each on the 16-byte path and the narrow one.
TF32_INSTANTIATIONS = 3 * 5 * 2


def require_no_spill(log: str) -> dict:
    """The 3xTF32 kernels' ptxas counts (``ptxas_counts``) from a fresh
    build's log: raises unless every instantiation is there and none
    spills a register."""
    counts = ptxas_counts(log)
    if len(counts) != TF32_INSTANTIATIONS:
        raise AssertionError(f"flash_tf32's build reported "
                             f"{len(counts)} instantiations, not "
                             f"{TF32_INSTANTIATIONS}: {sorted(counts)}")
    spilled = {k: v for k, v in counts.items()
               if v.get("spill_stores") or v.get("spill_loads")}
    if spilled:
        raise AssertionError(f"flash_tf32 spills registers: {spilled}")
    return counts


def main() -> int:
    import shutil

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
    # The native library first, alone (its build seconds and host ms are
    # this phase's numbers); then chaos_cpu's CPU worlds, beside the
    # kernel builds, which leave most cores idle once the short nvcc runs
    # are done.
    phase_native_vs_plain()
    chaos = start_chaos_cpu()
    tp_sp = start_tp_sp_cpu()
    t0 = time.perf_counter()
    info = cuda_build.build()
    # A library found built already carries no log to read.
    tf32_ptxas = (require_no_spill(info["flash_tf32"]["log"])
                  if info["flash_tf32"]["log"] else {})
    emit("device_build", device=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, peaks_of=part,
         build_s=time.perf_counter() - t0,
         kernels={k: {"build_s": v["seconds"],
                      "ptxas": ptxas_counts(v["log"])}
                  for k, v in info.items()},
         flash_tf32_registers_and_spills={
             k: [v.get("registers"), v.get("spill_stores", 0)]
             for k, v in tf32_ptxas.items()},
         beside="chaos_cpu's and tp_sp_spawn's CPU worlds ran during "
                "the builds")

    phase_chaos_cpu(chaos)
    tp_sp_run = phase_tp_sp_spawn(tp_sp)
    max_err = phase_kernel_vs_plain(device)
    train_err = phase_train_kernels_vs_plain(device)
    rows = phase_timings(device, peaks)
    vit_i8_rows = phase_vit_i8_timings(device, peaks)
    train_rows = phase_train_timings(device, peaks)
    launches = phase_server()
    split_plane_launches = phase_server(split=True)
    phase_forward_profile(device)
    server_vit = phase_server_vit()
    cnn_run = phase_train()
    train_launches = cnn_run["launches"]
    native_off = phase_train_native_off(cnn_run["lines"], cnn_run["staging"])
    phase_train_twin("train_stepwise", "cnn", ["--trainer-mode", "stepwise"],
                     cnn_run["lines"])
    phase_train_twin("train_epoch_gather_device", "cnn",
                     ["--epoch-gather", "device"], cnn_run["lines"])
    phase_train_feed_window(cnn_run["lines"])
    accum_run = phase_train(model="cnn_accum")
    phase_train_twin("train_grad_accum_stepwise", "cnn_accum",
                     ["--trainer-mode", "stepwise"], accum_run["lines"])
    moe_run = phase_train(model="moe", keep_best=True)
    moe_stepwise = phase_train_twin("train_moe_stepwise", "moe",
                                    ["--trainer-mode", "stepwise"],
                                    moe_run["lines"])
    publish_run = phase_train_publish(cnn_run["lines"])
    try:
        delta_launches = phase_server_delta(publish_run["dir"])["launches"]
    finally:
        shutil.rmtree(publish_run["root"], ignore_errors=True)
    nans_launches = phase_train_debug_nans(cnn_run["lines"])["launches"]
    profile_dir_launches = phase_train_profile_dir(
        cnn_run["lines"])["launches"]
    phase_train_profile(device)
    flash_err = phase_flash_vs_plain(device)
    flash_rows = phase_flash_timings(device, peaks)
    rank_run = phase_flash_rank_shapes(device, peaks)
    pipeline_run = phase_pipeline_shapes(device, peaks)
    split_launches = phase_flash_split_route(device)
    vit_run = phase_train(model="vit")
    vit_launches = vit_run["launches"]
    phase_train_twin("train_stepwise", "vit", ["--trainer-mode", "stepwise"],
                     vit_run["lines"])
    vit_accum_launches = phase_train(model="vit_accum")["launches"]
    remat_launches = phase_train(model="vit_remat",
                                 want_lines=vit_run["lines"])["launches"]
    phase_remat_memory(device)
    pp_train = phase_train_pipeline(device)
    phase_train_profile(device, model="vit")
    p2 = phase_train_profile(device, model="vit", patch_size=2)
    f32_launches = phase_train(model="vit_f32")["launches"]
    phase_train_profile(device, model="vit", dtype="f32")
    d12_profile = phase_train_profile(device, model="vit", embed_dim=48)
    scan_cnn = phase_train_scan_profile(device)
    phase_train_scan_profile(device, model="vit")
    phase_train_scan_profile(device, model="vit", patch_size=2)
    phase_train_scan_profile(device, model="moe_mlp")
    # The MoE's plain, capacity and aux runs time nothing from a trace:
    # they run after the last phase that does, as the serving phases do.
    moe_variants = phase_train_moe_variants(moe_run["lines"])
    # One serve process at full breadth, after every phase that times
    # kernels from a trace and before any NCCL group: the replica pool,
    # the shadow canary, a model set, the autoscaler.
    pool_run = phase_server_pool()
    canary_launches = phase_server_canary()["launches"]
    multimodel_launches = phase_server_multimodel()["launches"]
    autoscale_launches = phase_server_autoscale()["launches"]
    try:
        phase_server_moe(moe_run["best"])
    finally:
        shutil.rmtree(os.path.dirname(moe_run["best"]), ignore_errors=True)
    # Sharded and pipeline serving: a tensor group and a chain sharing the
    # card, K3 at the per-shard shapes, an expert group.
    sharded_run = phase_server_sharded()
    # The fleet: the port's router over two backends in this process, then
    # the chaos tool's router and backend processes sharing the card.
    fleet_run = phase_fleet_router()
    fleet_chaos = phase_fleet_chaos()
    # Run supervision and the build directory: processes of their own (a
    # killed run, a raising world of one, CPU worlds, cold starts) and
    # one resume in this process.
    fault_run = phase_train_fault_resume(cnn_run["lines"])
    phase_cold_start()
    # Data parallelism, last: once a process has held an NCCL group, its
    # profiler traces lose device events far more often (175 retaken
    # traces against 19 in one call, PERF.md), so every phase that times
    # kernels runs first. The cnn and ViT runs in a world of one, the
    # explicit mode there, --spawn 2, and the replayed step's cost.
    phase_train(dp=True, want_lines=cnn_run["lines"])
    phase_train_twin("train_explicit", "cnn", ["--trainer-mode", "explicit"],
                     cnn_run["lines"], dp=True)
    phase_train(model="vit", dp=True, want_lines=vit_run["lines"])
    phase_train_scan_profile_dp(device)
    zero_launches, zero_lines = phase_train_zero(cnn_run["lines"])
    hier_launches = phase_train_hier(zero_lines)
    phase_dp_spawn()

    def new_path_launches(kname):
        # The training kernels' launches in the weight-distribution and
        # debugging phases (each run: train's counts).
        return {"launches_publish": publish_run["launches"][kname],
                "launches_debug_nans": nans_launches[kname],
                "launches_profile_dir": profile_dir_launches[kname],
                "launches_native_off": native_off["launches"][kname],
                "launches_fault_resume": fault_run["launches"][kname],
                # The MoE family and ZeRO.
                "launches_train_moe": moe_run["launches"][kname],
                "launches_train_moe_stepwise": moe_stepwise["launches"][kname],
                **{f"launches_{phase}": launched[kname]
                   for phase, launched in moe_variants.items()},
                **{f"launches_{phase}": launched[kname]
                   for phase, launched in zero_launches.items()}}

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
        "launches_vit_server": server_vit["launches"],
        "launches_server_delta": delta_launches,
        "launches_server_split_native": split_plane_launches,
        "launches_server_pool": pool_run["launches"],
        "launches_server_pool_per_replica": pool_run["per_replica"],
        "launches_server_canary": canary_launches,
        "launches_server_multimodel": multimodel_launches,
        "launches_server_autoscale": autoscale_launches,
        "launches_fleet_router": fleet_run["launches"],
        "launches_fleet_chaos": fleet_chaos["launches_per_backend"],
        "launches_server_sharded": sharded_run["launches"],
        "launches_server_sharded_per_forward": sharded_run["per_forward"],
        "launches_server_sharded_cli": sharded_run["cli_launches"],
        "shard_shapes": sharded_run["shard_shapes"],
        "vit_shapes": vit_i8_rows,
        "vit_forward_profiles": server_vit["profiles"],
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
            "replay_ms": scan_cnn["scan"]["kernel_ms_per_call"][kname],
            "in_eager_step_ms":
                scan_cnn["stepwise"]["kernel_ms_per_call"][kname],
            "launches_grad_accum": accum_run["launches"][kname],
            "launches_vit_grad_accum": vit_accum_launches[kname],
            **new_path_launches(kname),
            "at": f"{TRAIN_BATCH}x{CLASSES}"})
    all_8 = train_rows["adam"]["all_8"]
    kernels.append({
        "name": "adam", "route": "cuda", "source": f"{CSRC}/adam.cu",
        "replaces": TPU_ADAM, "launches": train_launches["adam"],
        "launches_per_step": all_8["launches_per_step"],
        "max_abs_err": train_err["adam"], "ms": all_8["kernel_ms"],
        "call_ms": all_8["step_call_ms"], "step_ms": all_8["step_ms"],
        "plain_ms": all_8["plain_ms"], "bound_ms": all_8["bound_ms"],
        "bound_by": all_8["bound_by"], "library_ms": all_8["library_ms"],
        "replay_ms": scan_cnn["scan"]["kernel_ms_per_call"]["adam"],
        "in_eager_step_ms": scan_cnn["stepwise"]["kernel_ms_per_call"]["adam"],
        "launches_grad_accum": accum_run["launches"]["adam"],
        **new_path_launches("adam"),
        "at": f"one FusedAdam.step over the 8 cnn leaves, "
              f"{all_8['numel']} params",
        "vit_31": train_rows["adam"]["vit_31"]})
    # flash_fwd (the tensor-core forward) and flash_bwd run on the bf16 ViT
    # path (train_vit), at D = 12 too (train_vit_d12_profile); the
    # CUDA-core forward and the split pair, which no problem takes unnamed,
    # on the split route's path (flash_split_route). Each entry carries its
    # D = 12 rows (d12: T = 49, d12_p2: T = 196).
    vit_launches = {**vit_launches,
                    "flash_fwd": vit_launches["flash_fwd_routes"]["tensor"]}

    def d12_rows(kind, dtype, *keys):
        return {f"d12{p2}": {k: flash_rows[f"{kind}_d12{p2}_{dtype}"][k]
                             for k in keys}
                for p2 in ("", "_p2")}

    row_keys = ("kernel_ms", "plain_ms", "library_ms", "library_backend",
                "bound_ms", "bound_by", "route")
    # The CUDA-core kernels' D = 12 rows, named, by dtype.
    split_d12 = {"d12_named": {
        dt: d12_rows("flash_bwd", dt, "split_ms", "split_bound_ms",
                     "library_ms", "library_backend")
        for dt in ("bf16", "f32")}}
    d12 = {"flash_fwd": d12_rows("flash_fwd", "bf16", "cuda_core_ms",
                                 "copy_width", *row_keys),
           "flash_bwd": d12_rows("flash_bwd", "bf16", "split_ms", *row_keys),
           "flash_fwd_cuda_core": {"d12_named": {
               dt: d12_rows("flash_fwd", dt, "cuda_core_ms",
                            "cuda_core_bound_ms", "library_ms",
                            "library_backend") for dt in ("bf16", "f32")}},
           "flash_dq": split_d12, "flash_dkv": split_d12}
    # The D = 12 profile's launches per route (train_vit_d12_profile).
    d12_launches = {name: d12_profile["launches"][f"{name}_routes"]
                    for name in ("flash_fwd", "flash_bwd")}
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
            entry["p2"] = {k: flash_rows["flash_fwd_p2"][k] for k in (
                "kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        if kname in ("flash_dq", "flash_dkv"):
            f32 = flash_rows["flash_split_f32"]
            entry["pair_float32"] = {k: f32[k] for k in (
                "kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        entry.update(d12[kname])
        if kname in d12_launches:
            entry["launches_d12_profile"] = d12_launches[kname]
        if kname in ("flash_fwd", "flash_bwd"):
            entry["launches_grad_accum"] = vit_accum_launches[kname]
            entry["launches_remat"] = remat_launches[kname]
        kernels.append(entry)
    # The tiled pair runs on the ViT's --patch-size 2 path
    # (train_vit_p2_profile's counted steps).
    pair = flash_rows["flash_bwd_tiled"]
    for kname in ("flash_dq_tiled", "flash_dkv_tiled"):
        row = flash_rows[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{CSRC}/flash_bwd_tiled.cu", "replaces": TPU_FLASH_BWD,
            "launches": p2["launches"]["flash_bwd_routes"]["tiled"],
            "max_abs_err": flash_err["flash_bwd_tiled"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "pair": {k: pair[k] for k in (
                "kernel_ms", "split_ms", "plain_ms", "library_ms",
                "bound_ms")},
            "pair_t49": {k: flash_rows["flash_bwd_tiled_t49"][k] for k in (
                "kernel_ms", "split_ms", "fused_ms", "library_ms",
                "bound_ms")},
            "pair_d12_p2": d12_rows("flash_bwd", "bf16", "split_ms",
                                    *row_keys)["d12_p2"],
            "at": "x".join(map(str, P2_SHAPE)) + " (B, T, H, D) bfloat16"})
    # The 3xTF32 forward and pair run on the float32 ViT path (train_vit_f32,
    # the CLI under --dtype f32).
    at_f32 = "x".join(map(str, VIT_SHAPE)) + " (B, T, H, D) float32"
    row = flash_rows["flash_fwd_tf32"]
    kernels.append({
        "name": "flash_fwd_tf32", "route": "cuda",
        "source": f"{CSRC}/flash_tf32.cu", "replaces": TPU_FLASH_FWD,
        "launches": f32_launches["flash_fwd_routes"]["tf32x3"],
        "max_abs_err": flash_err["flash_fwd_tf32"], "ms": row["kernel_ms"],
        "call_ms": row["kernel_call_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "library_call": row["library_call"],
        "cuda_core_ms": row["cuda_core_ms"],
        "p2": {k: flash_rows["flash_fwd_tf32_p2"][k] for k in (
            "kernel_ms", "cuda_core_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")},
        **d12_rows("flash_fwd", "f32", "cuda_core_ms", "copy_width",
                   *row_keys),
        "at": at_f32})
    for kname in TF32_PAIR:
        row = flash_rows[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{CSRC}/flash_tf32.cu", "replaces": TPU_FLASH_BWD,
            "launches": f32_launches["flash_bwd_routes"]["tf32x3"],
            "max_abs_err": flash_err["flash_bwd_tf32"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **{f"pair{suffix}": {k: flash_rows[f"flash_bwd_tf32{suffix}"][k]
                                 for k in ("kernel_ms", "split_ms",
                                           "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}
               for suffix in ("", "_p2")},
            **{f"pair_{key}": value for key, value in d12_rows(
                "flash_bwd", "f32", "split_ms", *row_keys).items()},
            "at": at_f32})
    # Tensor and sequence parallelism's per-rank shapes (flash_rank_shapes)
    # and pipeline parallelism's per-microbatch shapes (pipeline_shapes):
    # each kernel's rows at the shapes whose route it is, with the
    # launches of the slice's entry points there (bf16, counted from 0).
    shape_keys = ("kernel_ms", "plain_ms", "library_ms", "library_backend",
                  "bound_ms", "bound_by", "route", "shape")
    kinds = {"flash_fwd": ("flash_fwd", "bf16"),
             "flash_bwd": ("flash_bwd", "bf16"),
             "flash_dq_tiled": ("flash_bwd", "bf16"),
             "flash_dkv_tiled": ("flash_bwd", "bf16"),
             "flash_fwd_tf32": ("flash_fwd", "f32"),
             "flash_dq_tf32": ("flash_bwd", "f32"),
             "flash_dkv_tf32": ("flash_bwd", "f32")}
    errs = {"flash_dq_tiled": "flash_bwd_tiled",
            "flash_dkv_tiled": "flash_bwd_tiled",
            "flash_dq_tf32": "flash_bwd_tf32",
            "flash_dkv_tf32": "flash_bwd_tf32"}
    for entry in kernels:
        kname = entry["name"]
        kind, dt = kinds.get(kname, (None, None))
        if kind is None:
            continue
        own = {"flash_bwd": "fused", "flash_dq_tiled": "tiled",
               "flash_dkv_tiled": "tiled"}.get(kname)
        for key, run, shapes in (("rank_shapes", rank_run, RANK_SHAPES),
                                 ("pipeline_shapes", pipeline_run,
                                  PIPELINE_SHAPES)):
            picked = {}
            for tag, _ in shapes:
                row = run["rows"][f"{kind}_{tag}_{dt}"]
                if own is not None and row["route"] != own:
                    continue
                picked[tag] = {k: row[k] for k in shape_keys}
                if dt == "bf16":
                    picked[tag]["launches_entry"] = run["launches"][tag][kind]
            entry[key] = picked
            entry[f"{key}_max_abs_err"] = run["max_abs_err"][
                errs.get(kname, kname)]
    # The two-tier mesh's runs on the card (train_hier): Adam on the ici
    # shards, the flash pair on the ViT's.
    for entry in kernels:
        for phase, launched in hier_launches.items():
            if entry["name"] in launched:
                entry[f"launches_{phase}"] = launched[entry["name"]]
    # The one-rank pipelined step's launches per run (train_pipeline).
    for entry in kernels:
        if entry["name"] in ("flash_fwd", "flash_bwd", "xent_fwd",
                             "xent_bwd", "adam"):
            entry["launches_train_pipeline"] = {
                run: got["launches"][entry["name"]]
                for run, got in pp_train["runs"].items()
                if "launches" in got}
    emit("smoke", seconds=time.perf_counter() - _STARTED,
         retaken_traces=RETAKEN["traces"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
