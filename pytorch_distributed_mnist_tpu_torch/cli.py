"""Command-line entry of the port.

``python -m pytorch_distributed_mnist_tpu_torch [flags]`` trains, as the
JAX package's bare command does: per-epoch reshuffle, train, eval, the
reference's epoch line, ``checkpoint_{e}.npz`` plus ``model_best.npz``,
``--resume`` (a path or ``auto``) and ``-e`` to evaluate only. It runs on
the card unless ``--device cpu`` is given.
``python -m pytorch_distributed_mnist_tpu_torch serve ...`` boots the HTTP
inference server (``serve/server.py``), and ``... route ...`` the fleet
router over N of them (``serve/router.py``; ``__main__`` dispatches it
before this module is imported, so a router process loads no torch).

The flags are the data-parallel main-path subset of the JAX package's
``build_parser``, with its defaults. ``--trainer-mode`` defaults to
``scan``, as the JAX CLI's does: each epoch is one captured CUDA graph of
the train step replayed per batch (and one of the eval step per eval
batch), from an epoch staged on the device, with one host read of the
metrics per pass (``train/steps.py::EpochProgram``; on the CPU the same
step body in a loop). ``--epoch-gather device`` keeps the dataset on the
device and gathers each batch there. ``stepwise`` runs one eager step per
batch; ``explicit`` does too, through the explicit data-parallel steps of
``parallel/collectives.py``. ``--model vit --attention flash`` trains the
ViT through the flash-attention kernels (``ops/flash.py``); ``--remat``
recomputes each of its blocks in the backward pass. ``--grad-accum N``
splits each step's batch into N micro-batches before one optimizer step
(scan and stepwise); ``--feed-window W`` sets how many batches the
per-batch modes stage ahead on a feeder thread (``data/staging.py``).

Data parallelism over processes, one device each: ``--spawn N`` starts N
local ranks (``parallel/launcher.py``; rank r on ``cuda:r`` over NCCL, or
every rank on the CPU over gloo with ``--device cpu``);
``--coordinator host:port --num-processes N --process-id r`` joins a world
rank by rank; a launcher's environment (``MASTER_ADDR`` with
``WORLD_SIZE``, Slurm, Open MPI) is detected. ``--batch-size`` is global:
each rank takes its share of every batch, the step's loss is one masked
mean over the global batch, the metrics are summed, and process 0 prints
and writes the checkpoints. A single process with none of these makes no
process group. The two-tier meshes' flags are not accepted yet.

``--model vit`` also trains over a ``('data', 'model', 'seq')`` mesh:
``--tensor-parallel N`` runs Megatron blocks over a model axis of N
ranks (``--attention flash`` then runs the kernels on each rank's heads,
``--tp-overlap`` the collective-matmul schedule on a sequence-sharded
residual stream, ``parallel/tensor.py``), ``--sequence-parallel N``
shards the tokens over a seq axis with ring or Ulysses attention
(``--sequence-parallel-impl``, ``parallel/ring.py``,
``parallel/ulysses.py``; Ulysses takes ``--attention flash`` as its local
attention). ``--pipeline-stages S`` runs it as a GPipe pipeline over a
``('data', 'stage')`` mesh (``parallel/pipeline_vit.py``), or with
``--tensor-parallel`` over ``('data', 'stage', 'model')`` with Megatron
stage bodies (``parallel/pipeline_tp.py``); ``--optimizer-sharding zero1``
then shards the moments stage x data.

``--model moe_mlp`` trains the switch MoE (``models/moe.py``; ``--moe-
dispatch dense|capacity``, ``--moe-aux-weight`` adds its load-balance
loss to the objective); ``--expert-parallel E`` splits its experts over
an expert axis of E ranks. ``--optimizer-sharding zero1|zero3`` shards
the optimizer state (and the params) over the data axis
(``parallel/zero.py``), ``--zero-overlap`` issues its bucketed
collectives as the backward runs (``parallel/zero_overlap.py``).

The run is supervised (``runtime/supervision.py``): every failure on a
rank takes one except path that sends the peers a poison pill at their
next agreement (the checkpoint phases, the dataset vote, the resume
agreements all exchange records over the world's gloo group), so they
exit with ``PeerFailure`` naming the rank and its phase instead of
waiting; ``--agreement-timeout`` bounds every agreement, and a process
that dies on a peer's failure exits 75. ``TPUMNIST_FAULT`` injects faults
at the named points (``runtime/chaos.py``). ``--spawn N --elastic``
survives a rank's loss by rebuilding a smaller world resumed from the
last checkpoint, and ``--elastic-grow`` admits joiners at epoch
boundaries (``runtime/elastic.py``).

The host data path (IDX parse, normalize, the epoch gather) runs in the
native C++ library over ``-j`` threads (``data/native.py``);
``--download`` fetches a missing dataset (``data/download.py``). The CUDA
kernels and the native library are built into ``--compile-cache`` (by
default ``build/torch_kernels/``), and every kernel library a run will
launch is built on a thread while its data stages, unless
``--no-precompile`` (``utils/compile_cache.py``).

``--publish delta`` writes each epoch as content-addressed chunks and a
manifest (``distrib/``); ``--async-checkpoint`` writes checkpoints on a
thread while the next epoch trains; ``--debug-nans`` raises
``FloatingPointError`` at the op that makes the first NaN
(``utils/debug_nans.py``: every op of every step in ``stepwise`` and
``explicit``; in ``scan`` a pass whose loss sum reads NaN is re-run
eagerly under the same checks); ``--profile-dir`` writes a ``torch.profiler`` trace of the
run with its train, eval and checkpoint spans.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import random
import sys
import traceback
from contextlib import closing
from typing import Optional

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.data.loader import MNISTDataLoader
from pytorch_distributed_mnist_tpu_torch.data.mnist import (
    load_dataset,
    normalize_images,
)
from pytorch_distributed_mnist_tpu_torch.models import (
    get_model,
    list_models,
    model_accepts,
)
from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
from pytorch_distributed_mnist_tpu_torch.ops.loss import set_loss_impl
from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    initialize_distributed,
    process_count,
    process_index,
    teardown,
)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.runtime import elastic, supervision
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    checkpoint_world,
    is_corrupt_checkpoint_error,
    latest_checkpoint,
    quarantine_checkpoint,
    save_checkpoint,
    try_resume,
)
from pytorch_distributed_mnist_tpu_torch.train.lr_schedule import (
    step_decay_schedule,
)
from pytorch_distributed_mnist_tpu_torch.train.state import (
    OPTIMIZERS,
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer
from pytorch_distributed_mnist_tpu_torch.utils import (
    compile_cache,
    debug_nans,
)
from pytorch_distributed_mnist_tpu_torch.utils.device import resolve_device
from pytorch_distributed_mnist_tpu_torch.utils.logging import log0
from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
    JsonlSink,
    StagingLog,
    StepTimer,
    compile_log,
    failure_events,
    phase,
    profile_trace,
)
from pytorch_distributed_mnist_tpu_torch.utils.watchdog import HARD_EXIT_CODE

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_mnist_tpu_torch",
        description="MNIST training on NVIDIA cards, one process per card "
                    "(PyTorch/CUDA port)",
        # No prefix abbreviation: an abbreviated '--spaw 2' would set
        # args.spawn yet survive the launcher's literal strip, and the
        # children would re-parse it beside the rendezvous flags.
        allow_abbrev=False,
    )
    p.add_argument("--root", type=str, default="data", help="dataset root dir")
    p.add_argument("-j", "--workers", type=int, default=4,
                   help="threads of the native host data path (normalize, "
                        "the epoch gather; data/native.py)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=256,
                   help="GLOBAL batch size, split across all processes")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--momentum", type=float, default=0.9,
                   help="for --optimizer sgd")
    p.add_argument("--wd", "--weight-decay", type=float, default=1e-4,
                   dest="weight_decay", help="for --optimizer sgd")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint path to resume from, or 'auto' for the "
                        "newest checkpoint in --checkpoint-dir (trains "
                        "fresh when there is none yet)")
    p.add_argument("-e", "--evaluate", action="store_true",
                   help="evaluate on the test set and exit")
    p.add_argument("--seed", type=int, default=None)
    # Rendezvous (the reference's --init-method/--world-size/--rank).
    p.add_argument("--coordinator", type=str, default=None,
                   help="rendezvous address host:port (rank 0's) for "
                        "multi-process runs")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--spawn", type=int, default=0, metavar="N",
                   help="start N local processes that rendezvous on a free "
                        "loopback port: the reference's mp.spawn launch "
                        "mode as a flag. Rank r runs on cuda:r over NCCL "
                        "(N cards needed), or on the CPU over gloo with "
                        "--device cpu")
    p.add_argument("--model", type=str, default="cnn", choices=list_models())
    p.add_argument("--attention", type=str, default="dense",
                   choices=["dense", "flash"],
                   help="core attention impl for --model vit: dense torch "
                        "softmax or the flash CUDA kernels (forward, dQ, "
                        "dK/dV)")
    p.add_argument("--patch-size", type=int, default=4,
                   help="ViT patch size (28 must divide evenly; tokens = "
                        "(28/patch)^2)")
    p.add_argument("--remat", action="store_true",
                   help="torch.utils.checkpoint each transformer block: "
                        "recompute block activations in backward instead "
                        "of storing them (~depth x lower activation memory "
                        "for the token axis; composes with --grad-accum). "
                        "--model vit only")
    p.add_argument("--pipeline-stages", type=int, default=1,
                   help="pipeline-parallel stages for --model vit (GPipe "
                        "over a 'stage' mesh axis; devices are split "
                        "data x stage, vit depth must divide evenly)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="tensor-parallel width for --model vit (Megatron "
                        "column/row parallel blocks over a 'model' mesh "
                        "axis; ranks are split data x model; composes "
                        "with --optimizer-sharding zero1 and "
                        "--sequence-parallel)")
    p.add_argument("--tp-overlap", action="store_true",
                   help="overlap the Megatron column-parallel matmuls with "
                        "their sequence all-gather: ring hops, each "
                        "followed by one row block's matmul, on a "
                        "sequence-sharded residual stream (parallel/"
                        "tensor.py allgather_matmul). Requires "
                        "--tensor-parallel >= 2 with --model vit and a "
                        "tp-divisible token count (e.g. --patch-size 7). "
                        "Off by default; this path is trajectory-equal to "
                        "the unoverlapped one")
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="sequence-parallel width for --model vit: the token "
                        "axis is sharded over a 'seq' mesh axis and every "
                        "block's attention runs as ring attention "
                        "(neighbour send/recv, parallel/ring.py). Token "
                        "count (28/patch)^2 must divide evenly - e.g. "
                        "--patch-size 7 gives 16 tokens")
    p.add_argument("--sequence-parallel-impl", type=str, default="ring",
                   choices=["ring", "ulysses"],
                   help="ring = blockwise online softmax with neighbour "
                        "send/recv (parallel/ring.py); ulysses = "
                        "all-to-all head re-sharding (parallel/ulysses.py; "
                        "head count must divide by the seq width, and it "
                        "does not compose with --tensor-parallel since "
                        "Ulysses re-shards heads itself)")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="expert-parallel width for --model moe_mlp: expert "
                        "weights (leading num_experts dim) shard over an "
                        "'expert' mesh axis (parallel/expert.py); devices "
                        "split data x expert, expert count must divide "
                        "evenly. Composes with --optimizer-sharding zero1 "
                        "and --moe-dispatch")
    p.add_argument("--moe-aux-weight", type=float, default=0.0,
                   metavar="W",
                   help="weight of the MoE router's load-balance loss in "
                        "the training objective (models/moe.py returns it "
                        "beside the logits when asked; top-1 routing can "
                        "collapse onto one expert without it — 0.01 is a "
                        "typical switch-transformer value). 0 (default) "
                        "skips it entirely; metrics always report the "
                        "cross-entropy alone")
    p.add_argument("--moe-dispatch", type=str, default="dense",
                   choices=["dense", "capacity"],
                   help="moe_mlp routing: dense = algebraic one-hot "
                        "combine (layout-exact); capacity = GShard-style "
                        "physical dispatch into per-expert buffers "
                        "bounded by the capacity factor, crossing the "
                        "expert axis via all_to_all "
                        "(parallel/moe_dispatch.py)")
    p.add_argument("--optimizer-sharding", type=str, default="none",
                   choices=["none", "zero1", "zero3"],
                   help="zero1 = shard Adam moments over the data axis "
                        "(ZeRO-1; parallel/zero.py). Params stay "
                        "replicated; the gradient all-reduce becomes a "
                        "reduce-scatter into the moment shards and an "
                        "all-gather of the updated params. zero3 = shard "
                        "params too (FSDP-style: the state holds 1/N of "
                        "each split param, all-gathered before use). Per "
                        "rank on the device: the whole params (the "
                        "gathered workspace under zero3), the whole "
                        "gradient buffer and 1/N of the moments, param "
                        "and gradient shards, plus a packing buffer for "
                        "the leaves split off dim 0; for the cnn (every "
                        "leaf split on dim 0) 2P + 4P/N floats against "
                        "unsharded Adam's 4P")
    p.add_argument("--zero-overlap", action="store_true",
                   help="overlapped ZeRO data plane "
                        "(parallel/zero_overlap.py): bucketed gradient "
                        "reduce-scatters issued from backward hooks as "
                        "each bucket's gradients exist, so communication "
                        "overlaps the remaining backward, the owner-shard "
                        "optimizer update, and the updated-shard "
                        "all-gather carried across the step boundary "
                        "into the next forward. Same state layout and "
                        "numerics as the default path; requires "
                        "--optimizer-sharding zero1|zero3 and pure data "
                        "parallelism; composes with --grad-accum")
    p.add_argument("--zero-bucket-mb", type=float, default=4.0,
                   metavar="MB",
                   help="gradient bucket budget for --zero-overlap: "
                        "size-ordered leaves pack into buckets of at "
                        "most this many MiB; each bucket is one "
                        "communication-issue group (smaller = earlier "
                        "first reduce-scatter, larger = fewer, "
                        "better-utilized collectives)")
    p.add_argument("--dataset", type=str, default="mnist",
                   choices=["mnist", "fashion_mnist", "synthetic"])
    p.add_argument("--download", action="store_true",
                   help="fetch and verify the dataset's IDX files into "
                        "--root when absent (the reference's "
                        "download=True); every process tries, and the "
                        "outcome is agreed across the world")
    p.add_argument("--allow-synthetic", action="store_true",
                   help="if the real dataset's IDX files are missing, train "
                        "on the labelled synthetic dataset instead of "
                        "exiting")
    p.add_argument("--dtype", type=str, default=None, choices=list(_DTYPES),
                   help="compute dtype; linear/cnn/vit default to bfloat16 "
                        "activations with float32 params and logits, the "
                        "MoE model to f32 (router numerics). f32 also "
                        "turns TF32 off on the card")
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=list(OPTIMIZERS),
                   help="adam_pallas = the fused CUDA update kernel")
    p.add_argument("--loss", type=str, default="xla", choices=["xla", "fused"],
                   help="cross-entropy impl: xla (plain torch ops) or fused "
                        "(the CUDA forward and backward kernels)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient-accumulation micro-batches per optimizer "
                        "step: each process's batch splits N ways, grads "
                        "accumulate in one buffer, one optimizer step "
                        "applies the exact full-batch gradient (~N x lower "
                        "activation memory)")
    p.add_argument("--trainer-mode", type=str, default="scan",
                   choices=["scan", "stepwise", "explicit"],
                   help="scan: each epoch replays one captured CUDA graph "
                        "of the step per batch (a loop on the CPU); "
                        "stepwise: one eager step per batch; explicit: "
                        "one eager step per batch through the explicit "
                        "data-parallel steps (metrics summed every step)")
    p.add_argument("--feed-window", type=int, default=2,
                   help="per-batch input-plane depth for stepwise/explicit "
                        "modes: W counts the batch the step consumes plus "
                        "at most W-1 staged (host gather + copy to the "
                        "device) beyond it. 2 (default) is double "
                        "buffering: batch N+1 stages on a feeder thread "
                        "while the step for batch N runs; 1 disables the "
                        "feeder (staging inline on the main thread, "
                        "bit-identical trajectories). Worlds of more than "
                        "one process always stage inline. Scan mode "
                        "ignores this: its epoch prefetch already carries "
                        "the host gather and the copy")
    p.add_argument("--epoch-gather", type=str, default="host",
                   choices=["host", "device"],
                   help="scan-mode batch staging: 'host' gathers each "
                        "epoch's permuted copy on the host (pipelined on "
                        "a background thread); 'device' keeps the dataset "
                        "resident on device and gathers inside the "
                        "epoch program (index_select) — per-epoch upload "
                        "drops from the full dataset to a ~KB index "
                        "matrix")
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--keep-last", type=int, default=0, metavar="N",
                   help="prune per-epoch checkpoints more than N epochs "
                        "older than the latest published one (model_best "
                        "is never pruned); 0 keeps every epoch's file")
    p.add_argument("--publish", type=str, default="full",
                   choices=["full", "delta"],
                   help="checkpoint publish format: 'full' writes the "
                        "whole npz file per epoch (default); 'delta' "
                        "writes content-addressed chunks plus a small "
                        "manifest (distrib/): adjacent epochs share "
                        "unchanged chunks, so each publish costs O(changed "
                        "bytes) and a serving fleet fetches only what "
                        "moved")
    p.add_argument("--chunk-mb", type=float, default=4.0, metavar="MB",
                   help="delta publish chunk budget in MiB (fixed per-leaf "
                        "byte boundaries, so a small weight change dirties "
                        "one chunk, not the file). Default 4")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write checkpoints on a background thread, "
                        "overlapping the file IO with the next epoch (the "
                        "state is copied off the card first, so the saved "
                        "state is exactly the epoch's)")
    p.add_argument("--metrics-file", type=str, default=None,
                   help="append one JSON line per epoch")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the op that makes the "
                        "first NaN: stepwise and explicit check every op "
                        "of every step; scan checks each pass's loss sum "
                        "and re-runs a NaN pass eagerly under the same "
                        "checks")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here (one "
                        "Chrome trace per rank, with train/eval/checkpoint "
                        "spans per epoch)")
    p.add_argument("--elastic", action="store_true",
                   help="survive a rank's loss by SHRINKING the world: the "
                        "spawned world runs under the elastic supervisor "
                        "(runtime/elastic.py); on a PeerFailure the "
                        "survivors agree the shrunk membership and are "
                        "started again as a smaller world resumed from the "
                        "last published checkpoint. Requires --spawn")
    p.add_argument("--min-world", type=int, default=1, metavar="W",
                   help="elastic floor: stop shrinking (exit code "
                        "78) when fewer than W ranks remain (default 1)")
    p.add_argument("--elastic-grow", action="store_true",
                   help="at each epoch boundary rank 0 checks the elastic "
                        "directory for join records; when one is pending "
                        "the world yields and the supervisor rebuilds it "
                        "larger, resumed from the last published "
                        "checkpoint. Requires --elastic")
    p.add_argument("--max-world", type=int, default=0, metavar="W",
                   help="elastic ceiling: admit no joiner past W ranks "
                        "(0, the default: unbounded). Requires --elastic")
    p.add_argument("--agreement-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="deadline of every agreement between ranks (the "
                        "checkpoint phases, the dataset vote, the resume): "
                        "a rank that died outside an agreed phase no "
                        "longer strands its peers; the watchdog prints a "
                        "phase report and exits with PeerFailure naming "
                        "the silent ranks. Default: the "
                        "TPUMNIST_AGREEMENT_TIMEOUT env var, else 0 = off")
    p.add_argument("--compile-cache", type=str, default=None, metavar="DIR",
                   help="build directory of the CUDA kernel libraries and "
                        "the native host library, reused by later runs. "
                        "Default: the TPUMNIST_COMPILE_CACHE env var, else "
                        "<checkout>/build/torch_kernels; an empty string "
                        "builds into a fresh temporary directory")
    p.add_argument("--no-precompile", action="store_true",
                   help="build each kernel library at its first launch: by "
                        "default every library the run will launch is "
                        "built on a thread while the first epoch's data "
                        "stages")
    p.add_argument("--synthetic-train-size", type=int, default=60000)
    p.add_argument("--synthetic-test-size", type=int, default=10000)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default, raises without a card), cuda:N or "
                        "cpu; a rank on the card talks NCCL, on the CPU "
                        "gloo")
    return p


def _model_kwargs(args) -> dict:
    """The model's constructor arguments from the flags, with the JAX
    CLI's refusals of flags the model does not take."""
    model_kwargs = {}
    if args.dtype:
        model_kwargs["compute_dtype"] = _DTYPES[args.dtype]
    patch = args.patch_size
    if patch < 1 or 28 % patch:
        raise SystemExit(f"--patch-size {patch}: 28 must divide evenly into "
                         f"patches (try 2, 4, 7, or 14)")
    if args.attention == "flash":
        if not model_accepts(args.model, "attention_fn"):
            raise SystemExit(
                f"--attention {args.attention} not supported: model "
                f"{args.model!r} does not accept an attention_fn")
        from pytorch_distributed_mnist_tpu_torch.ops.flash import (
            flash_attention,
        )

        model_kwargs["attention_fn"] = flash_attention
    if patch != 4:
        if not model_accepts(args.model, "patch_size"):
            raise SystemExit(f"--patch-size only applies to models with "
                             f"patches; {args.model!r} does not accept one")
        model_kwargs["patch_size"] = patch
    if args.remat:
        if not model_accepts(args.model, "remat"):
            raise SystemExit(
                f"--remat only applies to block-structured models; "
                f"{args.model!r} does not accept it")
        model_kwargs["remat"] = True
    return model_kwargs


def _vit_num_heads() -> int:
    from pytorch_distributed_mnist_tpu_torch.models.registry import (
        model_field_default,
    )

    return model_field_default("vit", "num_heads")


def _moe_num_experts() -> int:
    from pytorch_distributed_mnist_tpu_torch.models.registry import (
        model_field_default,
    )

    return model_field_default("moe_mlp", "num_experts")


def _check_parallel_flags(args, n_devices: int) -> None:
    """The JAX CLI's refusals of the tensor-, sequence- and
    expert-parallel, MoE and ZeRO flags, in its order and words, before
    the model or the data is built. ``n_devices`` is the world's (one
    device per process)."""
    ep = args.expert_parallel
    tp = args.tensor_parallel
    sp = args.sequence_parallel
    pp = args.pipeline_stages
    patch = args.patch_size
    for flag, width in (("--expert-parallel", ep), ("--tensor-parallel", tp),
                        ("--sequence-parallel", sp),
                        ("--pipeline-stages", pp)):
        if width < 1:
            raise SystemExit(f"{flag} must be >= 1, got {width}")
    if args.tp_overlap and (tp < 2 or pp > 1):
        raise SystemExit(
            "--tp-overlap requires --tensor-parallel >= 2 without "
            "--pipeline-stages (it rewrites the pure DP x TP schedule; "
            "the pipeline's stage body is already an explicit program)")
    if ep > 1:
        # EP targets the MoE family; TP/SP/PP target the ViT: the mesh
        # families are disjoint.
        if tp > 1 or sp > 1 or pp > 1:
            raise SystemExit(
                "--expert-parallel does not combine with "
                "--tensor-parallel/--sequence-parallel/--pipeline-stages: "
                "EP shards the moe_mlp expert dim over a data x expert "
                "mesh; the others shard the ViT")
        if args.model != "moe_mlp":
            raise SystemExit(
                f"--expert-parallel requires --model moe_mlp (the EP rule "
                f"table shards the leading num_experts weight dim; other "
                f"models would silently stay replicated); got --model "
                f"{args.model}")
        if args.trainer_mode == "explicit":
            raise SystemExit(
                "--expert-parallel does not compose with --trainer-mode "
                "explicit (the explicit shard_map owns the whole mesh as "
                "a data axis); use scan or stepwise")
        num_experts = _moe_num_experts()
        if num_experts % ep:
            raise SystemExit(
                f"--expert-parallel {ep} must divide the moe_mlp's "
                f"{num_experts} experts")
        if n_devices % ep:
            raise SystemExit(
                f"--expert-parallel {ep} does not divide the "
                f"{n_devices} available devices")
    if args.optimizer_sharding == "zero3" and (tp > 1 or sp > 1 or ep > 1):
        raise SystemExit(
            "--optimizer-sharding zero3 composes with data parallelism "
            "only; combine TP/SP/EP with zero1 instead (README "
            "composition matrix)")
    grad_accum = args.grad_accum
    if grad_accum > 1 and pp > 1:
        # Each accumulation micro-batch feeds the pipeline, which divides
        # it again: per-dataslice size must still split into the
        # pipeline's own microbatches (== stages by default).
        dp_size = max(1, n_devices // pp)
        micro = args.batch_size // grad_accum
        if micro % dp_size or (micro // dp_size) % pp:
            raise SystemExit(
                f"--grad-accum {grad_accum} with --pipeline-stages {pp}: "
                f"each accumulation micro-batch ({micro}) must split over "
                f"{dp_size} data slices into a per-slice batch divisible "
                f"by {pp} pipeline microbatches")
    if ep > 1 and args.moe_dispatch == "capacity" \
            and (args.batch_size // grad_accum) % n_devices:
        raise SystemExit(
            f"--moe-dispatch capacity with --expert-parallel {ep}: "
            f"the per-step batch ({args.batch_size // grad_accum}) "
            f"must divide evenly over the {n_devices} "
            f"data x expert token groups")
    aux_weight = args.moe_aux_weight
    if aux_weight:
        if args.model != "moe_mlp":
            raise SystemExit(
                f"--moe-aux-weight applies to --model moe_mlp (the router "
                f"sows the load-balance loss); got --model {args.model}")
        if args.trainer_mode == "explicit":
            raise SystemExit(
                "--moe-aux-weight does not compose with --trainer-mode "
                "explicit; use scan or stepwise")
    if args.zero_overlap:
        if args.optimizer_sharding == "none":
            raise SystemExit(
                "--zero-overlap schedules the ZeRO weight update "
                "explicitly; pass --optimizer-sharding zero1 or zero3 "
                "with it")
        if args.trainer_mode == "explicit":
            raise SystemExit(
                "--zero-overlap does not compose with --trainer-mode "
                "explicit (both own the whole mesh as one shard_map "
                "data axis); use scan or stepwise")
        if tp > 1 or sp > 1 or ep > 1 or pp > 1:
            raise SystemExit(
                "--zero-overlap composes with data parallelism only; "
                "TP/SP/EP/PP layouts stay on the default "
                "propagation-scheduled path (drop --zero-overlap)")
        if aux_weight:
            raise SystemExit(
                "--zero-overlap does not compose with --moe-aux-weight "
                "(the sown aux statistic is a global-batch quantity; "
                "the overlapped body sees local shards)")
        if args.loss == "fused":
            raise SystemExit(
                "--zero-overlap does not compose with --loss fused "
                "(the fused kernel's shard_map cannot nest inside the "
                "overlapped step's shard_map over the same data axis)")
        if args.epoch_gather == "device":
            raise SystemExit(
                "--zero-overlap requires --epoch-gather host (the "
                "overlapped step is not embedded in the device-gather "
                "epoch program)")
        if args.zero_bucket_mb <= 0:
            raise SystemExit(
                f"--zero-bucket-mb must be > 0, got {args.zero_bucket_mb:g}")
    if pp > 1 and sp > 1:
        raise SystemExit(
            "--pipeline-stages does not compose with --sequence-parallel: "
            "the ring/Ulysses attention is itself a shard_map collective "
            "program and cannot nest inside the pipeline's shard_map body "
            "(see docs/DESIGN.md for the cost argument)")
    if pp > 1:
        _check_pp_flags(args, n_devices, pp, tp)
    elif tp > 1 or sp > 1:
        _check_tp_sp_flags(args, n_devices, tp, sp, patch)
    if args.moe_dispatch != "dense" and not model_accepts(args.model,
                                                          "dispatch"):
        raise SystemExit(
            f"--moe-dispatch only applies to MoE models; "
            f"{args.model!r} does not accept a dispatch mode")
    if args.optimizer_sharding == "zero1" \
            and args.optimizer not in ("adam", "adam_pallas"):
        raise SystemExit(
            f"--optimizer-sharding zero1 requires an Adam optimizer "
            f"(got --optimizer {args.optimizer}: no mu/nu moment state "
            f"to shard)")


def _check_pp_flags(args, n_devices: int, pp: int, tp: int) -> None:
    """The JAX CLI's refusals of a pipeline mesh, in its order and
    words."""
    if args.model != "vit":
        raise SystemExit(
            f"--pipeline-stages requires --model vit (the pipelined "
            f"architecture is embed -> N transformer blocks -> head); "
            f"got --model {args.model}")
    if args.optimizer_sharding == "zero3":
        raise SystemExit(
            "--pipeline-stages composes with --optimizer-sharding "
            "zero1 (moments sharded stage x data); zero3 would "
            "re-shard the stage-sharded params themselves (see "
            "docs/DESIGN.md)")
    if n_devices % (pp * tp):
        raise SystemExit(
            f"--pipeline-stages {pp}"
            + (f" x --tensor-parallel {tp}" if tp > 1 else "")
            + f" does not divide the {n_devices} available devices")
    if tp > 1:
        num_heads = _vit_num_heads()
        if num_heads % tp:
            raise SystemExit(
                f"--tensor-parallel {tp} with --pipeline-stages: the "
                f"Megatron stage body shards the ViT's {num_heads} "
                f"attention heads over the model axis, so the width "
                f"must divide {num_heads}")


def _check_tp_sp_flags(args, n_devices: int, tp: int, sp: int,
                       patch: int) -> None:
    """The JAX CLI's refusals of a ``('data', 'model', 'seq')`` mesh (its
    mesh block, then its flash-under-TP guard), in its order and words."""
    if args.model != "vit":
        raise SystemExit(
            f"--tensor-parallel/--sequence-parallel require --model "
            f"vit (the Megatron rule table and the ring attention "
            f"target its blocks; other models would silently stay "
            f"replicated); got --model {args.model}")
    flash_ok = (tp == 1 and sp > 1
                and args.sequence_parallel_impl == "ulysses") \
        or (tp > 1 and sp == 1)
    if args.attention == "flash" and not flash_ok:
        raise SystemExit(
            "--attention flash composes with "
            "--sequence-parallel-impl ulysses (full sequence per "
            "device, head subset) or with --tensor-parallel alone "
            "(kernel shard_mapped over batch x heads); the ring "
            "supplies its own blockwise attention")
    if n_devices % (tp * sp):
        raise SystemExit(
            f"--tensor-parallel {tp} x --sequence-parallel {sp} does "
            f"not divide the {n_devices} available devices")
    tokens = (28 // patch) ** 2
    num_heads = _vit_num_heads()
    if sp > 1:
        if tokens % sp:
            raise SystemExit(
                f"--sequence-parallel {sp} needs the token count "
                f"(28/patch)^2 divisible by it; --patch-size {patch} "
                f"gives {tokens} tokens — try --patch-size 7 "
                f"(16 tokens)")
        if args.trainer_mode == "explicit":
            raise SystemExit(
                "--sequence-parallel does not compose with "
                "--trainer-mode explicit (the ring's shard_map cannot "
                "nest inside the explicit-DP shard_map); use scan or "
                "stepwise")
        if tp > 1 and num_heads % tp:
            raise SystemExit(
                f"--tensor-parallel {tp} with --sequence-parallel: the "
                f"ring shards the ViT's {num_heads} attention heads "
                f"exactly over the model axis, so the width must "
                f"divide {num_heads}")
        if args.sequence_parallel_impl == "ulysses":
            if tp > 1:
                raise SystemExit(
                    "--sequence-parallel-impl ulysses does not compose "
                    "with --tensor-parallel: Ulysses re-shards the "
                    "head axis itself (all_to_all)")
            if num_heads % sp:
                raise SystemExit(
                    f"--sequence-parallel-impl ulysses shards the "
                    f"{num_heads} heads over the seq axis; "
                    f"--sequence-parallel {sp} must divide {num_heads}")
    if args.tp_overlap:
        if sp > 1:
            raise SystemExit(
                "--tp-overlap does not compose with "
                "--sequence-parallel: the overlapped schedule already "
                "shards the token axis (over 'model', between blocks)")
        if tokens % tp:
            raise SystemExit(
                f"--tp-overlap shards the ViT's {tokens} tokens over "
                f"--tensor-parallel {tp}, which does not divide "
                f"evenly; try --patch-size 7 (16 tokens)")
        if args.trainer_mode == "explicit":
            raise SystemExit(
                "--tp-overlap does not compose with --trainer-mode "
                "explicit (the overlapped shard_map cannot nest "
                "inside the explicit-DP shard_map); use scan or "
                "stepwise")
        if args.attention == "flash":
            raise SystemExit(
                "--tp-overlap hands attention this device's local "
                "heads directly inside its shard_map; --attention "
                "flash's GSPMD wrapper does not apply there")
        if args.optimizer_sharding != "none":
            raise SystemExit(
                "--tp-overlap uses the explicit head-major layout "
                "(parallel/pipeline_tp.py); the ZeRO rule composition "
                "targets the standard flax tree — drop "
                "--optimizer-sharding")
    if tp > 1 and sp == 1 and args.attention == "flash":
        # The kernel runs on each rank's (B/dp, T, H/tp, D) block.
        if num_heads % tp:
            raise SystemExit(
                f"--attention flash with --tensor-parallel {tp}: the "
                f"kernel shards the ViT's {num_heads} heads over the "
                f"model axis, so the width must divide {num_heads}")
        dp_width = n_devices // (tp * sp)
        micro = args.batch_size // args.grad_accum
        if micro % dp_width:
            raise SystemExit(
                f"--attention flash with --tensor-parallel {tp}: the "
                f"per-step batch ({micro}) must divide evenly over the "
                f"{dp_width} data slices for the kernel's shard_map")


def _check_grad_accum(args) -> None:
    """The JAX CLI's refusals of ``--grad-accum``, before any device or
    data is touched."""
    grad_accum = args.grad_accum
    if grad_accum < 1:
        raise SystemExit(f"--grad-accum must be >= 1, got {grad_accum}")
    if grad_accum > 1:
        if args.trainer_mode == "explicit":
            raise SystemExit(
                "--grad-accum does not compose with --trainer-mode "
                "explicit; use scan or stepwise")
        if args.batch_size % grad_accum:
            raise SystemExit(
                f"--grad-accum {grad_accum} must divide --batch-size "
                f"{args.batch_size}")


def _build_loaders(args, seed: int, axis):
    supervision.set_phase("data_stage")
    supervision.maybe_fault("data_stage")
    name = "mnist" if args.dataset == "synthetic" else args.dataset
    synthesize = args.dataset == "synthetic"
    workers = getattr(args, "workers", 4)

    if getattr(args, "download", False) and not synthesize:
        # Every process tries the (idempotent, atomically published)
        # download: right whether the ranks share a filesystem or not.
        from pytorch_distributed_mnist_tpu_torch.data.download import (
            download_dataset,
        )

        try:
            download_dataset(args.root, name)
        except supervision.InjectedFault:
            raise  # the chaos harness's process-local failure
        except Exception as exc:  # noqa: BLE001 - the vote below decides
            log0(f"WARNING: download of {name!r} failed: {exc}")

    preloaded = None
    if not synthesize and process_count() > 1:
        # Real or synthetic is AGREED across the world: unless every rank
        # can read the files, every rank takes the same exit (fail
        # together, or fall back to synthetic together), on the outcome
        # of the actual load, over the supervision records.
        def _try_load(train: bool):
            try:
                return load_dataset(args.root, name, train=train,
                                    synthesize_if_missing=False)
            except Exception as exc:  # noqa: BLE001 - any failure votes
                split = "train" if train else "test"
                print(f"process {process_index()}: failed to load {name} "
                      f"{split} split: {exc!r}", file=sys.stderr, flush=True)
                return None

        loaded = (_try_load(train=True), _try_load(train=False))
        ok = all(split is not None for split in loaded)
        records = supervision.allgather_records(
            "dataset_load", ok, "" if ok else f"{name} load failed")
        supervision.raise_if_poisoned(records, "the dataset agreement")
        n_ok = sum(1 for rec in records if rec.ok)
        if n_ok == len(records):
            preloaded = loaded
        else:
            if not args.allow_synthetic:
                hint = ("the download may have failed (see any warning "
                        "above)" if getattr(args, "download", False) else
                        "pre-download on every host, or pass --download")
                exc = SystemExit(
                    f"{name!r} is not present on every host "
                    f"({n_ok}/{len(records)} loaded it) — {hint}, or pass "
                    f"--allow-synthetic to train on labelled fake data, or "
                    f"--dataset synthetic.")
                supervision.mark_agreed(exc)  # every rank raises it
                raise exc
            log0(f"WARNING: {name!r} is not present on every host "
                 f"({n_ok}/{len(records)} loaded it); all hosts will use "
                 f"the synthetic fallback so training data stays "
                 f"consistent across the job")
            synthesize = True
            name = "mnist"
    used_synthetic = synthesize

    def load_split(train: bool):
        nonlocal used_synthetic
        n = args.synthetic_train_size if train else args.synthetic_test_size
        if not synthesize:
            try:
                return load_dataset(args.root, name, train=train,
                                    synthesize_if_missing=False)
            except FileNotFoundError:
                split = "train" if train else "test"
                if not args.allow_synthetic:
                    hint = ("the download may have failed (see the warning "
                            "above)" if getattr(args, "download", False)
                            else "pass --download to fetch it")
                    raise SystemExit(
                        f"no {name} {split}-split IDX files under "
                        f"{args.root!r} — {hint}, or pass --allow-synthetic "
                        f"to train on labelled fake data, or --dataset "
                        f"synthetic.") from None
                log0(f"WARNING: no {name} {split}-split IDX files under "
                     f"{args.root!r}; using the synthetic fallback dataset")
                used_synthetic = True
        return load_dataset(args.root, name, train=train,
                            synthetic_train_size=n, synthetic_test_size=n,
                            seed=seed)

    if preloaded is not None:
        (train_images, train_labels), (test_images, test_labels) = preloaded
    else:
        train_images, train_labels = load_split(train=True)
        test_images, test_labels = load_split(train=False)
    # Each rank takes its shard of every global batch; eval shards too in
    # a world of more than one (padded and masked, the counts summed).
    train_loader = MNISTDataLoader(
        normalize_images(train_images, workers=workers), train_labels,
        batch_size=args.batch_size, train=True, num_replicas=axis.size,
        rank=axis.rank, seed=seed, workers=workers)
    test_loader = MNISTDataLoader(
        normalize_images(test_images, workers=workers), test_labels,
        batch_size=args.batch_size, train=False, num_replicas=axis.size,
        rank=axis.rank, seed=seed, shard=axis.size > 1, workers=workers)
    return train_loader, test_loader, used_synthetic


def _resolve_resume_auto(args) -> str:
    """``--resume auto``'s one agreed path ('' = none). Only process 0
    resolves; its record carries the path (or its error), so every rank
    resumes from the same checkpoint, or all exit together: ranks resuming
    at different epochs would run different numbers of collectives."""
    if process_count() <= 1:
        return latest_checkpoint(args.checkpoint_dir) or ""
    detail, err = "", None
    if process_index() == 0:
        try:
            resolved = latest_checkpoint(args.checkpoint_dir) or ""
            if len(resolved.encode()) > supervision.DETAIL_BYTES:
                raise ValueError(
                    f"checkpoint path is {len(resolved.encode())} bytes, "
                    f"over the {supervision.DETAIL_BYTES}-byte "
                    f"resume-resolution record; use a shorter "
                    f"--checkpoint-dir")
            detail = resolved
        except Exception as exc:  # noqa: BLE001 - agreed below
            err = repr(exc)
    records = supervision.allgather_records(
        "resume_resolve", err is None, detail if err is None else err)
    supervision.raise_if_poisoned(records, "resume resolution")
    leader = records[0]
    if not leader.ok:
        exc = SystemExit("--resume auto: resolution failed on process 0: "
                         + leader.detail)
        supervision.mark_agreed(exc)  # every rank raises it
        raise exc
    return leader.detail


def _note_cross_world_resume(resume_path: str) -> None:
    """A checkpoint saved by another world (an elastic rebuild, or any
    relaunch at a new size) is said so up front and recorded as a
    ``checkpoint_reshard`` event labelled ``grow`` or ``shrink``. Whole
    leaves load in any world; unreadable meta is left to the load."""
    try:
        saved = checkpoint_world(resume_path)
    except Exception:  # noqa: BLE001 - the load classifies the damage
        return
    if not saved:
        return
    current = {"processes": process_count(), "devices": process_count()}
    if saved != current:
        direction = ("grow" if (current["processes"], current["devices"])
                     > (saved["processes"], saved["devices"]) else "shrink")
        failure_events.record(
            "checkpoint_reshard",
            f"{resume_path}: saved by a {saved['processes']}-process/"
            f"{saved['devices']}-device world; resharding onto this "
            f"{current['processes']}-process/{current['devices']}-device "
            f"world ({direction})", saved=saved, current=current,
            direction=direction)
        log0(f"=> checkpoint '{resume_path}' was saved at world "
             f"{saved['processes']}x{saved['devices']} (processes x "
             f"devices); resharding onto {current['processes']}x"
             f"{current['devices']} ({direction})")


def _resume(args, state):
    """``(state, start_epoch, best_acc, path)`` under the agreement
    protocol. The ranks agree the load's OUTCOME, not just the path: all
    go on at the same epoch, or all exit with the same error. Under
    ``--resume auto`` a newest checkpoint that is corrupt on every rank
    is quarantined (process 0 renames it, the outcome agreed) and the
    next-older one tried; a mismatch (another model or optimizer), or an
    outcome that differs across ranks, raises."""
    supervision.set_phase("resume")
    supervision.maybe_fault("resume")
    auto = args.resume == "auto"
    multi = process_count() > 1
    while True:
        if auto:
            path = _resolve_resume_auto(args)
            if not path:
                log0(f"=> --resume auto: no checkpoint in "
                     f"'{args.checkpoint_dir}' yet, training fresh")
                return state, 0, 0.0, ""
        else:
            path = args.resume
        if path and (os.path.isfile(path) or os.path.isdir(path)):
            _note_cross_world_resume(path)
        if not (multi and path):
            try:
                state, start_epoch, best_acc = try_resume(path, state)
            except Exception as exc:
                if auto and is_corrupt_checkpoint_error(exc):
                    dest = quarantine_checkpoint(path)
                    failure_events.record("checkpoint_quarantined",
                                          f"{path} -> {dest}: {exc!r}")
                    log0(f"=> quarantined corrupt checkpoint {path!r} -> "
                         f"{dest!r} ({exc!r}); falling back to the "
                         f"next-older epoch")
                    continue
                raise
            return state, start_epoch, best_acc, path

        err: Optional[BaseException] = None
        start_epoch, best_acc = 0, 0.0
        try:
            state, start_epoch, best_acc = try_resume(path, state)
            outcome = str(start_epoch)
        except Exception as exc:  # noqa: BLE001 - agreed below
            print(f"process {process_index()}: resume from {path!r} "
                  f"failed: {exc!r}", file=sys.stderr, flush=True)
            err = exc
            outcome = (("corrupt:" if is_corrupt_checkpoint_error(exc)
                        else "error:") + repr(exc))
        records = supervision.allgather_records("resume_load", err is None,
                                                outcome)
        if err is not None:
            supervision.mark_agreed(err)  # delivered just above
        supervision.raise_if_poisoned(records, "the resume agreement")
        epochs = [int(rec.detail) if rec.ok else -1 for rec in records]
        if all(e == epochs[0] for e in epochs):
            if err is None:
                return state, start_epoch, best_acc, path
            all_corrupt = all(rec.detail.startswith("corrupt:")
                              for rec in records if not rec.ok)
            if all_corrupt and auto:
                qerr: Optional[BaseException] = None
                dest = ""
                if process_index() == 0:
                    try:
                        dest = quarantine_checkpoint(path)
                    except Exception as exc:  # noqa: BLE001
                        qerr = exc
                failed = supervision.agree("resume_quarantine", qerr)
                if failed and qerr is None:
                    raise supervision.PeerFailure(
                        supervision.peer_failure_message(
                            failed, f"quarantine of corrupt checkpoint "
                                    f"{path!r} failed on host(s) "
                                    f"{[h for h, _, _ in failed]};"),
                        hosts=[h for h, _, _ in failed],
                        phase="resume_quarantine", reason=failed[0][2])
                if qerr is not None:
                    raise qerr
                failure_events.record(
                    "checkpoint_quarantined",
                    f"{path} -> {dest or '(renamed on process 0)'}: "
                    f"{err!r}")
                log0(f"=> quarantined corrupt checkpoint {path!r} "
                     f"({err!r}); falling back to the next-older epoch")
                continue
            raise err  # the same on every rank (agreed above)
        exc = SystemExit(
            f"resume outcome diverged across hosts for {path!r}: start "
            f"epochs {epochs} (-1 = load failed). A rank resuming at "
            f"another epoch runs other collectives: check that "
            f"--checkpoint-dir is one filesystem for every rank and the "
            f"checkpoint is intact on every one.")
        supervision.mark_agreed(exc)  # every rank raises it
        raise exc


def _run_kernels(args) -> list:
    """The CUDA kernel libraries (``ops/cuda_build.py``) a run with these
    flags launches: what the precompile builds."""
    names = []
    if args.loss == "fused":
        names.append("xent")
    if args.optimizer == "adam_pallas":
        names.append("adam")
    if args.attention == "flash" and model_accepts(args.model,
                                                   "attention_fn"):
        from pytorch_distributed_mnist_tpu_torch.ops.flash import (
            FUSED_MAX_T,
        )

        if args.dtype == "f32":
            names.append("flash_tf32")
        else:
            tokens = (28 // args.patch_size) ** 2
            names += ["flash_fwd", "flash_bwd" if tokens <= FUSED_MAX_T
                      else "flash_bwd_tiled"]
    return names


def run(args, epoch_callback=None) -> dict:
    """Train (or, with ``-e``, evaluate) as the flags say; returns a
    summary dict. ``epoch_callback(epoch, history_row) -> bool`` fires
    after each epoch's checkpoint, on every rank; True stops the loop.
    The rendezvous, when the flags or the environment ask for one, comes
    before the model is built, and the process group it made is
    destroyed on every exit.

    The body runs under the agreed-exit protocol
    (``runtime/supervision.py``): any failure on this rank is reported
    (stderr and ``failure_events``, with its phase), then writes its
    survivor record when it is an elastic worker unwinding on a
    peer's failure, then delivers a poison pill to the peers' next
    agreement, then arms the exit escalation of a peer failure (exit 75),
    and re-raises."""
    if args.epoch_gather == "device" and args.trainer_mode != "scan":
        raise SystemExit(
            "--epoch-gather device requires --trainer-mode scan (the "
            "gather lives inside the scanned epoch program)")
    _check_grad_accum(args)
    if args.feed_window < 1:
        raise SystemExit(f"--feed-window must be >= 1, got "
                         f"{args.feed_window}")
    if args.chunk_mb <= 0:
        raise SystemExit(f"--chunk-mb must be > 0, got {args.chunk_mb}")
    model_kwargs = _model_kwargs(args)
    device = resolve_device(args.device)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, device)
    # The switch is process-wide: on for this run only, so a later run in
    # the same process without the flag does not inherit it.
    try:
        _check_parallel_flags(args, process_count())
        with debug_nans.enabled_for(args.debug_nans):
            return _run_in_world(args, model_kwargs, device, epoch_callback)
    except BaseException as exc:
        if not (isinstance(exc, SystemExit)
                and exc.code in (0, None, elastic.EXIT_GROW)):
            supervision.report_failure(exc)
        # The survivor record first (local file IO), before a pill that
        # may wait its whole bound on a dead transport.
        elastic.write_survivor_record(exc)
        supervision.deliver_poison(exc)
        supervision.escalate_exit(exc)
        raise
    finally:
        teardown()


def _run_in_world(args, model_kwargs: dict, device: torch.device,
                  epoch_callback) -> dict:
    """:func:`run` once this process is in its world."""
    build_dir = compile_cache.configure(getattr(args, "compile_cache", None))
    compile_log.reset()
    agreement_timeout = supervision.configure(
        getattr(args, "agreement_timeout", None))
    failure_events.reset()
    # Attached right after the reset, so even resume-time events (a
    # quarantine) reach the stream.
    sink = (JsonlSink(args.metrics_file)
            if args.metrics_file and process_index() == 0 else None)
    if sink is not None:
        failure_events.set_sink(sink, source="train")
    elastic.note_rebuilt_world()
    log0(args)
    log0(f"build directory: {build_dir}")
    if agreement_timeout:
        log0(f"agreement watchdog: {agreement_timeout:g}s deadline")
    seed = args.seed if args.seed is not None else 0
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)
    ep, pp = args.expert_parallel, args.pipeline_stages
    tp, sp = args.tensor_parallel, args.sequence_parallel
    if pp > 1 and tp > 1:
        # PP x TP: the stage body runs the explicit Megatron block
        # (parallel/pipeline_tp.py).
        mesh = make_mesh(("data", "stage", "model"),
                         shape=(process_count() // (pp * tp), pp, tp),
                         device=device)
    elif pp > 1:
        mesh = make_mesh(("data", "stage"),
                         shape=(process_count() // pp, pp), device=device)
    elif tp > 1 or sp > 1:
        mesh = make_mesh(("data", "model", "seq"),
                         shape=(process_count() // (tp * sp), tp, sp),
                         device=device)
    elif ep > 1:
        mesh = make_mesh(("data", "expert"),
                         shape=(process_count() // ep, ep), device=device)
    else:
        mesh = make_mesh(device=device)
    # Batches shard, and gradients and metrics sum, over the data axis.
    axis = mesh.data
    log0(f"devices: {mesh.size} ({'gpu' if device.type == 'cuda' else 'cpu'}"
         f"), processes: {process_count()}, mesh: {mesh.shape}")
    local_batch = args.batch_size // axis.size
    if (args.grad_accum > 1 and args.batch_size % axis.size == 0
            and local_batch % args.grad_accum):
        # Each process splits its own rows: the micro-batch must be whole
        # on every rank, as the JAX step's micro-batch must divide evenly
        # over its data shards.
        raise SystemExit(
            f"--grad-accum {args.grad_accum} must divide the per-process "
            f"batch ({local_batch}: --batch-size {args.batch_size} over "
            f"{axis.size} processes)")
    # Every kernel library the run will launch builds on a thread while
    # the data stages (-e runs one pass: nothing to overlap).
    precompile = None
    if (device.type == "cuda" and not args.evaluate
            and not getattr(args, "no_precompile", False)):
        precompile = cuda_build.Precompile(_run_kernels(args))
    set_loss_impl(args.loss)
    if args.moe_dispatch != "dense":
        model_kwargs["dispatch"] = args.moe_dispatch
    if model_accepts(args.model, "mesh") and mesh.reduces and pp == 1:
        # The MoE splits its experts over the expert axis, offsets its
        # capacity positions and sums its aux statistic over the data
        # axis; the ViT runs Megatron blocks over the model axis and
        # shards its tokens over the seq axis: they need the mesh; one
        # process runs them alone. (The pipeline builds its own stage
        # bodies on the mesh, from the mesh-less model.)
        model_kwargs["mesh"] = mesh
    if sp > 1:
        # The attention over the seq axis; under --attention flash (the
        # Ulysses composition alone passes the checks) the kernels are
        # its per-rank local attention (full sequence, local heads).
        local_attn = model_kwargs.pop("attention_fn", None)
        if args.sequence_parallel_impl == "ulysses":
            from pytorch_distributed_mnist_tpu_torch.parallel.ulysses import (
                ulysses_attention,
            )

            model_kwargs["attention_fn"] = functools.partial(
                ulysses_attention, mesh=mesh, axis="seq", batch_axis="data",
                local_attention=local_attn)
        else:
            from pytorch_distributed_mnist_tpu_torch.parallel.ring import (
                ring_attention,
            )

            # The ring's blockwise online softmax IS the attention.
            assert local_attn is None, "ring+flash must be refused earlier"
            model_kwargs["attention_fn"] = functools.partial(
                ring_attention, mesh=mesh, axis="seq", batch_axis="data",
                head_axis="model" if tp > 1 else None)
    elif tp > 1 and pp == 1 and model_kwargs.get("attention_fn") is not None:
        # --tensor-parallel + --attention flash: the kernels on each
        # rank's (B/dp, T, H/tp, D) block, whole heads by the rules.
        # (Under --pipeline-stages the kernels need no wrapper: the
        # Megatron stage body hands them this rank's heads.)
        from pytorch_distributed_mnist_tpu_torch.ops.flash import (
            sharded_flash_attention,
        )

        model_kwargs["attention_fn"] = functools.partial(
            sharded_flash_attention, mesh=mesh, batch_axis="data",
            head_axis="model")
    pp_sharding = None
    if pp > 1:
        # The pipelined split tree and the GPipe schedule, whole until it
        # is placed below, after the resume: once, onto the pipeline's
        # layout or ZeRO's composed on it.
        from pytorch_distributed_mnist_tpu_torch.parallel import (
            pipeline_tp,
            pipeline_vit,
        )

        create_pp_state = (pipeline_tp.create_pipelined_tp_vit_state
                           if tp > 1 else
                           pipeline_vit.create_pipelined_vit_state)
        state, pp_sharding = create_pp_state(
            get_model(args.model, **model_kwargs), seed, mesh, device,
            data_axis="data", lr=args.lr, optimizer=args.optimizer,
            momentum=args.momentum, weight_decay=args.weight_decay,
            place=False)
    elif tp > 1 and args.tp_overlap:
        # The head-major split tree and the collective-matmul schedule
        # (parallel/tensor.py); placed below, after the resume.
        from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
            create_overlap_tp_vit_state,
        )

        model_kwargs.pop("mesh", None)
        state, _ = create_overlap_tp_vit_state(
            get_model(args.model, **model_kwargs), seed, mesh, device,
            lr=args.lr, optimizer=args.optimizer, momentum=args.momentum,
            weight_decay=args.weight_decay, place=False)
    else:
        state = create_train_state(
            get_model(args.model, **model_kwargs), seed, device, lr=args.lr,
            optimizer=args.optimizer, momentum=args.momentum,
            weight_decay=args.weight_decay)
    state, start_epoch, best_acc, resume_path = _resume(args, state)
    if not (resume_path and start_epoch > 0):
        # A resumed checkpoint's epoch wins over --start-epoch.
        start_epoch = args.start_epoch
    rules = None
    if pp > 1:
        if args.optimizer_sharding == "none":
            pipeline_vit.place_state(state, mesh, pp_sharding)
    elif tp > 1:
        # Megatron's rules over 'model' (head-aligned qkv), or the
        # overlapped schedule's on its split tree. ZeRO composes
        # rules-first, its moments claiming the rest.
        from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
            overlap_tp_rules,
            shard_state,
            vit_tp_rules,
        )

        rules = (overlap_tp_rules("model") if args.tp_overlap
                 else vit_tp_rules("model"))
        if args.optimizer_sharding == "none":
            shard_state(state, mesh, rules)
    elif ep > 1:
        # The expert weights' leading num_experts dim splits over
        # 'expert' (parallel/expert.py); router, embed and head replicate.
        # ZeRO composes rules-first, its moments claiming the rest.
        from pytorch_distributed_mnist_tpu_torch.parallel.expert import (
            moe_ep_rules,
        )
        from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
            shard_state,
        )

        rules = moe_ep_rules("expert")
        if args.optimizer_sharding == "none":
            shard_state(state, mesh, rules)
    if args.optimizer_sharding != "none":
        from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
            shard_state_zero,
        )

        # Under --pipeline-stages the pipeline's layout is the base: the
        # stage-split block moments gain a data dim, the embed and head
        # moments shard over data alone.
        shard_state_zero(
            state, mesh, rules=rules,
            level=3 if args.optimizer_sharding == "zero3" else 1,
            base_sharding=pp_sharding,
            bucket_mb=args.zero_bucket_mb if args.zero_overlap else None,
            overlap=args.zero_overlap)
    train_loader, test_loader, synthesized = _build_loaders(args, seed, axis)
    if precompile is not None:
        precompile.join()
    trainer = Trainer(state, train_loader, test_loader, device,
                      mode=args.trainer_mode, epoch_gather=args.epoch_gather,
                      staging_log=StagingLog(), axis=axis,
                      grad_accum=args.grad_accum,
                      feed_window=args.feed_window,
                      aux_weight=args.moe_aux_weight,
                      zero_overlap=args.zero_overlap)
    # closing(trainer) joins an in-flight epoch prefetch on every exit.
    with closing(trainer):
        summary = _train_or_evaluate(args, trainer, start_epoch, best_acc,
                                     synthesized, epoch_callback, sink)
    stats = compile_log.stats()
    for name, rec in stats["builds"].items():
        log0(f"build[{name}]: {rec['built']} built "
             f"({rec['seconds']:.1f} s), {rec['reused']} reused")
    events = failure_events.snapshot()
    for ev in events:
        log0(f"supervision[{ev['kind']}]: {ev['detail']}")
    return {**summary, "compile_stats": stats, "failure_events": events}


def _train_or_evaluate(args, trainer, start_epoch: int, best_acc: float,
                       synthesized: bool, epoch_callback, sink) -> dict:
    """The epoch loop of :func:`run` (or, with ``-e``, one eval pass)."""
    train_loader = trainer.train_loader
    lr_of = step_decay_schedule(args.lr)
    if args.evaluate:
        supervision.set_phase("eval")
        test_loss, test_acc = trainer.evaluate()
        log0(f"Test Loss: {test_loss}, Test Acc: {test_acc}")
        return {"test_loss": test_loss.average,
                "test_acc": test_acc.accuracy, "best_acc": best_acc,
                "start_epoch": start_epoch, "epochs_run": 0}

    timer = StepTimer()
    history = []
    # The saver as a context: a clean exit waits for the last write and
    # raises its error; an exception still lands the write in flight.
    saver = AsyncCheckpointer() if args.async_checkpoint else None
    grow_joiners = None
    with profile_trace(args.profile_dir,
                       cuda=trainer.device.type == "cuda"), \
            (saver if saver is not None else contextlib.nullcontext()):
        for epoch in range(start_epoch, args.epochs):
            train_loader.set_sample_epoch(epoch)
            # No epoch follows the last one: stage no gather nothing will
            # use.
            trainer.prefetch_enabled = epoch + 1 < args.epochs
            trainer.state.with_learning_rate(lr_of(epoch))
            # The pass reads its metrics back before it returns, so the
            # timed span holds all of the epoch's device work and nothing
            # else.
            supervision.set_phase(f"train@{epoch}")
            with timer.measure(len(train_loader) * args.batch_size), \
                    phase("train", epoch=epoch):
                train_loss, train_acc = trainer.train()
            supervision.set_phase(f"eval@{epoch}")
            with phase("eval", epoch=epoch):
                test_loss, test_acc = trainer.evaluate()
            synth_tag = ", dataset: synthetic" if synthesized else ""
            log0(f"Epoch: {epoch}/{args.epochs}, lr: {lr_of(epoch):g},"
                 f" train loss: {train_loss}, train acc: {train_acc},"
                 f" test loss: {test_loss}, test acc: {test_acc}"
                 f"{synth_tag}")
            is_best = test_acc.accuracy > best_acc
            best_acc = max(test_acc.accuracy, best_acc)
            supervision.set_phase(f"checkpoint@{epoch}")
            ckpt_kwargs = dict(
                epoch=epoch, best_acc=best_acc, is_best=is_best,
                directory=args.checkpoint_dir, keep_last=args.keep_last,
                parallel_layout={"tensor": args.tensor_parallel,
                                 "sequence": args.sequence_parallel,
                                 "expert": args.expert_parallel,
                                 "pipeline": args.pipeline_stages},
                publish=args.publish, chunk_mb=args.chunk_mb)
            if saver is not None:
                # The span is the drain of the previous epoch's write and
                # this epoch's copy off the device; the write itself runs
                # on the saver's thread.
                with phase("checkpoint_drain", epoch=epoch):
                    saver.save(trainer.state, **ckpt_kwargs)
            else:
                with phase("checkpoint", epoch=epoch):
                    save_checkpoint(trainer.state, **ckpt_kwargs)
            history.append({"epoch": epoch,
                            "train_loss": train_loss.average,
                            "train_acc": train_acc.accuracy,
                            "test_loss": test_loss.average,
                            "test_acc": test_acc.accuracy,
                            "images_per_sec": timer.last_images_per_sec})
            if sink is not None:
                sink.write({**history[-1], "lr": lr_of(epoch),
                            "best_acc": best_acc,
                            "dataset": ("synthetic" if synthesized
                                        else args.dataset)})
            if epoch_callback is not None and \
                    epoch_callback(epoch, history[-1]):
                break
            if epoch + 1 < args.epochs:
                # The elastic grow rendezvous (a no-op outside an
                # --elastic-grow supervisor). On a yes, break: the saver's
                # clean exit publishes this epoch first, and only then
                # does the world yield.
                grow_joiners = elastic.maybe_grow_rendezvous()
                if grow_joiners:
                    break
    if grow_joiners:
        elastic.yield_for_grow(grow_joiners)
    supervision.set_phase("shutdown")
    ips = timer.images_per_sec
    # The reference's line; one device per process.
    per_chip = ips / process_count()
    log0(f"throughput: {ips:,.0f} images/sec ({per_chip:,.0f}/chip), "
         f"best acc: {best_acc * 100:.2f}%")
    return {"best_acc": best_acc, "history": history,
            "images_per_sec": ips,
            "checkpoint_drain_ms": None if saver is None else saver.drain_ms,
            "dataset_synthesized": synthesized,
            "start_epoch": start_epoch, "epochs_run": len(history),
            "staging": trainer.staging_log.summary()}


def _settle_seconds(args) -> float:
    """How long a spawned world's survivors get to exit on their own once
    a rank failed: the agreement deadline, the poison pill's bound and
    the exit escalation's grace when a deadline is set, else none."""
    timeout = supervision.resolve_timeout(
        getattr(args, "agreement_timeout", None))
    return 2 * timeout + 15.0 if timeout > 0 else 0.0


def _spawn(args, argv: list) -> int:
    """``--spawn N``: the JAX CLI's refusals, then one card per rank on the
    card (never two NCCL ranks on one card, and never a rank moved to the
    CPU unasked), then the local world, under the elastic supervisor with
    ``--elastic``; returns its exit code."""
    if args.spawn < 2:
        raise SystemExit(
            f"--spawn {args.spawn}: the local spawner simulates a "
            "multi-host world and needs at least 2 processes; for a "
            "single-process run just drop --spawn")
    if (args.coordinator or args.process_id is not None
            or args.num_processes is not None):
        raise SystemExit(
            "--spawn forks its own local world; it cannot combine with "
            "--coordinator/--num-processes/--process-id (those join an "
            "existing one)")
    if torch.device(args.device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards < args.spawn:
            print(f"--spawn {args.spawn} on {args.device}: NCCL needs one "
                  f"card per rank and {cards} card(s) are visible; "
                  f"--device cpu runs a gloo world on the CPU",
                  file=sys.stderr)
            return 2
    if args.elastic:
        # A rank's loss shrinks the world (the survivors start again as a
        # smaller one, resumed from the last published checkpoint)
        # instead of ending it; with --elastic-grow, joiners grow it.
        return elastic.supervise(
            args.spawn, argv, min_world=args.min_world,
            max_world=args.max_world, grow=args.elastic_grow,
            device=args.device)
    from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
        spawn_local,
    )

    return spawn_local(args.spawn, argv, device=args.device,
                       settle=_settle_seconds(args))


def _check_elastic_flags(args) -> None:
    """The JAX CLI's refusals of the elastic flags."""
    if args.elastic and not args.spawn:
        raise SystemExit(
            "--elastic supervises the worker processes it spawns, so it "
            "requires --spawn N (the local world). On a cluster the "
            "restart actor is the cluster manager — "
            "runtime/elastic.py::supervise is the reference "
            "implementation to integrate there.")
    if args.min_world < 1:
        raise SystemExit(f"--min-world must be >= 1, got {args.min_world}")
    if args.elastic and args.min_world > args.spawn:
        raise SystemExit(f"--min-world {args.min_world} exceeds the initial "
                         f"world size --spawn {args.spawn}")
    if (args.elastic_grow or args.max_world) and not args.elastic:
        raise SystemExit(
            "--elastic-grow/--max-world shape the elastic supervisor's "
            "grow direction; they require --elastic (and --spawn N)")
    if args.max_world < 0 or (args.elastic and args.max_world
                              and args.max_world < args.spawn):
        raise SystemExit(f"--max-world {args.max_world} is below the "
                         f"initial world size --spawn {args.spawn} (0 = "
                         f"unbounded)")


def main(argv: Optional[list] = None) -> None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from pytorch_distributed_mnist_tpu_torch.serve.server import (
            main as serve_main,
        )

        serve_main(argv[1:])
        return
    if argv and argv[0] == "route":
        from pytorch_distributed_mnist_tpu_torch.serve.router import (
            main as route_main,
        )

        route_main(argv[1:])
        return
    args = build_parser().parse_args(argv)
    _check_elastic_flags(args)
    if args.spawn:
        raise SystemExit(_spawn(args, argv))
    try:
        run(args)
    except BaseException as exc:
        if not getattr(exc, "_escalated", False):
            raise
        # Dying on a peer's failure: the watchdog's exit code, with the
        # error printed as an uncaught one would be.
        traceback.print_exc()
        sys.stderr.flush()
        raise SystemExit(HARD_EXIT_CODE) from None
