"""Command-line entry of the port.

``python -m pytorch_distributed_mnist_tpu_torch [flags]`` trains, as the
JAX package's bare command does: per-epoch reshuffle, train, eval, the
reference's epoch line, ``checkpoint_{e}.npz`` plus ``model_best.npz``,
``--resume`` (a path or ``auto``) and ``-e`` to evaluate only. It runs on
the card unless ``--device cpu`` is given.
``python -m pytorch_distributed_mnist_tpu_torch serve ...`` boots the HTTP
inference server (``serve/server.py``).

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
process group. Flags for meshes of more than the data axis, ZeRO and
elastic runs are not accepted yet.

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
import random
import sys
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
from pytorch_distributed_mnist_tpu_torch.ops.loss import set_loss_impl
from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_object,
    initialize_distributed,
    process_count,
    process_index,
    teardown,
)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
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
from pytorch_distributed_mnist_tpu_torch.utils import debug_nans
from pytorch_distributed_mnist_tpu_torch.utils.device import resolve_device
from pytorch_distributed_mnist_tpu_torch.utils.logging import log0
from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
    JsonlSink,
    StagingLog,
    StepTimer,
    phase,
    profile_trace,
)

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
                   help="accepted for parity with the JAX package; the port "
                        "gathers batches on the main thread")
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
    p.add_argument("--dataset", type=str, default="mnist",
                   choices=["mnist", "fashion_mnist", "synthetic"])
    p.add_argument("--allow-synthetic", action="store_true",
                   help="if the real dataset's IDX files are missing, train "
                        "on the labelled synthetic dataset instead of "
                        "exiting")
    p.add_argument("--dtype", type=str, default=None, choices=list(_DTYPES),
                   help="compute dtype; default bfloat16 activations with "
                        "float32 params and logits. f32 also turns TF32 "
                        "off on the card")
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
    name = "mnist" if args.dataset == "synthetic" else args.dataset
    synthesize = args.dataset == "synthetic"
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
                    raise SystemExit(
                        f"no {name} {split}-split IDX files under "
                        f"{args.root!r} — place them there, or pass "
                        f"--allow-synthetic to train on labelled fake data, "
                        f"or --dataset synthetic.") from None
                log0(f"WARNING: no {name} {split}-split IDX files under "
                     f"{args.root!r}; using the synthetic fallback dataset")
                used_synthetic = True
        return load_dataset(args.root, name, train=train,
                            synthetic_train_size=n, synthetic_test_size=n,
                            seed=seed)

    train_images, train_labels = load_split(train=True)
    test_images, test_labels = load_split(train=False)
    # Each rank takes its shard of every global batch; eval shards too in
    # a world of more than one (padded and masked, the counts summed).
    train_loader = MNISTDataLoader(normalize_images(train_images),
                                   train_labels, batch_size=args.batch_size,
                                   train=True, num_replicas=axis.size,
                                   rank=axis.rank, seed=seed)
    test_loader = MNISTDataLoader(normalize_images(test_images), test_labels,
                                  batch_size=args.batch_size, train=False,
                                  num_replicas=axis.size, rank=axis.rank,
                                  seed=seed, shard=axis.size > 1)
    return train_loader, test_loader, used_synthetic


def _resume(args, state):
    """``(state, start_epoch, best_acc, path)``. Under ``--resume auto`` a
    corrupt newest checkpoint is quarantined and the next-older one
    tried; a mismatch (another model or optimizer) raises. In a world of
    processes every rank loads the file process 0 resolved: ranks that
    resumed at different epochs would run different numbers of
    collectives."""
    auto = args.resume == "auto"
    while True:
        if auto:
            path = broadcast_object(latest_checkpoint(args.checkpoint_dir)
                                    if process_index() == 0 else None)
            if not path:
                log0(f"=> --resume auto: no checkpoint in "
                     f"'{args.checkpoint_dir}' yet, training fresh")
                return state, 0, 0.0, ""
        else:
            path = args.resume
        try:
            state, start_epoch, best_acc = try_resume(path, state)
        except Exception as exc:
            if auto and is_corrupt_checkpoint_error(exc):
                # Every rank read the same bytes; process 0 moves the file
                # once all have.
                barrier()
                if process_index() == 0:
                    dest = quarantine_checkpoint(path)
                    log0(f"=> quarantined corrupt checkpoint {path!r} -> "
                         f"{dest!r} ({exc!r}); falling back to the "
                         f"next-older epoch")
                barrier()
                continue
            raise
        return state, start_epoch, best_acc, path


def run(args, epoch_callback=None) -> dict:
    """Train (or, with ``-e``, evaluate) as the flags say; returns a
    summary dict. ``epoch_callback(epoch, history_row) -> bool`` fires
    after each epoch's checkpoint, on every rank; True stops the loop.
    The rendezvous, when the flags or the environment ask for one, comes
    before the model is built, and the process group it made is
    destroyed on every exit."""
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
        with debug_nans.enabled_for(args.debug_nans):
            return _run_in_world(args, model_kwargs, device, epoch_callback)
    finally:
        teardown()


def _run_in_world(args, model_kwargs: dict, device: torch.device,
                  epoch_callback) -> dict:
    """:func:`run` once this process is in its world."""
    log0(args)
    seed = args.seed if args.seed is not None else 0
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)
    axis = make_mesh(device=device)
    log0(f"devices: {axis.size} ({'gpu' if device.type == 'cuda' else 'cpu'}"
         f"), processes: {process_count()}, mesh: {axis.shape}")
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
    set_loss_impl(args.loss)
    state = create_train_state(
        get_model(args.model, **model_kwargs), seed, device, lr=args.lr,
        optimizer=args.optimizer, momentum=args.momentum,
        weight_decay=args.weight_decay)
    state, start_epoch, best_acc, resume_path = _resume(args, state)
    if not (resume_path and start_epoch > 0):
        # A resumed checkpoint's epoch wins over --start-epoch.
        start_epoch = args.start_epoch
    train_loader, test_loader, synthesized = _build_loaders(args, seed, axis)
    trainer = Trainer(state, train_loader, test_loader, device,
                      mode=args.trainer_mode, epoch_gather=args.epoch_gather,
                      staging_log=StagingLog(), axis=axis,
                      grad_accum=args.grad_accum,
                      feed_window=args.feed_window)
    # closing(trainer) joins an in-flight epoch prefetch on every exit.
    with closing(trainer):
        return _train_or_evaluate(args, trainer, start_epoch, best_acc,
                                  synthesized, epoch_callback)


def _train_or_evaluate(args, trainer, start_epoch: int, best_acc: float,
                       synthesized: bool, epoch_callback) -> dict:
    """The epoch loop of :func:`run` (or, with ``-e``, one eval pass)."""
    train_loader = trainer.train_loader
    lr_of = step_decay_schedule(args.lr)
    if args.evaluate:
        test_loss, test_acc = trainer.evaluate()
        log0(f"Test Loss: {test_loss}, Test Acc: {test_acc}")
        return {"test_loss": test_loss.average,
                "test_acc": test_acc.accuracy, "best_acc": best_acc,
                "start_epoch": start_epoch, "epochs_run": 0}

    sink = (JsonlSink(args.metrics_file)
            if args.metrics_file and process_index() == 0 else None)
    timer = StepTimer()
    history = []
    # The saver as a context: a clean exit waits for the last write and
    # raises its error; an exception still lands the write in flight.
    saver = AsyncCheckpointer() if args.async_checkpoint else None
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
            with timer.measure(len(train_loader) * args.batch_size), \
                    phase("train", epoch=epoch):
                train_loss, train_acc = trainer.train()
            with phase("eval", epoch=epoch):
                test_loss, test_acc = trainer.evaluate()
            synth_tag = ", dataset: synthetic" if synthesized else ""
            log0(f"Epoch: {epoch}/{args.epochs}, lr: {lr_of(epoch):g},"
                 f" train loss: {train_loss}, train acc: {train_acc},"
                 f" test loss: {test_loss}, test acc: {test_acc}"
                 f"{synth_tag}")
            is_best = test_acc.accuracy > best_acc
            best_acc = max(test_acc.accuracy, best_acc)
            ckpt_kwargs = dict(
                epoch=epoch, best_acc=best_acc, is_best=is_best,
                directory=args.checkpoint_dir, keep_last=args.keep_last,
                parallel_layout={"tensor": 1, "sequence": 1, "expert": 1,
                                 "pipeline": 1},
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
    ips = timer.images_per_sec
    # The reference's line; one device per process.
    per_chip = ips / trainer.axis.size
    log0(f"throughput: {ips:,.0f} images/sec ({per_chip:,.0f}/chip), "
         f"best acc: {best_acc * 100:.2f}%")
    return {"best_acc": best_acc, "history": history,
            "images_per_sec": ips,
            "checkpoint_drain_ms": None if saver is None else saver.drain_ms,
            "dataset_synthesized": synthesized,
            "start_epoch": start_epoch, "epochs_run": len(history),
            "staging": trainer.staging_log.summary()}


def _spawn(args, argv: list) -> int:
    """``--spawn N``: the JAX CLI's refusals, then one card per rank on the
    card (never two NCCL ranks on one card, and never a rank moved to the
    CPU unasked), then the local world; returns its exit code."""
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
    from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
        spawn_local,
    )

    return spawn_local(args.spawn, argv, device=args.device)


def main(argv: Optional[list] = None) -> None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from pytorch_distributed_mnist_tpu_torch.serve.server import (
            main as serve_main,
        )

        serve_main(argv[1:])
        return
    args = build_parser().parse_args(argv)
    if args.spawn:
        raise SystemExit(_spawn(args, argv))
    run(args)
