"""One run of a cell on one card: set-up, the warm-up epoch, the probe
that decides ``correct``, the measured window and, with ``--trace 1``,
the traced span of whole epochs.

What the window drives is the port's normal epoch, as its CLI's epoch
loop (``cli.py::_train_or_evaluate``) does it without the checkpoint
write: ``Trainer.train()`` then ``Trainer.evaluate()``, the learning rate
of ``step_decay_schedule`` by epoch index, in ``--trainer-mode scan``
with the host epoch gather, the native data path and its 4 workers,
``--loss fused`` and ``--optimizer adam_pallas`` (the ViT with
``--attention flash``). The window runs whole epochs until ``seconds``
have passed and ends at the end of the last one.

Every step of the window is a replay of the train and eval graphs that
the warm-up epoch (epoch 0) captured. So the probe comes after it and
runs through those replays: the train state, as the seed made it before
the warm-up, is copied back into the same tensors in place; one eval
pass (``Trainer.evaluate()``) reads the test loss at the initial
weights; then three train steps, each through the trainer's epoch
program on a one-batch view of its staged epoch: row 0 of the epochs
:func:`probe_epochs` names, each staged and at its epoch's learning
rate, as the window's epochs are. A view that starts at row 0 holds the
staged arrays' own addresses, so the program replays the graph it
captured on them. The window then goes on from the probe's state.
"""

from __future__ import annotations

import argparse
import gc
import os
import time
from typing import Dict, List, Optional

from portbench.core import check, data, spec, trace
from portbench.core.spec import Cell

TRACE_MIN_S = 0.5  # the traced span holds whole epochs until this long


class Clock:
    """Named marks from the process's start, for ``setup_s`` and its
    split."""

    def __init__(self, start: float) -> None:
        self.start = start
        self.marks: Dict[str, float] = {}
        self._last = start

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.marks[name] = now - self._last
        self._last = now

    def since_start(self) -> float:
        return time.perf_counter() - self.start


def cuda_env(root: str) -> None:
    """Every build and kernel cache of the program at a fixed directory
    inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["TPUMNIST_COMPILE_CACHE"] = os.path.join(build,
                                                        "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def model_kwargs(cell: Cell, torch) -> dict:
    """The port's model constructor arguments for the configuration, as
    the CLI's flags would give them."""
    cfg = cell.config
    kw = {"num_classes": cfg["num_classes"],
          "compute_dtype": getattr(torch, cfg["compute_dtype"])}
    if cfg["model"] == "vit":
        from pytorch_distributed_mnist_tpu_torch.ops.flash import (
            flash_attention,
        )

        kw.update(patch_size=cell.traffic["patch_size"],
                  embed_dim=cfg["embed_dim"], depth=cfg["depth"],
                  num_heads=cfg["num_heads"], mlp_ratio=cfg["mlp_ratio"])
        if cfg["attention"] == "flash":
            kw["attention_fn"] = flash_attention
    return kw


def kernel_libraries(cell: Cell) -> List[str]:
    """The CUDA libraries the cell's flags launch, as the CLI lists them
    for its precompile."""
    from pytorch_distributed_mnist_tpu_torch import cli

    cfg = cell.config
    flags = argparse.Namespace(
        loss=cfg["loss"], optimizer=cfg["optimizer"], model=cfg["model"],
        attention=cfg.get("attention", "dense"), dtype=None,
        patch_size=cell.traffic.get("patch_size", 4))
    return cli._run_kernels(flags)


def probe_epochs(cfg: dict) -> List[int]:
    """The staged epochs whose row 0 the probe trains on: the last at the
    warm-up's learning rate and the first two at the first decayed one,
    so a graph that kept the rate it was captured with shows."""
    every = cfg["lr_decay_every"]
    return [every - 1, every, every + 1]


def lr_of(cfg: dict):
    from pytorch_distributed_mnist_tpu_torch.train.lr_schedule import (
        step_decay_schedule,
    )

    return step_decay_schedule(cfg["lr"], cfg["lr_decay"],
                               cfg["lr_decay_every"])


class Rank:
    """The port's objects for one seed on one device: the data on the
    host, the weights, the state and a copy of it as the seed made it,
    the loaders and the trainer."""

    def __init__(self, cell: Cell, seed: int, device, ref,
                 clock: Optional[Clock] = None) -> None:
        import torch

        from pytorch_distributed_mnist_tpu_torch.data.loader import (
            MNISTDataLoader,
        )
        from pytorch_distributed_mnist_tpu_torch.models import get_model
        from pytorch_distributed_mnist_tpu_torch.models.convert import (
            state_leaves,
        )
        from pytorch_distributed_mnist_tpu_torch.ops.loss import (
            set_loss_impl,
        )
        from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
            make_mesh,
        )
        from pytorch_distributed_mnist_tpu_torch.train.state import (
            create_train_state,
        )
        from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer
        from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
            StagingLog,
        )

        class EpochStaging(StagingLog):
            """The trainer's staging log, keeping each epoch's wait."""

            def __init__(self) -> None:
                super().__init__()
                self.waits: List[float] = []

            def record_wait(self, wait_ms: float) -> None:
                super().record_wait(wait_ms)
                self.waits.append(wait_ms)

        if clock is not None:
            clock.mark("port_imports")
        cfg, traffic = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        made = data.dataset(traffic, seed, device)
        self.host = {k: v.cpu().numpy() for k, v in made.items()}
        leaves = ref.leaves(cfg, traffic)
        self.weights = {k: v.cpu() for k, v in
                        data.make_weights(leaves, seed, device).items()}
        del made
        if clock is not None:
            clock.mark("data_weights")
        set_loss_impl(cfg["loss"])
        model = get_model(cfg["model"], **model_kwargs(cell, torch))
        self.state = create_train_state(model, seed, device, lr=cfg["lr"],
                                        optimizer=cfg["optimizer"],
                                        init=False)
        params = dict(model.named_parameters())
        if sorted(params) != sorted(self.weights) or any(
                tuple(params[k].shape) != tuple(w.shape)
                for k, w in self.weights.items()):
            raise RuntimeError(
                f"the port's {cfg['model']} does not hold the configuration's "
                f"leaves: {sorted((k, tuple(p.shape)) for k, p in params.items())}")
        if sum(p.numel() for p in params.values()) != cfg.get(
                "parameters", sum(p.numel() for p in params.values())):
            raise RuntimeError(f"the port's {cfg['model']} holds another "
                               f"parameter count than the configuration")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(self.weights[k])
        # The state as the seed made it, on the host, for the probe.
        self._leaves = lambda: [t for _, t in state_leaves(self.state)]
        self._initial = [t.detach().cpu().clone() for t in self._leaves()]
        batch = traffic["batch_size"]
        workers = cfg["workers"]
        axis = make_mesh(device=device).data
        self.train_loader = MNISTDataLoader(
            self.host["train_image"], self.host["train_label"],
            batch_size=batch, train=True, num_replicas=1, rank=0, seed=seed,
            workers=workers)
        test_loader = MNISTDataLoader(
            self.host["test_image"], self.host["test_label"],
            batch_size=batch, train=False, num_replicas=1, rank=0,
            seed=seed, shard=False, workers=workers)
        self.staging = EpochStaging()
        self.trainer = Trainer(self.state, self.train_loader, test_loader,
                               device, mode=cfg["trainer_mode"],
                               epoch_gather=cfg["epoch_gather"],
                               staging_log=self.staging, axis=axis)
        self.lr_of = lr_of(cfg)
        self.probe_epochs = probe_epochs(cfg)

    # -- the probe -------------------------------------------------------

    def probe(self) -> dict:
        """The program's readings (``check.py``), after the warm-up epoch
        has captured the graphs: the state as the seed made it copied
        back in place, one eval pass, then one train step on row 0 of
        each of :attr:`probe_epochs`' staged batches, at its epoch's
        learning rate."""
        import torch

        trainer, state = self.trainer, self.state
        with torch.no_grad():
            for t, saved in zip(self._leaves(), self._initial):
                t.copy_(saved)
        eval_loss, _acc = trainer.evaluate()
        out = {"eval_loss": eval_loss.average, "losses": [], "counts": []}
        opt = state.optimizer
        params = dict(state.model.named_parameters())
        names = {id(p): n for n, p in params.items()}
        b1 = float(opt.hyperparams["b1"])
        state.model.train()
        for epoch in self.probe_epochs:
            self.train_loader.set_sample_epoch(epoch)
            state.with_learning_rate(self.lr_of(epoch))
            staged = trainer._staged_train_epoch()
            ms = trainer._train_epoch({k: v[:1] for k, v in staged.items()})
            out["losses"].append(float(ms.loss_sum) / float(ms.count))
            out["counts"].append(float(ms.count))
            if "grads" not in out:
                out["grads"] = {names[id(p)]: opt.state[p]["mu"].cpu()
                                / (1 - b1) for p in opt.params}
                out["grad_norms"] = {k: float(g.norm())
                                     for k, g in out["grads"].items()}
        out["counts"].append(float(eval_loss.count))
        with torch.no_grad():
            out["changes"] = {n: p.detach().cpu() - self.weights[n]
                              for n, p in params.items()}
        # As the warm-up's train pass left it: the window's first epoch
        # in gathering on the prefetch thread.
        self.train_loader.set_sample_epoch(0)
        trainer._start_prefetch()
        return out

    def probe_batches(self, device) -> List[dict]:
        """The probe's batches for the reference, from the sampler's
        arithmetic, each with its learning rate."""
        import torch

        batch = self.train_loader.local_batch_size
        steps = []
        for epoch in self.probe_epochs:
            rows = data.batch_rows(len(self.host["train_label"]), self.seed,
                                   epoch, 0, batch)
            steps.append({
                "images": torch.from_numpy(
                    self.host["train_image"][rows]).to(device),
                "labels": torch.from_numpy(
                    self.host["train_label"][rows]).to(device),
                "lr": self.lr_of(epoch)})
        return steps

    def epoch(self, epoch: int, spans: bool = False) -> float:
        """One epoch as the CLI runs it, without the checkpoint; returns
        the eval pass's host ms."""
        from torch.profiler import record_function

        self.train_loader.set_sample_epoch(epoch)
        self.state.with_learning_rate(self.lr_of(epoch))
        span = (record_function if spans else _no_span)
        with span(trace.SPAN_PREFIX + "train_pass"):
            self.trainer.train()
        t0 = time.perf_counter()
        with span(trace.SPAN_PREFIX + "eval_pass"):
            self.trainer.evaluate()
        return (time.perf_counter() - t0) * 1e3

    def close(self) -> None:
        self.trainer.close()


class _no_span:
    def __init__(self, name: str) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def set_up(rank: Rank, clock: Optional[Clock] = None) -> dict:
    """The warm-up epoch (epoch 0: the eager ticks and the graphs'
    captures), then the probe; returns the program's readings."""
    rank.epoch(0)
    if clock is not None:
        clock.mark("warmup_epoch")
    prog = rank.probe()
    if clock is not None:
        clock.mark("probe")
    return prog


def reference_numbers(cell: Cell, rank: Rank, prog: dict, device):
    """The gaps of ``prog`` (the program's readings) from the float32
    reference's, computed on ``device``, and the reference's readings."""
    import torch

    ref = spec.load_module("reference", cell.model)
    against = check.reference_readings(
        ref, cell.config, cell.traffic,
        {k: w.to(device) for k, w in rank.weights.items()},
        rank.probe_batches(device),
        torch.from_numpy(rank.host["test_image"]).to(device),
        torch.from_numpy(rank.host["test_label"]).to(device), "f32")
    return check.gaps(prog, against), against


def _trace_epochs(rank: Rank, epoch: int, torch, launches):
    """Trace whole epochs from ``epoch`` until :data:`TRACE_MIN_S`; returns
    (epochs run, the trace, the counters' change over it)."""
    before = launches.read_counts()
    t0 = time.perf_counter()
    n = 0
    with trace.tracing(torch) as prof:
        while True:
            rank.epoch(epoch + n, spans=True)
            n += 1
            if time.perf_counter() - t0 >= TRACE_MIN_S:
                break
        torch.cuda.synchronize()
    after = launches.read_counts()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    return n, trace.read(prof, torch), delta


def _complete(tr, delta, copies: int) -> Optional[str]:
    """None when the trace holds every launch of the port's kernels that
    its counters counted over the span and each train pass's staging
    copies; else what it lacks."""
    want, got = trace.expected_counts(delta), tr.own_counts()
    per_pass = trace.copies_per_pass(tr)
    if want and want == got and all(n == copies for n in per_pass):
        return None
    return (f"the port's kernels {got} where its counters say {want}; "
            f"host-to-device copies per train pass {per_pass} where the "
            f"trainer makes {copies}")


def run(cell: Cell, seed: int, seconds: float, traced: bool, clock: Clock,
        device_name: Optional[str] = None, log=print) -> dict:
    """One run's fields for the result."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build, launches
    from pytorch_distributed_mnist_tpu_torch.utils import compile_cache

    clock.mark("cuda_init")
    on_card = device_name is None
    device = (torch.device("cuda", 0) if on_card
              else torch.device(device_name))
    if on_card:
        torch.cuda.set_device(device)
        compile_cache.configure()
        build = cuda_build.build(kernel_libraries(cell))
        from pytorch_distributed_mnist_tpu_torch.data import native

        if native.enabled():
            native.build()
        built_s = sum(b["seconds"] for b in build.values())
        log(f"portbench: libraries {sorted(build)}, built in {built_s:.3f} s "
            f"(0 where reused)")
    clock.mark("build_or_load")
    ref = spec.load_module("reference", cell.model)
    rank = Rank(cell, seed, device, ref, clock)
    clock.mark("state_trainer")
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    prog = set_up(rank, clock)
    setup_s = clock.since_start()
    steps = rank.train_loader.steps_per_epoch
    images_per_epoch = steps * rank.train_loader.local_batch_size
    waits_from = len(rank.staging.waits)

    epoch, eval_ms, traced_rec = 1, [], None
    t0 = time.perf_counter()
    while True:
        if traced and traced_rec is None:
            copies = len(rank.trainer._device_epoch)  # one copy a tensor
            for attempt in range(2):
                n, tr, delta = _trace_epochs(rank, epoch, torch, launches)
                lacks = _complete(tr, delta, copies)
                epoch += n
                if lacks is None:
                    break
                log(f"portbench: the trace of epochs {epoch - n}-{epoch - 1} "
                    f"is incomplete: {lacks}"
                    + ("; taking it again" if attempt == 0 else
                       "; no metric is read from it"))
            traced_rec = {"epochs": n, "trace": tr, "complete": lacks is None}
            lo, hi = tr.bounds
            log(f"portbench: traced {n} epochs, {n * images_per_epoch} "
                f"images in {(hi - lo) / 1e9:.6f} s "
                f"({n * images_per_epoch * 1e9 / (hi - lo):.1f} images/s)")
        else:
            eval_ms.append(rank.epoch(epoch))
            epoch += 1
        if time.perf_counter() - t0 >= seconds and \
                len(eval_ms) >= (3 if traced else 0):
            break
    if on_card:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    epochs = epoch - 1
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # The probe's state restore set the optimizer's count back to 0.
    expected_steps = len(rank.probe_epochs) + steps * epochs
    steps_taken = int(rank.state.optimizer.count)
    waits = rank.staging.waits[waits_from:]
    result = {"window_s": window_s, "epochs": epochs, "setup_s": setup_s,
              "images": images_per_epoch * epochs, "peak": peak,
              "split": dict(clock.marks), "traced": traced_rec is not None}
    if traced_rec is not None:
        result["layers"] = layer_metrics(cell, rank, traced_rec, eval_ms,
                                         waits)
        tr = traced_rec["trace"]
        lo, hi = tr.bounds
        result["busy_s"] = trace.busy_ns(tr) / 1e9
        result["span_s"] = (hi - lo) / 1e9
        result["breakdown"] = trace.breakdown(tr)
    rank.close()

    # The window has closed and the peak is read: free the program, then
    # the reference.
    del rank.trainer, rank.state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, _ref = reference_numbers(cell, rank, prog, device)
    numbers["optimizer_steps_gap"] = abs(steps_taken - expected_steps)
    result["numbers"] = numbers
    return result


def layer_metrics(cell: Cell, rank: Rank, rec: dict, eval_ms: List[float],
                  waits: List[float]) -> dict:
    """Every per-layer metric of the cell that its reader finds."""
    ctx = Context(cell, rank, rec, eval_ms, waits)
    out = {}
    for metric in cell.per_layer:
        value = spec.load_module("metrics", metric["name"]).read(ctx)
        if value is not None:
            out[metric["name"]] = value
    return out


class Context:
    """What a per-layer reader reads: the traced span (``trace``, the
    epochs in it, whether it was complete), the window's host records
    (``eval_ms``, ``waits``), and the cell's sizes."""

    def __init__(self, cell: Cell, rank: Rank, rec: dict,
                 eval_ms: List[float], waits: List[float]) -> None:
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.trace = rec["trace"]
        self.epochs = rec["epochs"]
        self.complete = rec["complete"]
        self.steps_per_epoch = rank.train_loader.steps_per_epoch
        self.local_batch = rank.train_loader.local_batch_size
        self.train_steps = self.epochs * self.steps_per_epoch
        self.parameters = sum(p.numel()
                              for p in rank.state.model.parameters())
        self.eval_images = cell.traffic["test_images"]
        self.eval_ms = eval_ms
        self.waits = waits

    def train_windows(self):
        return self.trace.span_times("train_pass")

    def train_records(self):
        return self.trace.within(self.train_windows())

    def per_train_step_ms(self, pick) -> Optional[float]:
        """Device ms per train step of the train passes' records for
        which ``pick(name)`` holds; None from an incomplete trace or when
        none is found."""
        if not self.complete:
            return None
        ns = sum(e - s for name, s, e, kind in self.train_records()
                 if kind == "kernel" and pick(name))
        return ns / 1e6 / self.train_steps if ns else None

    @property
    def span_s(self) -> float:
        lo, hi = self.trace.bounds
        return (hi - lo) / 1e9
