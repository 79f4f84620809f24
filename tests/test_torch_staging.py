"""The port's per-batch input staging (``data/staging.py::BatchFeeder``,
``--feed-window``) on the CPU: the feeder changes when a batch is staged,
never what. Window 1 is the trainer's inline staging bit for bit, and a
window of 2 or more yields the same batches in the same order; the
snapshot of an epoch's indices, the feeder's errors, its window bound and
its thread's lifetime, as the JAX package's ``tests/test_staging.py``
holds them for its feeder. Every comparison here is exact."""

import threading
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.data import staging
from pytorch_distributed_mnist_tpu_torch.data.loader import (
    MNISTDataLoader,
    to_device,
)
from pytorch_distributed_mnist_tpu_torch.data.staging import BatchFeeder
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer
from pytorch_distributed_mnist_tpu_torch.utils.profiling import StagingLog

torch.set_num_threads(2)
CPU = torch.device("cpu")
JOIN_S = 10  # seconds a feeder thread may take to end


def _loader(n=200, bs=32, seed=7):
    rng = np.random.default_rng(0)
    images = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    return MNISTDataLoader(images, np.arange(n) % 10, batch_size=bs,
                           train=True, seed=seed)


def _collect(batches) -> list:
    return [{k: t.clone() for k, t in b.items()} for b in batches]


def _assert_same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            assert torch.equal(x[key], y[key]), key


def _feeder_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "input-feeder"]


@pytest.mark.parametrize("window", [1, 2, 4])
def test_every_window_yields_the_loaders_batches_in_order(window):
    loader = _loader()
    loader.set_sample_epoch(3)
    want = [to_device(b, CPU) for b in loader]
    feeder = BatchFeeder(loader, CPU, window=window)
    assert feeder.pipelined == (window > 1)
    _assert_same(_collect(feeder.epoch()), want)
    assert not _feeder_threads()


def test_the_epoch_snapshot_holds_across_a_sampler_jump():
    loader = _loader()
    loader.set_sample_epoch(0)
    want = [to_device(b, CPU) for b in loader]
    feeder = BatchFeeder(loader, CPU, window=2)
    epoch = feeder.epoch()  # the indices are taken here
    loader.set_sample_epoch(5)  # a resume jump before the first batch
    _assert_same(_collect(epoch), want)
    # The next epoch() snapshots the new epoch.
    _assert_same(_collect(feeder.epoch()),
                 [to_device(b, CPU) for b in loader])


def test_a_feeder_error_reaches_the_consumer(monkeypatch):
    loader = _loader()
    real = loader.host_batch
    calls = []

    def failing(row, mrow):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk gone")
        return real(row, mrow)

    monkeypatch.setattr(loader, "host_batch", failing)
    feeder = BatchFeeder(loader, CPU, window=2)
    got = []
    with pytest.raises(OSError, match="disk gone"):
        for batch in feeder.epoch():
            got.append(batch)
    assert len(got) == 2
    feeder.close()
    assert not _feeder_threads()


def test_close_joins_the_thread_of_an_abandoned_epoch():
    feeder = BatchFeeder(_loader(), CPU, window=3)
    epoch = feeder.epoch()
    next(epoch)  # the feeder now runs ahead, then blocks on the window
    time.sleep(0.05)
    assert _feeder_threads()
    feeder.close()
    deadline = time.monotonic() + JOIN_S
    while _feeder_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _feeder_threads()
    feeder.close()  # idempotent


def test_the_window_bounds_the_staged_batches(monkeypatch):
    loader = _loader(n=320)
    feeder = BatchFeeder(loader, CPU, window=3)
    staged_max = [0]
    real_stage = feeder._stage_pipelined

    def stage(row, mrow):
        run = feeder._active_run  # None until epoch() has stored it
        if run is not None:
            staged_max[0] = max(staged_max[0], len(run._staged))
        return real_stage(row, mrow)

    monkeypatch.setattr(feeder, "_stage_pipelined", stage)
    n = 0
    for _ in feeder.epoch():
        time.sleep(0.01)  # a slow consumer: the feeder fills the window
        n += 1
    assert n == 10
    # While it stages a batch, at most window - 2 others wait beyond the
    # one the consumer holds: window - 1 in all.
    assert staged_max[0] == feeder.window - 2


def test_a_world_of_processes_stages_inline(monkeypatch):
    monkeypatch.setattr(staging, "process_count", lambda: 2)
    feeder = BatchFeeder(_loader(), CPU, window=2)
    assert not feeder.pipelined
    log = StagingLog()
    feeder.staging_log = log
    _collect(feeder.epoch())
    assert not _feeder_threads()
    summary = log.summary()
    assert summary["stages"] == 6 and summary["pipelined_stages"] == 0
    assert summary["overlap_fraction"] == 0.0


def test_the_staging_log_records_each_stage():
    log = StagingLog()
    feeder = BatchFeeder(_loader(), CPU, window=2, staging_log=log)
    _collect(feeder.epoch())
    summary = log.summary()
    assert summary["stages"] == summary["pipelined_stages"] == 6
    assert summary["images"] == 6 * 32


def test_a_window_below_1_is_refused(tmp_path):
    with pytest.raises(ValueError, match="feed window must be >= 1"):
        BatchFeeder(_loader(), CPU, window=0)
    with pytest.raises(SystemExit) as info:
        cli.run(cli.build_parser().parse_args([
            "--feed-window", "0", "--device", "cpu", "--checkpoint-dir",
            str(tmp_path)]))
    assert str(info.value.code) == "--feed-window must be >= 1, got 0"


def test_a_ring_buffer_is_reused_only_after_its_copy(monkeypatch):
    # PinnedRing, under the feeder's batch buffers and the scan trainer's
    # epoch buffers: buffers in turn, and a buffer handed out again only
    # once the event of its last copy has been waited on. A stand-in for
    # torch.cuda.Event records what happens (no card here).
    log = []

    class Event:
        def record(self):
            log.append(("record", self))

        def synchronize(self):
            log.append(("sync", self))

    monkeypatch.setattr(staging.torch.cuda, "Event", Event)
    made = []
    ring = staging.PinnedRing(2, lambda: made.append(len(made)) or {},
                              pin=True)
    assert made == [0, 1]
    assert [ring.take(), ring.take()] == [0, 1]
    assert log == []  # no copy yet: nothing to wait on
    first = ring.copied(0)
    assert log == [("record", first)]
    assert ring.take() == 0
    assert log[-1] == ("sync", first)
    assert ring.take() == 1 and len(log) == 2  # buffer 1 was never copied
    # Off the card the buffers carry no event.
    plain = staging.PinnedRing(3, dict, pin=False)
    assert [plain.take() for _ in range(4)] == [0, 1, 2, 0]
    assert plain.copied(0) is None


@pytest.mark.parametrize("mode", ["stepwise", "explicit"])
def test_windows_1_and_2_train_bit_for_bit_alike(mode):
    results = {}
    for window in (1, 2):
        loader, test = _loader(seed=1), _loader(n=64, seed=1)
        state = create_train_state(get_model("linear"), 0, CPU)
        trainer = Trainer(state, loader, test, CPU, mode=mode,
                          feed_window=window, staging_log=StagingLog())
        history = []
        for epoch in range(2):
            loader.set_sample_epoch(epoch)
            loss, acc = trainer.train()
            history.append((loss.sum, acc.correct, acc.count))
        trainer.close()
        results[window] = (history, [p.detach().clone()
                                     for p in state.model.parameters()])
    assert results[1][0] == results[2][0]
    for a, b in zip(results[1][1], results[2][1]):
        assert torch.equal(a, b)
    assert not _feeder_threads()


def test_the_cli_prints_the_same_lines_at_windows_1_and_2(tmp_path, capsys):
    lines = {}
    for window in ("1", "2"):
        summary = cli.run(cli.build_parser().parse_args([
            "--dataset", "synthetic", "--model", "linear",
            "--synthetic-train-size", "256", "--synthetic-test-size", "64",
            "--batch-size", "64", "--epochs", "2", "--seed", "0",
            "--trainer-mode", "stepwise", "--feed-window", window,
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / window)]))
        lines[window] = [ln for ln in capsys.readouterr().out.splitlines()
                         if ln.startswith("Epoch: ")]
        assert summary["staging"]["stages"] == 8
        assert summary["staging"]["pipelined_stages"] == (
            8 if window == "2" else 0)
    assert len(lines["1"]) == 2 and lines["1"] == lines["2"]


def test_batches_stay_in_order_under_rapid_thread_switches():
    # A stress run of the conduit: the interpreter switches threads every
    # microsecond while the feeder races a consumer that takes batches as
    # fast as it can; every epoch must come out as the inline one, and no
    # feeder thread may outlive its epoch.
    import sys

    loader = _loader(n=256, bs=8)
    want = [to_device(b, CPU) for b in loader]
    feeder = BatchFeeder(loader, CPU, window=3)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            _assert_same(_collect(feeder.epoch()), want)
    finally:
        sys.setswitchinterval(before)
    deadline = time.monotonic() + JOIN_S
    while _feeder_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _feeder_threads()
