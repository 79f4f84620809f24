"""The port's replica pool (``serve/pool.py``) on CPU replicas: the cases
of ``tests/test_serve_pool.py`` and ``tests/test_pool_heal.py`` (replicas
answering as one engine, least-loaded dispatch, the reload fan-out and
its ordering rule, failover, quarantine, regroup, resize, the injection
hook), the engine's device scoping, and the port's pool against the JAX
``EnginePool`` on the same batches from one JAX checkpoint.

The JAX pool runs on the JAX package's CPU devices; its int8 plane is
built as the JAX server builds it (``int8_dot_general`` through the
model's ``dot_general`` field: the Pallas ``matmul_i8`` in interpret
mode). Sabotaged engines drive the failure paths deterministically; the
regroup path rebuilds real engines from the pool's own configuration."""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import (
    normalize_images,
    synthetic_dataset,
)
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.ops.pallas import int8_dot_general
from pytorch_distributed_mnist_tpu.serve.engine import (
    load_params_for_serving as jax_load_params,
)
from pytorch_distributed_mnist_tpu.serve.pool import EnginePool as JaxPool
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import create_train_state
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import int8_linear
from pytorch_distributed_mnist_tpu_torch.serve import engine as engine_mod
from pytorch_distributed_mnist_tpu_torch.serve.batcher import MicroBatcher
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    InferenceEngine,
    load_params_for_serving,
)
from pytorch_distributed_mnist_tpu_torch.serve.pool import (
    SERVE_FAULT_ENV,
    EnginePool,
    _parse_serve_fault,
)
from pytorch_distributed_mnist_tpu_torch.serve.reload import CheckpointWatcher
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    save_params_checkpoint,
)
from pytorch_distributed_mnist_tpu_torch.utils.device import (
    CPU_SLOTS,
    local_devices,
)
from pytorch_distributed_mnist_tpu_torch.utils.profiling import ServeLog

pytestmark = pytest.mark.serve
torch.set_num_threads(2)

CPU = torch.device("cpu")


def _linear():
    return get_model("linear", compute_dtype=torch.float32)


def _cpus(n):
    return [CPU] * n


@pytest.fixture(scope="module")
def setup():
    images, _ = synthetic_dataset(64, seed=3)
    return init_params("linear", 0), images


def _direct_labels(params, raw_images):
    model = _linear().eval()
    x = torch.from_numpy(normalize_images(raw_images))
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    with torch.no_grad():
        logits = torch.func.functional_call(model, tensors, (x,))
    return logits.argmax(-1).numpy()


def _pool(params, n=3, buckets=(8,), **kwargs):
    kwargs.setdefault("params_epoch", 1)
    pool = EnginePool(_linear, params, devices=_cpus(n), buckets=buckets,
                      **kwargs)
    pool.warmup()
    return pool


def _drive_pool(pool, request_stacks, max_inflight):
    """Closed-loop drive through the pipelined batcher; each request's
    (labels, epochs) in submit order."""
    def complete(handle):
        labels, epoch = pool.predict_complete(handle)
        tag = np.full_like(labels, -1 if epoch is None else epoch)
        return np.stack([labels, tag], axis=1)

    results = []
    with MicroBatcher(None, max_batch=pool.max_batch, max_wait_s=0.002,
                      dispatch_fn=pool.dispatch, complete_fn=complete,
                      max_inflight=max_inflight) as batcher:
        pendings = [batcher.submit(pool.preprocess(stack))
                    for stack in request_stacks]
        for p in pendings:
            out = batcher.result(p, timeout=60.0)
            results.append((out[:, 0].tolist(), sorted(set(out[:, 1]))))
    return results


def _serve_ok(pool, params, images):
    labels, _ = pool.predict_complete(pool.dispatch(
        pool.preprocess(images[:8])))
    np.testing.assert_array_equal(labels, _direct_labels(params, images[:8]))


class _DeadInflight:
    def __init__(self, inner):
        self.inner = inner

    def complete(self):
        self.inner.complete()  # release the real staging buffers first
        raise RuntimeError("replica died between dispatch and fetch")


class _SabotagedEngine:
    """Wraps a real engine; fails at the chosen stage like a replica whose
    device died (RuntimeError, never the input-shaped errors)."""

    def __init__(self, inner, fail_dispatch=False, fail_complete=False):
        self._inner = inner
        self.fail_dispatch = fail_dispatch
        self.fail_complete = fail_complete

    def dispatch_logits(self, images):
        if self.fail_dispatch:
            raise RuntimeError("device gone (sabotaged)")
        inflight = self._inner.dispatch_logits(images)
        if self.fail_complete:
            return _DeadInflight(inflight)
        return inflight

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _wait_healed(pool, deadline_s=30.0, regroups=1):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        topo = pool.topology()
        if topo["regroups"] >= regroups and not topo["quarantined_groups"]:
            return
        time.sleep(0.05)
    raise AssertionError(f"pool never healed: {pool.topology()}")


# -- tests/test_serve_pool.py -------------------------------------------------


def test_multi_replica_matches_single_replica(setup):
    params, images = setup
    stacks = [images[i:i + 1 + (i % 3)] for i in range(24)]
    results = {}
    for n in (1, 4):
        pool = EnginePool(_linear, params, devices=_cpus(n),
                          buckets=(1, 4, 8), params_epoch=2)
        pool.warmup()
        results[n] = _drive_pool(pool, stacks, max_inflight=n + 1)
    assert results[1] == results[4]
    for stack, (labels, epochs) in zip(stacks, results[4]):
        assert labels == _direct_labels(params, stack).tolist()
        assert epochs == [2]


def test_dispatch_picks_least_loaded_replica(setup):
    params, images = setup
    log = ServeLog()
    pool = EnginePool(_linear, params, devices=_cpus(4), buckets=(4,),
                      serve_log=log)
    pool.warmup()
    handles = [pool.dispatch(pool.preprocess(images[i:i + 2]))
               for i in range(4)]
    assert sorted(h.replica.name for h in handles) \
        == ["r0", "r1", "r2", "r3"]
    assert all(row["pending"] == 1 for row in pool.snapshot().values())
    for h in handles:
        labels, _ = pool.predict_complete(h)
        assert labels.shape == (2,)
    assert all(row["pending"] == 0 for row in pool.snapshot().values())
    replicas = log.snapshot()["replicas"]
    assert sorted(replicas) == ["r0", "r1", "r2", "r3"]
    assert all(replicas[r]["batches"] == 1 for r in replicas)


def test_every_replica_warms_and_steady_state_allocates_nothing(setup):
    """The port's counterpart of the zero-recompile pin: every replica's
    bucket forwards are warmed under their own names, and steady-state
    serving through every replica warms nothing again and allocates no
    new staging buffer."""
    params, images = setup
    pool = EnginePool(_linear, params, devices=_cpus(4), buckets=(2, 8))
    pool.warmup()
    programs = pool.warmup_log.stats()["programs"]
    assert set(programs) == {f"serve_forward_b{b}@r{i}" for b in (2, 8)
                             for i in range(4)}
    for _ in range(2):  # the first round fills the free-lists
        handles = [pool.dispatch(pool.preprocess(images[i:i + 3]))
                   for i in range(8)]
        for h in handles:
            pool.complete(h)
        if _ == 0:
            allocated = pool.staging_allocated()
    assert pool.staging_allocated() == allocated
    assert pool.warmup_log.stats()["programs"] == programs


def test_swap_fans_out_with_per_replica_stale_rejection(setup):
    params, images = setup
    other = init_params("linear", 9)
    pool = _pool(params, n=3)
    assert pool.swap_params(other, epoch=5) == 3
    assert [r.engine.params_epoch for r in pool.replicas] == [5, 5, 5]
    assert pool.swap_params(params, epoch=3) == 0  # stale everywhere
    assert [r.engine.params_epoch for r in pool.replicas] == [5, 5, 5]
    np.testing.assert_array_equal(
        pool.predict_complete(pool.dispatch(
            pool.preprocess(images[:8])))[0],
        _direct_labels(other, images[:8]))
    leader = init_params("linear", 11)
    assert pool.replicas[1].engine.swap_params(leader, epoch=9)
    assert pool.swap_params(other, epoch=7) == 2
    assert [r.engine.params_epoch for r in pool.replicas] == [7, 9, 7]


def test_hot_reload_never_mixes_epochs_within_a_batch(setup):
    params, images = setup
    states = {e: init_params("linear", e) for e in (10, 11, 12, 13)}
    pool = EnginePool(_linear, params, devices=_cpus(4), buckets=(1, 8),
                      params_epoch=10)
    pool.warmup()
    pool.swap_params(states[10], epoch=10)

    def complete(handle):
        labels, epoch = pool.predict_complete(handle)
        tag = np.full_like(labels, -1 if epoch is None else epoch)
        return np.stack([labels, tag], axis=1)

    failures = []
    stop = threading.Event()

    def hammer(wid):
        i = 0
        while not stop.is_set():
            stack = pool.preprocess(images[(wid + i) % 32:
                                           (wid + i) % 32 + 4])
            out = batcher.predict(stack, timeout=30.0)
            epochs = set(out[:, 1].tolist())
            if len(epochs) != 1 or not epochs <= {10, 11, 12, 13}:
                failures.append(out[:, 1].tolist())
            i += 1

    with MicroBatcher(None, max_batch=8, max_wait_s=0.002,
                      dispatch_fn=pool.dispatch, complete_fn=complete,
                      max_inflight=5) as batcher:
        threads = [threading.Thread(target=hammer, args=(w,), daemon=True)
                   for w in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        for epoch in (11, 12, 13):
            assert pool.swap_params(states[epoch], epoch=epoch) == 4
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]
    labels, epoch = pool.predict_complete(
        pool.dispatch(pool.preprocess(images[:8])))
    assert epoch == 13
    np.testing.assert_array_equal(labels,
                                  _direct_labels(states[13], images[:8]))


def test_watcher_fans_out_to_pool(setup, tmp_path):
    params, images = setup
    pool = _pool(params, n=2, params_epoch=None)
    log = ServeLog()
    watcher = CheckpointWatcher(str(tmp_path), "linear", pool.swap_params,
                                serve_log=log)
    published = init_params("linear", 21)
    save_params_checkpoint(params_to_jax(published), epoch=4,
                           directory=str(tmp_path))
    assert watcher.poll_once()
    assert [r.engine.params_epoch for r in pool.replicas] == [4, 4]
    assert log.snapshot()["reloads"] == 1
    np.testing.assert_array_equal(
        pool.predict_complete(pool.dispatch(
            pool.preprocess(images[:8])))[0],
        _direct_labels(published, images[:8]))
    pool.swap_params(init_params("linear", 22), epoch=9)
    save_params_checkpoint(params_to_jax(published), epoch=6,
                           directory=str(tmp_path))
    assert not watcher.poll_once()  # stale for the fleet: skipped
    assert log.snapshot()["reloads"] == 1
    assert [r.engine.params_epoch for r in pool.replicas] == [9, 9]


def test_pool_snapshot_rows(setup):
    params, _ = setup
    pool = EnginePool(_linear, params, devices=_cpus(2), buckets=(4,),
                      params_epoch=3)
    snap = pool.snapshot()
    assert sorted(snap) == ["r0", "r1"]
    for row in snap.values():
        assert row["pending"] == 0 and row["dispatched"] == 0
        assert row["params_epoch"] == 3
        assert row["device"] == "cpu"


def test_pool_requires_a_device(setup):
    with pytest.raises(ValueError, match="at least one device"):
        EnginePool(_linear, setup[0], devices=[])


# -- tests/test_pool_heal.py --------------------------------------------------


def test_dispatch_failure_fails_over_and_quarantines(setup):
    params, images = setup
    pool = _pool(params, quarantine_after=3, auto_regroup=False)
    r0 = pool.replicas[0]
    r0.engine = _SabotagedEngine(r0.engine, fail_dispatch=True)
    for _ in range(5):
        _serve_ok(pool, params, images)
    topo = pool.topology()
    assert topo["quarantined_groups"] == ["r0"]
    assert topo["active_groups"] == 2
    assert topo["failovers"] >= 3
    assert r0.failures == 3
    snap = pool.snapshot()
    assert snap["r0"]["quarantined"] is True
    assert "quarantined" not in snap["r1"]
    dispatched_before = r0.dispatched
    _serve_ok(pool, params, images)
    assert r0.dispatched == dispatched_before


def test_completion_failure_fails_over_in_flight_batch(setup):
    params, images = setup
    pool = _pool(params, quarantine_after=2, auto_regroup=False)
    r0 = pool.replicas[0]
    r0.engine = _SabotagedEngine(r0.engine, fail_complete=True)
    for _ in range(3):
        _serve_ok(pool, params, images)
    topo = pool.topology()
    assert topo["quarantined_groups"] == ["r0"]
    assert topo["failovers"] >= 2


def test_input_errors_never_count_toward_quarantine(setup):
    params, _ = setup
    pool = _pool(params, quarantine_after=2, auto_regroup=False)
    for _ in range(4):
        with pytest.raises(ValueError):
            pool.dispatch(np.zeros((3, 5, 5, 1), np.float32))
    topo = pool.topology()
    assert topo["quarantined_groups"] == [] and topo["failovers"] == 0
    assert all(r.failures == 0 for r in pool.replicas)


def test_success_resets_the_consecutive_counter(setup):
    params, images = setup
    pool = _pool(params, n=2, quarantine_after=3, auto_regroup=False)
    r0 = pool.replicas[0]
    real = r0.engine
    for _ in range(3):
        r0.engine = _SabotagedEngine(real, fail_dispatch=True)
        _serve_ok(pool, params, images)
        r0.engine = real
        _serve_ok(pool, params, images)
    assert pool.topology()["quarantined_groups"] == []
    assert r0.failures == 3 and r0.consecutive_failures == 0


def test_no_healthy_replica_raises_never_hangs(setup):
    params, images = setup
    pool = _pool(params, n=2, quarantine_after=1, auto_regroup=False)
    for r in pool.replicas:
        r.engine = _SabotagedEngine(r.engine, fail_dispatch=True)
    with pytest.raises(RuntimeError, match="no healthy replica"):
        pool.dispatch(pool.preprocess(images[:8]))
    assert pool.topology()["quarantined_groups"] == ["r0", "r1"]


def test_regroup_rebuilds_quarantined_group_under_traffic(setup):
    params, images = setup
    pool = _pool(params, quarantine_after=2)
    r0 = pool.replicas[0]
    r0.engine = _SabotagedEngine(r0.engine, fail_dispatch=True)
    stop = threading.Event()
    failures = []

    def hammer():
        while not stop.is_set():
            try:
                _serve_ok(pool, params, images)
            except Exception as exc:  # noqa: BLE001
                failures.append(repr(exc))

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    try:
        _wait_healed(pool)
    finally:
        stop.set()
        for t in threads:
            t.join(10.0)
    assert not failures, failures[:3]
    topo = pool.topology()
    assert topo["regroups"] == 1 and topo["active_groups"] == 3
    assert r0.generation == 1
    assert isinstance(r0.engine, InferenceEngine)  # a real rebuild
    assert r0.engine.device == CPU  # on its own device
    assert pool.snapshot()["r0"]["generation"] == 1
    dispatched_before = r0.dispatched
    for _ in range(4):
        _serve_ok(pool, params, images)
    assert r0.dispatched > dispatched_before


def test_regroup_catches_up_to_params_swapped_during_rebuild(setup):
    params, images = setup
    newer = init_params("linear", 42)
    pool = _pool(params, quarantine_after=1)
    # The rebuild waits until the reload has fanned out: the reload
    # lands mid-rebuild, whatever the host's speed.
    reloaded = threading.Event()

    def slow_factory():
        assert reloaded.wait(30.0)
        return _linear()

    pool.model_factory = slow_factory
    r0 = pool.replicas[0]
    r0.engine = _SabotagedEngine(r0.engine, fail_dispatch=True)
    _serve_ok(pool, params, images)  # one failure -> quarantine
    assert pool.swap_params(newer, epoch=9) == 2
    reloaded.set()
    _wait_healed(pool)
    deadline = time.monotonic() + 30.0
    while r0.engine.params_epoch != 9 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert r0.engine.params_epoch == 9
    _, epoch = pool.predict_complete(pool.dispatch(
        pool.preprocess(images[:8])))
    assert epoch == 9


def test_regroup_failure_retries_then_stays_quarantined(setup, capsys):
    """A replica whose rebuild keeps failing is retried
    ``regroup_retries`` times, then left quarantined, loudly; the healthy
    replicas keep answering."""
    params, images = setup
    pool = _pool(params, n=2, quarantine_after=1, regroup_retries=2)
    builds = []

    def broken_factory():
        builds.append(1)
        raise RuntimeError("the device did not come back")

    pool.model_factory = broken_factory
    r0 = pool.replicas[0]
    r0.engine = _SabotagedEngine(r0.engine, fail_dispatch=True)
    _serve_ok(pool, params, images)
    deadline = time.monotonic() + 30.0
    while "giving up on r0" not in capsys.readouterr().out:
        assert time.monotonic() < deadline, "the regroup never gave up"
        time.sleep(0.05)
    assert len(builds) == 2
    assert pool.topology()["quarantined_groups"] == ["r0"]
    _serve_ok(pool, params, images)


def test_resize_up_and_down_serves_identically(setup):
    params, images = setup
    pool = _pool(params, n=2)
    assert pool.topology()["topology_generation"] == 0
    result = pool.resize(n_devices=4)
    assert result["old"]["groups"] == 2 and result["new"]["groups"] == 4
    assert pool.n_replicas == 4 and pool.n_devices == 4
    assert pool.topology()["topology_generation"] == 1
    _serve_ok(pool, params, images)
    pool.resize(n_devices=1)
    assert pool.n_replicas == 1
    assert pool.topology()["topology_generation"] == 2
    _serve_ok(pool, params, images)


def test_resize_swap_is_atomic_for_in_flight_batches(setup):
    params, images = setup
    pool = _pool(params, n=2)
    handle = pool.dispatch(pool.preprocess(images[:8]))
    old_replica = handle.replica
    pool.resize(n_devices=3)
    assert handle.replica is old_replica
    assert old_replica not in pool.replicas
    labels, _ = pool.predict_complete(handle)
    np.testing.assert_array_equal(labels, _direct_labels(params, images[:8]))
    assert old_replica.pending == 0


def test_resize_carries_latest_params(setup):
    params, images = setup
    newer = init_params("linear", 7)
    pool = _pool(params, n=2)
    pool.swap_params(newer, epoch=5)
    pool.resize(n_devices=3)
    assert [r.engine.params_epoch for r in pool.replicas] == [5, 5, 5]
    labels, _ = pool.predict_complete(pool.dispatch(
        pool.preprocess(images[:8])))
    np.testing.assert_array_equal(labels, _direct_labels(newer, images[:8]))


def test_resize_validation_and_serialization(setup):
    params, _ = setup
    pool = _pool(params, n=2)
    with pytest.raises(ValueError, match="local device"):
        pool.resize(n_devices=99)
    with pytest.raises(ValueError, match="no mesh to resize"):
        pool.resize(mesh_size=2)
    with pool._lock:
        pool._resizing = True
    try:
        with pytest.raises(RuntimeError, match="already in progress"):
            pool.resize(n_devices=1)
    finally:
        with pool._lock:
            pool._resizing = False
    assert pool.n_replicas == 2


def test_resize_zero_means_all_local_devices(setup):
    pool = _pool(setup[0], n=1)
    pool.resize(n_devices=0)
    assert pool.n_devices == len(local_devices("cpu")) == CPU_SLOTS


def test_serve_fault_spec_parsing():
    assert _parse_serve_fault("") is None
    assert _parse_serve_fault("2") == (2, 0)
    assert _parse_serve_fault("1:5") == (1, 5)
    with pytest.raises(ValueError, match=SERVE_FAULT_ENV):
        _parse_serve_fault("a:b")
    with pytest.raises(ValueError, match=SERVE_FAULT_ENV):
        _parse_serve_fault("1:2:3")


def test_injected_fault_fires_quarantines_and_heals(setup, monkeypatch):
    params, images = setup
    monkeypatch.setenv(SERVE_FAULT_ENV, "0:2")
    pool = _pool(params, n=2, quarantine_after=2)
    for _ in range(8):
        _serve_ok(pool, params, images)
    _wait_healed(pool)
    topo = pool.topology()
    assert topo["regroups"] == 1 and topo["failovers"] >= 2
    assert pool.replicas[0].generation == 1
    dispatched = pool.replicas[0].dispatched
    for _ in range(4):
        _serve_ok(pool, params, images)
    assert pool.replicas[0].dispatched > dispatched
    assert pool.topology()["quarantined_groups"] == []


_MODE_MODEL = {"tensor": "vit", "expert": "moe_mlp", "pipeline": "vit"}


@pytest.mark.parametrize("mode", ["tensor", "expert", "pipeline"])
def test_sharded_serve_modes_are_refused_by_name(setup, mode):
    """Each sharded mode builds a pool of one 2-device group over its
    model that answers like the replicated engine (argmax; the logits
    within the float32 reassociation of the partial sums), and refuses a
    model it has no rule table for with the reference's words, the
    servable modes named (``--serve-mode expert --model vit``, ``tensor``
    or ``pipeline`` with ``moe_mlp``)."""
    from pytorch_distributed_mnist_tpu.serve.programs import (
        validate_serve_mode as jax_validate,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
        split_vit_params,
    )

    model_name = _MODE_MODEL[mode]
    images = setup[1][:5]
    params = init_params(model_name, 0)
    factory = functools.partial(get_model, model_name,
                                compute_dtype=torch.float32)
    want = InferenceEngine(factory(), params, buckets=(8,),
                           device="cpu").logits(images)
    served = split_vit_params(params) if mode == "pipeline" else params
    pool = EnginePool(factory, served, devices=_cpus(2), buckets=(8,),
                      serve_mode=mode, mesh_size=2, model_name=model_name)
    assert [r.name for r in pool.replicas] == [mode]
    assert pool.topology()["mesh_devices"] == 2
    got, _ = pool.complete(pool.dispatch(pool.preprocess(images)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    other = "vit" if model_name == "moe_mlp" else "moe_mlp"
    with pytest.raises(ValueError) as port_err:
        EnginePool(functools.partial(get_model, other), init_params(other, 0),
                   devices=_cpus(2), serve_mode=mode, mesh_size=2,
                   model_name=other)
    with pytest.raises(ValueError) as jax_err:
        jax_validate(mode, other, 2)
    assert str(port_err.value) == str(jax_err.value)
    assert "no sharding rule table" in str(port_err.value)


# -- the port's own: devices, modules, device scoping -------------------------


def test_local_devices_cpu_slots_and_no_card():
    assert local_devices("cpu") == [CPU] * CPU_SLOTS == [CPU] * 8
    with pytest.raises(ValueError, match="cuda or cpu"):
        local_devices("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            local_devices("cuda")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            EnginePool(_linear, init_params("linear", 0))  # default: cards


def test_pool_refuses_mixed_device_types(setup):
    with pytest.raises((ValueError, RuntimeError)):
        EnginePool(_linear, setup[0], devices=["cpu", "cuda:0"])


def test_every_replica_builds_its_own_model_module(setup):
    params, images = setup
    built = []

    def factory():
        built.append(_linear())
        return built[-1]

    pool = _pool(params, n=3, buckets=(8,))
    pool.model_factory = factory
    pool.resize(n_devices=3)
    assert len(built) == 3
    assert len({id(r.engine.model) for r in pool.replicas}) == 3
    assert [r.engine.model for r in pool.replicas] == built
    _serve_ok(pool, params, images)


class _FakeStream:
    pass


def test_dispatch_is_scoped_to_the_engines_device_and_stream(
        setup, monkeypatch):
    """What a replica on ``cuda:1`` dispatched from a thread whose current
    device is ``cuda:0`` needs: the enqueue under ``torch.cuda.device`` of
    the engine's own device, the event recorded on that device's current
    stream, and ``complete`` waiting on that event only. Pinned on the
    CPU with ``torch.cuda`` patched to record what the engine asks of it
    (no card here) and the engine set on its card path."""
    params, images = setup
    calls = []

    class FakeDevice:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            calls.append(("enter", self.device))

        def __exit__(self, *exc):
            calls.append(("exit", self.device))

    class FakeEvent:
        def record(self, stream=None):
            calls.append(("record", stream))

        def synchronize(self):
            calls.append(("synchronize", self))

    stream = _FakeStream()

    def current_stream(device=None):
        calls.append(("current_stream", device))
        return stream

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    engine = InferenceEngine(_linear(), params, buckets=(8,), device="cpu")
    other = InferenceEngine(_linear(), params, buckets=(8,), device="cpu")
    engine._cuda = other._cuda = True  # the card path, over CPU tensors
    inflight = {}

    def dispatch(name, eng):
        inflight[name] = eng.dispatch_logits(images[:8])

    threads = [threading.Thread(target=dispatch, args=(name, eng))
               for name, eng in (("engine", engine), ("other", other))]
    for t in threads:
        t.start()
        t.join(30.0)  # one after the other: the calls stay in order
    assert not any(t.is_alive() for t in threads)
    assert calls == [("enter", engine.device),
                     ("current_stream", engine.device), ("record", stream),
                     ("exit", engine.device)] * 2
    calls.clear()
    logits, _ = inflight["engine"].complete()
    # Its own event only: never the other engine's work.
    assert calls == [("synchronize", inflight["engine"].event)]
    assert inflight["engine"].event is not inflight["other"].event
    np.testing.assert_array_equal(logits.argmax(-1),
                                  _direct_labels(params, images[:8]))


def test_cpu_dispatch_records_no_event(setup):
    engine = InferenceEngine(_linear(), setup[0], buckets=(8,), device="cpu")
    assert engine._device_scope().__class__.__name__ == "nullcontext"
    assert engine.dispatch_logits(setup[1][:3]).event is None


def _overlap_tracked_linear(peaks):
    """A linear model whose forward lingers (a card forward's enqueue
    window, stretched) and records, per module, how many forwards ran in
    it at once."""
    model = _linear()
    inner = model.forward
    lock = threading.Lock()
    state = {"now": 0}
    peaks[id(model)] = 0

    def forward(x):
        with lock:
            state["now"] += 1
            peaks[id(model)] = max(peaks[id(model)], state["now"])
        try:
            time.sleep(0.005)
            return inner(x)
        finally:
            with lock:
                state["now"] -= 1

    model.forward = forward
    return model


def test_failover_redispatch_onto_a_busy_replica_answers_as_one_engine(
        setup):
    """The completion thread sends a failed-over batch again to the
    least-loaded healthy replica, which is the one the batcher's worker
    is dispatching to: both threads then enqueue on one engine. Every
    reply must equal the engine run alone, and no two forwards may share
    the engine's module at once (``functional_call`` swaps its
    parameters in and back out around each call)."""
    params, images = setup
    peaks = {}
    pool = EnginePool(functools.partial(_overlap_tracked_linear, peaks),
                      params, devices=_cpus(2), buckets=(8,),
                      params_epoch=1, quarantine_after=10 ** 6,
                      auto_regroup=False)
    pool.warmup()
    r0 = pool.replicas[0]
    r0.engine = _SabotagedEngine(r0.engine, fail_complete=True)
    alone = InferenceEngine(_linear(), params, buckets=(8,), device="cpu")
    rng = np.random.default_rng(5)
    stacks = [images[rng.integers(0, len(images), size=int(n))]
              for n in rng.integers(1, 9, size=48)]
    with MicroBatcher(None, max_batch=pool.max_batch, max_wait_s=0.001,
                      dispatch_fn=pool.dispatch,
                      complete_fn=lambda h: pool.complete(h)[0],
                      max_inflight=4) as batcher:
        pendings = [batcher.submit(pool.preprocess(s)) for s in stacks]
        replies = [batcher.result(p, timeout=60.0) for p in pendings]
    for stack, reply in zip(stacks, replies):
        np.testing.assert_array_equal(reply, alone.logits(stack))
    assert pool.topology()["failovers"] > 0
    assert set(peaks.values()) == {1}, peaks


def test_sum_staging_adds_per_plane_and_bucket():
    total = engine_mod.sum_staging([
        {"split": {1: 1, 8: 2}, "fused": {8: 1}},
        {"split": {8: 1}, "fused": {1: 3}}])
    assert total == {"split": {1: 1, 8: 3}, "fused": {8: 1, 1: 3}}


# -- against the JAX pool -----------------------------------------------------

SIZES = (1, 3, 8, 5, 8, 2, 7, 8, 8, 6, 4, 8)


@pytest.fixture(scope="module")
def cnn_checkpoint(tmp_path_factory):
    directory = tmp_path_factory.mktemp("pool_ckpt")
    jmodel = jax_get_model("cnn", compute_dtype=jnp.float32)
    state = create_train_state(jmodel, jax.random.key(0))
    path = jax_ckpt.save_checkpoint(state, epoch=0, best_acc=0.0,
                                    is_best=False, directory=str(directory))
    images, _ = synthetic_dataset(sum(SIZES), seed=5)
    return path, state, np.split(images, np.cumsum(SIZES)[:-1])


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_pool_matches_the_jax_pool(cnn_checkpoint, precision):
    """Two JAX replicas on its CPU devices and two port replicas on the
    CPU answer the same batches, dispatched alternately across the
    replicas, from one npz. int8: atol 2e-2 and argmax agreement >= 99%
    (the convolutions sum in another order, so an fc1 input at a rounding
    boundary can round the other way; the bound of
    ``tests/test_torch_serve_engine.py``); f32: atol 5e-6 (the bound of
    ``tests/test_torch_serve_vit.py``)."""
    path, state, batches = cnn_checkpoint
    kwargs = {"dot_general": int8_dot_general} if precision == "int8" else {}
    jmodel = jax_get_model("cnn", compute_dtype=jnp.float32, **kwargs)
    jparams, jepoch = jax_load_params(path, state)
    jax_pool = JaxPool(jmodel.apply, jparams,
                       devices=jax.local_devices()[:2], buckets=(1, 8),
                       params_epoch=jepoch, precision=precision, fuse=True)
    params, epoch = load_params_for_serving(path, "cnn")
    matmul = {"matmul": int8_linear} if precision == "int8" else {}
    pool = EnginePool(
        functools.partial(get_model, "cnn", compute_dtype=torch.float32,
                          **matmul),
        params, devices=_cpus(2), buckets=(1, 8), params_epoch=epoch,
        precision=precision, fuse=True)
    pool.warmup()
    got, want = [], []
    for pair in zip(batches[::2], batches[1::2]):
        # Two in flight at a time: least-loaded dispatch puts one on
        # each replica, on both sides.
        handles = [(pool.dispatch(pool.preprocess(raw)),
                    jax_pool.dispatch(jax_pool.preprocess(raw)))
                   for raw in pair]
        for mine, theirs in handles:
            logits, e = pool.complete(mine)
            jlogits, je = jax_pool.complete(theirs)
            assert e == je == 0
            got.append(logits)
            want.append(np.asarray(jlogits))
    assert sorted({r.dispatched for r in pool.replicas}) == [6]
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (sum(SIZES), 10)
    assert np.all(np.isfinite(got))
    atol = 2e-2 if precision == "int8" else 5e-6
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree >= (0.99 if precision == "int8" else 1.0), agree
    # The reload fan-out, both sides: a newer epoch installs everywhere.
    newer = {k: v * 0.5 for k, v in params.items()}
    assert pool.swap_params(newer, epoch=3) == 2
    assert [r.engine.params_epoch for r in pool.replicas] == [3, 3]
