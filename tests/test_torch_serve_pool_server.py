"""The port's pooled server over real loopback HTTP on CPU replicas: the
replicated cases of ``tests/test_serve_pool_server.py`` and
``tests/test_serve_heal_server.py``. ``--serve-devices N`` boots an
``EnginePool`` behind the pipelined batcher; ``tools/loadgen.py --smoke``
passes against it; a hot reload under live traffic swaps every replica;
the default configuration keeps the single-engine ``/stats`` schema; a
replica killed by ``TPUMNIST_SERVE_FAULT`` under live loadgen traffic is
quarantined and regrouped with zero dropped requests; ``POST /resize``
under traffic drops nothing and refuses what it must.

Servers run ``linear`` in float32 on the split plane (``--no-fuse``), as
the JAX suites do, with ``--device cpu``; every wait is bounded."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import (
    normalize_images,
    synthetic_dataset,
)
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.serve.pool import SERVE_FAULT_ENV
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    save_params_checkpoint,
)
from pytorch_distributed_mnist_tpu_torch.utils.device import CPU_SLOTS

pytestmark = pytest.mark.serve
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds any one loadgen run or wait may take


def _publish(ckpt_dir, epoch, seed):
    params = init_params("linear", seed)
    save_params_checkpoint(params_to_jax(params), epoch=epoch,
                           directory=str(ckpt_dir))
    return params


def _want(params, images):
    model = get_model("linear", compute_dtype=torch.float32).eval()
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    with torch.no_grad():
        logits = torch.func.functional_call(
            model, tensors, (torch.from_numpy(normalize_images(images)),))
    return [int(v) for v in logits.argmax(-1)]


def _serve_args(ckpt_dir, **overrides):
    argv = ["--checkpoint-dir", str(ckpt_dir), "--model", "linear",
            "--dtype", "f32", "--device", "cpu", "--host", "127.0.0.1",
            "--port", "0", "--buckets", "1,8,32", "--max-wait-ms", "2",
            "--max-queue", "128", "--poll-interval", "0.1", "--no-fuse"]
    for k, v in overrides.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return build_parser().parse_args(argv)


class _Server:
    def __init__(self, args):
        self.httpd = create_server(args)
        host, port = self.httpd.server_address[:2]
        self.url = f"http://{host}:{port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.ctx.close()
        self.httpd.server_close()
        self.thread.join(10.0)

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return json.loads(r.read())

    def post(self, path, payload, timeout=60):
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())


def _loadgen(url, requests, *extra):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "loadgen.py"),
         "--smoke", "--url", url, "--requests", str(requests),
         "--concurrency", "8", *extra],
        capture_output=True, text=True, timeout=TIMEOUT)
    return proc, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture()
def pooled_server(tmp_path):
    ckpt = tmp_path / "ckpt"
    params = _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_devices=4))
    try:
        yield srv, params, ckpt
    finally:
        srv.close()


# -- tests/test_serve_pool_server.py ------------------------------------------


def test_pooled_loadgen_smoke_every_replica(pooled_server):
    srv, params, _ = pooled_server
    images, _ = synthetic_dataset(3, seed=0)
    reply = srv.post("/predict", {"images": images.tolist()})
    assert reply["predictions"] == _want(params, images)
    assert reply["model_epoch"] == 0
    warmed = srv.get("/stats")["warmup"]["programs"]
    assert set(warmed) == {f"serve_forward_b{b}@r{i}" for b in (1, 8, 32)
                           for i in range(4)}
    proc, report = _loadgen(srv.url, 600, "--expect-replicas", "4")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert report["smoke_ok"] and report["ok"] == 600
    assert len(report["replicas"]) == 4
    stats = srv.get("/stats")
    # Steady state warms nothing again on any replica.
    assert stats["warmup"]["programs"] == warmed
    assert stats["serve_devices"] == 4 and stats["max_inflight"] == 5
    assert sorted(stats["replicas"]) == ["r0", "r1", "r2", "r3"]
    assert sum(r["batches"] for r in stats["replicas"].values()) \
        == stats["batches"]
    assert all(r["params_epoch"] == 0 for r in stats["replicas"].values())
    assert all(r["device"] == "cpu" for r in stats["replicas"].values())


def test_pooled_hot_reload_under_live_traffic(pooled_server):
    srv, _, ckpt = pooled_server
    images, _ = synthetic_dataset(4, seed=3)
    payload = {"images": images.tolist()}
    failures = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                reply = srv.post("/predict", payload)
                if (len(reply["predictions"]) != 4
                        or reply["model_epoch"] not in (0, 9)):
                    failures.append(("malformed", reply))
            except Exception as exc:  # noqa: BLE001
                failures.append(("error", repr(exc)))

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    params_b = _publish(ckpt, epoch=9, seed=77)
    deadline = time.time() + 15.0
    while time.time() < deadline:
        if srv.get("/healthz")["model_epoch"] == 9:
            break
        time.sleep(0.05)
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(10.0)
    assert not failures, failures[:5]
    stats = srv.get("/stats")
    assert stats["reloads"] == 1
    assert all(r["params_epoch"] == 9 for r in stats["replicas"].values())
    assert srv.post("/predict", payload)["predictions"] \
        == _want(params_b, images)


def test_default_single_replica_stats_schema_unchanged(tmp_path):
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=10)
    args = _serve_args(ckpt)
    assert args.serve_devices == 1 and args.max_inflight == 0
    srv = _Server(args)
    try:
        assert srv.httpd.ctx.pool is None
        images, _ = synthetic_dataset(2, seed=1)
        srv.post("/predict", {"images": images.tolist()})
        stats = srv.get("/stats")
        assert "replicas" not in stats and "topology_generation" not in stats
        assert "serve_devices" not in stats and "max_inflight" not in stats
        assert set(stats["warmup"]["programs"]) == {
            "serve_forward_b1", "serve_forward_b8", "serve_forward_b32"}
    finally:
        srv.close()


def test_serve_devices_zero_means_all_and_bounds_checked(tmp_path):
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_devices=0, buckets="1,8"))
    try:
        assert srv.get("/stats")["serve_devices"] == CPU_SLOTS
    finally:
        srv.close()
    with pytest.raises(SystemExit, match="this host has 8 local device"):
        create_server(_serve_args(ckpt, serve_devices=CPU_SLOTS + 1))
    with pytest.raises(SystemExit, match="must be >= 0"):
        create_server(_serve_args(ckpt, max_inflight=-1))


def test_pipelining_on_single_device(tmp_path):
    ckpt = tmp_path / "ckpt"
    params = _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_devices=1, max_inflight=3,
                              buckets="1,8"))
    try:
        assert srv.httpd.ctx.pool is not None
        assert srv.get("/stats")["max_inflight"] == 3
        images, _ = synthetic_dataset(6, seed=4)
        reply = srv.post("/predict", {"images": images.tolist()})
        assert reply["predictions"] == _want(params, images)
    finally:
        srv.close()


def test_card_pool_without_a_card_is_refused(tmp_path):
    """No replica is placed on the CPU when the card was asked for: with
    no card, ``--device cuda --serve-devices 2`` refuses to boot."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: nothing to refuse")
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=10)
    args = _serve_args(ckpt, serve_devices=2)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        create_server(args)


# -- tests/test_serve_heal_server.py ------------------------------------------


def test_serve_fault_env_names_agree():
    """``tools/chaos.py`` and the port's ``runtime/chaos.py`` spell the
    injection variables out; they must match the pool's and the
    canary's."""
    import importlib.util

    from pytorch_distributed_mnist_tpu_torch.runtime import chaos
    from pytorch_distributed_mnist_tpu_torch.serve.canary import (
        CANARY_FAULT_ENV,
    )

    spec = importlib.util.spec_from_file_location(
        "chaos_tool", os.path.join(REPO, "tools", "chaos.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.SERVE_FAULT_ENV == chaos.SERVE_FAULT_ENV == SERVE_FAULT_ENV
    assert tool.CANARY_FAULT_ENV == chaos.CANARY_FAULT_ENV \
        == CANARY_FAULT_ENV


def test_group_death_under_live_loadgen_regroups_zero_drops(
        tmp_path, monkeypatch):
    ckpt = tmp_path / "ckpt"
    params = _publish(ckpt, epoch=0, seed=10)
    monkeypatch.setenv(SERVE_FAULT_ENV, "0:5")
    srv = _Server(_serve_args(ckpt, serve_devices=4, quarantine_after=3))
    try:
        proc, report = _loadgen(srv.url, 600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert report["smoke_ok"] and report["ok"] == 600
        assert report["status_counts"] == {"200": 600}  # zero drops
        assert report["transport_errors"] == 0
        deadline = time.time() + 30
        while time.time() < deadline:
            stats = srv.get("/stats")
            if stats["regroups"] >= 1 and not stats["quarantined_groups"]:
                break
            time.sleep(0.1)
        assert stats["regroups"] >= 1, stats
        assert stats["failovers"] >= 3, stats
        assert stats["topology_generation"] >= 2, stats
        assert stats["active_groups"] == 4, stats
        assert stats["replicas"]["r0"]["generation"] == 1
        proc, report = _loadgen(srv.url, 100, "--expect-groups", "4")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert report["smoke_ok"] and report["active_groups"] == 4
        assert "topology_generation" in report
        images, _ = synthetic_dataset(6, seed=2)
        reply = srv.post("/predict", {"images": images.tolist()})
        assert reply["predictions"] == _want(params, images)
        assert reply["model_epoch"] == 0
    finally:
        srv.close()


def test_resize_under_live_traffic_zero_drops(tmp_path):
    ckpt = tmp_path / "ckpt"
    params = _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_devices=2))
    images, _ = synthetic_dataset(4, seed=3)
    payload = {"images": images.tolist()}
    want = _want(params, images)
    failures = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                reply = srv.post("/predict", payload, timeout=30)
                if reply["predictions"] != want:
                    failures.append(("corrupted", reply))
            except Exception as exc:  # noqa: BLE001
                failures.append(("error", repr(exc)))

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        reply = srv.post("/resize", {"serve_devices": 4})
        assert reply["ok"] and reply["new"]["groups"] == 4
        assert reply["old"]["groups"] == 2
        stats = srv.get("/stats")
        assert stats["serve_devices"] == 4 and stats["groups"] == 4
        assert stats["topology_generation"] == 1
        time.sleep(0.3)
        reply = srv.post("/resize", {"serve_devices": 2})
        assert reply["ok"] and reply["new"]["groups"] == 2
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(10.0)
        srv.close()
    assert not failures, failures[:5]


def test_resize_reports_final_topology_and_expect_groups(tmp_path):
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_devices=2))
    try:
        srv.post("/resize", {"serve_devices": 3})
        stats = srv.get("/stats")
        assert stats["groups"] == 3 == stats["active_groups"]
        assert stats["topology_generation"] == 1
        proc, _ = _loadgen(srv.url, 60, "--expect-groups", "3")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        proc, _ = _loadgen(srv.url, 10, "--expect-groups", "2")
        assert proc.returncode == 1  # the gate has teeth
    finally:
        srv.close()


def test_resize_rejections(tmp_path):
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_devices=2))
    try:
        for payload, match in [
            ({}, "serve_devices and/or serve_mesh"),
            ([4], "JSON object"),
            ({"serve_devices": 99}, "local device"),
            ({"serve_devices": "x"}, "invalid literal"),
            ({"serve_mesh": 2}, "no mesh to resize"),
            ({"serve_devices": 2, "model": "cnn"}, "unknown model"),
        ]:
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                srv.post("/resize", payload)
            assert exc_info.value.code == 400
            assert match in json.loads(exc_info.value.read())["error"]
        assert srv.get("/stats")["groups"] == 2
        # One resize at a time: 409 while another one runs.
        pool = srv.httpd.ctx.pool
        with pool._lock:
            pool._resizing = True
        try:
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                srv.post("/resize", {"serve_devices": 1})
            assert exc_info.value.code == 409
        finally:
            with pool._lock:
                pool._resizing = False
    finally:
        srv.close()
    single = _Server(_serve_args(ckpt))
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            single.post("/resize", {"serve_devices": 2})
        assert exc_info.value.code == 400
        assert "pooled data plane" in json.loads(
            exc_info.value.read())["error"]
    finally:
        single.close()


def test_int8_pool_server_replies_equal_one_engine_per_batch(tmp_path):
    """The int8 fused plane through a 2-replica server: each served
    batch's predictions equal one port engine's on the same batch (the
    int8 plane quantizes a Dense input over its whole batch, so the
    reference replays the batches the server formed)."""
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        int8_linear,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
    )

    ckpt = tmp_path / "ckpt"
    params = init_params("cnn", 3)
    save_params_checkpoint(params_to_jax(params), epoch=0,
                           directory=str(ckpt))
    argv = _serve_args(ckpt, serve_devices=2, serve_precision="int8",
                       buckets="1,8")
    argv.model, argv.no_fuse = "cnn", False
    srv = _Server(argv)
    try:
        pool = srv.httpd.ctx.pool
        served = []
        complete = pool.predict_complete

        def recording(handle):
            labels, epoch = complete(handle)
            served.append((np.array(handle.images), labels.copy()))
            return labels, epoch

        pool.predict_complete = recording
        images, _ = synthetic_dataset(30, seed=8)
        threads = [threading.Thread(target=srv.post, args=(
            "/predict", {"images": images[i:i + 3].tolist()}))
            for i in range(0, 30, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        ref = InferenceEngine(
            get_model("cnn", compute_dtype=torch.float32,
                      matmul=int8_linear), params, buckets=(1, 8),
            precision="int8", fuse=True, device="cpu")
        assert sum(len(x) for x, _ in served) == 30
        for batch, labels in served:
            np.testing.assert_array_equal(labels, ref.predict(batch))
    finally:
        srv.close()
