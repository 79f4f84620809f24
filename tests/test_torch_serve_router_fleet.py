"""The port's fleet router over port backends, on the CPU: three
in-process port servers (``--device cpu``, f32 ``linear``) on JAX-written
checkpoints behind the port's router, driven by ``tools/loadgen.py``.
The four cases of ``tests/test_serve_router_fleet.py``:

- a backend dies under open-loop traffic: every request answered, the
  dead backend quarantined, then re-admitted through probation after a
  restart on the same port; the aggregated ``/stats`` has a row per
  backend and merged quantiles;
- a rolling reload lands on every backend with zero failed requests;
- a corrupt publish behind a fleet canary rolls back, the baseline epoch
  serving throughout;
- a fleet with no routable backend answers the loud 503.

Then the wire between the packages: the port's router over one JAX and
one port backend answers every request with the JAX backend's digits,
and the JAX router rolls a publish out over two port backends."""

import json
import threading
import time
import urllib.error

import pytest

from pytorch_distributed_mnist_tpu.data.mnist import synthetic_dataset
from pytorch_distributed_mnist_tpu.serve import router as jax_router
from pytorch_distributed_mnist_tpu.serve import server as jax_server
from pytorch_distributed_mnist_tpu_torch.serve.router import (
    build_parser as router_parser,
)
from pytorch_distributed_mnist_tpu_torch.serve.router import create_router
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from tests.test_serve_router_fleet import _publish, _Server, _wait
from tools.loadgen import _make_images, run_open

pytestmark = [pytest.mark.serve, pytest.mark.fleet]


def _backend_args(ckpt_dir, port=0):
    return build_parser().parse_args([
        "--checkpoint-dir", str(ckpt_dir), "--device", "cpu",
        "--model", "linear", "--dtype", "f32",
        "--host", "127.0.0.1", "--port", str(port),
        "--buckets", "1,8",
        "--max-wait-ms", "2", "--max-queue", "256",
        "--poll-interval", "0.1",
    ])


def _boot_backend(ckpt_dir, port=0):
    return _Server(create_server(_backend_args(ckpt_dir, port=port)))


def _boot_jax_backend(ckpt_dir):
    return _Server(jax_server.create_server(jax_server.build_parser(
    ).parse_args(["--checkpoint-dir", str(ckpt_dir), "--model", "linear",
                  "--dtype", "f32", "--host", "127.0.0.1", "--port", "0",
                  "--buckets", "1,8", "--max-wait-ms", "2",
                  "--max-queue", "256", "--poll-interval", "0.1"])))


def _router_argv(backends):
    return ["--backends", ",".join(b.name for b in backends),
            "--host", "127.0.0.1", "--port", "0",
            "--health-interval", "0.1",
            "--quarantine-after", "2",
            "--probation-successes", "2",
            "--connect-timeout", "2.0"]


def _boot_router(backends):
    return _Server(create_router(router_parser().parse_args(
        _router_argv(backends))))


@pytest.fixture()
def fleet(tmp_path):
    """Three port backends (each its own checkpoint dir at epoch 0)
    behind the port's router; yields (router, [backends], [dirs])."""
    dirs, backends = [], []
    for i in range(3):
        ckpt = tmp_path / f"b{i}"
        _publish(ckpt, epoch=0, seed=10)
        dirs.append(ckpt)
        backends.append(_boot_backend(ckpt))
    router = _boot_router(backends)
    _wait(lambda: router.get("/healthz")["routable"] == 3,
          what="all 3 backends healthy")
    try:
        yield router, backends, dirs
    finally:
        router.close()
        for b in backends:
            try:
                b.close()
            except Exception:  # noqa: BLE001 - some died on purpose
                pass


def test_kill_one_backend_zero_dropped_then_readmit(fleet):
    router, backends, dirs = fleet
    bodies = _make_images(n_templates=4, images_per_request=1, seed=0,
                          extra_fields={"client_id": "acceptance"})
    victim = backends[1]
    result = {}

    def drive():
        result["collector"] = run_open(
            router.url, rate=120.0, duration=3.0, bodies=bodies,
            timeout=30.0, retries=2)

    traffic = threading.Thread(target=drive, daemon=True)
    traffic.start()
    time.sleep(1.0)
    victim.kill()
    traffic.join(60.0)
    assert not traffic.is_alive()
    collector = result["collector"]
    sent = sum(collector.status.values())
    assert sent > 100
    assert collector.errors == 0, collector.status
    assert collector.conn_refused == 0
    assert collector.status.get(200, 0) == sent, collector.status

    def _victim_row():
        for r in router.get("/stats")["backends"]:
            if r["name"] == victim.name:
                return r
        raise AssertionError(f"no row for {victim.name}")

    _wait(lambda: _victim_row()["state"] == "quarantined",
          what="victim quarantine")
    stats = router.get("/stats")
    rows = {r["name"]: r for r in stats["backends"]}
    assert set(rows) == {b.name for b in backends}
    assert rows[victim.name]["quarantines"] >= 1
    assert not rows[victim.name]["routable"]
    assert stats["fleet"]["routable"] == 2
    merged = stats["fleet"]["window"]
    assert merged["count"] > 0 and merged["backends"] >= 1
    assert merged["p99_ms"] >= merged["p50_ms"] > 0
    assert stats["router"]["by_code"].get("200", 0) > 100
    survivors = [r for n, r in rows.items() if n != victim.name]
    assert sum(r["requests"] for r in survivors) > 0
    assert all(r["epoch"] == 0 for r in survivors)

    revived = _boot_backend(dirs[1], port=victim.port)
    try:
        assert revived.name == victim.name
        _wait(lambda: _victim_row()["state"] == "healthy",
              what="victim re-admission")
        row = _victim_row()
        assert row["readmissions"] >= 1 and row["routable"]
        assert router.get("/healthz")["routable"] == 3
    finally:
        revived.close()


def test_rolling_reload_zero_drops(fleet, tmp_path):
    router, backends, dirs = fleet
    staging = tmp_path / "staging"
    _publish(staging, epoch=1, seed=77)
    source = str(staging / "checkpoint_1.npz")
    images, _ = synthetic_dataset(2, seed=3)
    payload = {"images": images.tolist(), "client_id": "roller"}
    failures = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                reply = router.post("/predict", payload)
                if len(reply["predictions"]) != 2:
                    failures.append(("malformed", reply))
            except Exception as exc:  # noqa: BLE001
                failures.append(("error", repr(exc)))

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    try:
        result = router.post("/rollout", {"source": source})
    finally:
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(10.0)
    assert result["ok"], result
    assert sorted(result["updated"]) == sorted(b.name for b in backends)
    assert result["target_epoch"] == 1
    assert not failures, failures[:5]
    for b in backends:
        health = b.get("/healthz")
        assert health["model_epoch"] == 1 and health["draining"] is False
    stats = router.get("/stats")
    assert stats["last_rollout"]["ok"]
    assert all(r["epoch"] == 1 for r in stats["backends"])


def test_fleet_canary_bad_publish_rolls_back(fleet, tmp_path):
    router, backends, dirs = fleet
    staging = tmp_path / "staging"
    staging.mkdir()
    bad = staging / "checkpoint_2.npz"
    bad.write_bytes(b"definitely not an npz")
    images, _ = synthetic_dataset(1, seed=5)
    try:
        router.post("/rollout", {
            "source": str(bad),
            "canary": {"fraction": 0.5, "backends": [backends[0].name]},
            "verify_timeout_s": 1.5,
        })
        code, body = 200, {}
    except urllib.error.HTTPError as exc:
        code = exc.code
        body = json.loads(exc.read())
    assert code == 502
    assert body["ok"] is False
    assert body["canary"]["state"] == "rolled_back"
    assert body["rollout"]["ok"] is False
    assert not (dirs[0] / "checkpoint_2.npz").exists()
    for b in backends:
        assert b.get("/healthz")["model_epoch"] == 0
        assert b.get("/healthz")["draining"] is False
    reply = router.post("/predict", {"images": images.tolist()})
    assert reply["model_epoch"] == 0
    stats = router.get("/stats")
    assert stats["fleet_canary"]["state"] == "rolled_back"
    assert stats["fleet_canary"]["rollbacks"] == 1


def test_zero_backends_is_a_loud_fleet_503(tmp_path):
    ckpt = tmp_path / "only"
    _publish(ckpt, epoch=0, seed=10)
    backend = _boot_backend(ckpt)
    router = _boot_router([backend])
    try:
        _wait(lambda: router.get("/healthz")["routable"] == 1,
              what="backend healthy")
        backend.kill()
        _wait(lambda: router.get("/stats")["backends"][0]["state"]
              == "quarantined", what="quarantine")
        images, _ = synthetic_dataset(1, seed=0)
        try:
            router.post("/predict", {"images": images.tolist()})
            code, headers, body = 200, {}, {}
        except urllib.error.HTTPError as exc:
            code, headers = exc.code, exc.headers
            body = json.loads(exc.read())
        assert code == 503
        assert body["error"] == "no routable backends in the fleet"
        assert body["fleet"][backend.name] == "quarantined"
        assert int(headers["Retry-After"]) >= 1
        try:
            health_code = 200
            router.get("/healthz")
        except urllib.error.HTTPError as exc:
            health_code = exc.code
            exc.read()
        assert health_code == 503
        assert router.get("/stats")["fleet"]["fleet_503s"] >= 1
    finally:
        router.close()


# ---------------------------------------------------------------------------
# The wire between the packages
# ---------------------------------------------------------------------------


def test_port_router_over_a_jax_and_a_port_backend_answers_as_jax(
        tmp_path):
    """One f32 linear checkpoint served by a JAX backend and a port
    backend behind the port's router: every reply's digits, whichever
    backend answered, equal a direct call to the JAX backend."""
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=21)
    jax_backend = _boot_jax_backend(ckpt)
    port_backend = _boot_backend(ckpt)
    router = _boot_router([jax_backend, port_backend])
    try:
        _wait(lambda: router.get("/healthz")["routable"] == 2,
              what="both backends healthy")
        images, _ = synthetic_dataset(64, seed=8)
        for i in range(0, 64, 4):
            payload = {"images": images[i:i + 1 + i % 4].tolist()}
            got = router.post("/predict", payload)
            want = jax_backend.post("/predict", payload)
            assert got["predictions"] == want["predictions"]
            assert got["model_epoch"] == want["model_epoch"] == 0
        rows = {r["name"]: r for r in router.get("/stats")["backends"]}
        assert rows[jax_backend.name]["requests"] > 0
        assert rows[port_backend.name]["requests"] > 0
    finally:
        router.close()
        jax_backend.close()
        port_backend.close()


def test_jax_router_rolls_out_over_two_port_backends(tmp_path):
    backends, dirs = [], []
    for i in range(2):
        ckpt = tmp_path / f"b{i}"
        _publish(ckpt, epoch=0, seed=10)
        dirs.append(ckpt)
        backends.append(_boot_backend(ckpt))
    router = _Server(jax_router.create_router(
        jax_router.build_parser().parse_args(_router_argv(backends))))
    try:
        _wait(lambda: router.get("/healthz")["routable"] == 2,
              what="both port backends healthy under the JAX router")
        staging = tmp_path / "staging"
        _publish(staging, epoch=1, seed=77)
        result = router.post("/rollout",
                             {"source": str(staging / "checkpoint_1.npz")})
        assert result["ok"], result
        assert sorted(result["updated"]) == sorted(b.name for b in backends)
        for b in backends:
            health = b.get("/healthz")
            assert health["model_epoch"] == 1 and health["draining"] is False
        images, _ = synthetic_dataset(3, seed=1)
        assert router.post("/predict", {"images": images.tolist()})[
            "model_epoch"] == 1
    finally:
        router.close()
        for b in backends:
            b.close()
