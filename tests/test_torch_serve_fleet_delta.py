"""Fleet registration and a manifest rollout over port backends, on the
CPU: in-process port servers (``--device cpu``, f32 ``linear``) on
JAX-published delta manifests and the port's router. Twins of
``tests/test_serve_delta_fleet.py``'s fleet cases:

- ``--register-dir`` records follow the backend's lifecycle (boot
  registers, drain removes, undrain writes again, shutdown removes);
- a ``--backends-dir`` router's membership tracks the records with no
  restart (join, leave on drain, rejoin, a late join);
- ``POST /rollout`` with a manifest source: every backend gets the
  manifest, pulls the chunks it lacks from ``--chunk-source`` and the
  fleet converges on the new epoch."""

import os

import pytest

from pytorch_distributed_mnist_tpu_torch.serve.router import (
    build_parser as router_parser,
)
from pytorch_distributed_mnist_tpu_torch.serve.router import create_router
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from tests.test_serve_delta_fleet import _delta_publish, _healthz, _record_urls
from tests.test_serve_router_fleet import _Server, _wait

pytestmark = [pytest.mark.serve, pytest.mark.fleet, pytest.mark.distrib]


def _boot_backend(ckpt_dir, *extra):
    return _Server(create_server(build_parser().parse_args([
        "--checkpoint-dir", str(ckpt_dir), "--device", "cpu",
        "--model", "linear", "--dtype", "f32",
        "--host", "127.0.0.1", "--port", "0",
        "--buckets", "1,8",
        "--max-wait-ms", "2", "--max-queue", "256",
        "--poll-interval", "0.1",
        *extra,
    ])))


def _boot_router(argv):
    base = ["--host", "127.0.0.1", "--port", "0",
            "--health-interval", "0.1",
            "--quarantine-after", "2",
            "--probation-successes", "1",
            "--connect-timeout", "2.0"]
    return _Server(create_router(router_parser().parse_args(base + argv)))


def test_register_record_follows_lifecycle(tmp_path):
    ckpt, reg = tmp_path / "ckpt", tmp_path / "fleet"
    _delta_publish(ckpt, epoch=0, seed=10)
    backend = _boot_backend(ckpt, "--register-dir", str(reg))
    try:
        assert _record_urls(str(reg)) == [backend.url]
        assert backend.get("/healthz")["model_epoch"] == 0
        backend.post("/drain", {"drain": True})
        assert _record_urls(str(reg)) == []
        assert backend.get("/healthz")["draining"] is True
        backend.post("/drain", {"drain": False})
        assert _record_urls(str(reg)) == [backend.url]
    finally:
        backend.close()
    # Shutdown removes the record even without a preceding drain.
    assert _record_urls(str(reg)) == []


def test_router_membership_tracks_backends_dir(tmp_path):
    reg = tmp_path / "fleet"
    backends = []
    for i in range(2):
        ckpt = tmp_path / f"b{i}"
        _delta_publish(ckpt, epoch=0, seed=10)
        backends.append(_boot_backend(ckpt, "--register-dir", str(reg)))
    router = _boot_router(["--backends-dir", str(reg)])
    try:
        _wait(lambda: _healthz(router)["routable"] == 2,
              what="both registered backends routable")
        backends[1].post("/drain", {"drain": True})
        # A sweep that read the record before the drain may probe the
        # draining backend (routable 1, total 2); the next one reaps it.
        _wait(lambda: (lambda h: (h["routable"], h["total"]))(
            _healthz(router)) == (1, 1),
            what="drained backend reaped from the fleet")
        backends[1].post("/drain", {"drain": False})
        _wait(lambda: _healthz(router)["routable"] == 2,
              what="undrained backend re-admitted")
        ckpt = tmp_path / "b2"
        _delta_publish(ckpt, epoch=0, seed=10)
        backends.append(_boot_backend(ckpt, "--register-dir", str(reg)))
        _wait(lambda: _healthz(router)["routable"] == 3,
              what="late-joining backend discovered")
    finally:
        router.close()
        for b in backends:
            b.close()


def test_manifest_rollout_converges_fleet(tmp_path):
    staging = tmp_path / "staging"
    _delta_publish(staging, epoch=0, seed=10)
    backends, dirs = [], []
    for i in range(3):
        ckpt = tmp_path / f"b{i}"
        _delta_publish(ckpt, epoch=0, seed=10)
        dirs.append(ckpt)
        backends.append(_boot_backend(ckpt, "--chunk-source", str(staging)))
    router = _boot_router(["--backends", ",".join(b.name for b in backends)])
    try:
        _wait(lambda: router.get("/healthz")["routable"] == 3,
              what="all 3 backends healthy")
        _delta_publish(staging, epoch=1, seed=10, shift=1e-3)
        source = str(staging / "checkpoint_1.manifest")
        result = router.post("/rollout", {"source": source})
        assert result["ok"], result
        assert sorted(result["updated"]) == sorted(b.name for b in backends)
        assert result["target_epoch"] == 1
        for b, d in zip(backends, dirs):
            health = b.get("/healthz")
            assert health["model_epoch"] == 1
            assert health["draining"] is False
            assert os.path.isfile(str(d / "checkpoint_1.manifest"))
            assert not os.path.exists(str(d / "checkpoint_1.npz"))
            stats = b.get("/stats")
            assert stats["delta_fetch"]["last"]["dirty_leaves"] >= 1
    finally:
        router.close()
        for b in backends:
            b.close()
