"""The port's multi-model serving (``--model-set``): the cases of
``tests/test_serve_multimodel.py``. N models from one process over one
set of devices: routing on the request's ``model`` field, per-plane
isolation (one model's hot reload touches nothing of the other's),
per-plane ``/stats`` blocks and the ``tools/loadgen.py --expect-models``
smoke over real loopback HTTP. The checkpoints are written by the JAX
package and every reply is held to the JAX model's forward on the same
images.

The port's servers run on ``--device cpu`` (float32 compute, the split
plane, as the JAX suite does); every wait is bounded."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import (
    normalize_images,
    synthetic_dataset,
)
from pytorch_distributed_mnist_tpu.models import get_model
from pytorch_distributed_mnist_tpu.train.checkpoint import save_checkpoint
from pytorch_distributed_mnist_tpu.train.state import create_train_state
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)

pytestmark = pytest.mark.serve
torch.set_num_threads(2)
TIMEOUT = 120  # seconds any one loadgen run or wait may take

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _publish(ckpt_dir, model_name, epoch, seed):
    model = get_model(model_name, compute_dtype=jnp.float32)
    state = create_train_state(model, jax.random.key(seed))
    save_checkpoint(state, epoch=epoch, best_acc=0.5, is_best=False,
                    directory=str(ckpt_dir), process_index=0)
    return state


def _args(model_set, **overrides):
    argv = [
        "--model-set", model_set, "--dtype", "f32", "--device", "cpu",
        "--host", "127.0.0.1", "--port", "0",
        "--buckets", "1,8",
        "--max-wait-ms", "2", "--max-queue", "64",
        "--poll-interval", "0.1",
        "--no-fuse",
    ]
    for k, v in overrides.items():
        flag = "--" + k.replace("_", "-")
        if v is True:
            argv.append(flag)
        else:
            argv += [flag, str(v)]
    return build_parser().parse_args(argv)


class _Server:
    def __init__(self, args):
        self.httpd = create_server(args)
        host, port = self.httpd.server_address[:2]
        self.url = f"http://{host}:{port}"
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.ctx.close()
        self.httpd.server_close()
        self.thread.join(10.0)

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return json.loads(r.read())

    def post(self, path, payload):
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())


@pytest.fixture()
def two_model_server(tmp_path):
    d1, d2 = tmp_path / "linear", tmp_path / "cnn"
    state_lin = _publish(d1, "linear", epoch=3, seed=1)
    state_cnn = _publish(d2, "cnn", epoch=7, seed=2)
    srv = _Server(_args(f"linear={d1},cnn={d2}"))
    try:
        yield srv, state_lin, state_cnn, d1, d2
    finally:
        srv.close()


def test_routes_on_model_field_with_correct_predictions(
        two_model_server):
    srv, state_lin, state_cnn, _, _ = two_model_server
    images, _ = synthetic_dataset(4, seed=3)
    payload = {"images": images.tolist()}
    norm = jnp.asarray(normalize_images(images))

    code, reply = srv.post("/predict", {**payload, "model": "linear"})
    assert code == 200 and reply["model"] == "linear"
    assert reply["model_epoch"] == 3
    model = get_model("linear", compute_dtype=jnp.float32)
    want = np.argmax(np.asarray(model.apply(
        state_lin.params, norm, train=False)), axis=-1)
    assert reply["predictions"] == [int(v) for v in want]

    code, reply = srv.post("/predict", {**payload, "model": "cnn"})
    assert code == 200 and reply["model"] == "cnn"
    assert reply["model_epoch"] == 7
    model = get_model("cnn", compute_dtype=jnp.float32)
    want = np.argmax(np.asarray(model.apply(
        state_cnn.params, norm, train=False)), axis=-1)
    assert reply["predictions"] == [int(v) for v in want]


def test_missing_and_unknown_model_are_400s(two_model_server):
    srv = two_model_server[0]
    images, _ = synthetic_dataset(1, seed=0)
    payload = {"images": images.tolist()}
    code, reply = srv.post("/predict", payload)
    assert code == 400
    assert "must name 'model'" in reply["error"]
    assert "linear" in reply["error"] and "cnn" in reply["error"]
    code, reply = srv.post("/predict", {**payload, "model": "vit"})
    assert code == 400 and "unknown model" in reply["error"]


def test_stats_carries_per_model_blocks_and_healthz_models(
        two_model_server):
    srv = two_model_server[0]
    images, _ = synthetic_dataset(1, seed=0)
    srv.post("/predict", {"images": images.tolist(), "model": "cnn"})
    stats = srv.get("/stats")
    assert stats["model_set"] == ["cnn", "linear"]
    models = stats["models"]
    assert sorted(models) == ["cnn", "linear"]
    for name, block in models.items():
        assert "latency_ms" in block and "window" in block
        assert block["buckets"] == [1, 8]
        # The per-plane warm-up block shows only that plane's programs
        # (names carry the model as the first segment after '@').
        assert block["warmup"]["programs"]
        for prog in block["warmup"]["programs"]:
            assert prog.partition("@")[2].split(".")[0] == name
    assert models["cnn"]["requests"] == 1
    assert models["linear"]["requests"] == 0
    assert models["cnn"]["model_epoch"] == 7
    assert models["linear"]["model_epoch"] == 3
    health = srv.get("/healthz")
    assert health["models"] == {"cnn": 7, "linear": 3}
    # The weighted-fair gate is live (default weights 1.0 each).
    assert stats["fair_dispatch"]["weights"] == {
        "cnn": 1.0, "linear": 1.0}
    assert stats["fair_dispatch"]["grants"]["cnn"] >= 1


def test_one_models_reload_is_invisible_to_the_other(
        two_model_server):
    """Isolation: publishing a new checkpoint for linear swaps ONLY the
    linear plane: cnn keeps its epoch and its replies, and no bucket is
    warmed again anywhere (a reload is an atomic param swap on the one
    plane it touches)."""
    srv, _, _, d1, _ = two_model_server
    images, _ = synthetic_dataset(2, seed=4)
    payload = {"images": images.tolist()}
    warmed_before = {name: plane.warmup_log.stats()
                     for name, plane in srv.httpd.ctx.planes.items()}
    cnn_before = srv.post("/predict", {**payload, "model": "cnn"})[1]

    state_new = _publish(d1, "linear", epoch=9, seed=9)
    lin_plane = srv.httpd.ctx.planes["linear"]
    cnn_plane = srv.httpd.ctx.planes["cnn"]
    # The background poll thread (0.1s interval) may legitimately win
    # the race to this publish; poll_once is lock-serialized against it,
    # so EITHER poll installs — exactly once (the reloads==1 pin below).
    installed = lin_plane.watcher.poll_once()
    assert installed or lin_plane.engine.params_epoch == 9
    assert lin_plane.engine.params_epoch == 9
    assert cnn_plane.engine.params_epoch == 7
    # cnn's own watcher sees nothing new.
    assert cnn_plane.watcher.poll_once() is False

    code, reply = srv.post("/predict", {**payload, "model": "linear"})
    assert code == 200 and reply["model_epoch"] == 9
    model = get_model("linear", compute_dtype=jnp.float32)
    want = np.argmax(np.asarray(model.apply(
        state_new.params, jnp.asarray(normalize_images(images)),
        train=False)), axis=-1)
    assert reply["predictions"] == [int(v) for v in want]
    code, reply = srv.post("/predict", {**payload, "model": "cnn"})
    assert code == 200 and reply["model_epoch"] == 7
    assert reply["predictions"] == cnn_before["predictions"]
    assert srv.get("/healthz")["models"] == {"cnn": 7, "linear": 9}
    assert {name: plane.warmup_log.stats()
            for name, plane in srv.httpd.ctx.planes.items()} \
        == warmed_before
    stats = srv.get("/stats")
    assert stats["models"]["linear"]["reloads"] == 1
    assert stats["models"]["cnn"]["reloads"] == 0


def test_loadgen_expect_models_smoke_over_loopback(two_model_server):
    srv = two_model_server[0]
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "loadgen.py"),
         "--smoke", "--url", srv.url, "--requests", "40",
         "--concurrency", "4", "--model", "cnn",
         "--expect-models", "2"],
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["smoke_ok"] is True
    assert report["models_served"] == ["cnn", "linear"]
    assert report["model_set"] == ["cnn", "linear"]
    # --expect-models has teeth: the wrong count fails the smoke.
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "loadgen.py"),
         "--smoke", "--url", srv.url, "--requests", "10",
         "--concurrency", "2", "--model", "cnn",
         "--expect-models", "3"],
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 1


def test_model_weights_flag_validation(tmp_path):
    d1 = tmp_path / "a"
    d1.mkdir()
    with pytest.raises(SystemExit, match="requires --model-set"):
        create_server(build_parser().parse_args(
            ["--checkpoint-dir", str(d1), "--model", "linear",
             "--model-weights", "linear=2"]))
    with pytest.raises(SystemExit, match="twice"):
        create_server(build_parser().parse_args(
            ["--model-set", f"linear={d1},linear={d1}"]))
    with pytest.raises(SystemExit, match="unknown model"):
        create_server(build_parser().parse_args(
            ["--model-set", f"zzz={d1}"]))
    with pytest.raises(SystemExit, match="MODEL=CHECKPOINT_DIR"):
        create_server(build_parser().parse_args(
            ["--model-set", "linear"]))


def test_weighted_fair_dispatch_under_dual_backlog(tmp_path):
    """Both models hammered concurrently with 3:1 weights: the gate's
    granted-rows split lands near the weights (tolerant: fairness binds
    only while both planes genuinely contend)."""
    d1, d2 = tmp_path / "lin", tmp_path / "cnn"
    _publish(d1, "linear", epoch=0, seed=1)
    _publish(d2, "cnn", epoch=0, seed=2)
    srv = _Server(_args(f"linear={d1},cnn={d2}",
                        model_weights="linear=3,cnn=1"))
    try:
        images, _ = synthetic_dataset(1, seed=0)
        payload = {"images": images.tolist()}
        errors = []

        def hammer(model, n):
            for _ in range(n):
                code, _ = srv.post("/predict",
                                   {**payload, "model": model})
                if code != 200:
                    errors.append((model, code))

        threads = [threading.Thread(target=hammer, args=(m, 60),
                                    daemon=True)
                   for m in ("linear", "cnn") for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not errors, errors[:5]
        stats = srv.get("/stats")
        fair = stats["fair_dispatch"]
        assert fair["weights"] == {"linear": 3.0, "cnn": 1.0}
        assert fair["granted_rows"]["linear"] > 0
        assert fair["granted_rows"]["cnn"] > 0
        assert stats["models"]["linear"]["requests"] == 120
        assert stats["models"]["cnn"]["requests"] == 120
    finally:
        srv.close()


def test_pooled_model_set_names_replicas_and_resizes_one_plane(tmp_path):
    """A model set over a 2-replica pool per plane: replica rows and
    warm-up records carry the model as their first segment, and a
    ``/resize`` naming one model re-shapes that plane's pool only."""
    d1, d2 = tmp_path / "lin", tmp_path / "cnn"
    state_lin = _publish(d1, "linear", epoch=0, seed=1)
    _publish(d2, "cnn", epoch=0, seed=2)
    srv = _Server(_args(f"linear={d1},cnn={d2}", serve_devices=2))
    try:
        stats = srv.get("/stats")
        assert sorted(stats["models"]["cnn"]["replicas"]) \
            == ["cnn.r0", "cnn.r1"]
        assert sorted(stats["models"]["linear"]["replicas"]) \
            == ["linear.r0", "linear.r1"]
        code, reply = srv.post("/resize", {"serve_devices": 3,
                                           "model": "linear"})
        assert code == 200 and reply["new"]["groups"] == 3
        stats = srv.get("/stats")
        assert stats["models"]["linear"]["groups"] == 3
        assert stats["models"]["cnn"]["groups"] == 2
        images, _ = synthetic_dataset(5, seed=6)
        code, reply = srv.post("/predict", {"images": images.tolist(),
                                            "model": "linear"})
        model = get_model("linear", compute_dtype=jnp.float32)
        want = np.argmax(np.asarray(model.apply(
            state_lin.params, jnp.asarray(normalize_images(images)),
            train=False)), axis=-1)
        assert code == 200 and reply["predictions"] == [int(v) for v in want]
        code, reply = srv.post("/resize", {"serve_devices": 1})
        assert code == 400 and "must name 'model'" in reply["error"]
    finally:
        srv.close()
