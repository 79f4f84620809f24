"""The port's HTTP server (``serve/server.py``) on the CPU: boot over a
checkpoint directory, answer ``/predict``, ``/healthz``, ``/stats`` and
``/drain``, and hot-reload a newly published checkpoint."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import synthetic_dataset
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    save_params_checkpoint,
)

pytestmark = pytest.mark.serve
# The suite runs files in parallel workers beside timing-sensitive JAX
# serving tests; two intra-op threads keep these small CPU runs from
# taking every core.
torch.set_num_threads(2)


def _args(directory, *extra):
    return build_parser().parse_args([
        "--model", "cnn", "--serve-precision", "int8", "--port", "0",
        "--device", "cpu", "--checkpoint-dir", str(directory),
        "--buckets", "1,8", "--poll-interval", "0.1", *extra])


class _Server:
    def __init__(self, args) -> None:
        self.httpd = create_server(args)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self.base + path, data=data)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    def close(self):
        self.httpd.shutdown()
        self.httpd.ctx.close()
        self.httpd.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def server(tmp_path):
    save_params_checkpoint(params_to_jax(init_params("cnn", 0)), epoch=0,
                           directory=str(tmp_path))
    srv = _Server(_args(tmp_path))
    yield srv, tmp_path
    srv.close()


def test_predict_healthz_stats_and_hot_reload(server):
    srv, directory = server
    images, _ = synthetic_dataset(11, seed=4)
    code, reply = srv.request("/predict", {"images": images.tolist()})
    assert code == 200, reply
    assert len(reply["predictions"]) == 11 and reply["model_epoch"] == 0
    assert reply["predictions"] == srv.httpd.ctx.engine.predict(
        images).tolist()
    # One image without the list around it.
    code, one = srv.request("/predict", {"images": images[0].tolist()})
    assert code == 200
    assert one["predictions"] == srv.httpd.ctx.engine.predict(
        images[:1]).tolist()

    code, health = srv.request("/healthz")
    assert code == 200 and health["ok"] and health["model"] == "cnn"
    assert health["model_epoch"] == 0
    assert health["checkpoint"].endswith("checkpoint_0.npz")

    code, stats = srv.request("/stats")
    assert code == 200
    assert stats["serve_precision"] == "int8" and stats["fused"] is True
    assert stats["device"] == "cpu" and stats["buckets"] == [1, 8]
    assert stats["serve_mode"] == "replicated"
    assert stats["requests"] >= 2 and stats["latency_ms"]["count"] >= 2
    assert "matmul_i8" in stats["kernel_launches"]
    assert len(stats["warmup"]["programs"]) == 4  # 2 buckets x 2 planes

    save_params_checkpoint(params_to_jax(init_params("cnn", 1)), epoch=1,
                           directory=str(directory))
    deadline = time.monotonic() + 30
    while srv.request("/healthz")[1]["model_epoch"] != 1:
        assert time.monotonic() < deadline, "model_epoch did not flip"
        time.sleep(0.05)
    code, after = srv.request("/predict", {"images": images[:3].tolist()})
    assert code == 200 and after["model_epoch"] == 1
    assert srv.request("/stats")[1]["reloads"] == 1


def test_cache_drain_and_bad_requests(server):
    srv, _ = server
    images, _ = synthetic_dataset(4, seed=5)
    body = {"images": images.tolist()}
    first = srv.request("/predict", body)[1]
    again = srv.request("/predict", body)[1]
    assert again["predictions"] == first["predictions"]
    assert srv.request("/stats")[1]["cache"]["hits"] == 1

    assert srv.request("/predict", {"pixels": []})[0] == 400
    assert srv.request("/predict", {"images": [[1, 2], [3]]})[0] == 400
    assert srv.request("/predict", {"images": images.tolist(),
                                    "model": "vit"})[0] == 400
    assert srv.request("/nowhere")[0] == 404

    code, drained = srv.request("/drain", {"drain": True})
    assert code == 200 and drained["draining"] and not drained["was_draining"]
    assert srv.request("/predict", body)[0] == 503
    assert srv.request("/drain", {"drain": False})[1]["draining"] is False
    assert srv.request("/predict", body)[0] == 200


def test_boot_without_checkpoint(tmp_path, capsys):
    with pytest.raises(SystemExit, match="require-checkpoint"):
        create_server(_args(tmp_path, "--require-checkpoint"))
    srv = _Server(_args(tmp_path, "--no-reload"))
    try:
        assert "serving fresh params" in capsys.readouterr().out
        images = np.zeros((2, 28, 28), np.uint8)
        code, reply = srv.request("/predict", {"images": images.tolist()})
        assert code == 200 and reply["model_epoch"] is None
    finally:
        srv.close()


def test_parser_leaves_out_unported_flags_and_defaults_to_cuda():
    args = build_parser().parse_args([])
    assert args.device == "cuda" and args.serve_precision == "f32"
    assert args.buckets == "1,8,32,128" and args.cache_mb == 64.0
    assert args.register_dir is None
    assert build_parser().parse_args(["--register-dir", "d"]).register_dir \
        == "d"
    for flag in ("--serve-mode", "--serve-mesh"):
        with pytest.raises(SystemExit):
            build_parser().parse_args([flag, "1"])


def test_cli_dispatches_serve_and_refuses_training(capsys, tmp_path):
    # A bare invocation trains (the JAX package's default subcommand);
    # training flags the port does not have yet (every trainer mode and
    # --grad-accum are ported; --zero-overlap is not) exit 2.
    with pytest.raises(SystemExit) as info:
        cli.main(["--epochs", "1", "--zero-overlap", "--device",
                  "cpu", "--checkpoint-dir", str(tmp_path)])
    assert info.value.code == 2
    assert "unrecognized arguments: --zero-overlap" \
        in capsys.readouterr().err
    with pytest.raises(SystemExit) as info:
        cli.main(["serve", "--help"])
    assert info.value.code == 0
    assert "--serve-precision" in capsys.readouterr().out
