"""Serving the ViT in the port (``serve --model vit``) on the CPU: the
port's ``InferenceEngine`` on the ViT against the JAX package's at every
precision, on the fused and the split plane, from one JAX checkpoint; the
int8 plane's ten int8 products per forward; and the server booting on a
port-written and on a JAX-written ViT checkpoint, answering
``/predict``, ``/healthz`` and ``/stats`` and hot-reloading.

The JAX engine is built as the JAX server builds its planes
(``_model_for``): on ``int8`` the model gets ``int8_dot_general`` through
its ``dot_general`` field, so its Dense layers reach the Pallas
``matmul_i8`` (interpret mode on the CPU). The ViT is at its registered
widths (patch 4, embed 64, 4 heads, depth 2, MLP 256), dense attention,
buckets (1, 8)."""

import json
import threading
import time
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
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.ops.pallas import int8_dot_general
from pytorch_distributed_mnist_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import TrainState as JaxState
from pytorch_distributed_mnist_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import int8_linear
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    InferenceEngine,
    load_params_for_serving,
)
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    save_params_checkpoint,
)

pytestmark = pytest.mark.serve
torch.set_num_threads(2)

BUCKETS = (1, 8)
# Request sizes: each bucket exactly, padded ones, one that chunks
# through the top bucket (13 = 8 + 5).
SIZES = (1, 3, 8, 5, 13, 8, 2, 7)
PRECISIONS = ("f32", "bf16", "int8w", "int8")
# The ViT's int8 products, in the order a forward runs them: (K, N).
VIT_I8_SHAPES = ([(16, 64)] + [(64, 192), (64, 64), (64, 256), (256, 64)] * 2
                 + [(64, 10)])


def _jax_vit_state(**model_kwargs):
    """A JAX ViT train state with its init jitted (the eager init
    dispatches op by op)."""
    model = jax_get_model("vit", **model_kwargs)
    params = jax.jit(model.init)(jax.random.key(0),
                                 jnp.zeros((1, 28, 28, 1), jnp.float32))
    tx = jax_make_optimizer(1e-3, "adam", 0.9, 1e-4)
    return JaxState(step=jnp.zeros((), jnp.int32), params=params,
                    opt_state=tx.init(params), apply_fn=model.apply, tx=tx)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """One JAX-written float32 ViT checkpoint, its params in the port's
    layout, and the request batches."""
    directory = tmp_path_factory.mktemp("vit_ckpt")
    state = _jax_vit_state(compute_dtype=jnp.float32)
    path = jax_ckpt.save_checkpoint(state, epoch=0, best_acc=0.0,
                                    is_best=False, directory=str(directory))
    params, epoch = load_params_for_serving(path, "vit")
    assert epoch == 0 and len(params) == 31
    images, _ = synthetic_dataset(sum(SIZES), seed=3)
    return state.params, params, np.split(images, np.cumsum(SIZES)[:-1])


def _port_engine(params, precision, fuse=True, matmul=int8_linear):
    kwargs = {"matmul": matmul} if precision == "int8" else {}
    model = get_model("vit", compute_dtype=torch.float32, **kwargs)
    return InferenceEngine(model, params, buckets=BUCKETS,
                           precision=precision, fuse=fuse, params_epoch=0,
                           device="cpu")


def _jax_engine(jparams, precision, fuse):
    kwargs = {"dot_general": int8_dot_general} if precision == "int8" else {}
    model = jax_get_model("vit", compute_dtype=jnp.float32, **kwargs)
    return JaxEngine(model.apply, {"params": jparams["params"]},
                     buckets=BUCKETS, precision=precision, fuse=fuse,
                     params_epoch=0)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_vit_engine_matches_jax(setup, precision, fuse):
    jparams, params, batches = setup
    engine = _port_engine(params, precision, fuse)
    jax_engine = _jax_engine(jparams, precision, fuse)
    # The fused plane takes the raw uint8 requests, the split plane their
    # normalized floats (the host normalize).
    inputs = batches if fuse else [normalize_images(b) for b in batches]
    got = np.concatenate([engine.logits(b) for b in inputs])
    want = np.concatenate([np.asarray(jax_engine.logits(b)) for b in inputs])
    assert got.shape == want.shape == (sum(SIZES), 10)
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    if precision != "int8":
        # float32 compute on both sides (bf16 and int8w round the weights
        # alike, bitwise, tests/test_torch_serve_programs.py); the
        # products and LayerNorm statistics sum in another order in XLA
        # and in PyTorch: atol 5e-6 on logits below 2 (measured 6.6e-7).
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
        return
    # int8: both sides quantize each Dense input per tensor, dynamically.
    # An input a float32 rounding away from a quantization boundary
    # rounds the other way on one side, and moves the logits by a step
    # of that product's scale: the cnn engine's bound (atol 2e-2,
    # measured 1.1e-2 here) and argmax agreement on 99% of the rows.
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree >= 0.99, agree


def test_the_int8_vit_runs_ten_int8_products_per_forward(setup):
    _, params, batches = setup
    shapes = []

    def counting(x, w, out_dtype=None):
        shapes.append(tuple(w.shape))
        return int8_linear(x, w, out_dtype)

    spy = _port_engine(params, "int8", matmul=counting)
    engine = _port_engine(params, "int8")
    np.testing.assert_array_equal(spy.logits(batches[4]),
                                  engine.logits(batches[4]))
    # 13 rows chunk through the top bucket: 8 + 5 (padded to 8).
    assert shapes == VIT_I8_SHAPES * 2


def test_the_vit_fused_plane_is_bitwise_the_split_plane(setup):
    _, params, batches = setup
    for precision in ("f32", "int8"):
        engine = _port_engine(params, precision)
        for raw in batches:
            # A padded chunk's pad rows are raw zeros on the fused plane
            # and normalized zeros on the split plane, and the int8 plane
            # quantizes each Dense input over the whole chunk (as the JAX
            # engine does): on int8 only chunks that fill their bucket
            # are the same bits.
            if precision == "int8" and len(raw) not in BUCKETS:
                continue
            fused = engine.logits(raw)
            split = engine.logits(normalize_images(raw))
            assert fused.tobytes() == split.tobytes(), precision


# -- the server --------------------------------------------------------------

def _args(directory, *extra):
    return build_parser().parse_args([
        "--model", "vit", "--port", "0", "--device", "cpu",
        "--checkpoint-dir", str(directory), "--buckets", "1,8",
        "--poll-interval", "0.1", *extra])


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


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_the_server_serves_the_vit(precision, fuse, tmp_path):
    save_params_checkpoint(params_to_jax(init_params("vit", 0)), epoch=0,
                           directory=str(tmp_path))
    extra = ["--serve-precision", precision] + ([] if fuse else ["--no-fuse"])
    srv = _Server(_args(tmp_path, *extra))
    try:
        images, _ = synthetic_dataset(11, seed=4)
        code, reply = srv.request("/predict", {"images": images.tolist()})
        assert code == 200, reply
        assert reply["model_epoch"] == 0
        assert reply["predictions"] == srv.httpd.ctx.engine.predict(
            images).tolist()
        code, health = srv.request("/healthz")
        assert code == 200 and health["model"] == "vit"
        code, stats = srv.request("/stats")
        assert stats["serve_precision"] == precision
        assert stats["fused"] is fuse
    finally:
        srv.close()


def test_the_vit_server_hot_reloads_and_caches(tmp_path):
    save_params_checkpoint(params_to_jax(init_params("vit", 0)), epoch=0,
                           directory=str(tmp_path))
    srv = _Server(_args(tmp_path, "--serve-precision", "int8"))
    try:
        images, _ = synthetic_dataset(6, seed=5)
        body = {"images": images.tolist()}
        first = srv.request("/predict", body)[1]
        assert srv.request("/predict", body)[1]["predictions"] \
            == first["predictions"]
        assert srv.request("/stats")[1]["cache"]["hits"] == 1
        save_params_checkpoint(params_to_jax(init_params("vit", 1)),
                               epoch=1, directory=str(tmp_path))
        deadline = time.monotonic() + 30
        while srv.request("/healthz")[1]["model_epoch"] != 1:
            assert time.monotonic() < deadline, "model_epoch did not flip"
            time.sleep(0.05)
        code, after = srv.request("/predict", body)
        assert code == 200 and after["model_epoch"] == 1
        assert after["predictions"] == srv.httpd.ctx.engine.predict(
            images).tolist()
        assert srv.request("/stats")[1]["reloads"] == 1
    finally:
        srv.close()


def test_a_jax_written_vit_checkpoint_boots_the_server(tmp_path, capsys):
    state = _jax_vit_state()
    jax_ckpt.save_checkpoint(state, epoch=3, best_acc=0.5, is_best=False,
                             directory=str(tmp_path))
    srv = _Server(_args(tmp_path, "--serve-precision", "bf16",
                        "--require-checkpoint"))
    try:
        assert "checkpoint_3.npz' (epoch 3)" in capsys.readouterr().out
        images, _ = synthetic_dataset(3, seed=6)
        code, reply = srv.request("/predict", {"images": images.tolist()})
        assert code == 200 and reply["model_epoch"] == 3
        assert len(reply["predictions"]) == 3
    finally:
        srv.close()


def test_a_cnn_checkpoint_is_refused_by_the_vit_server(tmp_path):
    save_params_checkpoint(params_to_jax(init_params("cnn", 0)), epoch=0,
                           directory=str(tmp_path))
    with pytest.raises(SystemExit, match="require-checkpoint"):
        create_server(_args(tmp_path, "--require-checkpoint"))
