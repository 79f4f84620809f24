"""The slice as a whole: the port's int8 fused ``InferenceEngine`` against
the JAX package's, on one JAX checkpoint and the same raw uint8 batches.

The JAX engine is built as the JAX server builds its int8 plane
(``_model_for``): the model gets ``int8_dot_general`` through its
``dot_general`` field, so its Dense layers reach the Pallas ``matmul_i8``
(interpret mode on the CPU). Both sides compute in float32 and use buckets
(1, 8) to keep the JAX compile time down.
"""

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
from pytorch_distributed_mnist_tpu.serve.engine import (
    load_params_for_serving as jax_load_params,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import create_train_state
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
    int8_linear,
    matmul_i8,
)
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    InferenceEngine,
    load_params_for_serving,
)

pytestmark = pytest.mark.serve
# The suite runs files in parallel workers beside timing-sensitive JAX
# serving tests; two intra-op threads keep these small CPU runs from
# taking every core.
torch.set_num_threads(2)

BUCKETS = (1, 8)
# Request sizes: every bucket exactly, padded ones, and one that chunks
# through the top bucket (13 = 8 + 5).
SIZES = (1, 3, 8, 5, 13, 8, 2, 8, 7, 8, 8, 6, 8, 8, 4, 8)


def _port_engine(params, epoch, device="cpu"):
    model = get_model("cnn", compute_dtype=torch.float32, matmul=int8_linear)
    return InferenceEngine(model, params, buckets=BUCKETS, precision="int8",
                           fuse=True, params_epoch=epoch, device=device)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ckpt")
    jmodel = jax_get_model("cnn", dot_general=int8_dot_general,
                           compute_dtype=jnp.float32)
    state = create_train_state(jmodel, jax.random.key(0))
    path = jax_ckpt.save_checkpoint(state, epoch=0, best_acc=0.0,
                                    is_best=False, directory=str(directory))
    jparams, jepoch = jax_load_params(path, state)
    jax_engine = JaxEngine(jmodel.apply, jparams, buckets=BUCKETS,
                           precision="int8", fuse=True, params_epoch=jepoch)
    params, epoch = load_params_for_serving(path, "cnn")
    assert epoch == jepoch == 0
    images, _ = synthetic_dataset(sum(SIZES), seed=3)
    batches = np.split(images, np.cumsum(SIZES)[:-1])
    return jax_engine, _port_engine(params, epoch), params, batches


def test_int8_fused_engine_matches_jax(setup):
    jax_engine, engine, _, batches = setup
    got = np.concatenate([engine.logits(b) for b in batches])
    want = np.concatenate([np.asarray(jax_engine.logits(b)) for b in batches])
    assert got.shape == want.shape == (sum(SIZES), 10)
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    # Both sides quantize each Dense input per tensor, dynamically. The
    # convolutions sum in another order in XLA and in PyTorch, so a value
    # at a rounding boundary of the fc1 input can round the other way, and
    # each such flip moves the logits by a step of the int8 product's
    # scale. About half the rows come out bitwise equal and the largest
    # difference is 4.3e-3 on logits up to 1.9, hence atol 2e-2, and
    # argmax agreement on at least 99% of the rows.
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree >= 0.99, agree


def test_int8_engine_runs_the_int8_matmul_twice_per_chunk(setup):
    _, engine, _, batches = setup
    calls = []

    def counting(x, w, out_dtype=None):
        calls.append(tuple(w.shape))
        return int8_linear(x, w, out_dtype)

    spy = _port_engine(setup[2], 0)
    spy.model.fc1.matmul = spy.model.fc2.matmul = counting
    before = matmul_i8.launches
    np.testing.assert_array_equal(spy.logits(batches[4]),
                                  engine.logits(batches[4]))
    # 13 rows chunk through the top bucket: 8 + 5 (padded to 8).
    assert calls == [(12544, 128), (128, 10)] * 2
    assert matmul_i8.launches == before  # CPU tensors take the plain path


def test_fused_plane_is_bitwise_equal_to_split_plane(setup):
    _, engine, _, batches = setup
    for raw in batches[:4]:
        fused = engine.logits(raw)
        split = engine.logits(normalize_images(raw))  # float -> split
        assert fused.tobytes() == split.tobytes()


def test_swap_params_refuses_an_older_epoch(setup):
    _, _, params, batches = setup
    engine = _port_engine(params, 0)
    seen = []
    engine.add_swap_hook(seen.append)
    newer = {k: v * 0.5 for k, v in params.items()}
    assert engine.swap_params(newer, epoch=5)
    assert engine.params_epoch == 5 and seen == [5]
    logits_5 = engine.logits(batches[0])
    assert not engine.swap_params(params, epoch=3)
    assert engine.params_epoch == 5 and seen == [5]
    np.testing.assert_array_equal(engine.logits(batches[0]), logits_5)
    # In flight: a dispatched batch keeps the params it captured.
    inflight = engine.dispatch_logits(batches[0])
    assert engine.swap_params(params, epoch=6)
    logits, epoch = inflight.complete()
    assert epoch == 5
    np.testing.assert_array_equal(logits, logits_5)


def test_staging_buffers_are_reused_and_warmup_is_recorded(setup):
    _, _, params, batches = setup
    engine = _port_engine(params, 0)
    engine.warmup()
    programs = engine.warmup_log.stats()["programs"]
    assert sorted(programs) == sorted(
        [f"serve_forward_b{b}" for b in BUCKETS]
        + [f"serve_forward_b{b}.fused" for b in BUCKETS])
    assert all(p["runs"] == 1 for p in programs.values())
    for b in batches:  # warms the in-flight window (13 rows hold 2 x 8)
        engine.logits(b)
    allocated = engine.staging_allocated()
    assert allocated["fused"] == {1: 1, 8: 2}
    for b in batches:
        engine.logits(b)
    assert engine.staging_allocated() == allocated


def test_cuda_engine_without_a_card_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _port_engine(setup[2], 0, device="cuda")
