"""Serving ``moe_mlp`` in the port (``serve --model moe_mlp``) on the CPU:
the port's ``InferenceEngine`` against the JAX package's at every
precision (``f32``, ``bf16``, ``int8w``, ``int8``), on the fused and the
split plane, from one JAX checkpoint; and an expert-parallel checkpoint
refused by the replicated server.

``MoEClassifier`` takes no ``dot_general`` in JAX (and no ``matmul``
here), so the int8 planes dequantize its weights and compute in float32
on both sides: no int8 product runs. The model is at its registered
widths (8 experts, embed 64, hidden 128), dense dispatch, float32
compute, buckets (1, 8)."""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import (
    normalize_images,
    synthetic_dataset,
)
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.models import (
    get_model,
    model_accepts,
)
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    InferenceEngine,
    load_params_for_serving,
)
from pytorch_distributed_mnist_tpu_torch.serve.programs import (
    check_checkpoint_layout,
)
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)

pytestmark = pytest.mark.serve
torch.set_num_threads(2)

BUCKETS = (1, 8)
SIZES = (1, 3, 8, 5, 13, 8, 2, 7)
PRECISIONS = ("f32", "bf16", "int8w", "int8")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    directory = tmp_path_factory.mktemp("moe_ckpt")
    state = jax_create_train_state(jax_get_model("moe_mlp"),
                                   jax.random.key(0))
    path = jax_ckpt.save_checkpoint(state, epoch=0, best_acc=0.0,
                                    is_best=False, directory=str(directory))
    params, epoch = load_params_for_serving(path, "moe_mlp")
    assert epoch == 0 and len(params) == 10
    images, _ = synthetic_dataset(sum(SIZES), seed=3)
    return state.params, params, np.split(images, np.cumsum(SIZES)[:-1])


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_moe_engine_matches_jax(setup, precision, fuse):
    jparams, params, batches = setup
    assert not model_accepts("moe_mlp", "matmul")  # no int8 product
    engine = InferenceEngine(get_model("moe_mlp"), params, buckets=BUCKETS,
                             precision=precision, fuse=fuse, params_epoch=0,
                             device="cpu")
    jax_engine = JaxEngine(jax_get_model("moe_mlp").apply,
                           {"params": jparams["params"]}, buckets=BUCKETS,
                           precision=precision, fuse=fuse, params_epoch=0)
    inputs = batches if fuse else [normalize_images(b) for b in batches]
    got = np.concatenate([engine.logits(b) for b in inputs])
    want = np.concatenate([np.asarray(jax_engine.logits(b)) for b in inputs])
    assert got.shape == want.shape == (sum(SIZES), 10)
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    # float32 compute on both sides (the int8 planes dequantize the
    # weights alike; int8 also rounds the activations alike), products
    # summed in another order: atol 1e-5 on logits of order 1. The top-1
    # routing is a discrete decision: the same on every row.
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_an_expert_parallel_checkpoint_is_refused(tmp_path):
    check_checkpoint_layout({"tensor": 1, "sequence": 1, "expert": 1,
                             "pipeline": 1}, "replicated", "moe_mlp")
    with pytest.raises(ValueError, match="expert-parallel 2"):
        check_checkpoint_layout({"expert": 2}, "replicated", "moe_mlp")
    state = create_train_state(get_model("moe_mlp"), 0,
                               torch.device("cpu"))
    port_ckpt.save_checkpoint(state, epoch=0, best_acc=0.0, is_best=False,
                              directory=str(tmp_path),
                              parallel_layout={"tensor": 1, "sequence": 1,
                                               "expert": 2, "pipeline": 1})
    args = build_parser().parse_args([
        "--model", "moe_mlp", "--port", "0", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path), "--buckets", "1,8"])
    with pytest.raises((ValueError, SystemExit), match="expert-parallel 2"):
        create_server(args).server_close()
