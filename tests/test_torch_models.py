"""The port's ``cnn`` and ``linear`` against the JAX package's, on the same
params carried across by ``models/convert.py::params_from_jax``."""

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
from pytorch_distributed_mnist_tpu_torch.models import (
    get_model,
    list_models,
    model_accepts,
)
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    params_from_jax,
    params_to_jax,
)

pytestmark = pytest.mark.serve
# The suite runs files in parallel workers beside timing-sensitive JAX
# serving tests; two intra-op threads keep these small CPU runs from
# taking every core.
torch.set_num_threads(2)


def _jax_flat(variables):
    """JAX leaves named as a checkpoint names them."""
    flat, _ = jax.tree_util.tree_flatten_with_path({"params": variables})
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in flat}


def _both(name, jax_dtype, torch_dtype, seed=0):
    jmodel = jax_get_model(name, compute_dtype=jax_dtype)
    variables = jmodel.init(jax.random.key(seed),
                            jnp.zeros((1, 28, 28, 1), jnp.float32))
    tmodel = get_model(name, compute_dtype=torch_dtype)
    params = params_from_jax(name, _jax_flat(variables))
    tmodel.load_state_dict({k: torch.from_numpy(v)
                            for k, v in params.items()})
    return jmodel, variables, tmodel.eval()


def _images(n, seed):
    return normalize_images(synthetic_dataset(n, seed=seed)[0])


def test_registry_and_capability_probe():
    assert list_models() == ["cnn", "linear", "moe_mlp", "vit"]
    assert model_accepts("cnn", "matmul")
    assert model_accepts("linear", "matmul")
    assert model_accepts("vit", "matmul")
    assert not model_accepts("cnn", "dot_general")
    with pytest.raises(ValueError, match="unknown model"):
        get_model("typo")


def test_params_from_jax_names_shapes_and_layouts():
    _, variables, _ = _both("cnn", jnp.float32, torch.float32)
    flat = _jax_flat(variables)
    assert sorted(flat) == sorted(
        f"['params']['params']['{layer}']['{leaf}']"
        for layer in ("conv1", "conv2", "fc1", "fc2")
        for leaf in ("bias", "kernel"))
    params = params_from_jax("cnn", flat)
    hwio = flat["['params']['params']['conv2']['kernel']"]
    assert hwio.shape == (3, 3, 32, 64)
    assert params["conv2.weight"].shape == (64, 32, 3, 3)
    np.testing.assert_array_equal(params["conv2.weight"][5, 7],
                                  hwio[:, :, 7, 5])
    assert params["fc1.kernel"].shape == (12544, 128)  # (K, N) kept
    # Round trip back to the JAX names and layouts.
    back = params_to_jax(params)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    # A checkpoint of another model is refused, never half-loaded.
    with pytest.raises(ValueError, match="no leaf"):
        params_from_jax("linear", flat)


def test_init_params_is_seeded_and_shaped():
    a, b = init_params("cnn", 3), init_params("cnn", 3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["fc1.kernel"], init_params("cnn", 4)[
        "fc1.kernel"])
    assert a["conv1.weight"].shape == (32, 1, 3, 3)


def test_training_init_draws_like_flax_lecun_normal():
    # The values are the port's own (a torch generator), so the contract
    # is the distribution. Biases are zero. Each kernel's std is
    # sqrt(1 / fan_in), which is what the 0.8796 constant makes of a normal
    # cut at 2 std, within 4 standard errors of a std estimate
    # (4 / sqrt(2n): 17% for conv1's 288 draws, 0.2% for fc1's 1.6 M). No
    # draw lies past the cut. fc1's quantiles are within 2% of a std of
    # those of flax's lecun_normal on the same shape (5 standard errors
    # of the 1% quantile at that size).
    from pytorch_distributed_mnist_tpu_torch.models.registry import (
        lecun_normal_init,
    )

    model = get_model("cnn")
    lecun_normal_init(model, seed=0)
    for name, p in model.named_parameters():
        got = p.detach().numpy().ravel()
        if name.endswith(".bias"):
            assert not got.any()
            continue
        fan_in = got.size // p.shape[0 if p.dim() == 4 else 1]
        std = (1.0 / fan_in) ** 0.5
        assert abs(got.std() / std - 1) < 4 / (2 * got.size) ** 0.5, name
        assert np.abs(got).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6)
    got = model.fc1.kernel.detach().numpy().ravel()
    want = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.key(0), (12544, 128), jnp.float32)).ravel()
    qs = [0.01, 0.1, 0.5, 0.9, 0.99]
    np.testing.assert_allclose(np.quantile(got, qs), np.quantile(want, qs),
                               atol=0.02 * want.std(), rtol=0)


@pytest.mark.parametrize("name", ["cnn", "linear"])
@pytest.mark.parametrize("layout", ["nhwc", "hw", "flat"])
def test_f32_logits_match_jax(name, layout):
    # float32 compute on both sides; the convolutions sum in another
    # order in XLA and in PyTorch, hence atol 1e-4 (logits are O(1)).
    jmodel, variables, tmodel = _both(name, jnp.float32, torch.float32)
    x = _images(24, seed=1)
    if layout == "hw":
        x = x[..., 0]
    elif layout == "flat":
        x = x.reshape(x.shape[0], -1)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (24, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["cnn", "linear"])
def test_bf16_argmax_agrees_with_jax(name):
    # bfloat16 compute (the models' default) on both sides. bf16 rounds
    # at other places in XLA and in PyTorch (fused vs unfused casts), and
    # random weights give near-ties between classes, so the contract is
    # argmax agreement on at least 98% of rows, not equal logits.
    jmodel, variables, tmodel = _both(name, jnp.bfloat16, torch.bfloat16)
    x = _images(200, seed=2)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree >= 0.98, agree
