"""The port's ``vit`` (``models/attention.py``) against the JAX package's,
on the same params carried across by ``models/convert.py``, with dense
attention and with flash attention on both sides (the JAX kernels in
Pallas interpret mode), plus the training init's distributions."""

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
from pytorch_distributed_mnist_tpu.ops.pallas.flash import (
    flash_attention as jax_flash_attention,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import TrainState as JaxState
from pytorch_distributed_mnist_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from pytorch_distributed_mnist_tpu_torch.models import (
    get_model,
    model_accepts,
    model_field_default,
)
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    jax_leaf_name,
    jax_param_order,
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.models.registry import (
    lecun_normal_init,
    param_kind,
)
from pytorch_distributed_mnist_tpu_torch.ops.attention import full_attention
from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt

torch.set_num_threads(2)

_ATTENTION = {"dense": (None, None),
              "flash": (jax_flash_attention, flash_attention)}
_CACHE = {}


def _jax_flat(variables):
    flat, _ = jax.tree_util.tree_flatten_with_path({"params": variables})
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in flat}


def _images(n, seed):
    return normalize_images(synthetic_dataset(n, seed=seed)[0])


def _both(attention, patch, jax_dtype, torch_dtype):
    """The JAX vit, its variables, and the port's vit on the same params."""
    jax_fn, port_fn = _ATTENTION[attention]
    jmodel = jax_get_model("vit", compute_dtype=jax_dtype, patch_size=patch,
                           attention_fn=jax_fn)
    variables = jmodel.init(jax.random.key(patch),
                            jnp.zeros((1, 28, 28, 1), jnp.float32))
    tmodel = get_model("vit", compute_dtype=torch_dtype, patch_size=patch,
                       attention_fn=port_fn)
    params = params_from_jax("vit", _jax_flat(variables), patch_size=patch)
    tmodel.load_state_dict({k: torch.from_numpy(v)
                            for k, v in params.items()})
    return jmodel, variables, tmodel.eval()


def _f32_case(attention, patch):
    """The JAX side's f32 logits, once per attention and patch size (the
    flash kernels take a second or two to trace in interpret mode)."""
    key = (attention, patch)
    if key not in _CACHE:
        jmodel, variables, tmodel = _both(attention, patch, jnp.float32,
                                          torch.float32)
        x = _images(16, seed=1)
        _CACHE[key] = (x, tmodel, np.asarray(
            jax.jit(jmodel.apply)(variables, jnp.asarray(x))))
    return _CACHE[key]


def jax_vit_state(**model_kwargs):
    """A JAX ``vit`` + ``adam_pallas`` train state, as the JAX package's
    ``create_train_state`` builds it but with the init jitted (the ViT's
    eager init dispatches op by op: 9 s against 2 s here)."""
    model = jax_get_model("vit", **model_kwargs)
    params = jax.jit(model.init)(jax.random.key(0),
                                 jnp.zeros((1, 28, 28, 1), jnp.float32))
    tx = jax_make_optimizer(1e-3, "adam_pallas", 0.9, 1e-4)
    return JaxState(step=jnp.zeros((), jnp.int32), params=params,
                    opt_state=tx.init(params), apply_fn=model.apply, tx=tx)


def test_31_leaves_carried_from_a_jax_vit_checkpoint(tmp_path):
    jstate = jax_vit_state()
    path = jax_ckpt.save_checkpoint(jstate, epoch=0, best_acc=0.0,
                                    is_best=False, directory=str(tmp_path))
    flat, _ = port_ckpt.load_params(path)
    assert len(flat) == 31
    params = params_from_jax("vit", flat)
    model = get_model("vit")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert sorted(params) == sorted(shapes) and len(shapes) == 31
    assert sorted(jax_leaf_name(n) for n in shapes) == sorted(flat)
    for name, arr in params.items():
        assert arr.shape == shapes[name], name
    assert shapes["pos_embed"] == (1, 49, 64)
    assert shapes["block0.attn.qkv.kernel"] == (64, 192)
    assert shapes["embed.kernel"] == (16, 64)
    assert jax_leaf_name("block0.ln1.weight") == \
        "['params']['params']['block0']['ln1']['scale']"
    assert jax_leaf_name("pos_embed") == "['params']['params']['pos_embed']"
    # The JAX flatten order is the lexicographic order of the key paths.
    assert [jax_leaf_name(n) for n in jax_param_order(shapes)] == list(flat)
    back = params_to_jax(params)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    # cnn and linear names are unchanged.
    assert jax_leaf_name("conv1.weight") == \
        "['params']['params']['conv1']['kernel']"
    assert jax_leaf_name("fc.bias") == "['params']['params']['fc']['bias']"


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("patch", [4, 7])
@pytest.mark.parametrize("layout", ["nhwc", "hw", "flat"])
def test_f32_logits_match_jax(attention, patch, layout):
    # float32 on both sides; the products sum in another order in XLA and
    # in PyTorch, hence atol 1e-5 on logits of order 1.
    x, tmodel, want = _f32_case(attention, patch)
    if layout == "hw":
        x = x[..., 0]
    elif layout == "flat":
        x = x.reshape(x.shape[0], -1)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (16, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_argmax_agrees_with_jax(attention):
    # bfloat16 compute (the default) on both sides rounds at other places
    # in XLA and in PyTorch, and random weights give near-ties between
    # classes, so the contract is argmax agreement on >= 95% of rows.
    jmodel, variables, tmodel = _both(attention, 4, jnp.bfloat16,
                                      torch.bfloat16)
    x = _images(64, seed=2)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree >= 0.95, agree


def test_d12_vit_with_flash_matches_jax_forward_and_gradients():
    # The ViT at embed_dim=48 in 4 heads: D = 12, a head dim that is not a
    # multiple of 8, which the port's tensor-core kernels take in their
    # narrow instantiation on the card (here, on the CPU, their plain
    # versions). The JAX ViT runs its Pallas flash kernels in interpret
    # mode on the same params, carried across by models/convert.py. float32
    # on both sides; the products sum in another order, hence atol 1e-5 on
    # logits of order 1, and on each leaf's gradient rtol 1e-4 with atol
    # 1e-5 times its largest magnitude.
    kwargs = {"embed_dim": 48, "num_heads": 4}
    jmodel = jax_get_model("vit", compute_dtype=jnp.float32,
                           attention_fn=jax_flash_attention, **kwargs)
    variables = jax.jit(jmodel.init)(jax.random.key(12),
                                     jnp.zeros((1, 28, 28, 1), jnp.float32))
    tmodel = get_model("vit", compute_dtype=torch.float32,
                       attention_fn=flash_attention, **kwargs)
    params = params_from_jax("vit", _jax_flat(variables), **kwargs)
    tmodel.load_state_dict({k: torch.from_numpy(v)
                            for k, v in params.items()})
    assert tmodel.block0.attn.qkv.kernel.shape == (48, 144)
    x = _images(8, seed=12)
    g = np.random.default_rng(12).standard_normal((8, 10)).astype(np.float32)

    def loss(v):
        return jnp.sum(jmodel.apply(v, jnp.asarray(x)) * g)

    want_logits = np.asarray(jax.jit(jmodel.apply)(variables,
                                                   jnp.asarray(x)))
    want_grads = params_from_jax("vit", _jax_flat(jax.jit(jax.grad(loss))(
        variables)), **kwargs)
    logits = tmodel(torch.from_numpy(x))
    (logits * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=0,
                               atol=1e-5)
    grads = {n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert sorted(grads) == sorted(want_grads) and len(grads) == 31
    for name, want in want_grads.items():
        np.testing.assert_allclose(
            grads[name], want, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=name)


def test_training_init_draws_like_flax():
    # LayerNorm scales 1, biases 0, pos_embed normal(0.02), Dense kernels
    # lecun_normal (std sqrt(1/fan_in)) within 4 standard errors of a std
    # estimate (4 / sqrt(2n): 35% for head's 640 draws, 11% for
    # pos_embed's 3136).
    model = get_model("vit")
    lecun_normal_init(model, seed=0)
    kinds = {}
    for name, p in model.named_parameters():
        got = p.detach().numpy().ravel()
        kind = param_kind(name)
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "bias":
            assert not got.any(), name
        elif kind == "scale":
            assert np.all(got == 1.0), name
        else:
            std = 0.02 if kind == "pos_embed" else (1.0 / p.shape[0]) ** 0.5
            assert abs(got.std() / std - 1) < 4 / (2 * got.size) ** 0.5, name
            assert abs(got.mean()) < 4 * std / got.size ** 0.5, name
    assert kinds == {"bias": 15, "scale": 5, "pos_embed": 1, "kernel": 10}
    # A seed gives the same draws; another seed others.
    again = get_model("vit")
    lecun_normal_init(again, seed=0)
    assert torch.equal(again.pos_embed, model.pos_embed)
    lecun_normal_init(again, seed=1)
    assert not torch.equal(again.block0.attn.qkv.kernel,
                           model.block0.attn.qkv.kernel)


def test_capability_probes_and_defaults():
    assert model_accepts("vit", "attention_fn")
    assert model_accepts("vit", "patch_size")
    assert model_accepts("vit", "matmul")
    assert not model_accepts("cnn", "attention_fn")
    assert not model_accepts("cnn", "patch_size")
    assert model_accepts("vit", "remat")
    assert not model_accepts("cnn", "remat")
    assert model_field_default("vit", "num_heads") == 4
    assert model_field_default("vit", "patch_size") == 4
    assert model_field_default("vit", "embed_dim") == 64
    assert model_field_default("vit", "depth") == 2
    assert model_field_default("vit", "mlp_ratio") == 4
    with pytest.raises(ValueError, match="no field"):
        model_field_default("vit", "heads")
    with pytest.raises(ValueError, match="unknown model"):
        model_field_default("typo", "num_heads")
    model = get_model("vit")
    assert model.block0.attn.attention_fn is None  # full_attention
    assert model.block0.ln1.eps == 1e-6
    with pytest.raises(ValueError, match="does not divide"):
        get_model("vit", patch_size=5)


def test_default_attention_is_the_dense_oracle():
    # attention_fn=None and full_attention give the same logits.
    x = torch.from_numpy(_images(4, seed=3))
    a = get_model("vit", compute_dtype=torch.float32)
    lecun_normal_init(a, seed=2)
    b = get_model("vit", compute_dtype=torch.float32,
                  attention_fn=full_attention)
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        assert torch.equal(a(x), b(x))
