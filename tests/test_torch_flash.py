"""The port's flash attention (``ops/flash.py``) against the JAX package's
Pallas kernels, which run in interpret mode on the CPU as the JAX
package's own tests run them. On the CPU the port's wrappers take their
plain versions; the CUDA kernels are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are float32, made with numpy. The two sides sum the same products
in another order, so outputs of order 1 agree to ``atol 1e-5``. The
shapes include head dims that are not a multiple of 8 (D in {4, 7, 12,
20}), which the port's tensor-core kernels take in their narrow
instantiation on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.ops.attention import (
    full_attention as jax_full_attention,
)
from pytorch_distributed_mnist_tpu.ops.pallas import flash as jax_flash
from pytorch_distributed_mnist_tpu_torch.ops import flash

torch.set_num_threads(2)

SHAPES = [(2, 49, 4, 16), (1, 1, 1, 8), (1, 16, 4, 16), (2, 130, 2, 32),
          (1, 40, 2, 4), (1, 57, 3, 7), (2, 49, 4, 12), (1, 90, 2, 20)]
CASES = [(shape, causal) for shape in SHAPES for causal in (False, True)]
ATOL = 1e-5


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{'x'.join(map(str, s))}-{'causal' if c else 'full'}"
                     for s, c in CASES])
def case(request):
    """Inputs and the JAX side's results, once per shape and mask: the
    Pallas forward and backward (padded (B*H, Tp, .) outputs) and
    ``jax.vjp`` of ``flash_attention``."""
    shape, causal = request.param
    rng = np.random.default_rng(sum(shape) + causal)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    scale = shape[-1] ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, o_heads, lse = jax_flash._flash_forward(jq, jk, jv, causal, scale,
                                                 True)
    grads = jax_flash._flash_backward(jq, jk, jv, o_heads, lse, jg, causal,
                                      scale, True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal=causal), jq, jk, jv)
    b, t, h, _ = shape
    return {"causal": causal, "inputs": (q, k, v, g), "out": np.asarray(out),
            # lse's real rows: (B*H, Tp, 1) -> (B, H, T).
            "lse": np.asarray(lse)[:, :t, 0].reshape(b, h, t),
            "grads": [np.asarray(x) for x in grads],
            "vjp": [np.asarray(x) for x in vjp(jg)]}


def _torch(*arrays):
    return [torch.from_numpy(x) for x in arrays]


def test_fwd_plain_matches_the_pallas_forward(case):
    q, k, v, _ = _torch(*case["inputs"])
    o, lse = flash.flash_fwd_plain(q, k, v, causal=case["causal"])
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), case["out"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), case["lse"], rtol=0, atol=ATOL)


def test_bwd_plain_matches_the_pallas_backward(case):
    q, k, v, g = _torch(*case["inputs"])
    causal = case["causal"]
    o, lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    got = flash.flash_bwd_plain(q, k, v, o, lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, case["grads"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL,
                                   err_msg=name)


def test_autograd_matches_jax_vjp_of_flash_attention(case):
    q, k, v, g = _torch(*case["inputs"])
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (flash.flash_fwd.launches, flash.flash_dq.launches,
              flash.flash_dkv.launches)
    out = flash.flash_attention(q, k, v, causal=case["causal"])
    out.backward(g)
    np.testing.assert_allclose(out.detach().numpy(), case["out"], rtol=0,
                               atol=ATOL)
    for name, t, want in zip(("dq", "dk", "dv"), (q, k, v), case["vjp"]):
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=ATOL,
                                   err_msg=name)
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (flash.flash_fwd.launches, flash.flash_dq.launches,
            flash.flash_dkv.launches) == before


def test_wrappers_on_the_cpu_are_the_plain_versions(case):
    q, k, v, g = _torch(*case["inputs"])
    causal = case["causal"]
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    want_o, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    dq, delta = flash.flash_dq(q, k, v, o, lse, g, causal=causal)
    dk, dv = flash.flash_dkv(q, k, v, lse, delta, g, causal=causal)
    want = flash.flash_bwd_plain(q, k, v, o, lse, g, causal=causal)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    np.testing.assert_allclose(
        delta.numpy(), (g * o).sum(-1).permute(0, 2, 1).numpy(), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_oracle_and_strided_qkv_views(causal):
    # The ViT hands flash_attention slices of its qkv product; the result
    # is the dense oracle's, to float32 summation order.
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((2, 49, 3, 4, 16))
                           .astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = flash.flash_attention(q, k, v, causal=causal)
    want = np.asarray(jax_full_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=causal))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_bf16_inputs_keep_bf16_outputs():
    rng = np.random.default_rng(8)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 16, 2, 16))
                                   .astype(np.float32)).to(torch.bfloat16)
                  for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = flash.flash_attention(q, k, v)
    out.backward(g)
    assert out.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))
    _, lse = flash.flash_fwd(q.detach(), k.detach(), v.detach())
    assert lse.dtype == torch.float32
    # The float32 computation of the same bf16 values, rounded once to
    # bf16 at the output (relative step 2**-8).
    want = flash.flash_attention(q.detach().float(), k.detach().float(),
                                 v.detach().float())
    np.testing.assert_allclose(out.detach().float().numpy(), want.numpy(),
                               rtol=2 ** -8, atol=1e-3)


def _shape_refusals(fn):
    x = np.zeros((1, 16, 2, 8), np.float32)
    shorter = np.zeros((1, 8, 2, 8), np.float32)
    with pytest.raises(ValueError, match="requires Tq == Tk"):
        fn(x, shorter, shorter)
    with pytest.raises(ValueError, match="multiple of 8, got 20"):
        fn(x, x, x, block=20)
    with pytest.raises(ValueError, match="must be <= 512"):
        fn(x, x, x, block=1024)


def test_shape_and_block_refusals_on_both_sides():
    _shape_refusals(lambda q, k, v, **kw: jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    _shape_refusals(lambda q, k, v, **kw: flash.flash_attention(
        *_torch(q, k, v), **kw))
    # The block is checked, then ignored: the kernels tile by 64 rows.
    q, k, v = _torch(*(np.random.default_rng(9).standard_normal(
        (1, 16, 2, 8)).astype(np.float32) for _ in range(3)))
    assert torch.equal(flash.flash_attention(q, k, v, block=8),
                       flash.flash_attention(q, k, v))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash.flash_fwd(x.half(), x.half(), x.half())
    wide = torch.zeros((1, 4, 1, 144))
    with pytest.raises(ValueError, match="head dims up to 128"):
        flash.flash_fwd(wide, wide, wide)
    meta = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="different devices"):
        flash.flash_fwd(x, meta, x)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        flash.flash_fwd(meta, meta, meta)
    with pytest.raises(ValueError, match="must match q's"):
        flash.flash_fwd(x, x.double().float()[:, :2], x)
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="row statistics"):
        flash.flash_dkv(x, x, x, lse, lse[:, :1], x)
