"""The port's dense attention and online-softmax helpers
(``ops/attention.py``) against the JAX package's, on the same inputs made
with numpy. Both sides compute in float32; the products sum in another
order in XLA and in PyTorch, hence ``atol 1e-5`` on outputs of order 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.ops import attention as jax_attn
from pytorch_distributed_mnist_tpu_torch.ops import attention as port_attn

torch.set_num_threads(2)

SHAPES = [(2, 49, 4, 16), (1, 1, 1, 8), (1, 16, 4, 16), (2, 130, 2, 32)]


def _qkv(shape, seed, tk=None):
    rng = np.random.default_rng(seed)
    kshape = shape if tk is None else (shape[0], tk) + shape[2:]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(kshape).astype(np.float32),
            rng.standard_normal(kshape).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(shape, causal):
    q, k, v = _qkv(shape, seed=sum(shape))
    want = np.asarray(jax_attn.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = port_attn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_full_attention_end_aligned_mask_zeroes_fully_masked_rows():
    # Tq = 8 > Tk = 5: tril(k=-3) leaves rows 0-2 with nothing to attend.
    q, k, v = _qkv((1, 8, 2, 16), seed=3, tk=5)
    want = np.asarray(jax_attn.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = port_attn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True).numpy()
    assert not got[:, :3].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_full_attention_keeps_bf16_and_scale():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv((2, 16, 2, 8), seed=4))
    out = port_attn.full_attention(q, k, v, scale=0.5)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jax_attn.full_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        scale=0.5).astype(jnp.float32))
    # One bf16 rounding of the output on each side.
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_online_softmax_blocks_match_jax_and_dense(masked):
    q, k, v = _qkv((2, 12, 2, 16), seed=5)
    blocks = [(0, 5), (5, 12)]
    causal = np.tril(np.ones((12, 12), bool))
    jstate = jax_attn.online_softmax_init(jnp.asarray(q))
    pstate = port_attn.online_softmax_init(torch.from_numpy(q))
    for lo, hi in blocks:
        mask = causal[:, lo:hi] if masked else None
        jstate = jax_attn.online_softmax_block(
            jstate, jnp.asarray(q), jnp.asarray(k[:, lo:hi]),
            jnp.asarray(v[:, lo:hi]),
            mask=None if mask is None else jnp.asarray(mask))
        pstate = port_attn.online_softmax_block(
            pstate, torch.from_numpy(q), torch.from_numpy(k[:, lo:hi]),
            torch.from_numpy(v[:, lo:hi]),
            mask=None if mask is None else torch.from_numpy(mask))
    for got, want in zip(pstate, jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    out = port_attn.online_softmax_finish(pstate)
    dense = port_attn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=masked)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_attn.online_softmax_finish(jstate)),
        rtol=0, atol=1e-5)
