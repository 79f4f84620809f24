"""Card-only checks of the port's CUDA kernels against their plain
versions. They skip without an NVIDIA card: a CUDA kernel has no CPU
mode. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
    matmul_i8,
    matmul_i8_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 12544, 128), (33, 12544, 128),
                                   (128, 12544, 128), (128, 128, 10),
                                   (5, 784, 10), (3, 7, 5)])
def test_matmul_i8_kernel_equals_plain(card, m, k, n):
    gen = torch.Generator(device=card).manual_seed(m + k + n)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=card,
                      generator=gen)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=card,
                      generator=gen)
    before = matmul_i8.launches
    got = matmul_i8(a, b)
    torch.cuda.synchronize()
    assert matmul_i8.launches == before + 1
    assert torch.equal(got, matmul_i8_plain(a, b))


@pytest.mark.parametrize("b", [1, 7, 256, 300])
@pytest.mark.parametrize("c", [10, 128])
def test_xent_kernels_match_plain(card, b, c):
    from pytorch_distributed_mnist_tpu_torch.ops import xent

    gen = torch.Generator(device=card).manual_seed(b * 1000 + c)
    logits = torch.randn(b, c, device=card, generator=gen) * 3
    labels = torch.randint(0, c, (b,), device=card, generator=gen)
    logits[0] = 0.0
    logits[0, 0] = 20.0  # the exact tie: lse == picked in float32
    labels[0] = 0
    g = torch.rand(b, device=card, generator=gen)
    before = (xent.xent_fwd.launches, xent.xent_bwd.launches)
    loss, lse = xent.xent_fwd(logits, labels)
    dl = xent.xent_bwd(logits, labels, lse, g)
    torch.cuda.synchronize()
    assert (xent.xent_fwd.launches, xent.xent_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want_loss, want_lse = xent.xent_fwd_plain(logits, labels)
    # exp's sum is taken in another order (warp shuffles vs torch's sum).
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dl, xent.xent_bwd_plain(logits, labels, lse, g),
                               rtol=1e-6, atol=1e-6)
    assert float(loss[0]) == 0.0


@pytest.mark.parametrize("n", [10, 288, 12544 * 128, 1000003])
@pytest.mark.parametrize("t", [1, 2, 10])
def test_adam_kernel_equals_plain_bitwise(card, n, t):
    from pytorch_distributed_mnist_tpu_torch.ops import adam

    gen = torch.Generator(device=card).manual_seed(n + t)
    p = torch.randn(n, device=card, generator=gen)
    g = torch.randn(n, device=card, generator=gen)
    m = torch.randn(n, device=card, generator=gen) * 0.1
    v = torch.rand(n, device=card, generator=gen) * 0.01
    hyper = {k: torch.tensor(val, dtype=torch.float32, device=card)
             for k, val in {"learning_rate": 1e-3,
                            **adam.ADAM_DEFAULTS}.items()}
    h = adam.adam_hypers(hyper, torch.tensor(float(t), device=card))
    got = [p.clone(), m.clone(), v.clone()]
    want = [p.clone(), m.clone(), v.clone()]
    before = adam.adam_leaf.launches
    adam.adam_leaf(got[0], g, got[1], got[2], h)
    adam.adam_leaf_plain(want[0], g, want[1], want[2], h)
    torch.cuda.synchronize()
    assert adam.adam_leaf.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
