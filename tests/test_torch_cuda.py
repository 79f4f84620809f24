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
