"""The port's int8 matmul (``pytorch_distributed_mnist_tpu_torch/ops/
matmul_i8.py``) against the JAX package's Pallas ``matmul_i8`` and
``int8_dot_general``.

On the CPU the port's wrapper takes its plain version (float64 product,
exact); the JAX kernel runs in Pallas interpret mode, as the JAX
package's own tests run it. The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
from pytorch_distributed_mnist_tpu_torch.ops import matmul_i8 as port

jax_mm = importlib.import_module(
    "pytorch_distributed_mnist_tpu.ops.pallas.matmul_i8")

pytestmark = pytest.mark.serve
# The suite runs files in parallel workers beside timing-sensitive JAX
# serving tests; two intra-op threads keep these small CPU runs from
# taking every core.
torch.set_num_threads(2)


def _int8(rng, shape):
    return rng.integers(-128, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n", [
    (1, 12544, 128),   # fc1 at bucket 1
    (33, 200, 130),    # ragged in every dim
    (7, 784, 10),      # linear's fc
    (8, 128, 10),      # fc2
    (3, 5, 1),
])
def test_plain_matmul_equals_jax_pallas_exactly(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    want = np.asarray(jax_mm.matmul_i8(jnp.asarray(a), jnp.asarray(b)))
    got = port.matmul_i8_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matmul_worst_case_sum_is_exact():
    # 127 * -128 * 12544 = -2.04e8: the largest magnitude fc1 can reach.
    a = torch.full((2, 12544), 127, dtype=torch.int8)
    b = torch.full((12544, 3), -128, dtype=torch.int8)
    out = port.matmul_i8_plain(a, b)
    assert int(out[0, 0]) == 127 * -128 * 12544
    assert torch.equal(out, torch.full((2, 3), 127 * -128 * 12544,
                                       dtype=torch.int32))


def test_quantize_dynamic_i8_bitwise_equals_jax_jitted():
    # The reference runs inside jitted serving programs, where XLA turns
    # ``max|x| / 127.0`` into a multiply by the float32 reciprocal; the
    # element division ``x / scale`` stays a true divide. Compared
    # against the jitted function for that reason.
    quant = jax.jit(jax_mm.quantize_dynamic_i8)
    rng = np.random.default_rng(0)
    for trial in range(60):
        shape = (int(rng.integers(1, 9)), int(rng.integers(1, 70)))
        x = (rng.standard_normal(shape)
             * rng.uniform(1e-3, 1e3)).astype(np.float32)
        if trial == 0:
            x[:] = 0.0  # the 1e-12 floor
        q_ref, s_ref = quant(jnp.asarray(x))
        q, s = port.quantize_dynamic_i8(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        assert s.numpy().tobytes() == np.asarray(s_ref, np.float32).tobytes()


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_int8_linear_bitwise_equals_int8_dot_general(lead):
    # Jitted, as the serving programs run it (see the scale test above).
    rng = np.random.default_rng(len(lead))
    k, n = 96, 17
    dims = (((len(lead),), (0,)), ((), ()))
    ref = jax.jit(lambda a, b: jax_mm.int8_dot_general(a, b, dims))
    for _ in range(8):
        x = (rng.standard_normal(lead + (k,))
             * rng.uniform(0.1, 10)).astype(np.float32)
        w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
        want = np.asarray(ref(jnp.asarray(x), jnp.asarray(w)))
        got = port.int8_linear(torch.from_numpy(x), torch.from_numpy(w),
                               torch.float32)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 operands"):
        port.matmul_i8(a.float(), torch.zeros((8, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="int8 operands"):
        port.matmul_i8(a, torch.zeros((8, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        port.matmul_i8(a, torch.zeros((7, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        port.matmul_i8(a[None], torch.zeros((8, 2), dtype=torch.int8))


def test_cpu_tensors_take_the_plain_path_without_counting():
    rng = np.random.default_rng(5)
    a, b = _int8(rng, (9, 40)), _int8(rng, (40, 6))
    before = port.matmul_i8.launches
    got = port.matmul_i8(torch.from_numpy(a), torch.from_numpy(b))
    assert port.matmul_i8.launches == before  # no kernel was launched
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


class _OnCard:
    """A CPU tensor that reports a CUDA device: reaches the wrapper's
    kernel branch on a machine without a card or nvcc."""

    def __init__(self, t: torch.Tensor) -> None:
        self._t = t
        self.dtype, self.shape = t.dtype, t.shape
        self.device = torch.device("cuda", 0)

    def dim(self):
        return self._t.dim()

    def stride(self, i):
        return self._t.stride(i)


def test_cuda_operands_launch_the_kernel_or_raise(monkeypatch):
    # No fallback to the plain version: without nvcc the build raises,
    # and nothing is counted as launched.
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "library_path",
                        lambda name: "/nonexistent-build/lib.so")
    before = port.matmul_i8.launches
    a = _OnCard(torch.zeros((4, 8), dtype=torch.int8))
    b = _OnCard(torch.zeros((8, 2), dtype=torch.int8))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        port.matmul_i8(a, b)
    assert port.matmul_i8.launches == before


def test_split_k_fills_the_card_at_fc1_and_stays_whole_when_wide():
    # fc1 at M=1: 4 output tiles on 132 SMs -> K split across blocks, in
    # whole clusters of 8; a few clusters add atomically (1 x 128 is cheap).
    splits, cluster = port.split_k(1, 128, 12544, 132)
    assert splits > cluster == 8 and splits % cluster == 0
    # fc1 at M=128: 16 tiles; one cluster of 8 covers all of K, so C is
    # stored once, without atomics or zeroing.
    assert port.split_k(128, 128, 12544, 132) == (8, 8)
    # fc2's K=128 is one step: never split.
    assert port.split_k(128, 10, 128, 132) == (1, 1)
    # Enough output tiles already: one slice.
    assert port.split_k(4096, 4096, 4096, 132) == (1, 1)


@pytest.mark.parametrize("m,k,n", [
    (1, 12544, 128), (8, 12544, 128), (32, 12544, 128), (33, 12544, 128),
    (128, 12544, 128), (5, 784, 10), (130, 200, 70), (3, 7, 5)])
def test_split_k_plans_whole_clusters_within_the_atomic_budget(m, k, n):
    splits, cluster = port.split_k(m, n, k, 132)
    assert cluster in (1, 2, 4, 8) and splits % cluster == 0
    k_steps = -(-k // port._BLOCK_K)
    # Every cluster but the last holds some of K.
    per_slice = -(-k_steps // splits)
    assert (splits - cluster) * per_slice < max(k_steps, 1)
    groups = splits // cluster
    assert groups == 1 or groups * m * n <= port._ATOMIC_BUDGET


def test_library_path_is_keyed_on_the_source(tmp_path, monkeypatch):
    src = tmp_path / "demo.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(cuda_build, "source_path",
                        lambda name: str(src))
    first = cuda_build.library_path("demo")
    src.write_text("// two\n")
    assert cuda_build.library_path("demo") != first
    assert first.startswith(cuda_build.BUILD_ROOT)

