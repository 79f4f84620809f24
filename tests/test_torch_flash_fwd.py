"""The port's flash-attention forward entry, ``ops/flash.py::flash_fwd``,
on the CPU: the route it takes on the card is a pure function of shape and
dtype, the CPU path is ``flash_fwd_plain`` and counts no launch, and the
tensor-core kernel's roundings, emulated here in torch ops, stay within
the tolerance the card holds the kernel to (``chip_smoke.flash_tolerance``)
and agree with the JAX package's ``_flash_forward`` (Pallas kernel in
interpret mode, as the JAX package's own tests run it). The kernels
themselves are held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_distributed_mnist_tpu.ops.pallas import flash as jax_flash
from pytorch_distributed_mnist_tpu_torch.ops import cuda_build, flash

torch.set_num_threads(2)


def _tensor_route_forward(q, k, v, causal):
    """``flash_fwd_plain`` with the tensor-core kernel's roundings: the
    float32 product of the bf16 inputs scaled afterwards (the reference
    scales q first; the same bits for a power-of-two scale), and P rounded
    once to bf16 for P V while l sums the float32 P. Returns O in float32
    (before the output's bf16 rounding) and lse."""
    scale = q.shape[-1] ** -0.5
    keep = flash._keep(q.shape[1], causal, q.device)
    s = scale * (flash._heads(q) @ flash._heads(k).transpose(-1, -2))
    s = torch.where(keep, s, torch.full((), flash.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros(()))
    l = p.sum(dim=-1, keepdim=True)
    o = (p.bfloat16().float() @ flash._heads(v)) / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full((), flash.NEG_INF))
    return o.permute(0, 2, 1, 3).contiguous(), lse[..., 0]


# --------------------------------------------------------------- routes


@pytest.mark.parametrize("shape", chip_smoke.FLASH_CHECK_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in chip_smoke.FLASH_CHECK_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_fwd_route_of_every_check_shape(shape, dtype):
    # With D a multiple of 8 bf16 takes the bf16 tensor-core kernel and
    # float32 the 3xTF32 one, at any T; the check shape with D = 12 takes
    # the CUDA-core kernel in both.
    if shape[-1] % 8:
        want = "cuda_core"
    else:
        want = "tensor" if dtype == torch.bfloat16 else "tf32x3"
    assert flash._fwd_route(shape, dtype) == want


@pytest.mark.parametrize("shape,dtype,route", [
    (chip_smoke.VIT_SHAPE, torch.bfloat16, "tensor"),
    (chip_smoke.VIT_SHAPE, torch.float32, "tf32x3"),
    ((1, 4096, 1, 128), torch.bfloat16, "tensor"),   # no limit on T
    ((1, 49, 1, 12), torch.bfloat16, "cuda_core"),   # D not a multiple of 8
    ((1, 49, 1, 8), torch.bfloat16, "tensor"),
])
def test_fwd_route_edges(shape, dtype, route):
    assert flash._fwd_route(shape, dtype) == route


# ------------------------------------------------------------ CPU path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_fwd_on_the_cpu_is_the_plain_version(dtype, causal):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 21, 2, 16))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    before = (flash.flash_fwd.launches, dict(flash.flash_fwd.route_launches))
    got = flash.flash_fwd(q, k, v, causal=causal)
    want = flash.flash_fwd_plain(q, k, v, causal=causal)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # CPU tensors launch nothing: no counter moves.
    assert (flash.flash_fwd.launches,
            dict(flash.flash_fwd.route_launches)) == before


def test_flash_fwd_refuses_a_route_it_does_not_have():
    q = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="no route 'tensor'"):
        flash.flash_fwd(q, q, q, route="tensor")  # float32
    with pytest.raises(ValueError, match="no route 'mma'"):
        flash.flash_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                        route="mma")


def test_route_launches_name_both_routes():
    # Both tensor-core routes (bf16 and 3xTF32) and the CUDA-core one.
    assert set(flash.flash_fwd.route_launches) == {"tensor", "tf32x3",
                                                   "cuda_core"}


# ----------------------------------------------------------- rounding

# The check shapes the tensor-core forward takes in bf16 (D a multiple
# of 8).
TENSOR_SHAPES = [s for s in chip_smoke.FLASH_CHECK_SHAPES if s[-1] % 8 == 0]


@pytest.mark.parametrize("shape", TENSOR_SHAPES,
                         ids=["x".join(map(str, s)) for s in TENSOR_SHAPES])
def test_one_bf16_rounding_of_p_fits_the_tolerance(shape):
    # The tensor-core forward feeds P to a bf16 product where the plain
    # version keeps it float32, and scales the float32 product where the
    # plain version scales q. Emulated on the CPU at every bf16 case of
    # the smoke's check shapes, causal and not, O (after the output's
    # rounding) must stay within flash_tolerance(bf16) of flash_fwd_plain,
    # and lse within the float32 tolerance.
    gen = torch.Generator().manual_seed(sum(shape))
    tol = chip_smoke.flash_tolerance(torch.bfloat16)
    f32 = chip_smoke.flash_tolerance(torch.float32)
    b, t, h, d = shape
    for causal in (False, True):
        qkv = torch.randn(b, t, 3, h, d, generator=gen).bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        want_o, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
        o, lse = _tensor_route_forward(q, k, v, causal)
        assert chip_smoke.tolerance_used(o.bfloat16(), want_o, tol) <= 1.0
        assert chip_smoke.tolerance_used(lse, want_lse, f32) <= 1.0


@pytest.mark.parametrize("shape", [(2, 49, 4, 16), (1, 70, 1, 8),
                                   (1, 33, 2, 48), (1, 1, 1, 16)],
                         ids=["vit-like", "d8", "d48", "t1"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tensor_route_emulation_matches_the_pallas_forward(shape, causal):
    # Seeded numpy inputs rounded to bf16 go through JAX's Pallas forward
    # in float32 (interpret mode) and through the emulation: each is the
    # float32 computation of the same values, the emulation with P rounded
    # once to bf16 (a relative step of 2**-9 on each term of P V, which
    # can cancel in a small output). Held to the tolerance the card holds
    # the kernel to (chip_smoke.flash_tolerance(bf16)); lse is float32 on
    # both sides, summed in another order.
    rng = np.random.default_rng(sum(shape) + causal)
    arrays = [np.asarray(jnp.asarray(rng.standard_normal(shape)
                                     .astype(np.float32), jnp.bfloat16),
                         np.float32) for _ in range(3)]
    scale = shape[-1] ** -0.5
    out, _, lse = jax_flash._flash_forward(*(jnp.asarray(x) for x in arrays),
                                           causal, scale, True)
    b, t, h, _ = shape
    q, k, v = (torch.from_numpy(x).bfloat16() for x in arrays)
    o, got_lse = _tensor_route_forward(q, k, v, causal)
    tol = chip_smoke.flash_tolerance(torch.bfloat16)
    assert chip_smoke.tolerance_used(o, torch.from_numpy(np.asarray(out)),
                                     tol) <= 1.0
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse)[:, :t, 0].reshape(b, h, t),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------- build


def test_flash_fwd_library_is_registered_with_its_signature():
    argtypes, _ = cuda_build.KERNELS["flash_fwd"]["flash_fwd_mma_launch"]
    # q, k, v, o, lse; b, h, t, d, sb, st, sh, scale, causal, bf16,
    # device, stream.
    assert len(argtypes) == 5 + len(cuda_build._FLASH_TAIL)
    assert cuda_build.source_path("flash_fwd").endswith("csrc/flash_fwd.cu")


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd", "flash_bwd_tiled",
                                  "matmul_i8"])
def test_tensor_core_kernels_include_the_shared_header(name):
    with open(cuda_build.source_path(name), "rb") as f:
        assert cuda_build.local_headers(f.read()) == ["mma_common.cuh"]


def test_library_path_is_keyed_on_the_shared_header(tmp_path, monkeypatch):
    src = tmp_path / "demo.cu"
    header = tmp_path / "shared.cuh"
    src.write_text('#include "shared.cuh"\n// demo\n')
    header.write_text("// one\n")
    monkeypatch.setattr(cuda_build, "source_path", lambda name: str(src))
    first = cuda_build.library_path("demo")
    assert cuda_build.library_path("demo") == first  # stable
    header.write_text("// two\n")
    assert cuda_build.library_path("demo") != first
