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


def pad_to_dp(x: torch.Tensor, smallest: int = 16) -> torch.Tensor:
    """x with its head dims zero-padded to the kernels' DP: the smallest
    power of two from ``smallest`` (16 in bf16, 8 in float32) that holds
    D, as the kernels stage rows in shared memory."""
    d = x.shape[-1]
    dp = smallest
    while dp < d:
        dp *= 2
    return torch.nn.functional.pad(x, (0, dp - d))


def _tensor_route_forward(q, k, v, causal):
    """``flash_fwd_plain`` with the tensor-core kernel's roundings, on
    head dims zero-padded to DP as the kernel stages them: the float32
    product of the bf16 inputs scaled afterwards by D's scale (the
    reference scales q first; the same bits for a power-of-two scale), and
    P rounded once to bf16 for P V while l sums the float32 P. Returns O
    (its D columns) in float32, before the output's bf16 rounding, and
    lse."""
    d = q.shape[-1]
    scale = d ** -0.5
    q, k, v = (pad_to_dp(x) for x in (q, k, v))
    keep = flash._keep(q.shape[1], causal, q.device)
    s = scale * (flash._heads(q) @ flash._heads(k).transpose(-1, -2))
    s = torch.where(keep, s, torch.full((), flash.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros(()))
    l = p.sum(dim=-1, keepdim=True)
    o = (p.bfloat16().float() @ flash._heads(v)) / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full((), flash.NEG_INF))
    return o.permute(0, 2, 1, 3)[..., :d].contiguous(), lse[..., 0]


# --------------------------------------------------------------- routes


@pytest.mark.parametrize("shape", chip_smoke.FLASH_CHECK_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in chip_smoke.FLASH_CHECK_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_fwd_route_of_every_check_shape(shape, dtype):
    # bf16 takes the bf16 tensor-core kernel and float32 the 3xTF32 one,
    # at any T and any D: the check shapes whose D is not a multiple of 8
    # too (the kernels' narrow instantiation).
    want = "tensor" if dtype == torch.bfloat16 else "tf32x3"
    assert flash._fwd_route(shape, dtype) == want


@pytest.mark.parametrize("shape,dtype,route", [
    (chip_smoke.VIT_SHAPE, torch.bfloat16, "tensor"),
    (chip_smoke.VIT_SHAPE, torch.float32, "tf32x3"),
    ((1, 4096, 1, 128), torch.bfloat16, "tensor"),   # no limit on T
    ((1, 49, 1, 12), torch.bfloat16, "tensor"),   # D not a multiple of 8
    ((1, 49, 1, 8), torch.bfloat16, "tensor"),
    ((1, 49, 1, 12), torch.float32, "tf32x3"),
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
    # Both tensor-core routes (bf16 and 3xTF32) and the CUDA-core one,
    # which a caller may name.
    assert set(flash.flash_fwd.route_launches) == {"tensor", "tf32x3",
                                                   "cuda_core"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cuda_core_may_be_named_at_d12_on_the_cpu(dtype):
    # No problem takes the CUDA-core forward unnamed; named at the ViT's
    # D = 12 it is accepted, and CPU tensors take the plain version.
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 49, 4, 12))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    before = dict(flash.flash_fwd.route_launches)
    got = flash.flash_fwd(q, k, v, route="cuda_core")
    want = flash.flash_fwd_plain(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dict(flash.flash_fwd.route_launches) == before


# The copy width (bytes) of chip_smoke.flash_inputs' qkv slices at each
# check shape whose D is not a multiple of 8, bf16 and float32: what the
# kernels' C entries pick (copy_width in csrc/stage_common.cuh), from D's
# bytes, the strides' and the pointers (the slices of one qkv product
# start D * H elements apart).
NARROW_WIDTHS = {(2, 33, 2, 12): (8, 16), (2, 196, 2, 12): (8, 16),
                 (2, 40, 2, 4): (8, 16), (2, 57, 3, 7): (2, 4),
                 (1, 30, 2, 10): (4, 8), (2, 90, 2, 20): (8, 16),
                 (1, 100, 2, 100): (8, 16)}


def test_narrow_widths_cover_the_check_shapes_off_8():
    assert sorted(NARROW_WIDTHS) == sorted(
        s for s in chip_smoke.FLASH_CHECK_SHAPES if s[-1] % 8)
    # Every width the narrow path has: 2 (odd D in bf16), 4, 8 and 16.
    assert {w for pair in NARROW_WIDTHS.values() for w in pair} == \
        {2, 4, 8, 16}


@pytest.mark.parametrize("shape", sorted(NARROW_WIDTHS),
                         ids=["x".join(map(str, s))
                              for s in sorted(NARROW_WIDTHS)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
def test_copy_width_of_the_narrow_check_shapes(shape, dtype):
    q, k, v, do = chip_smoke.flash_inputs(shape, dtype,
                                          torch.Generator().manual_seed(0),
                                          torch.device("cpu"))
    width = NARROW_WIDTHS[shape][dtype == torch.float32]
    # CPU allocations start on 64-byte boundaries, as the card's do on
    # 256-byte ones: only D, the strides and the slices' offsets count.
    assert flash._copy_width(q, k, v) == width
    assert flash._copy_width(q, k, v, do) == width


@pytest.mark.parametrize("offset,width", [(0, 16), (1, 2), (2, 4), (4, 8),
                                          (8, 16)])
def test_copy_width_counts_the_pointer(offset, width):
    # A bf16 (2, 49, 4, 16) view that starts `offset` elements into its
    # buffer: D = 16 and the strides are whole 16-byte rows, so the
    # pointer alone sets the width.
    base = torch.zeros(offset + 2 * 49 * 4 * 16, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    x = base[offset:].view(2, 49, 4, 16)
    assert flash._copy_width(x) == width


def test_copy_width_counts_d_and_the_strides():
    f32 = torch.zeros(2, 49, 4, 24)
    assert flash._copy_width(f32) == 16           # 96-byte rows
    assert flash._copy_width(f32[..., :12]) == 16  # 48 bytes of D
    assert flash._copy_width(f32[..., :6]) == 8
    assert flash._copy_width(f32[..., :3]) == 4
    bf16 = torch.zeros(2, 49, 4, 24, dtype=torch.bfloat16)
    assert flash._copy_width(bf16[..., :16]) == 16  # 48-byte rows
    assert flash._copy_width(bf16[..., :12]) == 8
    assert flash._copy_width(bf16[..., :7]) == 2
    assert flash._copy_width(torch.zeros(2, 49, 4, 13,
                                         dtype=torch.bfloat16)[..., :8]) == 2


# ----------------------------------------------------------- rounding

# The check shapes the tensor-core forward takes in bf16: every one, those
# whose D is not a multiple of 8 in the narrow instantiation (the same
# arithmetic on head dims zero-padded to DP).
TENSOR_SHAPES = list(chip_smoke.FLASH_CHECK_SHAPES)


@pytest.mark.parametrize("shape", TENSOR_SHAPES,
                         ids=["x".join(map(str, s)) for s in TENSOR_SHAPES])
def test_one_bf16_rounding_of_p_fits_the_tolerance(shape):
    # The tensor-core forward feeds P to a bf16 product where the plain
    # version keeps it float32, and scales the float32 product where the
    # plain version scales q. Emulated on the CPU at every bf16 case of
    # the smoke's check shapes (head dims zero-padded to DP), causal and
    # not, O (after the output's rounding) must stay within
    # flash_tolerance(bf16) of flash_fwd_plain, and lse within the float32
    # tolerance.
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
                                   (1, 33, 2, 48), (1, 1, 1, 16),
                                   (2, 49, 4, 12), (1, 40, 2, 4),
                                   (1, 57, 3, 7), (1, 90, 2, 20)],
                         ids=["vit-like", "d8", "d48", "t1", "d12", "d4",
                              "d7", "d20"])
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


def test_library_path_is_keyed_on_a_nested_header(tmp_path, monkeypatch):
    # A header included through another header keys the build too: the
    # tensor-core kernels reach stage_common.cuh through mma_common.cuh.
    src = tmp_path / "demo.cu"
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    inner = tmp_path / "inner.cuh"
    inner.write_text("// one\n")
    src.write_text('#include "outer.cuh"\n// demo\n')
    monkeypatch.setattr(cuda_build, "source_path", lambda name: str(src))
    first = cuda_build.library_path("demo")
    assert cuda_build.library_path("demo") == first
    inner.write_text("// two\n")
    assert cuda_build.library_path("demo") != first


def test_the_staging_header_is_shared_by_every_flash_kernel():
    with open(f"{cuda_build.CSRC}/mma_common.cuh", "rb") as f:
        assert cuda_build.local_headers(f.read()) == ["stage_common.cuh"]
    # Each tensor-core flash entry picks one copy width per call and
    # dispatches to the 16-byte or the narrow instantiation of its DP.
    for name, smallest in (("flash_fwd", 16), ("flash_bwd", 16),
                           ("flash_bwd_tiled", 16), ("flash_tf32", 8)):
        with open(cuda_build.source_path(name)) as f:
            source = f.read()
        entries = source.count('extern "C" int ')
        assert source.count("copy_width(d, sb, st, sh,") == entries, name
        assert source.count(f"with_dp<{smallest}>(s,") == entries, name
        assert "d >= 1" in source or "s.d >= 1" in source, name


@pytest.mark.parametrize("mangled,name", [
    ("_ZN46_GLOBAL__N__e1f3c0a8_12_flash_fwd_cu_5d4e0e8120flash_fwd_mma_"
     "kernelILi16ELb1EEEvPK13__nv_bfloat16", "flash_fwd_mma_kernel<16, true>"),
    ("_ZN12_GLOBAL__N_121flash_dkv_tf32_kernelILi128ELb0EEEvPKf",
     "flash_dkv_tf32_kernel<128, false>"),
    ("_Z15xent_fwd_kernelPKfPKlPfS3_iii", "xent_fwd_kernel"),
])
def test_the_smoke_names_each_kernel_instantiation(mangled, name):
    assert chip_smoke.kernel_of(mangled) == name


def test_the_smoke_reads_ptxas_counts_per_instantiation():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121"
        "flash_dkv_tf32_kernelILi8ELb1EEEvPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_121",
        "    0 bytes stack frame, 48 bytes spill stores, 80 bytes spill "
        "loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 464 bytes "
        "cmem[0]"])
    assert chip_smoke.ptxas_counts(log) == {
        "flash_dkv_tf32_kernel<8, true>": {"spill_stores": 48,
                                           "spill_loads": 80,
                                           "registers": 72}}


@pytest.mark.parametrize("kernels,backend", [
    (["void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits"],
     "flash"),
    (["fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttenti"],
     "efficient"),
    (["cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma"], "cudnn"),
    (["ampere_sgemm_128x64_tn", "void at::native::softmax_warp_forward"],
     "math"),
])
def test_the_smoke_names_the_sdpa_backend(kernels, backend):
    assert chip_smoke.sdpa_backend(kernels) == backend
