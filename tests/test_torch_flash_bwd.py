"""The port's flash-attention backward entry, ``ops/flash.py::flash_bwd``,
on the CPU: it is ``flash_bwd_plain`` there, it matches the JAX package's
``_flash_backward`` (Pallas kernels in interpret mode, as the JAX
package's own tests run them), the backward route it would take on the
card is the documented one, and ``flash_attention``'s backward goes
through it. The CUDA kernels are held against the plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances are those ``tests/test_torch_flash.py`` states: float32 sums
the same products in another order (``atol 1e-5``); a bfloat16 output is
the float32 computation of the same bf16 values rounded once (relative
step ``2**-8``, ``atol 1e-3``)."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_distributed_mnist_tpu.ops.pallas import flash as jax_flash
from pytorch_distributed_mnist_tpu_torch.ops import cuda_build, flash

torch.set_num_threads(2)

# The last is a T above the fused kernel's 128, which the tiled route
# takes on the card.
SHAPES = [(2, 49, 4, 16), (1, 16, 2, 8), (1, 1, 1, 8), (1, 196, 1, 16)]
CASES = [(shape, dtype, causal) for shape in SHAPES
         for dtype in ("float32", "bfloat16") for causal in (False, True)]
ATOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -8, 1e-3


def _ids(cases):
    return [f"{'x'.join(map(str, s))}-{d}-{'causal' if c else 'full'}"
            for s, d, c in cases]


@pytest.fixture(scope="module", params=CASES, ids=_ids(CASES))
def case(request):
    """Inputs made with numpy (rounded to bf16 for the bf16 cases), the
    JAX forward's O and lse, and the JAX backward in the case's dtype and
    in float32 on the same values."""
    shape, dtype, causal = request.param
    rng = np.random.default_rng(sum(shape) + 3 * causal
                                + (dtype == "bfloat16"))
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(4)]
    if dtype == "bfloat16":
        arrays = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                  for x in arrays]
    scale = shape[-1] ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in arrays)
    out, o_heads, lse = jax_flash._flash_forward(jq, jk, jv, causal, scale,
                                                 True)
    grads = jax_flash._flash_backward(jq, jk, jv, o_heads, lse, jg, causal,
                                      scale, True)
    f32 = [jnp.asarray(x, jnp.float32) for x in (jq, jk, jv, jg)]
    grads_f32 = jax_flash._flash_backward(
        *f32[:3], o_heads.astype(jnp.float32), lse, f32[3], causal, scale,
        True)
    b, t, h, _ = shape
    return {"dtype": getattr(torch, dtype), "causal": causal,
            "inputs": arrays,
            "out": np.array(jnp.asarray(out, jnp.float32)),
            # lse's real rows: (B*H, Tp, 1) -> (B, H, T).
            "lse": np.array(lse)[:, :t, 0].reshape(b, h, t),
            "grads": [np.asarray(jnp.asarray(x, jnp.float32))
                      for x in grads],
            "grads_f32": [np.asarray(x) for x in grads_f32]}


def _torch_operands(case):
    """q, k, v, O, lse and dO as torch tensors in the case's dtype, O and
    lse from the JAX forward."""
    dtype = case["dtype"]
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in case["inputs"])
    o = torch.from_numpy(case["out"]).to(dtype)
    lse = torch.from_numpy(case["lse"])
    return q, k, v, o, lse, g


def test_flash_bwd_on_the_cpu_is_the_plain_version(case):
    q, k, v, o, lse, g = _torch_operands(case)
    causal = case["causal"]
    before = chip_smoke._bwd_counts(flash)
    got = flash.flash_bwd(q, k, v, o, lse, g, causal=causal)
    want = flash.flash_bwd_plain(q, k, v, o, lse, g, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == case["dtype"] and torch.equal(a, b)
    # CPU tensors launch nothing: no counter moves.
    assert chip_smoke._bwd_counts(flash) == before


def test_flash_bwd_matches_the_pallas_backward(case):
    q, k, v, o, lse, g = _torch_operands(case)
    got = flash.flash_bwd(q, k, v, o, lse, g, causal=case["causal"])
    if case["dtype"] == torch.float32:
        for name, a, b in zip(("dq", "dk", "dv"), got, case["grads"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL,
                                       err_msg=name)
        return
    # bf16: each side is the float32 computation of the same values
    # rounded once, so each lies within half a step of JAX's float32
    # result, and the two within a step of each other.
    for name, a, b, ref in zip(("dq", "dk", "dv"), got, case["grads"],
                               case["grads_f32"]):
        a = a.float().numpy()
        np.testing.assert_allclose(a, ref, rtol=BF16_RTOL, atol=BF16_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(b, ref, rtol=BF16_RTOL, atol=BF16_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(a, b, rtol=2 * BF16_RTOL,
                                   atol=2 * BF16_ATOL, err_msg=name)


# The route each FLASH_CHECK_SHAPES entry takes in bf16, at any D: fused
# up to T = 128, tiled above. float32 takes the 3xTF32 pair at any D.
BF16_ROUTES = {
    (256, 49, 4, 16): "fused", (128, 49, 4, 16): "fused",
    (2, 1, 2, 16): "fused",
    (2, 16, 2, 16): "fused", (2, 196, 2, 16): "tiled",
    (2, 200, 2, 64): "tiled", (1, 200, 2, 128): "tiled",
    (3, 130, 2, 32): "tiled", (1, 70, 1, 8): "fused",
    (2, 128, 2, 128): "fused", (3, 100, 3, 48): "fused",
    (2, 33, 2, 12): "fused", (2, 196, 2, 12): "tiled",
    (2, 40, 2, 4): "fused", (2, 57, 3, 7): "fused",
    (1, 30, 2, 10): "fused", (2, 90, 2, 20): "fused",
    (1, 100, 2, 100): "fused",
}


def test_the_route_table_covers_every_check_shape():
    assert sorted(BF16_ROUTES) == sorted(chip_smoke.FLASH_CHECK_SHAPES)


@pytest.mark.parametrize("shape", sorted(BF16_ROUTES),
                         ids=["x".join(map(str, s))
                              for s in sorted(BF16_ROUTES)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_bwd_route_of_every_check_shape(shape, dtype):
    if dtype == torch.bfloat16:
        want = BF16_ROUTES[shape]
    else:
        want = "tf32x3"
    assert flash._bwd_route(shape, dtype) == want


@pytest.mark.parametrize("shape,dtype,route", [
    ((1, 128, 1, 16), torch.bfloat16, "fused"),
    ((1, 129, 1, 16), torch.bfloat16, "tiled"),
    ((1, 49, 1, 12), torch.bfloat16, "fused"),   # D not a multiple of 8
    ((1, 49, 1, 128), torch.bfloat16, "fused"),
    ((1, 49, 1, 16), torch.float32, "tf32x3"),
] + [(shape, getattr(torch, dtype), route)  # the smoke's route run
     for shape, dtype, route in chip_smoke.SPLIT_ROUTE_CASES])
def test_bwd_route_edges(shape, dtype, route):
    assert flash._bwd_route(shape, dtype) == route


@pytest.mark.parametrize("t", [129, 196, 200, 4096])
@pytest.mark.parametrize("d", [8, 48, 128])
def test_bwd_route_is_tiled_above_the_fused_kernel(t, d):
    assert flash._bwd_route((2, t, 2, d), torch.bfloat16) == "tiled"
    # float32 takes the 3xTF32 pair at any T.
    assert flash._bwd_route((2, t, 2, d), torch.float32) == "tf32x3"
    # So do head dims that are not a multiple of 8.
    assert flash._bwd_route((2, t, 2, d + 4), torch.bfloat16) == "tiled"
    assert flash._bwd_route((2, t, 2, d + 4), torch.float32) == "tf32x3"


def test_bwd_routes_a_caller_may_name():
    bf16, f32 = torch.bfloat16, torch.float32
    assert flash._bwd_routes((2, 49, 4, 16), bf16) == ("fused", "tiled",
                                                       "split")
    assert flash._bwd_routes((2, 196, 4, 16), bf16) == ("tiled", "split")
    assert flash._bwd_routes((2, 49, 4, 16), f32) == ("tf32x3", "split")
    assert flash._bwd_routes((2, 196, 4, 16), f32) == ("tf32x3", "split")
    # D = 12 has the D = 16 routes: "split" only when named.
    assert flash._bwd_routes((2, 49, 4, 12), bf16) == ("fused", "tiled",
                                                       "split")
    assert flash._bwd_routes((2, 49, 4, 12), f32) == ("tf32x3", "split")
    assert set(flash.flash_bwd.route_launches) == {"fused", "tiled",
                                                   "tf32x3", "split"}


@pytest.mark.parametrize("shape,dtype,route", [
    ((1, 196, 1, 16), torch.bfloat16, "fused"),   # T above the fused 128
    ((1, 49, 1, 16), torch.float32, "tiled"),     # bf16 only
    ((1, 49, 1, 12), torch.float32, "tiled"),     # bf16 only, at any D
    ((1, 49, 1, 16), torch.bfloat16, "tensor"),   # no such route
    ((1, 49, 1, 16), torch.bfloat16, "tf32x3"),   # float32 only
    ((1, 49, 1, 12), torch.bfloat16, "tf32x3"),   # float32 only, at any D
    ((1, 196, 1, 16), torch.float32, "fused"),    # bf16 only
])
def test_flash_bwd_refuses_a_route_the_problem_has_not(shape, dtype, route):
    q = torch.zeros(shape, dtype=dtype)
    lse = torch.zeros(shape[0], shape[2], shape[1])
    with pytest.raises(ValueError, match="no route"):
        flash.flash_bwd(q, q, q, q, lse, q, route=route)


@pytest.mark.parametrize("route", ["fused", "tiled", "split"])
def test_a_named_route_on_the_cpu_is_the_plain_version(route):
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 33, 2, 16))
                                    .astype(np.float32)).bfloat16()
                   for _ in range(4))
    o, lse = flash.flash_fwd_plain(q, k, v, causal=True)
    before = (chip_smoke._bwd_counts(flash),
              dict(flash.flash_bwd.route_launches))
    got = flash.flash_bwd(q, k, v, o, lse, do, causal=True, route=route)
    want = flash.flash_bwd_plain(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (chip_smoke._bwd_counts(flash),
            dict(flash.flash_bwd.route_launches)) == before


def test_alignment_check_finds_misaligned_views():
    # The copy width the kernels pick: 16 bytes (their 16-byte path) for
    # the ViT's qkv slices; a view that starts 2 bytes off, or whose
    # strides are 20 elements, takes the narrow path at 2 or 8 bytes.
    base = torch.zeros(2 * 49 * 3 * 4 * 16 + 1, dtype=torch.bfloat16)
    qkv = base[:-1].view(2, 49, 3, 4, 16)
    assert flash._copy_width(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) == 16
    shifted = base[1:].view(2, 49, 3, 4, 16)  # 2 bytes off
    assert flash._copy_width(shifted[:, :, 1]) == 2
    odd = torch.zeros(2, 49, 4, 20, dtype=torch.bfloat16)[..., :16]
    assert flash._copy_width(odd) == 8  # strides of 20 elements


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_backward_goes_through_flash_bwd(monkeypatch,
                                                         dtype):
    calls = []
    real = flash.flash_bwd

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(flash, "flash_bwd", spy)
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 16, 2, 8))
                                   .astype(np.float32)).to(dtype)
                  for _ in range(4))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    flash.flash_attention(*leaves, causal=True).backward(g)
    assert calls == [{"causal": True, "scale": 8 ** -0.5}]
    o, lse = flash.flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                   causal=True)
    want = flash.flash_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse,
                                 g, causal=True)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)


@pytest.mark.parametrize("name", sorted(cuda_build.KERNELS))
def test_every_kernel_symbol_is_declared_with_its_c_arity(name):
    # ctypes passes what argtypes says: a count that differs from the C
    # entry's would shift every argument after it.
    with open(cuda_build.source_path(name)) as f:
        source = f.read()
    for symbol, (argtypes, restype) in cuda_build.KERNELS[name].items():
        head = f'extern "C" int {symbol}('
        assert head in source, symbol
        params = source.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(argtypes), symbol
        assert restype is ctypes.c_int


def _bf16_operands_backward(q, k, v, o, lse, do, causal):
    """``flash_bwd_plain`` with the fused kernel's two roundings: P (for
    dV) and dS (for dK and dQ) rounded once to bf16 before their products,
    as they enter the tensor cores."""
    scale = q.shape[-1] ** -0.5
    delta = flash._delta_plain(o, do)
    p, ds = flash._ds_plain(q, k, v, lse, delta, do, causal, scale)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    heads = flash._heads
    return (flash._out(scale * (ds @ heads(k)), q),
            flash._out(scale * (ds.transpose(-1, -2) @ heads(q)), k),
            flash._out(p.transpose(-1, -2) @ heads(do), v))


def test_one_bf16_rounding_of_p_and_ds_fits_the_tolerance():
    # The fused kernel feeds P and dS to bf16 tensor-core products where
    # the plain version keeps them float32. Emulated here on the CPU at
    # bf16 shapes of the fused route (three draws each, causal and not),
    # the largest share of chip_smoke.flash_tolerance's bf16 allowance
    # used was 0.67 with torch 2.13's CPU generator: one rounding fits,
    # with no hi/lo split.
    gen = torch.Generator().manual_seed(0)
    tol = chip_smoke.flash_tolerance(torch.bfloat16)
    worst = 0.0
    for shape in [(256, 49, 4, 16), (2, 1, 2, 16), (2, 16, 2, 16),
                  (1, 70, 1, 8), (2, 128, 2, 128), (3, 100, 3, 48),
                  (8, 128, 4, 16), (2, 113, 2, 64), (64, 49, 4, 12),
                  (2, 57, 3, 7), (1, 100, 2, 100)]:
        b, t, h, d = shape
        for causal in (False, True):
            for _ in range(3):
                qkv = torch.randn(b, t, 3, h, d, generator=gen).bfloat16()
                do = torch.randn(b, t, h, d, generator=gen).bfloat16()
                q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
                o, lse = flash.flash_fwd_plain(q, k, v, causal=causal)
                want = flash.flash_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal)
                got = _bf16_operands_backward(q, k, v, o, lse, do, causal)
                worst = max(worst, *(chip_smoke.tolerance_used(a, w, tol)
                                     for a, w in zip(got, want)))
    assert worst <= 1.0


def _tiled_backward_emulation(q, k, v, o, lse, do, causal, rows=64):
    """``flash_bwd_plain`` with the tiled kernels' arithmetic, tile by tile
    at 64 rows: delta from the bf16 dO and O in float32; per (query tile,
    key tile), S and dP as float32 sums of the bf16 products, P and dS in
    float32, then P rounded once to bf16 for dV and dS for dQ and dK; dQ
    summed over the key tiles in order, dK and dV over the query tiles.
    Tiles wholly above the causal diagonal are skipped, as the kernels
    skip them."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    qh, kh, vh, oh, doh = (flash._heads(x) for x in (q, k, v, o, do))
    delta = (doh * oh).sum(-1)
    dq, dk, dv = (torch.zeros(b, h, t, d) for _ in range(3))
    for q0 in range(0, t, rows):
        qs = slice(q0, min(t, q0 + rows))
        qi = torch.arange(qs.start, qs.stop)[:, None]
        for k0 in range(0, t, rows):
            if causal and k0 > qs.stop - 1:
                break
            ks = slice(k0, min(t, k0 + rows))
            kj = torch.arange(ks.start, ks.stop)[None, :]
            keep = qi >= kj if causal else torch.ones_like(qi >= kj)
            s = qh[..., qs, :] @ kh[..., ks, :].transpose(-1, -2)
            p = torch.where(keep, torch.exp(scale * s - lse[..., qs, None]),
                            torch.zeros(()))
            dp = doh[..., qs, :] @ vh[..., ks, :].transpose(-1, -2)
            ds = p * (dp - delta[..., qs, None])
            p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
            dq[..., qs, :] += ds16 @ kh[..., ks, :]
            dk[..., ks, :] += ds16.transpose(-1, -2) @ qh[..., qs, :]
            dv[..., ks, :] += p16.transpose(-1, -2) @ doh[..., qs, :]
    return (flash._out(scale * dq, q), flash._out(scale * dk, k),
            flash._out(dv, v))


# The bf16 shapes of chip_smoke.FLASH_CHECK_SHAPES that the tiled route
# takes (D = 12 among them, whose head dims the kernels pad to 16 with
# zeros: the same sums), and the smoke's route-phase shape.
TILED_SHAPES = [s for s in chip_smoke.FLASH_CHECK_SHAPES if s[1] > 128] \
    + [(32, 196, 4, 16)]


def test_the_tiled_shapes_are_the_check_shapes_above_128():
    assert TILED_SHAPES[:4] == [(2, 196, 2, 16), (2, 200, 2, 64),
                                (1, 200, 2, 128), (3, 130, 2, 32)]


@pytest.mark.parametrize("shape", TILED_SHAPES,
                         ids=["x".join(map(str, s)) for s in TILED_SHAPES])
def test_tiled_rounding_of_p_and_ds_fits_the_tolerance(shape):
    # The tiled kernels feed P and dS to bf16 tensor-core products where
    # the plain version keeps them float32. Emulated here on the CPU tile
    # by tile (three draws, causal and not), the worst share of
    # chip_smoke.flash_tolerance's bf16 allowance used must stay within it;
    # the share each shape used is written in PERF.md.
    gen = torch.Generator().manual_seed(sum(shape))
    tol = chip_smoke.flash_tolerance(torch.bfloat16)
    b, t, h, d = shape
    worst = 0.0
    for causal in (False, True):
        for _ in range(3):
            qkv = torch.randn(b, t, 3, h, d, generator=gen).bfloat16()
            do = torch.randn(b, t, h, d, generator=gen).bfloat16()
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            o, lse = flash.flash_fwd_plain(q, k, v, causal=causal)
            want = flash.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
            got = _tiled_backward_emulation(q, k, v, o, lse, do, causal)
            worst = max(worst, *(chip_smoke.tolerance_used(a, w, tol)
                                 for a, w in zip(got, want)))
    assert worst <= 1.0
