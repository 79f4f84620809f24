"""The port's float32 flash-attention route ``"tf32x3"``
(``csrc/flash_tf32.cu``) on the CPU. The kernels run every product as
three TF32 tensor-core products (each operand split into a high and a low
TF32 part) with float32 sums. Here that arithmetic is emulated in torch
ops, tile by tile as the kernels order it: the TF32 rounding itself
(``cvt.rna.tf32.f32``) pinned bit for bit, then the forward and backward
held to the tolerance the card holds the kernels to
(``chip_smoke.flash_tolerance(float32)``) against the plain versions and
against the JAX package's ``_flash_forward`` / ``_flash_backward`` (Pallas
kernels in interpret mode, as the JAX package's own tests run them). A
single TF32 product per multiply is shown to miss that tolerance: it is
why every product is split. Routes, the CPU path, the build table and the
bounds the smoke reports are checked too. The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_distributed_mnist_tpu.ops.pallas import flash as jax_flash
from pytorch_distributed_mnist_tpu_torch.ops import cuda_build, flash

torch.set_num_threads(2)

ROWS = 64  # rows a block owns (wgmma's M): query rows, or keys for dK/dV
KSTEP = 8  # the k-depth of wgmma m64nNk8 in TF32


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` in torch bit operations, as the kernels' split
    computes it: a float32 rounded to 10 mantissa bits, to nearest with
    ties away from zero. Half a unit of the kept last bit is added to the
    magnitude's bits (a carry may run into the exponent), then the 13
    dropped bits are cleared; the sign bit is untouched."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a: torch.Tensor, b: torch.Tensor, acc=None, single=False):
    """``acc + a @ b`` with the kernels' products: per k-step of 8 along the
    summed axis, a_lo b_hi, a_hi b_lo and a_hi b_hi, each exact in float32
    (products of TF32 values), summed in float32. The kernels add the same
    products in another order (by partial sums over independent
    accumulators), which moves the result by float32 rounding only.
    ``single`` takes one TF32 product per multiply instead (a_hi b_hi)."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], KSTEP):
        ah, al = _split(a[..., k0:k0 + KSTEP])
        bh, bl = _split(b[..., k0:k0 + KSTEP, :])
        if not single:
            out = out + al @ bh
            out = out + ah @ bl
        out = out + ah @ bh
    return out


def _keep(rows: slice, cols: slice, causal: bool) -> torch.Tensor:
    qi = torch.arange(rows.start, rows.stop)[:, None]
    kj = torch.arange(cols.start, cols.stop)[None, :]
    return qi >= kj if causal else torch.ones_like(qi >= kj)


def pad_to_dp(x: torch.Tensor) -> torch.Tensor:
    """x with its head dims zero-padded to the float32 kernels' DP, the
    smallest power of two from 8 that holds D, as they stage rows."""
    d = x.shape[-1]
    dp = 8
    while dp < d:
        dp *= 2
    return torch.nn.functional.pad(x, (0, dp - d))


def tf32x3_forward(q, k, v, causal, single=False):
    """``flash_fwd_plain`` with the 3xTF32 forward's arithmetic, on head
    dims zero-padded to DP as the kernel stages them: q scaled by D's
    scale and rounded once, then per key tile (``flash._tf32_tiles``: 64
    keys, 32 at DP = 128) S = Q K^T, the masked online softmax (running
    max, P = exp(s - m), the sums rescaled by exp(m_old - m)) and O += P V,
    both products split 3xTF32. Returns (O, lse), O's D columns."""
    d = q.shape[-1]
    q, k, v = (pad_to_dp(x) for x in (q, k, v))
    b, t, h, dp = q.shape
    tile = flash._tf32_tiles(dp)[0]
    qh = flash._heads(q) * d ** -0.5
    kh, vh = flash._heads(k), flash._heads(v)
    m = torch.full((b, h, t, 1), flash.NEG_INF)
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, dp))
    for k0 in range(0, t, tile):
        ks = slice(k0, min(t, k0 + tile))
        s = _mm3(qh, kh[..., ks, :].transpose(-1, -2), single=single)
        s = torch.where(_keep(slice(0, t), ks, causal), s,
                        torch.full((), flash.NEG_INF))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - mx)
        p = torch.exp(s - mx)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = _mm3(p, vh[..., ks, :], acc=acc * corr, single=single)
        m = mx
    o = acc / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full((), flash.NEG_INF))
    return o.permute(0, 2, 1, 3)[..., :d].contiguous(), lse[..., 0]


def tf32x3_backward(q, k, v, o, lse, do, causal):
    """``flash_bwd_plain`` with the 3xTF32 pair's arithmetic, on head dims
    zero-padded to DP as the kernels stage them: delta from O and dO in
    float32; S and dP, P = exp(scale s - lse) and dS = P (dP - delta) in
    float32 per (query rows, key rows) tile; every product split 3xTF32.
    The dQ kernel's 64-query blocks take key tiles of
    ``flash._tf32_tiles``' dQ rows in order, dQ += dS K; the dK/dV
    kernel's 64-key blocks take query tiles of its dK/dV rows in order,
    dK += dS^T Q and dV += P^T dO; tiles wholly past the causal diagonal
    are skipped. Returns dQ, dK and dV's D columns."""
    d = q.shape[-1]
    scale = d ** -0.5
    q, k, v, o, do = (pad_to_dp(x) for x in (q, k, v, o, do))
    b, t, h, dp = q.shape
    _, dq_tile, dkv_tile = flash._tf32_tiles(dp)
    qh, kh, vh, oh, doh = (flash._heads(x) for x in (q, k, v, o, do))
    delta = (doh * oh).sum(-1)
    dq, dk, dv = (torch.zeros(b, h, t, dp) for _ in range(3))

    def p_ds(qs, ks):
        s = _mm3(qh[..., qs, :], kh[..., ks, :].transpose(-1, -2))
        p = torch.where(_keep(qs, ks, causal),
                        torch.exp(scale * s - lse[..., qs, None]),
                        torch.zeros(()))
        dp_ = _mm3(doh[..., qs, :], vh[..., ks, :].transpose(-1, -2))
        return p, p * (dp_ - delta[..., qs, None])

    for q0 in range(0, t, ROWS):
        qs = slice(q0, min(t, q0 + ROWS))
        for k0 in range(0, min(t, qs.stop) if causal else t, dq_tile):
            ks = slice(k0, min(t, k0 + dq_tile))
            _, ds = p_ds(qs, ks)
            dq[..., qs, :] = _mm3(ds, kh[..., ks, :], acc=dq[..., qs, :])
    for k0 in range(0, t, ROWS):
        ks = slice(k0, min(t, k0 + ROWS))
        first = k0 // dkv_tile * dkv_tile if causal else 0
        for q0 in range(first, t, dkv_tile):
            qs = slice(q0, min(t, q0 + dkv_tile))
            p, ds = p_ds(qs, ks)
            dk[..., ks, :] = _mm3(ds.transpose(-1, -2), qh[..., qs, :],
                                  acc=dk[..., ks, :])
            dv[..., ks, :] = _mm3(p.transpose(-1, -2), doh[..., qs, :],
                                  acc=dv[..., ks, :])
    return tuple(flash._out(x, y)[..., :d].contiguous()
                 for x, y in ((scale * dq, q), (scale * dk, k), (dv, v)))


# ------------------------------------------------------- TF32 rounding


def _bits(x: float) -> int:
    return int(torch.tensor([x]).view(torch.int32)[0]) & 0xFFFFFFFF


def _from_bits(bits: int) -> float:
    signed = bits - (1 << 32) if bits >= 1 << 31 else bits
    return float(torch.tensor([signed], dtype=torch.int32)
                 .view(torch.float32)[0])


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0x3F801000, 0x3F802000),  # a tie with an even kept bit: away (RNE: down)
    (0x3F803000, 0x3F804000),  # a tie with an odd kept bit: away
    (0x3F801001, 0x3F802000),  # just above the tie: up
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0xBF800FFF, 0xBF800000),  # negative, below the tie: toward zero
    (0x3FFFF000, 0x40000000),  # the carry runs into the exponent: 2.0
    (0x3FFFFFFF, 0x40000000),  # 2 - 2^-23 rounds to 2.0
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0 keeps its sign
], ids=lambda x: f"{x:08x}")
def test_tf32_rounding_is_nearest_ties_away(bits, want):
    got = _tf32(torch.tensor([_from_bits(bits)]))
    assert _bits(float(got[0])) == want


def test_split_carries_about_21_bits():
    # hi and lo are TF32 values (13 low bits clear) and hi + lo is within
    # 2^-21 of x, relatively: what each 3xTF32 product rests on.
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.integers(-3, 4, 4096))
                         .astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -13  # lo matters


# --------------------------------------------- 3xTF32 against plain

# The float32 check shapes the route takes: every one, those whose D is
# not a multiple of 8 in the kernels' narrow instantiation (the same
# arithmetic on head dims zero-padded to DP).
TF32_SHAPES = list(chip_smoke.FLASH_CHECK_SHAPES)
IDS = ["x".join(map(str, s)) for s in TF32_SHAPES]


def _inputs(shape, seed):
    """q, k, v as slices of one qkv product, and dO, from numpy."""
    rng = np.random.default_rng(seed)
    b, t, h, d = shape
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3, h, d))
                           .astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((b, t, h, d))
                          .astype(np.float32))
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do


def test_the_route_takes_every_float32_check_shape_but_d12():
    # Every float32 check shape takes the route; those whose D is not a
    # multiple of 8 (D = 12 and the others) take its narrow instantiation,
    # the rest its 16-byte path (chip_smoke.flash_inputs' qkv slices).
    assert [s for s in chip_smoke.FLASH_CHECK_SHAPES if s[-1] % 8] == \
        [(2, 33, 2, 12), (2, 196, 2, 12), (2, 40, 2, 4), (2, 57, 3, 7),
         (1, 30, 2, 10), (2, 90, 2, 20), (1, 100, 2, 100)]
    for shape in TF32_SHAPES:
        assert flash._fwd_route(shape, torch.float32) == "tf32x3"
        assert flash._bwd_route(shape, torch.float32) == "tf32x3"
        q, k, v, _ = chip_smoke.flash_inputs(
            shape, torch.float32, torch.Generator().manual_seed(0),
            torch.device("cpu"))
        wide = flash._copy_width(q, k, v) == 16 and shape[-1] % 8 == 0
        assert wide == (shape[-1] % 8 == 0)


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=IDS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tf32x3_forward_fits_the_float32_tolerance(shape, causal):
    q, k, v, _ = _inputs(shape, sum(shape) + causal)
    tol = chip_smoke.flash_tolerance(torch.float32)
    want_o, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    o, lse = tf32x3_forward(q, k, v, causal)
    assert chip_smoke.tolerance_used(o, want_o, tol) <= 1.0
    assert chip_smoke.tolerance_used(lse, want_lse, tol) <= 1.0


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=IDS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tf32x3_backward_fits_the_float32_tolerance(shape, causal):
    q, k, v, do = _inputs(shape, 3 * sum(shape) + causal)
    tol = chip_smoke.flash_tolerance(torch.float32)
    o, lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    want = flash.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    got = tf32x3_backward(q, k, v, o, lse, do, causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        assert chip_smoke.tolerance_used(a, w, tol) <= 1.0


def test_a_single_tf32_product_misses_the_float32_tolerance():
    # One TF32 product per multiply keeps 10 mantissa bits of each
    # operand: at a ViT-like shape its forward uses many times the float32
    # allowance, while the 3xTF32 split stays far inside it. This is why
    # the route splits every product.
    q, k, v, _ = _inputs((8, 196, 4, 16), 11)
    tol = chip_smoke.flash_tolerance(torch.float32)
    want_o, _ = flash.flash_fwd_plain(q, k, v)
    single, _ = tf32x3_forward(q, k, v, False, single=True)
    split, _ = tf32x3_forward(q, k, v, False)
    assert chip_smoke.tolerance_used(single, want_o, tol) > 4.0
    assert chip_smoke.tolerance_used(split, want_o, tol) < 0.25


# ---------------------------------------------- against the Pallas kernels

PALLAS_SHAPES = [(2, 49, 4, 16), (1, 70, 1, 8), (1, 33, 2, 48),
                 (1, 130, 1, 32), (2, 49, 4, 12), (1, 57, 3, 7)]
PALLAS_IDS = ["vit-like", "d8", "d48", "t130", "d12", "d7"]


@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=PALLAS_IDS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tf32x3_emulation_matches_the_pallas_forward(shape, causal):
    # Seeded numpy inputs go through JAX's Pallas forward in float32
    # (interpret mode) and through the emulation, held to the tolerance the
    # card holds the kernel to; lse is float32 on both sides, summed in
    # another order.
    rng = np.random.default_rng(sum(shape) + causal)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(3)]
    out, _, lse = jax_flash._flash_forward(*(jnp.asarray(x) for x in arrays),
                                           causal, shape[-1] ** -0.5, True)
    b, t, h, _ = shape
    o, got_lse = tf32x3_forward(*(torch.from_numpy(x) for x in arrays),
                                causal)
    tol = chip_smoke.flash_tolerance(torch.float32)
    assert chip_smoke.tolerance_used(o, torch.from_numpy(np.array(out)),
                                     tol) <= 1.0
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse)[:, :t, 0].reshape(b, h, t),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=PALLAS_IDS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tf32x3_emulation_matches_the_pallas_backward(shape, causal):
    # The JAX forward's O and lse feed both backwards, so each computes
    # from the same values; dQ, dK and dV held to the float32 tolerance.
    rng = np.random.default_rng(2 * sum(shape) + causal)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(4)]
    jq, jk, jv, jg = (jnp.asarray(x) for x in arrays)
    scale = shape[-1] ** -0.5
    out, o_heads, lse = jax_flash._flash_forward(jq, jk, jv, causal, scale,
                                                 True)
    grads = jax_flash._flash_backward(jq, jk, jv, o_heads, lse, jg, causal,
                                      scale, True)
    b, t, h, _ = shape
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    got = tf32x3_backward(q, k, v, torch.from_numpy(np.array(out)),
                          torch.from_numpy(np.array(lse)[:, :t, 0]
                                           .reshape(b, h, t)), do, causal)
    tol = chip_smoke.flash_tolerance(torch.float32)
    for a, w in zip(got, grads):
        assert chip_smoke.tolerance_used(
            a, torch.from_numpy(np.array(w)), tol) <= 1.0


# ------------------------------------------------ routes and the CPU path


@pytest.mark.parametrize("shape,fwd,bwd", [
    ((256, 49, 4, 16), "tf32x3", "tf32x3"),   # the ViT under --dtype f32
    ((256, 196, 4, 16), "tf32x3", "tf32x3"),  # ... at --patch-size 2
    ((1, 4096, 1, 128), "tf32x3", "tf32x3"),  # no limit on T
    ((1, 49, 1, 8), "tf32x3", "tf32x3"),
    ((1, 49, 1, 12), "tf32x3", "tf32x3"),   # D not a multiple of 8
    ((2, 33, 2, 12), "tf32x3", "tf32x3"),
])
def test_float32_routes(shape, fwd, bwd):
    assert flash._fwd_route(shape, torch.float32) == fwd
    assert flash._bwd_route(shape, torch.float32) == bwd


def test_bf16_never_takes_the_tf32x3_route():
    for shape in chip_smoke.FLASH_CHECK_SHAPES:
        assert flash._fwd_route(shape, torch.bfloat16) != "tf32x3"
        assert "tf32x3" not in flash._bwd_routes(shape, torch.bfloat16)


@pytest.mark.parametrize("route", ["tf32x3", "cuda_core"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_float32_forward_on_the_cpu_is_the_plain_version(route, causal):
    q, k, v, _ = _inputs((2, 21, 2, 16), 5)
    before = (flash.flash_fwd.launches, dict(flash.flash_fwd.route_launches))
    got = flash.flash_fwd(q, k, v, causal=causal, route=route)
    want = flash.flash_fwd_plain(q, k, v, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # CPU tensors launch nothing: no counter moves.
    assert (flash.flash_fwd.launches,
            dict(flash.flash_fwd.route_launches)) == before


@pytest.mark.parametrize("route", [None, "tf32x3", "split"])
def test_float32_backward_on_the_cpu_is_the_plain_version(route):
    q, k, v, do = _inputs((2, 33, 2, 16), 6)
    o, lse = flash.flash_fwd_plain(q, k, v, causal=True)
    before = (chip_smoke._bwd_counts(flash),
              dict(flash.flash_bwd.route_launches))
    got = flash.flash_bwd(q, k, v, o, lse, do, causal=True, route=route)
    want = flash.flash_bwd_plain(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (chip_smoke._bwd_counts(flash),
            dict(flash.flash_bwd.route_launches)) == before


def test_tf32x3_is_refused_where_it_is_not_the_route():
    x = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="no route 'tf32x3'"):
        flash.flash_fwd(x.bfloat16(), x.bfloat16(), x.bfloat16(),
                        route="tf32x3")
    d12 = torch.zeros((1, 4, 1, 12), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no route 'tf32x3'"):
        flash.flash_fwd(d12, d12, d12, route="tf32x3")  # bf16 at D = 12
    with pytest.raises(ValueError, match="no route 'tensor'"):
        flash.flash_fwd(x, x, x, route="tensor")


def test_alignment_counts_bytes_for_float32():
    # 16-byte rows are 4 float32 elements: the ViT's float32 qkv slices
    # (strides of 3*H*D and D elements) take the 16-byte path.
    base = torch.zeros(2 * 49 * 3 * 4 * 16 + 1)
    qkv = base[:-1].view(2, 49, 3, 4, 16)
    assert flash._copy_width(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) == 16
    assert flash._copy_width(torch.zeros(2, 49, 4, 20)[..., :16]) == 16
    assert flash._copy_width(torch.zeros(2, 49, 4, 18)[..., :16]) == 8
    shifted = base[1:].view(2, 49, 3, 4, 16)  # 4 bytes off
    assert flash._copy_width(shifted[:, :, 1]) == 4


def test_the_library_is_registered_with_both_entries():
    entries = cuda_build.KERNELS["flash_tf32"]
    # q, k, v, o, lse and the tail; the backward takes the tiled pair's
    # pointers (q, k, v, o, dout, lse, delta, dq, dk, dv) and the tail.
    assert len(entries["flash_fwd_tf32_launch"][0]) == \
        5 + len(cuda_build._FLASH_TAIL)
    assert entries["flash_bwd_tf32_launch"][0] == \
        cuda_build.KERNELS["flash_bwd_tiled"]["flash_bwd_tiled_launch"][0]
    path = cuda_build.source_path("flash_tf32")
    assert path.endswith("csrc/flash_tf32.cu")
    with open(path, "rb") as f:
        source = f.read()
    # Its TF32 helpers are its own: it shares only the staging header with
    # the bf16 kernels, so an edit to their tensor-core header
    # (mma_common.cuh) does not rebuild it.
    assert cuda_build.local_headers(source) == ["stage_common.cuh"]
    # Every product is a TF32 wgmma (m64nNk8, float32 sums); no mma.sync.
    for instr in (b"wgmma.mma_async.sync.aligned.m64n", b".f32.tf32.tf32",
                  b"ex2.approx.ftz.f32"):
        assert instr in source
    assert b"mma.sync" not in source
    # The split rounds as _tf32 does: half a unit of the kept last bit
    # added, the 13 dropped bits cleared, for hi and for lo.
    assert source.count(b"+ 0x1000u) & 0xffffe000u") == 2


# ------------------------------------------------- the staged planes


def _source() -> str:
    with open(cuda_build.source_path("flash_tf32")) as f:
        return f.read()


def _c_ternary(expr: str, dp: int) -> int:
    """Evaluates a chain ``c1 ? v1 : c2 ? v2 : v3`` of the kernel source
    at ``dp``."""
    parts = [x.strip() for x in re.split(r"[?:]", expr)]
    while len(parts) > 1:
        cond, value = parts[0], parts[1]
        if eval(cond, {"dp": dp}):
            return int(value)
        parts = parts[2:]
    return int(parts[0])


def test_the_tile_rows_mirror_the_kernel_source():
    # flash._tf32_tiles is the Python copy of fwd_tile, dq_tile and
    # dkv_tile: the streamed tiles' rows at each head-dim capacity.
    source = _source()
    rules = [re.search(rf"constexpr int {name}\(int dp\) \{{\s*return "
                       rf"([^;]+);", source).group(1)
             for name in ("fwd_tile", "dq_tile", "dkv_tile")]
    for dp in (8, 16, 32, 64, 128):
        assert flash._tf32_tiles(dp) == tuple(_c_ternary(r, dp)
                                             for r in rules)
        # wgmma's N takes every streamed tile, and a tile is whole chunks
        # of 8 rows that the products may take two at a time.
        assert all(t % 16 == 0 for t in flash._tf32_tiles(dp))


def test_the_split_pass_formulas_are_the_sources():
    # _tf32_plane_words mirrors these lines of split_tile and reordered.
    source = re.sub(r"\s+", " ", _source())
    for line in ("const int r = (c & 7) + 8 * ((c >> 3) / CPR), "
                 "x = (c >> 3) % CPR;",
                 "*reinterpret_cast<uint4*>(hi + 4 * c) =",
                 "const int at = ((x >> 1) * (ROWS / 4) + (p >> 2)) * 32 + "
                 "(x & 1) * 16 + (p & 3);",
                 "thi[at + 4 * e] = hr[j];",
                 "return (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);"):
        assert line in source, line


PLANES = [(rows, dp) for dp in (8, 16, 32, 64, 128)
          for rows in sorted({64, *flash._tf32_tiles(dp)})]


def _raw_at(rows: int, dp: int, r: int, x: int) -> int:
    """``raw_at`` of the 16-byte path: chunk x of row r of a raw tile that
    the tensor memory accelerator wrote in boxes of min(4 DP, 128) bytes a
    row, each swizzled (16-byte chunk j of row r at j ^ ((r SW >> 7) &
    (SW / 16 - 1)))."""
    sw = min(4 * dp, 128)
    cb = sw // 16
    b, j = divmod(x, cb)
    return b * rows * (sw // 4) + r * (sw // 4) + 4 * (j ^ ((r * sw >> 7)
                                                              & (cb - 1)))


def test_the_tensor_copy_layout_is_the_sources():
    source = re.sub(r"\s+", " ", _source())
    for line in ("return dp * 4 < 128 ? dp * 4 : 128;",
                 "return b * ROWS * (SW / 4) + r * (SW / 4) + "
                 "4 * (j ^ ((r * SW >> 7) & (CB - 1)));",
                 "SW == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : SW == 64 ? "
                 "CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B"):
        assert line in source, line


@pytest.mark.parametrize("rows,dp", PLANES,
                         ids=[f"{r}x{d}" for r, d in PLANES])
def test_a_swizzled_tile_reads_without_bank_conflicts(rows, dp):
    # Every chunk of the tile has a slot of its own, and the split pass's
    # reads (8 consecutive rows, one chunk column) fall on 8 distinct
    # 16-byte groups of banks: a 128-byte wavefront.
    at = [[_raw_at(rows, dp, r, x) for x in range(dp // 4)]
          for r in range(rows)]
    flat = sorted(a for row in at for a in row)
    assert flat == list(range(0, rows * dp, 4))
    for x in range(dp // 4):
        for r0 in range(0, rows, 8):
            assert len({at[r][x] // 4 % 8 for r in range(r0, r0 + 8)}) == 8


@pytest.mark.parametrize("transposed", [False, True], ids=["nat", "t"])
@pytest.mark.parametrize("rows,dp", PLANES,
                         ids=[f"{r}x{d}" for r, d in PLANES])
def test_a_plane_takes_every_element_once(rows, dp, transposed):
    words = flash._tf32_plane_words(rows, dp, transposed)
    assert sorted(words.flatten().tolist()) == list(range(rows * dp))


def _operand(plane: torch.Tensor, rows: int, k: int, j: int) -> torch.Tensor:
    """The (rows x 8) operand one wgmma reads at k-step j from a K-major
    plane of ``k`` columns without swizzle: LBO 128 bytes (the next 4
    columns), SBO 32 k bytes (the next 8 rows), start 256 j bytes."""
    i = torch.arange(rows)[:, None]
    c = torch.arange(8)[None, :]
    at = 64 * j + (8 * k) * (i >> 3) + 32 * (c >> 2) + 4 * (i & 7) + (c & 3)
    return plane[at]


def _planes(tile: torch.Tensor, transposed: bool) -> torch.Tensor:
    rows, dp = tile.shape
    plane = torch.zeros(rows * dp, dtype=tile.dtype)
    plane[flash._tf32_plane_words(rows, dp, transposed).flatten()] = \
        tile.flatten()
    return plane


@pytest.mark.parametrize("rows,dp", PLANES,
                         ids=[f"{r}x{d}" for r, d in PLANES])
def test_a_descriptor_reads_the_tile_back(rows, dp):
    # The natural plane read by k-steps gives the tile's columns in order;
    # the transposed plane gives its rows, each group of 8 reordered (row
    # 2i at column i, row 2i + 1 at column i + 4).
    tile = torch.arange(rows * dp, dtype=torch.float64).reshape(rows, dp)
    nat, tra = _planes(tile, False), _planes(tile, True)
    order = [0, 2, 4, 6, 1, 3, 5, 7]
    for j in range(dp // 8):
        assert torch.equal(_operand(nat, rows, dp, j), tile[:, 8 * j:8 * j + 8])
    for j in range(rows // 8):
        assert torch.equal(_operand(tra, dp, rows, j),
                           tile[8 * j:8 * j + 8][order].T)


def _a_operand(c: torch.Tensor, j: int) -> torch.Tensor:
    """The (64 x 8) A operand of chunk j as the kernels form it from a 64 x
    N sum in mma's C layout (a_frag): thread (warp w, g, tq) holds columns
    8j + 2tq, 8j + 2tq + 1 of rows 16w + g and 16w + g + 8 and passes them as
    a0 (g, tq), a2 (g, tq + 4), a1 (g + 8, tq), a3 (g + 8, tq + 4)."""
    a = torch.empty((64, 8), dtype=c.dtype)
    for w in range(4):
        for lane in range(32):
            g, tq = lane >> 2, lane & 3
            r = 16 * w + g
            frag = [c[r, 8 * j + 2 * tq], c[r + 8, 8 * j + 2 * tq],
                    c[r, 8 * j + 2 * tq + 1], c[r + 8, 8 * j + 2 * tq + 1]]
            a[r, tq], a[r + 8, tq] = frag[0], frag[1]
            a[r, tq + 4], a[r + 8, tq + 4] = frag[2], frag[3]
    return a


@pytest.mark.parametrize("keys,dp", [(64, 16), (64, 8), (32, 128), (16, 128),
                                     (64, 64), (32, 32)])
def test_a_product_through_the_reordered_plane_is_mm3(keys, dp):
    # O += P V as the kernels run it: P's C fragments as A through the
    # reordered axis, V's hi and lo split once into transposed planes read
    # by descriptor, per chunk of 8 keys a_lo b_hi, a_hi b_lo and a_hi b_hi.
    # The products are exact; summed in float64 they equal _mm3's plain
    # order summed in float64, and _mm3 itself to float32 rounding (one
    # rounding of the largest sum per key).
    rng = np.random.default_rng(keys + dp)
    p = torch.from_numpy(rng.random((64, keys)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((keys, dp)).astype(np.float32))
    vh, vl = _split(v)
    planes = [_planes(x.double(), True) for x in (vh, vl)]
    got = torch.zeros((64, dp), dtype=torch.float64)
    for j in range(keys // KSTEP):
        ah, al = _split(_a_operand(p, j))
        bh, bl = (_operand(x, dp, keys, j).T for x in planes)
        got += al.double() @ bh + ah.double() @ bl + ah.double() @ bh
    want = torch.zeros((64, dp), dtype=torch.float64)
    for k0 in range(0, keys, KSTEP):
        ah, al = (x.double() for x in _split(p[:, k0:k0 + KSTEP]))
        bh, bl = (x.double() for x in _split(v[k0:k0 + KSTEP]))
        want += al @ bh + ah @ bl + ah @ bh
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got.float(), _mm3(p, v), rtol=0,
                               atol=keys * 2.0 ** -24 * float(
                                   (p.abs() @ v.abs()).max()))


# ------------------------------------------------------ the smoke's builds


def _ptxas_log(spill_of=None, drop=None) -> str:
    """An nvcc -Xptxas -v log of the 30 3xTF32 instantiations, one of
    them (``spill_of``) spilling 16 bytes, one (``drop``) left out."""
    lines = []
    for kernel in ("flash_fwd_tf32_kernel", "flash_dq_tf32_kernel",
                   "flash_dkv_tf32_kernel"):
        for dp in (8, 16, 32, 64, 128):
            for narrow in (0, 1):
                name = f"{kernel}<{dp}, {'true' if narrow else 'false'}>"
                if name == drop:
                    continue
                spill = 16 if name == spill_of else 0
                mangled = (f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILi{dp}"
                           f"ELb{narrow}EEEvPKf")
                lines += [f"ptxas info    : Compiling entry function "
                          f"'{mangled}' for 'sm_90a'",
                          f"    0 bytes stack frame, {spill} bytes spill "
                          f"stores, {spill} bytes spill loads",
                          "ptxas info    : Used 128 registers"]
    return "\n".join(lines)


def test_the_smoke_requires_every_instantiation_and_no_spill():
    counts = chip_smoke.require_no_spill(_ptxas_log())
    assert len(counts) == chip_smoke.TF32_INSTANTIATIONS == 30
    assert counts["flash_dkv_tf32_kernel<128, true>"] == {
        "spill_stores": 0, "spill_loads": 0, "registers": 128}
    with pytest.raises(AssertionError, match="spills registers"):
        chip_smoke.require_no_spill(
            _ptxas_log(spill_of="flash_dq_tf32_kernel<8, true>"))
    with pytest.raises(AssertionError, match="29 instantiations"):
        chip_smoke.require_no_spill(
            _ptxas_log(drop="flash_fwd_tf32_kernel<64, false>"))


# ------------------------------------------------------ the smoke's bounds


def test_the_smoke_bounds_the_3xtf32_kernels_at_a_third_of_tf32():
    peaks = chip_smoke.PEAKS["H100"]
    assert peaks[4] == 495e12 and chip_smoke.TF32_PER_PRODUCT == 3
    p2 = chip_smoke.P2_SHAPE
    least, by, bytes_moved, ops = chip_smoke.flash_bound_ms(
        "flash_fwd_tf32", p2, 4, peaks)
    # 52.2 MB (0.0156 ms) against 2.52 GFLOP at 165 TFLOP/s (0.0153 ms).
    assert bytes_moved == 52_183_040 and ops == 2_517_630_976
    assert by == "bytes" and least == pytest.approx(0.015577, rel=1e-4)
    # The pair at T = 196: 157.4 MB against 8.81 GFLOP, the dK/dV kernel
    # bound by its products (the sum of the two kernels' bounds); at T = 49
    # both by their bytes.
    least, by = chip_smoke.pair_bound_ms(chip_smoke.TF32_PAIR, p2, 4, peaks)
    assert by == "operations" and least == pytest.approx(0.054002, rel=1e-4)
    least, by = chip_smoke.pair_bound_ms(chip_smoke.TF32_PAIR,
                                         chip_smoke.VIT_SHAPE, 4, peaks)
    assert by == "bytes"
    # The CUDA-core kernels of the same problem stay at the float32 rate.
    assert chip_smoke.flash_bound_ms("flash_fwd", p2, 4, peaks)[3] == ops
    assert chip_smoke.flash_bound_ms("flash_fwd", p2, 4, peaks)[0] > least


@pytest.mark.parametrize("dtype,tokens,fwd,bwd", [
    ("f32", 49, "tf32x3", "tf32x3"), ("f32", 196, "tf32x3", "tf32x3"),
    ("bf16", 49, "tensor", "fused"), ("bf16", 196, "tensor", "tiled")])
def test_the_smoke_expects_one_route_per_training_run(dtype, tokens, fwd,
                                                      bwd):
    want = chip_smoke._flash_want(dtype, tokens, 10, 8)
    assert want["flash_fwd_routes"] == {r: 10 if r == fwd else 0
                                        for r in flash.flash_fwd.route_launches}
    assert want["flash_bwd_routes"] == {r: 8 if r == bwd else 0
                                        for r in flash.flash_bwd.route_launches}
    assert want["flash_bwd"] == (8 if bwd == "fused" else 0)
    assert want["flash_dq"] == want["flash_dkv"] == 0
