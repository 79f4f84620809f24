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


@pytest.mark.parametrize("b", [1, 7, 128, 256, 300])
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
    before = adam.adam_leaves.launches
    adam.adam_leaf(got[0], g, got[1], got[2], h)
    adam.adam_leaf_plain(want[0], g, want[1], want[2], h)
    torch.cuda.synchronize()
    assert adam.adam_leaves.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _adam_hyper(card):
    from pytorch_distributed_mnist_tpu_torch.ops import adam

    return {k: torch.tensor(val, dtype=torch.float32, device=card)
            for k, val in {"learning_rate": 1e-3,
                           **adam.ADAM_DEFAULTS}.items()}


def _adam_state(card, shapes, seed, offset=0):
    """p, m, v per shape (views ``offset`` floats into their buffers)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    out = []
    for shape in shapes:
        n = 1
        for s in shape:
            n *= s
        bufs = [torch.randn(offset + n, device=card, generator=gen)
                for _ in range(3)]
        p, m, v = (b[offset:].view(shape) for b in bufs)
        m.mul_(0.1)
        v.abs_().mul_(0.01)
        out.append([p, m, v])
    return out


@pytest.mark.parametrize("model", ["cnn", "vit"])
def test_adam_leaves_equals_plain_over_200_steps(card, model):
    import chip_smoke
    from pytorch_distributed_mnist_tpu_torch.ops import adam

    shapes = [s for _, s in chip_smoke.leaf_shapes(model)]
    hyper = _adam_hyper(card)
    got = _adam_state(card, shapes, 5)
    want = [[x.clone() for x in leaf] for leaf in got]
    table = adam.LeafTable([x[0] for x in got], [x[1] for x in got],
                           [x[2] for x in got])
    count = torch.zeros((), dtype=torch.int32, device=card)
    gen = torch.Generator(device=card).manual_seed(6)
    before = adam.adam_leaves.launches
    for _ in range(200):  # through t = 31 and t = 168
        count.add_(1)
        grads = [torch.randn(s, device=card, generator=gen) * 1e-2
                 for s in shapes]
        adam.adam_leaves([x[0] for x in got], grads, [x[1] for x in got],
                         [x[2] for x in got], hyper, count, table=table)
        adam.adam_leaves_plain([x[0] for x in want], grads,
                               [x[1] for x in want], [x[2] for x in want],
                               hyper, count)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    assert adam.adam_leaves.launches == before + 200


def test_adam_kernel_forms_the_hypers_of_adam_hypers(card):
    from pytorch_distributed_mnist_tpu_torch.ops import adam

    hyper = _adam_hyper(card)
    (p, m, v), = _adam_state(card, [(3,)], 7)
    g = torch.zeros(3, device=card)
    out = torch.empty(9, device=card)
    for t in range(1, 3001):
        count = torch.tensor(t, dtype=torch.int32, device=card)
        adam.adam_leaves([p], [g], [m], [v], hyper, count, hypers_out=out)
        want = adam.adam_hypers(hyper, count.float())
        assert torch.equal(out, want), t


def test_adam_leaves_takes_misaligned_leaves_and_two_launches(card):
    from pytorch_distributed_mnist_tpu_torch.ops import adam

    # 70 leaves (two launches), their buffers 1 float (4 bytes) off the
    # 16-byte grid, with lengths around the 4-wide vectors.
    shapes = [(n,) for n in range(1, 71)]
    got = _adam_state(card, shapes, 8, offset=1)
    want = [[x.clone() for x in leaf] for leaf in got]
    gen = torch.Generator(device=card).manual_seed(9)
    bufs = [torch.randn(1 + s[0], device=card, generator=gen)
            for s in shapes]
    grads = [b[1:] for b in bufs]
    hyper = _adam_hyper(card)
    count = torch.tensor(3, dtype=torch.int32, device=card)
    before = adam.adam_leaves.launches
    adam.adam_leaves([x[0] for x in got], grads, [x[1] for x in got],
                     [x[2] for x in got], hyper, count)
    adam.adam_leaves_plain([x[0] for x in want], grads, [x[1] for x in want],
                           [x[2] for x in want], hyper, count)
    torch.cuda.synchronize()
    assert adam.adam_leaves.launches == before + 2
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_fused_adam_step_launches_once(card):
    import chip_smoke
    from pytorch_distributed_mnist_tpu_torch.ops import adam

    gen = torch.Generator(device=card).manual_seed(10)
    params = [torch.randn(s, device=card, generator=gen)
              for _, s in chip_smoke.leaf_shapes("vit")]
    opt = adam.FusedAdam(params, lr=1e-3)
    before = adam.adam_leaves.launches
    for _ in range(3):
        for p in params:
            p.grad = torch.randn(p.shape, device=card, generator=gen)
        opt.step()
    torch.cuda.synchronize()
    assert adam.adam_leaves.launches == before + 3
    assert int(opt.inner_count) == int(opt.count) == 3


FLASH_SHAPES = [(256, 49, 4, 16), (2, 1, 2, 16), (2, 16, 2, 16),
                (2, 196, 2, 16), (2, 200, 2, 64), (1, 200, 2, 128),
                (3, 130, 2, 32), (1, 70, 1, 8)]


def _flash_close(got, want, dtype):
    # float32: the same products summed in another order (rtol 1e-4, atol
    # 1e-5 of the largest value). bfloat16: both sum in float32 from the
    # same inputs and round once at the output (one bf16 step: rtol 2**-7,
    # atol 2**-8 of the largest value).
    rtol, scale = (2.0 ** -7, 2.0 ** -8) if dtype == torch.bfloat16 \
        else (1e-4, 1e-5)
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=scale * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_match_plain(card, shape, dtype, causal):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    b, t, h, d = shape
    gen = torch.Generator(device=card).manual_seed(b * t * h * d + causal)
    # q, k and v as the ViT hands them over: slices of one qkv product.
    qkv = torch.randn(b, t, 3, h, d, device=card, generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(b, t, h, d, device=card, generator=gen).to(dtype)
    before = (flash.flash_fwd.launches, flash.flash_dq.launches,
              flash.flash_dkv.launches)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    want_o, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    dq, delta = flash.flash_dq(q, k, v, want_o, want_lse, do, causal=causal)
    want_dq, want_delta = flash.flash_dq_plain(q, k, v, want_o, want_lse, do,
                                               causal=causal)
    dk, dv = flash.flash_dkv(q, k, v, want_lse, want_delta, do,
                             causal=causal)
    want_dk, want_dv = flash.flash_dkv_plain(q, k, v, want_lse, want_delta,
                                             do, causal=causal)
    torch.cuda.synchronize()
    assert (flash.flash_fwd.launches, flash.flash_dq.launches,
            flash.flash_dkv.launches) == tuple(n + 1 for n in before)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    for got, want in ((o, want_o), (dq, want_dq), (dk, want_dk),
                      (dv, want_dv)):
        _flash_close(got, want, dtype)
    for got, want in ((lse, want_lse), (delta, want_delta)):
        _flash_close(got, want, torch.float32)


def test_flash_attention_trains_through_the_kernels(card):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    gen = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn(4, 49, 4, 16, device=card, generator=gen)
               .requires_grad_(True) for _ in range(3))
    g = torch.randn(4, 49, 4, 16, device=card, generator=gen)
    # float32 with D = 16: the 3xTF32 forward and pair, once each.
    before = (flash.flash_fwd.route_launches["tf32x3"],
              flash.flash_bwd.route_launches["tf32x3"],
              flash.flash_dq.launches, flash.flash_dkv.launches)
    flash.flash_attention(q, k, v).backward(g)
    torch.cuda.synchronize()
    assert (flash.flash_fwd.route_launches["tf32x3"],
            flash.flash_bwd.route_launches["tf32x3"],
            flash.flash_dq.launches, flash.flash_dkv.launches) == \
        (before[0] + 1, before[1] + 1, before[2], before[3])
    from pytorch_distributed_mnist_tpu_torch.ops.attention import (
        full_attention,
    )

    qd, kd, vd = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    full_attention(qd, kd, vd).backward(g)
    for got, want in ((q.grad, qd.grad), (k.grad, kd.grad),
                      (v.grad, vd.grad)):
        _flash_close(got, want, torch.float32)


# With head dims that are not a multiple of 8 the tensor-core kernels run
# their narrow instantiation: copy widths of 8 (D = 12, 100), 2 (D = 7,
# bf16) and 4 (D = 10, bf16) bytes.
FLASH_BWD_SHAPES = FLASH_SHAPES + [(2, 128, 2, 128), (3, 100, 3, 48),
                                   (2, 33, 2, 12), (2, 196, 2, 12),
                                   (2, 57, 3, 7), (1, 30, 2, 10),
                                   (1, 100, 2, 100)]


def _bwd_counts(flash):
    """(fused kernel, tiled pair, 3xTF32 pair, dQ kernel, dK/dV kernel)
    launches."""
    return (flash.flash_bwd.launches, flash.flash_bwd.route_launches["tiled"],
            flash.flash_bwd.route_launches["tf32x3"],
            flash.flash_dq.launches, flash.flash_dkv.launches)


# What one flash_bwd call moves in _bwd_counts, per route.
BWD_MOVES = {"fused": (1, 0, 0, 0, 0), "tiled": (0, 1, 0, 0, 0),
             "tf32x3": (0, 0, 1, 0, 0), "split": (0, 0, 0, 1, 1)}


def _flash_bwd_inputs(card, shape, dtype, seed, offset=0, causal=False):
    """q, k, v as slices of one (B, T, 3, H, D) qkv product that starts
    ``offset`` elements into its buffer, dO, and the plain forward's O and
    lse."""
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    b, t, h, d = shape
    gen = torch.Generator(device=card).manual_seed(seed)
    buf = torch.randn(offset + b * t * 3 * h * d, device=card, generator=gen)
    qkv = buf.to(dtype)[offset:].view(b, t, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(b, t, h, d, device=card, generator=gen).to(dtype)
    o, lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_matches_plain_on_its_route(card, shape, dtype, causal):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    b, t, h, d = shape
    q, k, v, o, lse, do = _flash_bwd_inputs(card, shape, dtype,
                                            b * t * h * d + causal,
                                            causal=causal)
    before = _bwd_counts(flash)
    got = flash.flash_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    moved = tuple(n - m for m, n in zip(before, _bwd_counts(flash)))
    # Only the route's own counters move.
    assert moved == BWD_MOVES[flash._bwd_route(shape, dtype)]
    want = flash.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.is_contiguous()
        _flash_close(a, w, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_fused_gives_the_same_bits_twice(card, causal):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    q, k, v, o, lse, do = _flash_bwd_inputs(card, (256, 49, 4, 16),
                                            torch.bfloat16, 21,
                                            causal=causal)
    first = flash.flash_bwd(q, k, v, o, lse, do, causal=causal)
    second = flash.flash_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bwd_copies_a_misaligned_view(card):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    # The qkv product starts 3 elements (6 bytes) into its buffer: the
    # kernel takes the views as they are, 2 bytes at a time.
    q, k, v, o, lse, do = _flash_bwd_inputs(card, (8, 49, 4, 16),
                                            torch.bfloat16, 22, offset=3)
    assert flash._copy_width(q, k, v) == 2
    before = flash.flash_bwd.launches
    got = flash.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert flash.flash_bwd.launches == before + 1
    for a, w in zip(got, flash.flash_bwd_plain(q, k, v, o, lse, do)):
        _flash_close(a, w, torch.bfloat16)


@pytest.mark.parametrize("shape,dtype", [((32, 196, 4, 16), torch.bfloat16),
                                         ((4, 49, 4, 16), torch.bfloat16),
                                         ((4, 49, 4, 16), torch.float32),
                                         ((4, 49, 4, 12), torch.bfloat16),
                                         ((4, 49, 4, 12), torch.float32),
                                         ((4, 196, 4, 12), torch.bfloat16)])
def test_flash_attention_backward_takes_its_route(card, shape, dtype):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    gen = torch.Generator(device=card).manual_seed(23)
    q, k, v = (torch.randn(shape, device=card, generator=gen).to(dtype)
               .requires_grad_(True) for _ in range(3))
    g = torch.randn(shape, device=card, generator=gen).to(dtype)
    before = _bwd_counts(flash)
    flash.flash_attention(q, k, v).backward(g)
    torch.cuda.synchronize()
    moved = tuple(n - m for m, n in zip(before, _bwd_counts(flash)))
    assert moved == BWD_MOVES[flash._bwd_route(shape, dtype)]


@pytest.mark.parametrize("shape", [(32, 196, 4, 16), (2, 200, 2, 64),
                                   (1, 200, 2, 128), (3, 130, 2, 32),
                                   (256, 49, 4, 16), (1, 1, 1, 8)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_tiled_matches_plain_with_the_same_bits(card, shape,
                                                          causal):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    q, k, v, o, lse, do = _flash_bwd_inputs(card, shape, torch.bfloat16,
                                            sum(shape) + causal,
                                            causal=causal)
    before = _bwd_counts(flash)
    first = flash.flash_bwd(q, k, v, o, lse, do, causal=causal,
                            route="tiled")
    second = flash.flash_bwd(q, k, v, o, lse, do, causal=causal,
                             route="tiled")
    torch.cuda.synchronize()
    moved = tuple(n - m for m, n in zip(before, _bwd_counts(flash)))
    assert moved == (0, 2, 0, 0, 0)
    want = flash.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
        _flash_close(a, w, torch.bfloat16)


def test_flash_bwd_split_named_in_bf16_matches_plain(card):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    q, k, v, o, lse, do = _flash_bwd_inputs(card, (32, 196, 4, 16),
                                            torch.bfloat16, 24)
    before = _bwd_counts(flash)
    got = flash.flash_bwd(q, k, v, o, lse, do, route="split")
    torch.cuda.synchronize()
    moved = tuple(n - m for m, n in zip(before, _bwd_counts(flash)))
    assert moved == BWD_MOVES["split"]
    for a, w in zip(got, flash.flash_bwd_plain(q, k, v, o, lse, do)):
        _flash_close(a, w, torch.bfloat16)


def test_flash_bwd_tiled_copies_a_misaligned_view(card):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    q, k, v, o, lse, do = _flash_bwd_inputs(card, (4, 196, 4, 16),
                                            torch.bfloat16, 25, offset=3)
    assert flash._copy_width(q, k, v) == 2
    got = flash.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, w in zip(got, flash.flash_bwd_plain(q, k, v, o, lse, do)):
        _flash_close(a, w, torch.bfloat16)


def _routes(flash):
    return dict(flash.flash_fwd.route_launches)


@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_tensor_route_matches_plain_with_the_same_bits(card, shape,
                                                                 causal):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    b, t, h, d = shape
    gen = torch.Generator(device=card).manual_seed(b * t * h * d + 7 * causal)
    qkv = torch.randn(b, t, 3, h, d, device=card,
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert flash._fwd_route(shape, torch.bfloat16) == "tensor"
    before = _routes(flash)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    o2, lse2 = flash.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = _routes(flash)
    assert (after["tensor"] - before["tensor"],
            after["cuda_core"] - before["cuda_core"]) == (2, 0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    want_o, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16 and o.is_contiguous()
    _flash_close(o, want_o, torch.bfloat16)
    _flash_close(lse, want_lse, torch.float32)


@pytest.mark.parametrize("shape", [(256, 49, 4, 16), (1, 70, 1, 8),
                                   (2, 33, 2, 12)])
def test_flash_fwd_float32_takes_the_cuda_core_route(card, shape):
    # float32 takes the 3xTF32 kernel at every D, D = 12 included; the
    # CUDA-core kernel only where it is named.
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    gen = torch.Generator(device=card).manual_seed(31)
    q, k, v = (torch.randn(shape, device=card, generator=gen)
               for _ in range(3))
    route = "tf32x3"
    assert flash._fwd_route(shape, torch.float32) == route
    before = _routes(flash)
    o, lse = flash.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    after = _routes(flash)
    assert {r: after[r] - before[r] for r in after} == \
        {r: int(r == route) for r in after}
    want_o, want_lse = flash.flash_fwd_plain(q, k, v)
    _flash_close(o, want_o, torch.float32)
    _flash_close(lse, want_lse, torch.float32)


@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_tf32_matches_plain_with_the_same_bits(card, shape, causal):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    q, k, v, o, lse, do = _flash_bwd_inputs(card, shape, torch.float32,
                                            2 * sum(shape) + causal,
                                            causal=causal)
    fwd_before, bwd_before = _routes(flash), _bwd_counts(flash)
    first = flash.flash_fwd(q, k, v, causal=causal)
    second = flash.flash_fwd(q, k, v, causal=causal)
    grads = flash.flash_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash.flash_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    after = _routes(flash)
    assert {r: after[r] - fwd_before[r] for r in after} == \
        {r: 2 * int(r == "tf32x3") for r in after}
    assert tuple(n - m for m, n in zip(bwd_before, _bwd_counts(flash))) == \
        (0, 0, 2, 0, 0)
    for a, b, w in zip(first, second, (o, lse)):
        assert torch.equal(a, b)
        _flash_close(a, w, torch.float32)
    want = flash.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for a, b, w in zip(grads, again, want):
        assert torch.equal(a, b)
        assert a.dtype == torch.float32 and a.is_contiguous()
        _flash_close(a, w, torch.float32)


def test_flash_tf32_copies_a_misaligned_view(card):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    # The qkv product starts 1 element (4 bytes) into its buffer: the
    # kernels take the views as they are, 4 bytes at a time.
    q, k, v, o, lse, do = _flash_bwd_inputs(card, (8, 49, 4, 16),
                                            torch.float32, 33, offset=1)
    assert flash._copy_width(q, k, v) == 4
    fwd_before, bwd_before = _routes(flash)["tf32x3"], _bwd_counts(flash)
    got_o, got_lse = flash.flash_fwd(q, k, v)
    grads = flash.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert _routes(flash)["tf32x3"] == fwd_before + 1
    assert tuple(n - m for m, n in zip(bwd_before, _bwd_counts(flash))) == \
        BWD_MOVES["tf32x3"]
    _flash_close(got_o, o, torch.float32)
    _flash_close(got_lse, lse, torch.float32)
    for a, w in zip(grads, flash.flash_bwd_plain(q, k, v, o, lse, do)):
        _flash_close(a, w, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_d12_takes_the_tensor_core_routes(card, dtype):
    # D = 12 (the ViT at embed 48 in 4 heads) takes the tensor-core
    # kernels' narrow instantiation by default: the bf16 forward and fused
    # backward, or the 3xTF32 forward and pair.
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    shape = (2, 33, 2, 12)
    q, k, v, o, lse, do = _flash_bwd_inputs(card, shape, dtype, 34,
                                            causal=True)
    assert flash._copy_width(q, k, v) == (8 if dtype == torch.bfloat16
                                          else 16)
    fwd_route = "tensor" if dtype == torch.bfloat16 else "tf32x3"
    bwd_route = "fused" if dtype == torch.bfloat16 else "tf32x3"
    fwd_before, bwd_before = _routes(flash), _bwd_counts(flash)
    got_o, got_lse = flash.flash_fwd(q, k, v, causal=True)
    grads = flash.flash_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    after = _routes(flash)
    assert {r: after[r] - fwd_before[r] for r in after} == \
        {r: int(r == fwd_route) for r in after}
    assert tuple(n - m for m, n in zip(bwd_before, _bwd_counts(flash))) == \
        BWD_MOVES[bwd_route]
    _flash_close(got_o, o, dtype)
    _flash_close(got_lse, lse, torch.float32)
    for a, w in zip(grads, flash.flash_bwd_plain(q, k, v, o, lse, do,
                                                 causal=True)):
        _flash_close(a, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_d12_named_cuda_core_routes_match_plain(card, dtype):
    # The CUDA-core forward and split pair, which no problem takes unnamed,
    # named at the D = 12 shape they used to serve by default.
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    shape = (2, 33, 2, 12)
    q, k, v, o, lse, do = _flash_bwd_inputs(card, shape, dtype, 35,
                                            causal=True)
    fwd_before, bwd_before = _routes(flash), _bwd_counts(flash)
    got_o, got_lse = flash.flash_fwd(q, k, v, causal=True, route="cuda_core")
    grads = flash.flash_bwd(q, k, v, o, lse, do, causal=True, route="split")
    torch.cuda.synchronize()
    after = _routes(flash)
    assert {r: after[r] - fwd_before[r] for r in after} == \
        {r: int(r == "cuda_core") for r in after}
    assert tuple(n - m for m, n in zip(bwd_before, _bwd_counts(flash))) == \
        BWD_MOVES["split"]
    _flash_close(got_o, o, dtype)
    _flash_close(got_lse, lse, torch.float32)
    for a, w in zip(grads, flash.flash_bwd_plain(q, k, v, o, lse, do,
                                                 causal=True)):
        _flash_close(a, w, dtype)


def test_flash_fwd_copies_a_misaligned_view(card):
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    # The qkv product starts 3 elements (6 bytes) into its buffer: the
    # kernel takes the views as they are, 2 bytes at a time.
    q, k, v, _, _, _ = _flash_bwd_inputs(card, (8, 49, 4, 16),
                                         torch.bfloat16, 32, offset=3)
    assert flash._copy_width(q, k, v) == 2
    before = _routes(flash)["tensor"]
    o, lse = flash.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    assert _routes(flash)["tensor"] == before + 1
    want_o, want_lse = flash.flash_fwd_plain(q, k, v)
    _flash_close(o, want_o, torch.bfloat16)
    _flash_close(lse, want_lse, torch.float32)


def _check_shapes():
    import chip_smoke

    return chip_smoke.CHECK_SHAPES


@pytest.mark.parametrize("m,k,n", _check_shapes())
def test_matmul_i8_equals_plain_with_the_same_bits_twice(card, m, k, n):
    gen = torch.Generator(device=card).manual_seed(3 * m + k + n)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=card,
                      generator=gen)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=card,
                      generator=gen)
    first = matmul_i8(a, b)
    second = matmul_i8(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, matmul_i8_plain(a, b))


# -- the scan trainer mode: captured CUDA graphs of the train step ------


def test_a_graph_of_xent_and_adam_launches_equals_the_eager_launches(card):
    from pytorch_distributed_mnist_tpu_torch.ops import adam, xent

    gen = torch.Generator(device=card).manual_seed(21)
    logits = torch.randn(256, 10, device=card, generator=gen) * 3
    labels = torch.randint(0, 10, (256,), device=card, generator=gen)
    g = torch.rand(256, device=card, generator=gen)
    p = torch.randn(1000, device=card, generator=gen)
    grad = torch.randn(1000, device=card, generator=gen)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    hyper = {k: torch.tensor(x, device=card) for k, x in (
        ("learning_rate", 1e-3), ("b1", 0.9), ("b2", 0.999), ("eps", 1e-8),
        ("eps_root", 0.0))}
    count = torch.zeros((), dtype=torch.int32, device=card)
    start = (p.clone(), m.clone(), v.clone())

    def body():
        loss, lse = xent.xent_fwd(logits, labels)
        dl = xent.xent_bwd(logits, labels, lse, g)
        count.add_(1)
        adam.adam_leaves([p], [grad], [m], [v], hyper, count)
        return loss, dl

    def restart():
        for t, t0 in zip((p, m, v), start):
            t.copy_(t0)
        count.zero_()

    want = []
    for _ in range(2):
        loss, dl = body()
        want.append([x.clone() for x in (loss, dl, p, m, v)])
    restart()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):  # each kernel has launched above
        loss, dl = body()
    got = []
    for _ in range(2):
        graph.replay()
        got.append([x.clone() for x in (loss, dl, p, m, v)])
    torch.cuda.synchronize()
    assert int(count) == 2
    for w, r in zip(want, got):
        for a, b in zip(w, r):
            assert torch.equal(a, b)


def _scan_case(card, model, seed):
    """A train state of ``model`` on the card (fused loss, fused Adam, the
    ViT with flash attention) and 6 batches of 64 synthetic images."""
    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.data.mnist import (
        normalize_images,
        synthetic_dataset,
    )
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )

    kwargs = {"attention_fn": flash_attention} if model == "vit" else {}
    state = create_train_state(get_model(model, **kwargs), seed, card,
                               optimizer="adam_pallas")
    images, labels = synthetic_dataset(6 * 64, seed=seed + 1)
    staged = {"image": torch.from_numpy(
                  normalize_images(images).reshape(6, 64, 28, 28, 1)),
              "label": torch.from_numpy(
                  labels.astype(np.int64).reshape(6, 64)),
              "mask": torch.ones(6, 64)}
    return state, {k: t.to(card) for k, t in staged.items()}


@pytest.fixture
def scan_settings(monkeypatch):
    """The trainer's settings on the card (deterministic cuDNN) and the
    fused loss, put back afterwards."""
    from pytorch_distributed_mnist_tpu_torch.ops import loss

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    loss.set_loss_impl("fused")
    try:
        yield
    finally:
        loss.set_loss_impl("xla")


@pytest.mark.parametrize("model", ["cnn", "vit"])
def test_a_replayed_epoch_equals_the_eager_stepwise_epoch(card, model,
                                                         scan_settings):
    from pytorch_distributed_mnist_tpu_torch.ops.metrics import (
        accumulate_metrics,
        metrics_init,
    )
    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
        train_step,
    )

    eager, staged = _scan_case(card, model, seed=0)
    scanned, _ = _scan_case(card, model, seed=0)
    epoch = make_train_epoch(scanned)
    # Pass 1: two eager ticks, the capture, four replays; pass 2: six
    # replays.
    for _ in range(2):
        acc = metrics_init(card)
        for s in range(6):
            batch = {k: t[s] for k, t in staged.items()}
            accumulate_metrics(acc, train_step(eager, batch))
        got = epoch(staged)
        for a, b in zip(got, acc):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert epoch.program.replays == 10
    for (name, a), b in zip(scanned.model.named_parameters(),
                            eager.model.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(scanned.optimizer.inner_leaves()[1][1],
                    eager.optimizer.inner_leaves()[1][1]):
        assert torch.equal(a, b)
    assert int(scanned.step) == int(eager.step) == 12


@pytest.mark.parametrize("model, remat", [("cnn", False), ("vit", False),
                                          ("vit", True)])
def test_a_replayed_accumulated_epoch_equals_the_eager_steps(
        card, model, remat, scan_settings):
    # --grad-accum 2 (and --remat) inside the captured step: the replayed
    # epoch equals eager accumulated steps bit for bit, and each replay
    # counts two cross-entropy launches (and the ViT's two flash
    # forwards and backwards a block, one forward more under remat).
    from pytorch_distributed_mnist_tpu_torch.ops.metrics import (
        accumulate_metrics,
        metrics_init,
    )
    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
        train_step,
    )

    eager, staged = _scan_case(card, model, seed=7)
    scanned, _ = _scan_case(card, model, seed=7)
    if remat:
        scanned.model.remat = True
    staged["mask"][5, 31:34] = 0.0  # zeros on both sides of a micro-batch
    epoch = make_train_epoch(scanned, grad_accum=2)
    for _ in range(2):
        acc = metrics_init(card)
        for s in range(6):
            batch = {k: t[s] for k, t in staged.items()}
            accumulate_metrics(acc, train_step(eager, batch, accum=2))
        got = epoch(staged)
        for a, b in zip(got, acc):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    for (name, a), b in zip(scanned.model.named_parameters(),
                            eager.model.parameters()):
        assert torch.equal(a, b), name
    per_replay = {k[1]: n for k, n in epoch.program.launches.per_replay
                  .items() if k[2] == "launches"}
    want = {"xent_fwd": 2, "xent_bwd": 2, "adam_leaves": 1}
    if model == "vit":
        want.update(flash_fwd=2 * 2 * (2 if remat else 1), flash_bwd=2 * 2)
    assert per_replay == want


def test_the_feeder_stages_the_inline_batches_on_the_card(card):
    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.data.loader import (
        MNISTDataLoader,
    )
    from pytorch_distributed_mnist_tpu_torch.data.staging import BatchFeeder

    rng = np.random.default_rng(0)
    images = rng.normal(size=(300, 28, 28, 1)).astype(np.float32)
    loader = MNISTDataLoader(images, np.arange(300) % 10, 32, seed=3)
    inline = [{k: t.clone() for k, t in b.items()}
              for b in BatchFeeder(loader, card, window=1).epoch()]
    feeder = BatchFeeder(loader, card, window=3)
    assert feeder.pipelined
    piped = []
    for batch in feeder.epoch():
        # Work on the consumer's stream between batches, as a step's.
        torch.cuda._sleep(100_000)
        piped.append({k: t.clone() for k, t in batch.items()})
    torch.cuda.synchronize()
    assert len(piped) == len(inline) == 300 // 32
    for a, b in zip(piped, inline):
        for key in ("image", "label", "mask"):
            assert torch.equal(a[key], b[key]), key
    feeder.close()


def test_epoch_counters_equal_captured_launches_times_replays(
        card, scan_settings):
    from pytorch_distributed_mnist_tpu_torch.ops import launches
    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
    )

    state, staged = _scan_case(card, "vit", seed=4)
    epoch = make_train_epoch(state)
    before = launches.read_counts()
    for _ in range(2):
        epoch(staged)
    torch.cuda.synchronize()
    after = launches.read_counts()
    delta = {k[1] + "." + k[2]: after[k] - before[k] for k in after
             if after[k] != before[k]}
    # Per step: one cross-entropy forward and backward, one Adam launch,
    # and per attention layer (depth 2) one bf16 tensor-core forward and
    # one fused backward. 12 steps: 2 eager, 10 replayed.
    per_step = {"xent_fwd.launches": 1, "xent_bwd.launches": 1,
                "adam_leaves.launches": 1, "flash_fwd.launches": 2,
                "flash_fwd.tensor": 2, "flash_bwd.launches": 2,
                "flash_bwd.fused": 2}
    assert delta == {k: 12 * n for k, n in per_step.items()}
    assert {k[1] + "." + k[2]: n
            for k, n in epoch.program.launches.per_replay.items()} == per_step
    assert epoch.program.replays == 10


def test_a_rebound_param_raises_before_a_replay(card, scan_settings):
    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
    )

    state, staged = _scan_case(card, "cnn", seed=5)
    epoch = make_train_epoch(state)
    epoch(staged)
    p = next(state.model.parameters())
    with torch.no_grad():
        p.data = p.data.clone()
    replays = epoch.program.replays
    with pytest.raises(RuntimeError, match="rebound"):
        epoch(staged)
    assert epoch.program.replays == replays


@pytest.fixture
def nccl_world_of_one(card):
    """This process as an NCCL world of one on the card (the explicit
    rendezvous on a free loopback port), torn down afterwards."""
    from pytorch_distributed_mnist_tpu_torch.parallel import distributed
    from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
        free_port,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh

    device = torch.device("cuda", torch.cuda.current_device())
    distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                       device)
    try:
        yield make_mesh(device=device)
    finally:
        distributed.teardown()


def test_a_replayed_epoch_with_the_nccl_all_reduce_equals_the_eager_steps(
        card, nccl_world_of_one, scan_settings):
    from pytorch_distributed_mnist_tpu_torch.ops import launches
    from pytorch_distributed_mnist_tpu_torch.ops.metrics import (
        accumulate_metrics,
        metrics_init,
    )
    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        make_train_epoch,
        train_step,
    )

    axis = nccl_world_of_one
    assert axis.reduces and axis.size == 1
    eager, staged = _scan_case(card, "cnn", seed=6)
    scanned, _ = _scan_case(card, "cnn", seed=6)
    epoch = make_train_epoch(scanned, axis)
    before = launches.read_counts()
    # Pass 1: two eager ticks (the first all-reduces), the capture, four
    # replays; pass 2: six replays. Each step: the NCCL all-reduce of the
    # flat gradient buffer, then one Adam launch over it.
    for _ in range(2):
        acc = metrics_init(card)
        for s in range(6):
            batch = {k: t[s] for k, t in staged.items()}
            accumulate_metrics(acc, train_step(eager, batch, axis))
        got = epoch(staged)
        for a, b in zip(got, acc):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    after = launches.read_counts()
    for (name, a), b in zip(scanned.model.named_parameters(),
                            eager.model.parameters()):
        assert torch.equal(a, b), name
    delta = {k[1]: after[k] - before[k] for k in after
             if k[2] == "launches" and after[k] != before[k]}
    # Each step also all-reduces its count of real examples: the global
    # masked mean's divisor.
    assert delta == {"count_all_reduce": 24, "grad_all_reduce": 24,
                     "adam_leaves": 24, "xent_fwd": 24, "xent_bwd": 24}
    assert epoch.program.launches.per_replay[
        ("parallel.collectives", "grad_all_reduce", "launches")] == 1
    assert epoch.program.replays == 10


def test_two_replicas_on_two_threads_answer_bit_for_bit(card):
    """Two int8 replicas of one pool (both on the card, or on two cards
    when there are) dispatched from two threads at once, each thread's
    current device the other replica's: every reply's logits equal the
    same engine's run alone, bit for bit."""
    import functools
    import threading

    import numpy as np

    from pytorch_distributed_mnist_tpu_torch.data.mnist import (
        synthetic_dataset,
    )
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import int8_linear
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.pool import EnginePool

    n_cards = torch.cuda.device_count()
    devices = [torch.device("cuda", 0),
               torch.device("cuda", min(1, n_cards - 1))]
    factory = functools.partial(get_model, "cnn", matmul=int8_linear)
    params = init_params("cnn", 0)
    pool = EnginePool(factory, params, devices=devices, buckets=(1, 8, 32),
                      precision="int8", fuse=True)
    pool.warmup()
    alone = InferenceEngine(factory(), params, buckets=(1, 8, 32),
                            precision="int8", fuse=True, device=devices[0])
    images, _ = synthetic_dataset(40 * 16, seed=7)
    batches = np.split(images, 40)
    got = {}

    def drive(idx):
        torch.cuda.set_device(devices[1 - idx])
        replica = pool.replicas[idx]
        for j in range(idx, len(batches), 2):
            got[j] = replica.engine.dispatch_logits(batches[j]).complete()[0]

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads)
    for j, raw in enumerate(batches):
        assert np.array_equal(got[j], alone.logits(raw)), j


def test_the_router_over_two_int8_backends_answers_as_one_backend(
        card, tmp_path):
    """The port's router over two in-process int8 cnn backends on the
    card: each request, sent alone (a batch of its own), gets through the
    router the same reply, bit for bit, as straight from a third backend
    on the same checkpoint."""
    import json
    import threading
    import urllib.request

    from pytorch_distributed_mnist_tpu_torch.data.mnist import (
        synthetic_dataset,
    )
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
        params_to_jax,
    )
    from pytorch_distributed_mnist_tpu_torch.serve import router, server
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        save_params_checkpoint,
    )

    save_params_checkpoint(params_to_jax(init_params("cnn", 3)), epoch=0,
                           directory=str(tmp_path))
    started = []

    def serve(httpd):
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        started.append(httpd)
        return f"127.0.0.1:{httpd.server_address[1]}"

    def post(name, images):
        req = urllib.request.Request(
            f"http://{name}/predict",
            data=json.dumps({"images": images.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    names = [serve(server.create_server(server.build_parser().parse_args([
        "--model", "cnn", "--serve-precision", "int8", "--port", "0",
        "--device", "cuda", "--checkpoint-dir", str(tmp_path),
        "--require-checkpoint", "--no-reload"]))) for _ in range(3)]
    front = serve(router.create_router(router.build_parser().parse_args([
        "--backends", ",".join(names[:2]), "--port", "0",
        "--health-interval", "0.1"])))
    try:
        images, _ = synthetic_dataset(200, seed=9)
        sizes = [1, 3, 8, 17, 32, 40, 64, 35]
        start = 0
        for size in sizes * 2:
            x = images[start % 150:start % 150 + size]
            start += size
            got, want = json.loads(post(front, x)), json.loads(
                post(names[2], x))
            assert got["predictions"] == want["predictions"]
            assert got["model_epoch"] == want["model_epoch"] == 0
        stats = json.loads(urllib.request.urlopen(
            f"http://{front}/stats", timeout=60).read())
        assert all(r["requests"] > 0 for r in stats["backends"])
    finally:
        for httpd in started:
            httpd.shutdown()
            httpd.ctx.close()
            httpd.server_close()
