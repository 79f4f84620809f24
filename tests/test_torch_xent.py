"""The port's cross-entropy (``ops/xent.py``, ``ops/loss.py``) against the
JAX package's fused Pallas kernels and its XLA loss.

On the CPU the port's wrappers take their plain versions; the JAX kernels
run in Pallas interpret mode, as the JAX package's own tests run them.
The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerance: ``rtol=1e-6, atol=1e-6`` wherever the two sides reduce a row,
because the sum of ``exp`` (and the log-sum-exp) is taken in another
order; everything else is exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.ops import loss as jax_loss
from pytorch_distributed_mnist_tpu_torch.ops import loss as port_loss
from pytorch_distributed_mnist_tpu_torch.ops import xent as port

jax_xent = importlib.import_module(
    "pytorch_distributed_mnist_tpu.ops.pallas.xent")

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(b, c, seed, tie=True):
    """Logits (scale 3), labels, upstream gradient; with ``tie`` row 0 is
    saturated at the exact tie (``lse == picked`` in float32) and row 1
    is ``[1e4, 0, ...]``."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c, size=b).astype(np.int32)
    g = rng.uniform(0.1, 1.0, size=b).astype(np.float32)
    if tie:
        logits[0] = 0.0
        logits[0, 3] = 20.0
        labels[0] = 3
        if b > 1:
            logits[1] = 0.0
            logits[1, 0] = 1e4
            labels[1] = 0
    return logits, labels, g


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("c", [10, 128])
@pytest.mark.parametrize("b", [1, 7, 130])
def test_plain_forward_matches_jax_kernel(b, c):
    logits, labels, _ = _inputs(b, c, seed=b * 131 + c)
    want_loss, want_lse = jax_xent._fwd_impl(
        jnp.asarray(logits), jnp.asarray(labels), interpret=True)
    loss, lse = port.xent_fwd(_t(logits), _t(labels).long())
    assert loss.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:b, 0],
                               **TOL)
    # The tie row clamps to exactly 0 on both sides.
    assert float(loss[0]) == 0.0 == float(want_loss[0])
    assert port.xent_fwd.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("c", [10, 128])
@pytest.mark.parametrize("b", [1, 7, 130])
def test_plain_backward_matches_jax_grad(b, c):
    logits, labels, g = _inputs(b, c, seed=b * 17 + c)
    _, vjp = jax.vjp(
        lambda l: jax_xent.fused_cross_entropy_per_example(
            l, jnp.asarray(labels)), jnp.asarray(logits))
    (want,) = vjp(jnp.asarray(g))
    x = _t(logits).clone().requires_grad_(True)
    port.fused_cross_entropy_per_example(x, _t(labels)).backward(_t(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)
    # The tie gate: at lse == picked (both 20 in float32) the reference
    # differentiates max(x, 0) with factor 0.5, so row 0 is half of
    # (exp(l - lse) - onehot) * g, in float32.
    p = np.exp(logits[0] - np.float32(20.0))
    onehot = np.zeros(c, np.float32)
    onehot[3] = 1.0
    half = np.float32(0.5) * (p - onehot) * g[0]
    np.testing.assert_allclose(x.grad[0].numpy(), half, rtol=1e-6,
                               atol=1e-12)
    assert float(x.grad[0, 0]) != 0.0


def test_backward_keeps_the_logits_dtype():
    logits, labels, _ = _inputs(5, 10, seed=3, tie=False)
    x = _t(logits).bfloat16().requires_grad_(True)
    port.fused_cross_entropy(x, _t(labels)).backward()
    assert x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_fused_mean_and_masked_mean_match_jax(masked):
    logits, labels, _ = _inputs(9, 10, seed=5)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0], np.float32) if masked \
        else None
    want = jax_xent.fused_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = port.fused_cross_entropy(
        _t(logits), _t(labels), None if mask is None else _t(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _recording_bwd(monkeypatch):
    """Swaps a recorder of each ``g`` stride into the wrapper the fused
    loss's backward calls; returns the list it fills."""
    seen, bwd = [], port.xent_bwd

    def recording(logits, labels, lse, g):
        seen.append(g.stride(0))
        return bwd(logits, labels, lse, g)

    monkeypatch.setattr(port, "xent_bwd", recording)
    return seen


@pytest.mark.parametrize("masked", [False, True])
def test_a_stride_0_cotangent_gives_the_contiguous_gradient_bit_for_bit(
        monkeypatch, masked):
    """The world step's objective (a per-example sum over the count)
    hands the backward a broadcast cotangent, stride 0; the backward
    copies it and gives the contiguous cotangent's gradient bit for bit,
    which is JAX's fused gradient (interpret mode) within the row
    tolerance."""
    b = 9
    logits, labels, _ = _inputs(b, 10, seed=15)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0], np.float32) if masked \
        else np.ones(b, np.float32)
    live = _t(mask)
    seen = _recording_bwd(monkeypatch)
    x = _t(logits).clone().requires_grad_(True)
    per_ex = port.fused_cross_entropy_per_example(x, _t(labels))
    num = (per_ex * live).sum() if masked else per_ex.sum()
    (num / torch.clamp(live.sum(), min=1.0)).backward()
    assert seen == [1]
    g = torch.full((b,), 1.0) / torch.clamp(live.sum(), min=1.0)
    if masked:
        g = g * live
    y = _t(logits).clone().requires_grad_(True)
    port.fused_cross_entropy_per_example(y, _t(labels)).backward(
        g.contiguous())
    assert seen == [1, 1]
    assert torch.equal(x.grad, y.grad)
    want = jax.grad(lambda l: jax_xent.fused_cross_entropy(
        l, jnp.asarray(labels), jnp.asarray(mask) if masked else None))(
        jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)
    # The mean itself (masked_mean) matches JAX's gradient too.
    z = _t(logits).clone().requires_grad_(True)
    port.fused_cross_entropy(z, _t(labels),
                             _t(mask) if masked else None).backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want), **TOL)


def test_a_cotangent_of_another_stride_is_copied_first(monkeypatch):
    """A column of a stacked loss arrives at stride 2; the backward
    copies it and gives the contiguous cotangent's gradient."""
    logits, labels, _ = _inputs(6, 10, seed=16)
    seen = _recording_bwd(monkeypatch)
    x = _t(logits).clone().requires_grad_(True)
    per_ex = port.fused_cross_entropy_per_example(x, _t(labels))
    weights = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    (torch.stack([per_ex, torch.zeros(6)], dim=1) * weights).sum().backward()
    assert seen == [1]
    y = _t(logits).clone().requires_grad_(True)
    port.fused_cross_entropy_per_example(y, _t(labels)).backward(
        weights[:, 0].contiguous())
    assert torch.equal(x.grad, y.grad)


# The kernels' layout edges (csrc/xent.cu): one class, two (the
# backward's one lane of two), an odd C (the backward's two classes a
# lane not neighbours), the group sizes 16 and 32, and the first C a
# warp owns.
@pytest.mark.parametrize("c", [1, 2, 3, 15, 16, 32, 33])
def test_plain_loss_and_gradient_match_jax_at_the_layout_edges(c):
    logits, labels, g = _inputs(7, c, seed=19 * c, tie=False)
    want_loss, want_lse = jax_xent._fwd_impl(
        jnp.asarray(logits), jnp.asarray(labels), interpret=True)
    loss, lse = port.xent_fwd(_t(logits), _t(labels).long())
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:7, 0],
                               **TOL)
    _, vjp = jax.vjp(
        lambda l: jax_xent.fused_cross_entropy_per_example(
            l, jnp.asarray(labels)), jnp.asarray(logits))
    (want,) = vjp(jnp.asarray(g))
    x = _t(logits).clone().requires_grad_(True)
    port.fused_cross_entropy_per_example(x, _t(labels)).backward(_t(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)


def test_check_refuses_a_g_of_stride_2_or_0():
    logits, labels, g = _inputs(5, 10, seed=17)
    l, lab = _t(logits), _t(labels).long()
    _, lse = port.xent_fwd(l, lab)
    wide = torch.from_numpy(np.repeat(g, 2))
    with pytest.raises(ValueError, match="contiguous per-row"):
        port.xent_bwd(l, lab, lse, wide[::2])
    with pytest.raises(ValueError, match="contiguous per-row"):
        port.xent_bwd(l, lab, torch.from_numpy(np.repeat(
            lse.numpy(), 2))[::2], _t(g))
    broadcast = torch.tensor(float(g[0])).expand(5)
    assert broadcast.stride(0) == 0
    with pytest.raises(ValueError, match="contiguous per-row"):
        port.xent_bwd(l, lab, lse, broadcast)
    with pytest.raises(ValueError, match="contiguous per-row"):
        port.xent_bwd(l, lab, lse[:1].expand(5), _t(g))


def test_all_masked_batch_gives_zero():
    logits, labels, _ = _inputs(4, 10, seed=6)
    got = port.fused_cross_entropy(_t(logits), _t(labels), torch.zeros(4))
    assert float(got) == 0.0


def test_129_classes_raise_on_both_sides():
    logits, labels, _ = _inputs(3, 129, seed=7, tie=False)
    with pytest.raises(ValueError, match="up to 128 classes"):
        jax_xent.fused_cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels))
    with pytest.raises(ValueError, match="up to 128 classes"):
        port.fused_cross_entropy(_t(logits), _t(labels))
    with pytest.raises(ValueError, match="up to 128 classes"):
        port.xent_fwd(_t(logits), _t(labels).long())


def test_wrappers_refuse_what_the_kernel_does_not_take():
    logits, labels, _ = _inputs(4, 10, seed=8, tie=False)
    with pytest.raises(ValueError, match="int64 labels"):
        port.xent_fwd(_t(logits), _t(labels))  # int32
    with pytest.raises(ValueError, match="float32 logits"):
        port.xent_fwd(_t(logits).double(), _t(labels).long())
    with pytest.raises(ValueError, match="unit stride"):
        port.xent_fwd(_t(logits).t().contiguous().t(), _t(labels).long())


@pytest.mark.parametrize("b,c", [(7, 10), (33, 128)])
def test_xla_loss_matches_jax_including_the_tie_gradient(b, c):
    logits, labels, g = _inputs(b, c, seed=b + c)
    want = jax_loss.cross_entropy_per_example(jnp.asarray(logits),
                                              jnp.asarray(labels))
    _, vjp = jax.vjp(lambda l: jax_loss.cross_entropy_per_example(
        l, jnp.asarray(labels)), jnp.asarray(logits))
    (want_grad,) = vjp(jnp.asarray(g))
    x = _t(logits).clone().requires_grad_(True)
    got = port_loss.cross_entropy_per_example(x, _t(labels))
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)
    # Row 0 sits at the tie: torch.maximum halves its gradient there, as
    # the reference's max(x, 0) does (clamp would pass it whole).
    assert float(got[0].detach()) == 0.0
    other = x.grad[0, 0].item()
    assert other == pytest.approx(0.5 * float(g[0]) * np.exp(-20.0),
                                  rel=1e-5)


def test_set_loss_impl_dispatches_and_refuses_unknown():
    logits, labels, _ = _inputs(6, 10, seed=9)
    mask = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.float32)
    try:
        port_loss.set_loss_impl("fused")
        assert port_loss.get_loss_impl() == "fused"
        fused = port_loss.cross_entropy(_t(logits), _t(labels), mask)
        port_loss.set_loss_impl("xla")
        plain = port_loss.cross_entropy(_t(logits), _t(labels), mask)
        np.testing.assert_allclose(float(fused), float(plain), **TOL)
        with pytest.raises(ValueError, match="unknown loss impl"):
            port_loss.set_loss_impl("triton")
    finally:
        port_loss.set_loss_impl("xla")
