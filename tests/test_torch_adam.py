"""The port's optimizers (``ops/adam.py``, ``train/state.py``) against the
JAX package's fused Pallas Adam and optax.

On the CPU the port's wrapper takes its plain version; the JAX kernel
runs in Pallas interpret mode, as the JAX package's own tests run it.
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances: the leaf update is elementwise, in the same order on both
sides, but XLA:CPU fuses two of the reference kernel's multiply-adds
(pinned below), so the moments agree to one rounding of their terms and
the params to ``rtol=1e-6``. Across optimizer steps the bias corrections
``1 - b**t`` also come from ``pow`` in XLA and in PyTorch, so
whole-optimizer runs are compared with ``rtol=1e-6``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_mnist_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from pytorch_distributed_mnist_tpu_torch.ops import adam as port
from pytorch_distributed_mnist_tpu_torch.train.state import (
    OptaxAdam,
    OptaxSGD,
    make_optimizer,
)

jax_adam = importlib.import_module(
    "pytorch_distributed_mnist_tpu.ops.pallas.adam")

torch.set_num_threads(2)
STEP_TOL = dict(rtol=1e-6, atol=1e-9)
SHAPES = [(3, 3, 1, 32), (32,), (12544, 8), (10,), (1,), (1000, 3)]


def _hypers(t, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """The float32[9] vector as the reference's injected path computes it:
    float32 scalars, float32 complements and bias corrections."""
    f = np.float32
    b1, b2, t = f(b1), f(b2), f(t)
    return np.array([lr, b1, b2, eps, f(1) / (f(1) - b1 ** t),
                     f(1) / (f(1) - b2 ** t), f(1) - b1, f(1) - b2,
                     eps_root], np.float32)


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (rng.uniform(0, 0.01, shape)).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("t", [1, 2, 10])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_leaf_update_matches_jax_kernel(shape, t):
    # XLA:CPU contracts the kernel's moment updates into fused
    # multiply-adds (pinned in the next test); the port rounds every
    # product as the kernel's source writes it. So m and v agree to one
    # rounding of their terms, and p to rtol 1e-6.
    p, g, m, v = _leaf(shape, seed=len(shape) * 100 + t)
    h = _hypers(t)
    delta, m_want, v_want = jax_adam.fused_adam_leaf(
        jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), jnp.asarray(h),
        interpret=True)
    p_want = np.asarray(optax.apply_updates(jnp.asarray(p), delta))
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    port.adam_leaf(tp, torch.from_numpy(g), tm, tv, torch.from_numpy(h))
    b1, b2, c1, c2 = h[1], h[2], h[6], h[7]
    # One rounding of the larger term: the fused and the unfused sums
    # differ by at most that (the result itself may be far smaller).
    half_ulp = np.float32(2.0 ** -24)
    m_bound = half_ulp * (np.abs(b1 * m) + np.abs(c1 * g)) * 2
    v_bound = half_ulp * (np.abs(b2 * v) + np.abs(c2 * g * g)) * 2
    assert np.all(np.abs(tm.numpy() - np.asarray(m_want)) <= m_bound)
    assert np.all(np.abs(tv.numpy() - np.asarray(v_want)) <= v_bound)
    np.testing.assert_allclose(tp.numpy(), p_want, rtol=1e-6, atol=1e-9)
    assert port.adam_leaf.launches == 0  # CPU tensors never launch


def test_xla_cpu_contracts_the_moment_updates_the_port_does_not():
    # The reference kernel writes m = b1*m + c1*g and v = b2*v + c2*g*g.
    # Run on the CPU, XLA computes fma(c1, g, b1*m) and fma(b2, v,
    # c2*g*g) (one rounding fewer); the port, on the CPU and on the card
    # (csrc/adam.cu), rounds each product and each sum. Both pinned here
    # bit for bit (float64 holds every float32 product exactly).
    p, g, m, v = _leaf((3000,), seed=0)
    h = _hypers(1)
    b1, b2, c1, c2 = h[1], h[2], h[6], h[7]
    _, m_jax, v_jax = jax_adam.fused_adam_leaf(
        jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), jnp.asarray(h),
        interpret=True)
    f64 = np.float64
    np.testing.assert_array_equal(
        np.asarray(m_jax),
        (f64(c1) * g.astype(f64) + (b1 * m).astype(f64)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(v_jax),
        (f64(b2) * v.astype(f64) + ((c2 * g) * g).astype(f64)
         ).astype(np.float32))
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    port.adam_leaf(tp, torch.from_numpy(g), tm, tv, torch.from_numpy(h))
    np.testing.assert_array_equal(tm.numpy(), b1 * m + c1 * g)
    np.testing.assert_array_equal(tv.numpy(), b2 * v + (c2 * g) * g)
    assert not np.array_equal(tm.numpy(), np.asarray(m_jax))


def test_hypers_vector_matches_the_reference_arithmetic():
    hyper = {k: torch.tensor(v, dtype=torch.float32) for k, v in
             {"learning_rate": 1e-3, **port.ADAM_DEFAULTS}.items()}
    for t in (1, 2, 3, 10, 1000):
        got = port.adam_hypers(hyper, torch.tensor(float(t)))
        np.testing.assert_allclose(got.numpy(), _hypers(t), rtol=1e-7,
                                   atol=0)
        # The complements are float32 subtractions, bit for bit.
        assert got[6].item() == np.float32(1) - np.float32(0.9)
        assert got[7].item() == np.float32(1) - np.float32(0.999)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"bias": rng.standard_normal((7,)).astype(np.float32),
            "kernel": rng.standard_normal((13, 5)).astype(np.float32)}


def _run_both(jax_tx, port_opt_of, steps=3, lrs=(1e-3, 1e-3, 1e-4)):
    """``steps`` updates on both sides from the same params and grads,
    with the learning rate written between steps; returns the JAX
    (params, opt_state) and the port's (params, optimizer)."""
    params = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("bias", "kernel")]
    opt = port_opt_of(tp)
    for i in range(steps):
        grads = _tree(10 + i)
        hyper = dict(js.hyperparams)
        hyper["learning_rate"] = jnp.asarray(lrs[i], jnp.float32)
        js = js._replace(hyperparams=hyper)
        updates, js = jax_tx.update({k: jnp.asarray(v)
                                     for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        opt.set_learning_rate(lrs[i])
        for t, k in zip(tp, ("bias", "kernel")):
            t.grad = torch.from_numpy(grads[k])
        opt.step()
    return jp, js, tp, opt


@pytest.mark.parametrize("name", ["adam_pallas", "adam"])
def test_adam_optimizers_track_optax_over_three_steps(name):
    jax_tx = jax_make_optimizer(1e-3, name)
    jp, js, tp, opt = _run_both(
        jax_tx, lambda ps: make_optimizer(ps, lr=1e-3, optimizer=name))
    assert isinstance(opt, port.FusedAdam)
    assert isinstance(opt, OptaxAdam) == (name == "adam")
    inner = js.inner_state[0]
    assert int(js.count) == int(opt.count) == 3
    assert int(inner.count) == int(opt.inner_count) == 3
    for t, k in zip(tp, ("bias", "kernel")):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), **STEP_TOL)
        np.testing.assert_allclose(opt.state[t]["mu"].numpy(),
                                   np.asarray(inner.mu[k]), **STEP_TOL)
        np.testing.assert_allclose(opt.state[t]["nu"].numpy(),
                                   np.asarray(inner.nu[k]), **STEP_TOL)
    for key, value in opt.hyperparams.items():
        assert value.dtype == torch.float32
        assert value.item() == float(js.hyperparams[key])


def test_sgd_tracks_optax_over_three_steps():
    jax_tx = jax_make_optimizer(1e-2, "sgd", momentum=0.9,
                                weight_decay=1e-4)
    jp, js, tp, opt = _run_both(
        jax_tx, lambda ps: make_optimizer(ps, lr=1e-2, optimizer="sgd",
                                          momentum=0.9, weight_decay=1e-4),
        lrs=(1e-2, 1e-2, 1e-3))
    assert isinstance(opt, OptaxSGD)
    assert int(js.count) == int(opt.count) == 3
    trace = js.inner_state[1][0].trace
    for t, k in zip(tp, ("bias", "kernel")):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), **STEP_TOL)
        np.testing.assert_allclose(opt.state[t]["trace"].numpy(),
                                   np.asarray(trace[k]), **STEP_TOL)
    assert list(opt.hyperparams) == list(js.hyperparams) == ["learning_rate"]


def test_second_moment_complement_is_a_float32_subtraction():
    # With gradient 1 from zero moments, one step leaves nu = 1 - b2. On
    # the reference's CLI path b2 is an injected float32 array, so that is
    # f32(1) - f32(0.999) = 0.0009999871, not f32(0.001).
    want = np.float32(1) - np.float32(0.999)
    assert want != np.float32(0.001)
    jax_tx = jax_make_optimizer(1e-3, "adam_pallas")
    js = jax_tx.init({"w": jnp.zeros(4)})
    _, js = jax_tx.update({"w": jnp.ones(4)}, js, {"w": jnp.zeros(4)})
    assert np.all(np.asarray(js.inner_state[0].nu["w"]) == want)
    p = torch.zeros(4)
    opt = port.FusedAdam([p], lr=1e-3)
    p.grad = torch.ones(4)
    opt.step()
    assert torch.all(opt.state[p]["nu"] == torch.tensor(want))


def test_leaf_wrapper_refuses_what_the_kernel_does_not_take():
    p, g, m, v = (torch.from_numpy(x) for x in _leaf((4, 3), seed=1))
    h = torch.from_numpy(_hypers(1))
    with pytest.raises(ValueError, match="float32"):
        port.adam_leaf(p.double(), g, m, v, h)
    with pytest.raises(ValueError, match="shape"):
        port.adam_leaf(p, g[:2], m, v, h)
    with pytest.raises(ValueError, match=r"float32\[9\]"):
        port.adam_leaf(p, g, m, v, h[:8])
    opt = port.FusedAdam([torch.zeros(2)], lr=1e-3)
    with pytest.raises(RuntimeError, match="no gradient"):
        opt.step()
