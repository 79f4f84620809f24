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
whole-optimizer runs are compared with ``rtol=1e-6``. That ``pow``
differs by at most one ulp of ``b**t`` (pinned below); on the card the
kernel forms its hypers with CUDA's ``powf``, which ``chip_smoke.py``
holds to ``adam_hypers`` there.
"""

import importlib
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from pytorch_distributed_mnist_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from pytorch_distributed_mnist_tpu_torch.ops import adam as port
from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
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
    assert port.adam_leaves.launches == 0  # CPU tensors never launch


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


# ---------------------------------------------------------- bias corrections

B1, B2 = np.float32(0.9), np.float32(0.999)


def _port_hyper():
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in
            {"learning_rate": 1e-3, **port.ADAM_DEFAULTS}.items()}


@jax.jit
def _optax_corrections(b1, b2, count):
    # optax.tree.bias_correction's ``1 - decay**count``, with the decays
    # the injected float32 arrays of inject_hyperparams(optax.adam) and
    # the int32 incremented count.
    return 1 - b1 ** count, 1 - b2 ** count


@jax.jit
def _pallas_corrections(b1, b2, count):
    # pallas_adam.update: ``b ** t`` with t the float32 count.
    t = count.astype(jnp.float32)
    return (1.0 - jnp.asarray(b1, jnp.float32) ** t,
            1.0 - jnp.asarray(b2, jnp.float32) ** t)


@jax.jit
def _powers(b1, b2, count):
    t = count.astype(jnp.float32)
    return b1 ** count, b2 ** count, b1 ** t, b2 ** t


def _ulp(x):
    return np.spacing(np.abs(np.float32(x)))


TINY = np.finfo(np.float32).tiny  # the smallest normal float32


def _check_step(t):
    """The port's ``b ** t`` and ``1 - b ** t`` against the reference's at
    one step; returns whether any of them differed at all. XLA:CPU flushes
    a subnormal result to zero (b1 ** t from t = 829 on), torch keeps it:
    there the port's ``b ** t`` must be subnormal, and ``1 - b ** t`` is 1
    on both sides."""
    hyper = _port_hyper()
    tt = torch.tensor(float(t))
    port_bc = [float(x) for x in port.bias_corrections(hyper, tt)]
    port_pow = [float(torch.pow(hyper[k], tt)) for k in ("b1", "b2")]
    count = jnp.asarray(t, jnp.int32)
    b1, b2 = jnp.asarray(B1), jnp.asarray(B2)
    refs_bc = [[float(x) for x in f(b1, b2, count)]
               for f in (_optax_corrections, _pallas_corrections)]
    p1_opt, p2_opt, p1_pal, p2_pal = (float(x) for x in _powers(b1, b2,
                                                                 count))
    differed = False
    for ref_pow in ((p1_opt, p2_opt), (p1_pal, p2_pal)):
        for got, want in zip(port_pow, ref_pow):
            if want == 0.0:
                assert 0.0 <= got < TINY, (t, got)
            else:
                assert abs(got - want) <= _ulp(want), (t, got, want)
            differed |= got != want
    for ref_bc in refs_bc:
        for got, want in zip(port_bc, ref_bc):
            # One ulp of b**t apart, then each side's rounding of 1 - b**t:
            # adjacent values round to within one ulp of the result.
            assert abs(got - want) <= _ulp(want), (t, got, want)
            differed |= got != want
    return differed


def test_the_reference_expressions_are_optax_s_bias_correction():
    # The expression _optax_corrections holds is the one behind
    # make_optimizer("adam"): optax's own bias_correction of a moment of
    # ones gives 1 / (1 - decay**count) with the same bits.
    for t in (1, 31, 168, 3000):
        count = jnp.asarray(t, jnp.int32)
        for decay, i in ((B1, 0), (B2, 1)):
            got = jax.jit(optax.tree.bias_correction)(
                jnp.float32(1.0), jnp.asarray(decay), count)
            want = 1 / _optax_corrections(jnp.asarray(B1), jnp.asarray(B2),
                                          count)[i]
            assert np.float32(got) == np.float32(want)


@pytest.mark.parametrize("t", [31, 168], ids=["t31-b1", "t168-b2"])
def test_bias_correction_pow_is_within_one_ulp_of_the_reference(t):
    # t = 31 (b1) and t = 168 (b2) are the first steps at which torch's
    # vectorized pow (a tensor of many t) rounds b**t one ulp away from
    # its scalar pow. The port calls pow on 0-dim tensors (the scalar
    # path); with jax 0.9.0 and torch 2.13 that matched XLA:CPU's pow bit
    # for bit at every normal b**t. A later release may round apart, so
    # only the bound is asserted.
    _check_step(t)


def test_bias_correction_pow_stays_within_one_ulp_over_3000_steps():
    for t in range(1, 3001):
        _check_step(t)


def test_torch_s_vectorized_pow_is_not_the_port_s():
    # What the port computes at step t is pow of 0-dim tensors; the same
    # pow over a tensor of steps may take another (vectorized) routine.
    # The port's value is the 0-dim one: bias_corrections at t equals
    # 1 - pow on the scalars, whatever the vectorized routine gives.
    hyper = _port_hyper()
    for t in (31, 168):
        tt = torch.tensor(float(t))
        scalar = [1.0 - torch.pow(hyper[k], tt) for k in ("b1", "b2")]
        got = port.bias_corrections(hyper, tt)
        assert all(torch.equal(a, b) for a, b in zip(got, scalar))
        ts = torch.arange(1, 3001, dtype=torch.float32)
        for k in ("b1", "b2"):
            vec = torch.pow(hyper[k], ts)[t - 1]
            assert abs(float(vec) - float(torch.pow(hyper[k], tt))) <= \
                _ulp(float(vec))


# ------------------------------------------------------ the multi-leaf path

def _leaves(shapes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        m = torch.from_numpy((rng.standard_normal(shape) * 0.1)
                             .astype(np.float32))
        v = torch.from_numpy(rng.uniform(0, 0.01, shape).astype(np.float32))
        out.append((p, g, m, v))
    return out


@pytest.mark.parametrize("model", ["cnn", "vit"])
def test_adam_leaves_plain_equals_the_per_leaf_update_bit_for_bit(model):
    shapes = [s for _, s in chip_smoke.leaf_shapes(model)]
    assert len(shapes) == chip_smoke.TRAIN_RUNS[model]["params"]
    hyper = _port_hyper()
    for t in (1, 31, 168):
        count = torch.tensor(t, dtype=torch.int32)
        leaves = _leaves(shapes, seed=t)
        got = [[x.clone() for x in leaf] for leaf in leaves]
        want = [[x.clone() for x in leaf] for leaf in leaves]
        port.adam_leaves([x[0] for x in got], [x[1] for x in got],
                         [x[2] for x in got], [x[3] for x in got], hyper,
                         count)
        h = port.adam_hypers(hyper, torch.tensor(float(t)))
        for p, g, m, v in want:
            port.adam_leaf_plain(p, g, m, v, h)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    assert port.adam_leaves.launches == 0


def test_fused_adam_over_the_vit_leaves_tracks_the_pallas_adam():
    shapes = [s for _, s in chip_smoke.leaf_shapes("vit")]
    rng = np.random.default_rng(7)
    keys = [f"leaf{i:02d}" for i in range(len(shapes))]  # flatten order
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in zip(keys, shapes)}
    jax_tx = jax_make_optimizer(1e-3, "adam_pallas")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    opt = make_optimizer(tp, lr=1e-3, optimizer="adam_pallas")
    # The moments' tolerance, as the leaf test states it: one rounding of
    # their terms per step (XLA:CPU fuses the multiply-adds), carried
    # through the later steps' decay.
    half_ulp = 2.0 ** -24
    m_bound = {k: 0.0 for k in keys}
    v_bound = {k: 0.0 for k in keys}
    b1, b2 = float(B1), float(B2)
    c1, c2 = float(1 - B1), float(1 - B2)
    for step in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in zip(keys, shapes)}
        for t, k in zip(tp, keys):
            m, v = (opt.state[t][x].numpy().astype(np.float64)
                    for x in ("mu", "nu"))
            g = grads[k].astype(np.float64)
            m_bound[k] = b1 * m_bound[k] + 2 * half_ulp * (
                np.abs(b1 * m) + np.abs(c1 * g))
            v_bound[k] = b2 * v_bound[k] + 2 * half_ulp * (
                np.abs(b2 * v) + np.abs(c2 * g * g))
        updates, js = jax_tx.update({k: jnp.asarray(v)
                                     for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        for t, k in zip(tp, keys):
            t.grad = torch.from_numpy(grads[k])
        opt.step()
    inner = js.inner_state[0]
    assert int(inner.count) == int(opt.inner_count) == 3
    for t, k in zip(tp, keys):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), **STEP_TOL)
        mu, nu = opt.state[t]["mu"].numpy(), opt.state[t]["nu"].numpy()
        assert np.all(np.abs(mu - np.asarray(inner.mu[k])) <= m_bound[k])
        assert np.all(np.abs(nu - np.asarray(inner.nu[k])) <= v_bound[k])


def _covered(numels):
    """How often the kernel's blocks, as launch_plan lays them out, touch
    each element of each leaf: the kernel's block -> (leaf, chunk) search,
    replayed."""
    hits = [np.zeros(n, dtype=np.int64) for n in numels]
    plan = port.launch_plan(numels)
    for leaves, first in plan:
        assert len(leaves) <= port.MAX_LEAVES
        assert first[0] == 0 and len(first) == len(leaves) + 1
        for b in range(first[-1]):
            i = max(j for j in range(len(leaves)) if first[j] <= b)
            n = numels[leaves[i]]
            start = (b - first[i]) * port.CHUNK
            assert start < n  # no block is idle
            hits[leaves[i]][start:min(n, start + port.CHUNK)] += 1
    return plan, hits


@pytest.mark.parametrize("numels", [
    [0], [1], [0, 1, 0], [1023, 1024, 1025], [3, 5, 7, 2049],
    [64] * 20 + [1605632, 10, 0],
    [5] * 64, [5] * 65, [1] * 129 + [0] * 3 + [4097],
], ids=["empty", "one", "empty-around-one", "chunk-edges", "unaligned",
        "cnn-like", "64-leaves", "65-leaves", "three-launches"])
def test_launch_plan_covers_every_element_exactly_once(numels):
    plan, hits = _covered(numels)
    for n, h in zip(numels, hits):
        assert np.all(h == 1), n
    live = sum(1 for n in numels if n > 0)
    assert len(plan) == math.ceil(live / port.MAX_LEAVES)
    assert sorted(i for leaves, _ in plan for i in leaves) == \
        [i for i, n in enumerate(numels) if n > 0]


def test_launch_plan_of_the_models_takes_one_launch():
    for model, blocks in (("cnn", 1593), ("vit", 122)):
        numels = [math.prod(s) for _, s in chip_smoke.leaf_shapes(model)]
        plan = port.launch_plan(numels)
        assert len(plan) == 1 and plan[0][1][-1] == blocks


def test_adam_leaves_refuses_overlapping_and_non_float32_leaves():
    hyper, count = _port_hyper(), torch.tensor(1, dtype=torch.int32)
    buf = torch.zeros(30)

    def zeros():
        return [torch.zeros(10), torch.zeros(10)]

    with pytest.raises(ValueError, match="share storage"):
        port.adam_leaves([buf[:10], buf[5:15]], zeros(), zeros(), zeros(),
                         hyper, count)
    p = torch.zeros(10)
    with pytest.raises(ValueError, match="share storage"):
        port.adam_leaves([p, p], zeros(), zeros(), zeros(), hyper, count)
    m = torch.zeros(10)
    with pytest.raises(ValueError, match="share storage"):
        port.adam_leaves([torch.zeros(10)], [torch.zeros(10)], [m], [m],
                         hyper, count)
    # Neighbours that only touch are fine.
    port.adam_leaves([buf[:10], buf[10:20]], zeros(), zeros(), zeros(),
                     hyper, count)
    with pytest.raises(ValueError, match="float32"):
        port.adam_leaves([torch.zeros(10, dtype=torch.float64)],
                         [torch.zeros(10)], [torch.zeros(10)],
                         [torch.zeros(10)], hyper, count)
    with pytest.raises(ValueError, match="float32"):
        port.adam_leaves([torch.zeros(10)],
                         [torch.zeros(10, dtype=torch.bfloat16)],
                         [torch.zeros(10)], [torch.zeros(10)], hyper, count)
    with pytest.raises(ValueError, match="int32 scalar step count"):
        port.adam_leaves([torch.zeros(10)], [torch.zeros(10)],
                         [torch.zeros(10)], [torch.zeros(10)], hyper,
                         torch.tensor(1.0))
    with pytest.raises(ValueError, match="cuda"):
        port.LeafTable([torch.zeros(10)], [torch.zeros(10)],
                       [torch.zeros(10)])
    assert port.adam_leaves.launches == 0


def test_the_kernel_constants_and_entry_match_the_wrapper():
    with open(cuda_build.source_path("adam")) as f:
        source = f.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("kThreads") * constant("kVec") == port.CHUNK
    assert constant("kMaxLeaves") == port.MAX_LEAVES
    (symbol,) = cuda_build.KERNELS["adam"]
    assert symbol == "adam_leaves_launch"
    params = source.split(f'extern "C" int {symbol}(', 1)[1] \
        .split(")", 1)[0]
    assert params.count(",") + 1 == \
        len(cuda_build.KERNELS["adam"][symbol][0]) == 13
    # No fast math: the update's bits rest on every rounding.
    assert not any("fast" in flag for flag in cuda_build.NVCC_FLAGS)
