"""The port's MoE family (``models/moe.py``, ``parallel/moe_dispatch.py``,
``parallel/expert.py``) against the JAX package's, on the CPU.

Twins of ``tests/test_moe_dispatch.py`` (all 8 cases) and of the three
MoE cases of ``tests/test_moe_pipeline.py``: the same seeded numpy inputs
and the same JAX-initialised weights go through both packages. The
distributed cases run in gloo worlds of processes (one module fixture
starts them all at once): ``(data, expert)`` = (1, 2), (2, 2), (1, 4)
and (2, 1). Each rank feeds its data rank's rows, as the port's loader
does.

Tolerances (float32 everywhere): forward outputs rtol/atol 1e-5 and
gradients rtol 1e-4 / atol 1e-5 (the JAX tests' own bounds); train-step
params rtol 1e-4 / atol 1e-6 and loss sums rtol 1e-5 (the JAX EP test's);
routing masks bitwise.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.models.moe import SwitchMoE as JaxSwitchMoE
from pytorch_distributed_mnist_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from pytorch_distributed_mnist_tpu.parallel.moe_dispatch import (
    build_dispatch as jax_build_dispatch,
)
from pytorch_distributed_mnist_tpu.parallel.moe_dispatch import (
    load_balance_loss as jax_load_balance_loss,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.moe import SwitchMoE
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.parallel.expert import moe_ep_rules
from pytorch_distributed_mnist_tpu_torch.parallel.moe_dispatch import (
    build_dispatch,
    load_balance_loss,
    top1_mask_gate,
)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    P,
    state_shardings,
)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 180  # seconds the worlds of processes may take together
E = 8
WORLDS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4), "2x1": (2, 1)}
RAW = ("w1", "b1", "w2", "b2")

# One rank of a world: ``python -c _RANK coordinator n rank dir`` runs
# ``dir/job.json`` on the ``(data, expert)`` mesh and writes rank{r}.npz.
_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.models.moe import SwitchMoE
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    metric_all_reduce)
from pytorch_distributed_mnist_tpu_torch.parallel.expert import moe_ep_rules
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import shard_state
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as ck
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state)
from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

torch.set_num_threads(1)
coord, n, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
job = json.load(open(f"{out}/job.json"))
cpu = torch.device("cpu")
distributed.initialize_distributed(coord, n, rank, cpu)
dp, ep = job["shape"]
mesh = make_mesh(("data", "expert"), shape=(dp, ep), device=cpu)
d, e = mesh.data.rank, mesh.expert.rank
z = np.load(job["data"])
res = {}

def rows(a):
    b = a.shape[0] // dp
    return a[d * b:(d + 1) * b]

def layer(dispatch, cf):
    m = SwitchMoE(16, 8, 32, dispatch=dispatch, capacity_factor=cf,
                  mesh=mesh)
    k = 8 // ep
    for name, p in m.named_parameters():
        full = torch.from_numpy(z["moe/" + name])
        p.data = (full[e * k:(e + 1) * k] if name in ("w1", "b1", "w2", "b2")
                  else full).clone()
    return m

def sum_data(t):
    if mesh.data.group is not None:
        dist.all_reduce(t, group=mesh.data.group)
    return t

def gather_experts(t):
    if mesh.expert.group is None:
        return t
    out = torch.empty((ep * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.expert.group)
    return out

x = torch.from_numpy(z["x"])
for dispatch in ("capacity", "dense"):
    m = layer(dispatch, 8.0)
    o, _ = m(rows(x))
    res[f"{dispatch}/out"] = o.detach().numpy()
    torch.sin(o).sum().backward()
    for name, p in m.named_parameters():
        g = sum_data(p.grad.clone())
        if name in ("w1", "b1", "w2", "b2"):
            g = gather_experts(g)
        res[f"{dispatch}/grad/{name}"] = g.numpy()

for case in job["steps"]:
    tag = case["tag"]
    st = create_train_state(
        get_model("moe_mlp", mesh=mesh, dispatch=case["dispatch"],
                  capacity_factor=case["cf"]), 3, cpu,
        optimizer=case["optimizer"])
    ck.load_checkpoint(case["init"], st)
    if ep > 1:
        shard_state(st, mesh, moe_ep_rules())
    k = case["rows"]
    batch = {"image": torch.from_numpy(rows(z["image"][:k])),
             "label": torch.from_numpy(rows(z["label"][:k])).long(),
             "mask": torch.ones(k // dp)}
    ms = []
    for _ in range(case["steps"]):
        m_ = metric_all_reduce(
            train_step(st, batch, mesh.data, aux_weight=case["aux"]),
            mesh.data)
        ms.append([float(t) for t in m_])
    res[f"{tag}/metrics"] = np.array(ms)
    for name, arr in state_to_jax(st):
        if name.startswith("['params']"):
            res[f"{tag}/{name}"] = arr
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _x(b=64, c=16, seed=0):
    return np.random.default_rng(seed).normal(size=(b, c)).astype(np.float32)


def _jax_layer(dispatch, mesh=None, cf=float(E)):
    # capacity_factor=E -> capacity == local batch -> nothing can drop.
    return JaxSwitchMoE(num_experts=E, hidden=32, dispatch=dispatch,
                        capacity_factor=cf, mesh=mesh)


def _port_layer(variables, dispatch, cf=float(E)):
    m = SwitchMoE(16, E, 32, dispatch=dispatch, capacity_factor=cf)
    params = variables["params"]
    with torch.no_grad():
        for name, p in m.named_parameters():
            leaf = (params["router"][name.split(".")[1]]
                    if name.startswith("router.") else params[name])
            p.copy_(torch.from_numpy(np.array(leaf)))
    return m


def _flat_layer(variables) -> dict:
    params = variables["params"]
    out = {f"moe/router.{k}": np.asarray(v)
           for k, v in params["router"].items()}
    out.update({f"moe/{k}": np.asarray(params[k]) for k in RAW})
    return out


def _batch(n=32, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


def _jax_state(optimizer, path):
    st = jax_create_train_state(jax_get_model("moe_mlp"), jax.random.key(0),
                                optimizer=optimizer)
    return st, jax_ckpt.save_checkpoint(st, epoch=-1, best_acc=0.0,
                                        is_best=False, directory=str(path))


def _jax_params(state) -> dict:
    return {k: np.asarray(v) for k, v in jax_ckpt._leaves_with_names(
        {"params": state.params})}


# -- the worlds ---------------------------------------------------------------

STEP_CASES = {
    # tag: (optimizer, dispatch, cf, aux, steps, rows, worlds)
    "ep_step": ("sgd", "dense", 1.25, 0.0, 3, 16, ("1x2", "2x2", "1x4")),
    "cap_step": ("adam", "capacity", 2.0, 0.0, 1, 32, ("1x2", "2x2", "2x1")),
    "aux_step": ("sgd", "dense", 1.25, 0.1, 1, 32, ("2x2", "2x1")),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results, ``{world: [rank results]}``, and the
    inputs they were fed."""
    root = tmp_path_factory.mktemp("moe_worlds")
    x = _x()
    variables = _jax_layer("dense").init(jax.random.key(1), jnp.asarray(x))
    images, labels = _batch()
    inits = {opt: _jax_state(opt, root / f"init_{opt}")[1]
             for opt in ("sgd", "adam")}
    data = root / "data.npz"
    np.savez(data, x=x, image=images, label=labels, **_flat_layer(variables))
    procs = {}
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for name, shape in WORLDS.items():
        out = root / name
        out.mkdir()
        steps = [{"tag": tag, "optimizer": opt, "dispatch": disp, "cf": cf,
                  "aux": aux, "steps": n, "rows": k, "init": inits[opt]}
                 for tag, (opt, disp, cf, aux, n, k, on)
                 in STEP_CASES.items() if name in on]
        (out / "job.json").write_text(json.dumps(
            {"shape": shape, "data": str(data), "steps": steps}))
        port = launcher.free_port()
        n = shape[0] * shape[1]
        procs[name] = [subprocess.Popen(
            [sys.executable, "-c", _RANK, f"127.0.0.1:{port}", str(n),
             str(r), str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
    results = {}
    try:
        for name, ps in procs.items():
            texts = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in ps]
            for r, (p, text) in enumerate(zip(ps, texts)):
                assert p.returncode == 0, f"{name} rank {r}:\n{text}"
            results[name] = [dict(np.load(root / name / f"rank{r}.npz"))
                             for r in range(len(ps))]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    return {"results": results, "x": x, "variables": variables,
            "images": images, "labels": labels, "inits": inits,
            "root": root}


# -- tests/test_moe_dispatch.py twins -----------------------------------------

def test_build_dispatch_positions_and_drops():
    # 4 tokens all routed to expert 0, capacity 2: the first two keep
    # slots 0/1, the rest drop.
    row = [0.9] + [0.1 / (E - 1)] * (E - 1)
    probs = np.tile(np.array([row], np.float32), (4, 1))
    dispatch, combine = build_dispatch(torch.from_numpy(probs), capacity=2)
    assert dispatch.shape == (4, E, 2)
    np.testing.assert_array_equal(dispatch[:, 0].sum(-1).numpy(),
                                  [1, 1, 0, 0])
    np.testing.assert_allclose(combine[:2, 0].sum(-1).numpy(), 0.9,
                               rtol=1e-6)
    assert float(combine[2:].sum()) == 0.0
    jd, jc = jax_build_dispatch(jnp.asarray(probs), capacity=2)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(combine.numpy(), np.asarray(jc))


def test_capacity_matches_dense_when_no_drops():
    x = _x()
    variables = _jax_layer("dense").init(jax.random.key(1), jnp.asarray(x))
    ref, _ = _port_layer(variables, "dense")(torch.from_numpy(x))
    out, _ = _port_layer(variables, "capacity")(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    jout = _jax_layer("capacity").apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    # The routing decision itself, bitwise.
    probs = torch.softmax(_port_layer(variables, "dense").router(
        torch.from_numpy(x)), dim=-1)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ variables["params"]["router"][
        "kernel"] + variables["params"]["router"]["bias"], axis=-1)
    mask, _ = top1_mask_gate(probs)
    np.testing.assert_array_equal(
        mask.argmax(-1).numpy(), np.asarray(jnp.argmax(jprobs, -1)))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_capacity_distributed_matches_local(worlds, world):
    """Each rank's all-to-all dispatch == the no-mesh local program over
    its data rank's rows."""
    dp, ep = WORLDS[world]
    x, variables = worlds["x"], worlds["variables"]
    ref = np.asarray(_jax_layer("capacity").apply(variables, jnp.asarray(x)))
    b = x.shape[0] // dp
    for r, res in enumerate(worlds["results"][world]):
        d = r // ep
        np.testing.assert_allclose(res["capacity/out"],
                                   ref[d * b:(d + 1) * b], rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["dense/out"], ref[d * b:(d + 1) * b],
                                   rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_capacity_grads_match_dense(worlds, world):
    x, variables = worlds["x"], worlds["variables"]

    def loss(v):
        return jnp.sum(jnp.sin(_jax_layer("dense").apply(v, jnp.asarray(x))))

    g = jax.grad(loss)(variables)["params"]
    want = {f"router.{k}": np.asarray(v) for k, v in g["router"].items()}
    want.update({k: np.asarray(g[k]) for k in RAW})
    res = worlds["results"][world][0]
    for dispatch in ("capacity", "dense"):
        for name, value in want.items():
            np.testing.assert_allclose(res[f"{dispatch}/grad/{name}"], value,
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{dispatch} {name}")


def test_oversubscribed_tokens_drop_to_zero():
    x = _x(b=32)
    variables = _jax_layer("dense").init(jax.random.key(1), jnp.asarray(x))
    out, _ = _port_layer(variables, "capacity", cf=0.25)(torch.from_numpy(x))
    # at most E tokens can be served; the rest must be exactly zero rows
    served = np.count_nonzero(np.abs(out.detach().numpy()).sum(-1) > 1e-9)
    assert served <= E
    jout = _jax_layer("capacity", cf=0.25).apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)


def test_aux_loss_uniform_is_one_and_collapse_grows():
    uniform = torch.full((128, E), 1.0 / E)
    assert float(load_balance_loss(uniform)) == pytest.approx(1.0, rel=1e-6)
    collapsed = torch.nn.functional.one_hot(torch.zeros(128, dtype=torch.long),
                                            E).float()
    assert float(load_balance_loss(collapsed)) == pytest.approx(E, rel=1e-6)
    probs = np.random.default_rng(3).dirichlet(np.ones(E), 128).astype(
        np.float32)
    assert float(load_balance_loss(torch.from_numpy(probs))) == \
        pytest.approx(float(jax_load_balance_loss(jnp.asarray(probs))),
                      rel=1e-6)


def test_aux_loss_sown_by_module():
    x = _x()
    variables = _jax_layer("dense").init(jax.random.key(1), jnp.asarray(x))
    _, aux = _port_layer(variables, "dense")(torch.from_numpy(x),
                                             want_aux=True)
    assert np.isfinite(float(aux)) and float(aux) >= 1.0 - 1e-6
    _, inter = _jax_layer("dense").apply(variables, jnp.asarray(x),
                                         mutable=["intermediates"])
    (jaux,) = inter["intermediates"]["aux_loss"]
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("world", ["1x2", "2x2", "2x1"])
def test_moe_classifier_capacity_trains(worlds, world, tmp_path):
    """A train step of moe_mlp with capacity dispatch (cf 2.0) on the
    world's mesh == the JAX step on a mesh of the same token groups."""
    dp, ep = WORLDS[world]
    res = worlds["results"][world][0]
    images, labels = worlds["images"], worlds["labels"]
    jstate = jax_create_train_state(jax_get_model("moe_mlp"),
                                    jax.random.key(0))
    if ep > 1:
        from pytorch_distributed_mnist_tpu.parallel.expert import (
            moe_ep_rules as jax_rules,
        )
        from pytorch_distributed_mnist_tpu.parallel.tensor import (
            make_tp_train_step,
            shard_state,
        )

        mesh = jax_make_mesh(("data", "expert"), shape=(dp, ep),
                             devices=jax.devices()[:dp * ep])
        model = jax_get_model("moe_mlp", dispatch="capacity", mesh=mesh,
                              capacity_factor=2.0)
        jstate = jstate.replace(apply_fn=model.apply)
        jstate, sharding = shard_state(jstate, mesh, jax_rules("expert"))
        step = make_tp_train_step(mesh, sharding)
    else:
        # At ep == 1 the JAX CLI hands the model no mesh: the capacity
        # program runs over the global batch.
        model = jax_get_model("moe_mlp", dispatch="capacity",
                              capacity_factor=2.0)
        jstate = jstate.replace(apply_fn=model.apply)
        step = jax_make_train_step()
    jstate, m = step(jstate, {"image": jnp.asarray(images),
                              "label": jnp.asarray(labels)})
    loss_sum, correct, count = res["cap_step/metrics"][0]
    assert np.isfinite(loss_sum) and count == 32
    assert loss_sum == pytest.approx(float(m.loss_sum), rel=1e-5)
    assert correct == float(m.correct)
    want = _jax_params(jax.device_get(jstate))
    for name, value in want.items():
        # Adam's first step: -lr * g / (|g| + eps) turns an element's
        # rounding noise near g = 0 into a move of up to lr.
        np.testing.assert_allclose(res[f"cap_step/{name}"], value, rtol=0,
                                   atol=2e-5, err_msg=name)


# -- tests/test_moe_pipeline.py twins (the three MoE cases) --------------------

def test_moe_registered_and_trains(tmp_path):
    images, labels = _batch(16)
    jstate, path = _jax_state("adam", tmp_path)
    state = create_train_state(get_model("moe_mlp"), 3, CPU)
    port_ckpt.load_checkpoint(path, state)
    step = jax_make_train_step()
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels).long()}
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    losses, jlosses = [], []
    for _ in range(8):
        m = train_step(state, batch)
        losses.append(float(m.loss_sum) / float(m.count))
        jstate, jm = step(jstate, jbatch)
        jlosses.append(float(jm.loss_sum) / float(jm.count))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_ep_rules_shard_expert_dims():
    state = create_train_state(get_model("moe_mlp"), 0, CPU)
    sh = state_shardings(state, None, moe_ep_rules())
    assert sh["['params']['params']['moe']['w1']"] == P("expert", None, None)
    assert sh["['params']['params']['moe']['router']['kernel']"] == P()
    mu_w2 = sh["['opt_state'].inner_state[0].mu['params']['moe']['w2']"]
    assert mu_w2 == P("expert", None, None)


@pytest.mark.parametrize("world", ["1x2", "2x2", "1x4"])
def test_ep_step_equals_single_device_step(worlds, world):
    """DP x EP steps == single-device steps (routing included)."""
    images, labels = worlds["images"][:16], worlds["labels"][:16]
    s1 = jax_create_train_state(jax_get_model("moe_mlp"), jax.random.key(0),
                                optimizer="sgd")
    step = jax_make_train_step()
    for _ in range(3):
        s1, m1 = step(s1, {"image": jnp.asarray(images),
                           "label": jnp.asarray(labels)})
    res = worlds["results"][world][0]
    loss_sum, correct, _ = res["ep_step/metrics"][-1]
    np.testing.assert_allclose(loss_sum, float(m1.loss_sum), rtol=1e-5)
    assert int(correct) == int(m1.correct)
    for name, value in _jax_params(s1).items():
        np.testing.assert_allclose(res[f"ep_step/{name}"], value, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("world", ["2x2", "2x1"])
def test_aux_weighted_step_matches_jax(worlds, world):
    """``--moe-aux-weight``: f and p are global-batch means, so a rank's
    statistic sums over the data axis; the step equals JAX's."""
    images, labels = worlds["images"], worlds["labels"]
    s = jax_create_train_state(jax_get_model("moe_mlp"), jax.random.key(0),
                               optimizer="sgd")
    s, m = jax_make_train_step(aux_weight=0.1)(
        s, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    res = worlds["results"][world][0]
    np.testing.assert_allclose(res["aux_step/metrics"][0][0],
                               float(m.loss_sum), rtol=1e-5)
    for name, value in _jax_params(s).items():
        np.testing.assert_allclose(res[f"aux_step/{name}"], value, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# -- weights across the packages -----------------------------------------------

def test_a_jax_moe_checkpoint_resumes_in_the_port_and_back(tmp_path):
    jstate, path = _jax_state("adam", tmp_path / "jax")
    state = create_train_state(get_model("moe_mlp"), 3, CPU)
    port_ckpt.load_checkpoint(path, state)
    images, labels = _batch(16)
    train_step(state, {"image": torch.from_numpy(images),
                       "label": torch.from_numpy(labels).long()})
    jstate, _ = jax_make_train_step()(jstate, {"image": jnp.asarray(images),
                                               "label": jnp.asarray(labels)})
    back = port_ckpt.save_checkpoint(state, epoch=0, best_acc=0.0,
                                     is_best=False,
                                     directory=str(tmp_path / "port"))
    fresh = jax_create_train_state(jax_get_model("moe_mlp"),
                                   jax.random.key(5))
    restored, epoch, _ = jax_ckpt.load_checkpoint(back, fresh)
    assert epoch == 1
    got = _jax_params(restored)
    for name, value in _jax_params(jstate).items():
        np.testing.assert_allclose(got[name], value, rtol=0, atol=2e-5,
                                   err_msg=name)
