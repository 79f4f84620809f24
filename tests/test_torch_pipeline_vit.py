"""The port's pipelined ViT (``parallel/pipeline_vit.py``) against the JAX
package's, on the CPU: twins of ``tests/test_pipeline_vit.py`` (its
``slow`` cases at small size included), of the pipeline cases of
``tests/test_device_gather.py`` and ``tests/test_loss.py``, and the
pipeline's checkpoints across the two packages.

The port runs in one gloo world of 8 processes, started by a module
fixture beside two CLI worlds of 2: the world builds the ``('data',
'stage')`` meshes of the JAX tests, (2, 4), (4, 2) and the pure pipeline
(1, 8), one after another, each rank on its data rank's rows. The JAX
side runs as its own tests do, on its 8 virtual CPU devices. The
pipelined program is the ViT: forward rtol/atol 1e-5 against the JAX
model and pipeline; gradients rtol 1e-4 / atol 1e-5 against the JAX
model's (``--remat`` too); float32 SGD steps loss sums rtol 1e-5, params
rtol 1e-4 / atol 1e-6 against the JAX pipelined steps and the port's one
process; PP x ZeRO-1 equal to the pipeline alone within rtol 1e-6 / atol
1e-7, and to the JAX PP x ZeRO-1 steps within Adam's first-step noise.

The CLI worlds run ``--pipeline-stages 2 --optimizer-sharding zero1
--loss fused --attention flash --optimizer adam_pallas`` with ``--dtype
f32`` from the same npz as the JAX CLI run of those flags on its 8
devices (train and test loss rtol 1e-4, accuracy within one example, as
``tests/test_torch_vit_cli.py`` holds the two CLIs), and again with
``--epoch-gather device``, which must print the same epoch exactly.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.loader import (
    make_global_batch as jax_global_batch,
)
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.ops import loss as jax_loss
from pytorch_distributed_mnist_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_vit import (
    create_pipelined_vit_state as jax_create_pp_state,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_vit import (
    make_stage_forward_fns as jax_make_stage_forward_fns,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_vit import (
    merge_vit_params as jax_merge,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_vit import (
    split_stage_params as jax_split_stage_params,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_vit import (
    split_vit_params as jax_split,
)
from pytorch_distributed_mnist_tpu.parallel.zero import (
    shard_state_zero as jax_shard_state_zero,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
    DataAxis,
    GridMesh,
    make_mesh,
)
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
    create_pipelined_vit_state,
    make_pipelined_vit_apply,
    make_stage_forward_fns,
    merge_vit_params,
    pipeline_stage_rules,
    split_stage_params,
    split_vit_params,
)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import P
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 240  # seconds the world (and each CLI world) may take
QKV = "['params']['blocks']['attn']['qkv']['kernel']"
MU_QKV = "['opt_state'].inner_state[0].mu['blocks']['attn']['qkv']['kernel']"
TRACE_QKV = ("['opt_state'].inner_state[1][0].trace['blocks']['attn']['qkv']"
             "['kernel']")
# The meshes of the JAX forward test: (data, stage) and the depth. The
# world keeps the last one's mesh and state for the checkpoints and the
# SGD steps.
FORWARDS = {"pp8": ((1, 8), 8), "dp4_pp2": ((4, 2), 4),
            "dp2_pp4": ((2, 4), 4)}

# One rank: ``python -c _RANK coordinator n rank dir`` runs dir/job.json.
_RANK = r"""
import json, os, sys, time
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    jax_leaf_name, jax_param_order, state_to_jax)
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    metric_all_reduce)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
    create_pipelined_vit_state)
from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
    shard_state_zero)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as ck
from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

torch.set_num_threads(1)
coord, n, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
job = json.load(open(f"{out}/job.json"))
cpu = torch.device("cpu")
distributed.initialize_distributed(coord, n, rank, cpu)
z = np.load(job["data"])
res = {}

def mesh_of(shape):
    return make_mesh(("data", "stage"), shape=tuple(shape), device=cpu)

def batch(mesh):
    dp, d = mesh.data.size, mesh.data.rank
    b = z["image"].shape[0] // dp
    rows = slice(d * b, (d + 1) * b)
    return {"image": torch.from_numpy(z["image"][rows]),
            "label": torch.from_numpy(z["label"][rows]).long()}

def state(mesh, init, depth=4, place=True, **kw):
    opt = "adam" if "adam" in init else "sgd"
    st, sh = create_pipelined_vit_state(
        get_model("vit", compute_dtype=torch.float32, depth=depth, **kw), 0,
        mesh, cpu, data_axis="data", optimizer=opt, place=False)
    ck.load_checkpoint(job[init], st)
    if place:
        from pytorch_distributed_mnist_tpu_torch.parallel import pipeline_vit
        pipeline_vit.place_state(st, mesh, sh)
    return st, sh

def record(tag, st, ms):
    res[f"{tag}/metrics"] = np.array(ms)
    for name, arr in state_to_jax(st):
        res[f"{tag}/{name}"] = arr

def steps(tag, st, mesh, k):
    ms = []
    for _ in range(k):
        m = metric_all_reduce(train_step(st, batch(mesh), mesh.data),
                              mesh.data)
        ms.append([float(t) for t in m])
    record(tag, st, ms)

def grads(tag, st):
    # The reduced gradients the last step left in the flat buffer, each
    # gathered whole over its placement (a collective).
    named = dict(st.model.named_parameters())
    for name, view in zip(jax_param_order(named), st.grad_buffer.views):
        leaf = jax_leaf_name(name, "")
        pl = st.placements.get(leaf)
        g = view if pl is None else pl.gather(view)
        if g.dim() == 4:
            g = g.permute(2, 3, 1, 0)
        res[f"{tag}/{leaf}"] = g.numpy().copy()

for tag, (shape, depth) in job["forwards"].items():
    mesh = mesh_of(shape)
    st, _ = state(mesh, f"init_sgd{depth}", depth)
    with torch.no_grad():
        res[f"fwd/{tag}"] = st.model(batch(mesh)["image"]).numpy()

# The (2, 4) mesh and state of the last forward.
pl = st.placements[job["qkv"]]
res["placed/qkv"] = np.array([tuple(st.model.blocks.attn.qkv.kernel.shape),
                              pl.shape])
res["placed/spec"] = np.array([str(tuple(st.placements[k].spec))
                               for k in (job["qkv"], job["trace_qkv"])])
for layout, kw in (("npz", {}), ("sharded", {"layout": "sharded"}),
                   ("delta", {"publish": "delta", "chunk_mb": 0.01})):
    ck.save_checkpoint(st, epoch=0, best_acc=0.0, is_best=False,
                       directory=f"{out}/{layout}",
                       parallel_layout={"pipeline": 4}, **kw)
steps("pp_sgd", st, mesh, 3)
for remat in (False, True):
    st, _ = state(mesh, "init_sgd4", remat=remat)
    m = metric_all_reduce(train_step(st, batch(mesh), mesh.data), mesh.data)
    res[f"remat{int(remat)}/metrics"] = np.array([[float(t) for t in m]])
    grads(f"remat{int(remat)}", st)
for zero in (False, True):
    st, sh = state(mesh, "init_adam4", place=not zero)
    if zero:
        _, zsh = shard_state_zero(st, mesh, base_sharding=sh, level=1)
        res["zero/specs"] = np.array([str(tuple(s)) for s in zsh.values()])
    steps(f"adam_zero{int(zero)}", st, mesh, 2)
# The JAX checkpoints are written while this world runs.
ready = f"{out}/jax_ckpts.json"
for _ in range(int(job["wait"] / 0.2)):
    if os.path.exists(ready):
        break
    time.sleep(0.2)
st, _ = state(mesh, "init_sgd4")
for layout, path in json.load(open(ready)).items():
    ck.load_checkpoint(path, st)
    record(f"jax_{layout}", st, [])
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _f32_vit(depth=4, **kw):
    return jax_get_model("vit", compute_dtype=jnp.float32, depth=depth, **kw)


def _batch(n=16, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


def _leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in jax_ckpt._leaves_with_names(tree)}


def _jax_tree(state) -> dict:
    return _leaves({"params": state.params, "opt_state": state.opt_state,
                    "step": state.step})


def _jax_save(state, directory, **kw):
    return jax_ckpt.save_checkpoint(state, epoch=-1, best_acc=0.0,
                                    is_best=False, directory=str(directory),
                                    **kw)


def _port_init(root, name, depth=4, optimizer="sgd", seed=0):
    """A fresh pipelined state of the port (the tree is the same at any
    S), written with meta epoch 0: the one start both packages load."""
    mesh = make_mesh(("data", "stage"), (1, 1), device=CPU)
    state, _ = create_pipelined_vit_state(
        get_model("vit", compute_dtype=torch.float32, depth=depth), seed,
        mesh, CPU, optimizer=optimizer, place=False)
    return port_ckpt.save_checkpoint(state, epoch=-1, best_acc=0.0,
                                     is_best=False,
                                     directory=str(root / name))


def _split_tree(path) -> dict:
    """The pipelined params tree of a checkpoint, as the JAX split
    params nest it."""
    _, leaves = port_ckpt.read_checkpoint_arrays(path)
    tree = {}
    for key, value in leaves.items():
        keys = re.findall(r"\['([^']*)'\]", key)
        if key.startswith("['params']"):
            node = tree
            for k in keys[1:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = jnp.asarray(value)
    return tree


def _launch(n, root):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = launcher.free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, f"127.0.0.1:{port}", str(n), str(r),
         str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]


_CLI = ["--dataset", "synthetic", "--model", "vit", "--epochs", "1",
        "--batch-size", "64", "--synthetic-train-size", "256",
        "--synthetic-test-size", "128", "--seed", "0", "--dtype", "f32",
        "--pipeline-stages", "2", "--optimizer-sharding", "zero1",
        "--loss", "fused", "--attention", "flash",
        "--optimizer", "adam_pallas"]


# The JAX CLI in a process of its own, on the suite's 8 virtual devices
# (the environment this file runs in), its compile cache off as here.
_JAX_CLI = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from pytorch_distributed_mnist_tpu.cli import main
main(sys.argv[1:])
"""


def _cli_world(root, name, init, *extra, jax_side=False):
    """A CLI run from ``init`` writing its epoch rows: the port's world
    of 2 gloo ranks, or the JAX CLI (``jax_side``)."""
    rows = root / f"{name}.jsonl"
    argv = [*_CLI, "--resume", init, "--root", str(root / "data"),
            "--checkpoint-dir", str(root / name), "--metrics-file",
            str(rows), *extra]
    if jax_side:
        cmd = [sys.executable, "-c", _JAX_CLI, *argv]
        env = dict(os.environ, PYTHONPATH=REPO, TPUMNIST_COMPILE_CACHE="")
    else:
        cmd = [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
               "--spawn", "2", "--agreement-timeout", "60", "--device",
               "cpu", *argv]
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO,
                            env=env)
    return proc, rows


def _jax_pp_state(optimizer, init, mesh, zero=False):
    """A JAX DP x PP state restored from ``init`` (and ZeRO-1 on it),
    its sharding and the template it was restored onto (which the steps
    do not consume)."""
    tmpl, sharding = jax_create_pp_state(_f32_vit(), jax.random.key(7), mesh,
                                         data_axis="data",
                                         optimizer=optimizer)
    state, _, _ = jax_ckpt.load_checkpoint(init, tmpl)
    if zero:
        state, sharding = jax_shard_state_zero(state, mesh,
                                               base_sharding=sharding,
                                               level=1)
    return state, sharding, tmpl


def _jax_steps(state, sharding, mesh, images, labels, k):
    step = jax_make_train_step(mesh, state_sharding=sharding)
    batch = jax_global_batch({"image": images, "label": labels}, mesh)
    for _ in range(k):
        state, m = step(state, batch)
    return jax.device_get(state), [float(t) for t in m]


def _jax_refs(root, inits, images, labels) -> dict:
    """What the JAX package computes on the world's inputs: logits, one
    step's gradients, three DP x PP SGD steps, two PP x ZeRO-1 Adam steps,
    the sharding tree; and the port's own unpipelined SGD steps."""
    x, y = jnp.asarray(images), jnp.asarray(labels)
    refs = {}
    for depth in (4, 8):
        params = jax_merge(_split_tree(inits[f"init_sgd{depth}"]))
        refs[f"logits{depth}"] = np.asarray(
            jax.jit(_f32_vit(depth).apply)(params, x))
    params = jax_merge(_split_tree(inits["init_sgd4"]))

    def loss_fn(p):
        return jax_loss.cross_entropy(_f32_vit().apply(p, x), y)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    refs["loss_sum"] = float(loss) * len(labels)
    refs["grads"] = _leaves({"params": jax_split(grads)})
    mesh = jax_make_mesh(("data", "stage"), shape=(2, 4))
    state, sharding, refs["template"] = _jax_pp_state(
        "sgd", inits["init_sgd4"], mesh)
    refs["specs"] = {k: tuple(v.spec) for k, v in jax_ckpt._leaves_with_names(
        {"params": sharding.params, "opt_state": sharding.opt_state,
         "step": sharding.step})}
    refs["sgd"], refs["sgd_metrics"] = _jax_steps(state, sharding, mesh,
                                                  images, labels, 3)
    state, sharding, _ = _jax_pp_state("adam", inits["init_adam4"], mesh,
                                       True)
    refs["zero_specs"] = [str(s.spec)
                          for s in jax.tree.leaves(sharding.opt_state)]
    refs["zero"], refs["zero_metrics"] = _jax_steps(state, sharding, mesh,
                                                    images, labels, 2)
    one = create_train_state(
        get_model("vit", compute_dtype=torch.float32, depth=4), 0, CPU,
        optimizer="sgd")
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels).long()}
    for _ in range(3):
        m = train_step(one, batch)
    refs["one_metrics"] = [float(t) for t in m]
    refs["one"] = dict(state_to_jax(one))
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world's per-rank results, the CLI worlds' epoch rows,
    the JAX CLI run's and the JAX references, made while the worlds
    run."""
    root = tmp_path_factory.mktemp("pp_world")
    images, labels = _batch()
    data = root / "data.npz"
    np.savez(data, image=images, label=labels)
    # The JAX CLI run, the longest part, starts first.
    cli_init = _port_init(root, "cli_init", depth=2, optimizer="adam_pallas",
                          seed=3)
    clis = {"jax": _cli_world(root, "jax", cli_init, jax_side=True)}
    inits = {"init_sgd4": _port_init(root, "init_sgd4"),
             "init_adam4": _port_init(root, "init_adam4", optimizer="adam"),
             "init_sgd8": _port_init(root, "init_sgd8", depth=8)}
    (root / "job.json").write_text(json.dumps(
        {"data": str(data), "forwards": FORWARDS, "qkv": QKV,
         "trace_qkv": TRACE_QKV, "wait": WORLD_TIMEOUT, **inits}))
    procs = _launch(8, root)
    clis.update({name: _cli_world(root, name, cli_init, *extra)
                 for name, extra in (("host", ()),
                                     ("device", ("--epoch-gather",
                                                 "device")))})
    try:
        # A JAX DP x PP state, in each layout, for the world to resume.
        mesh = jax_make_mesh(("data", "stage"), shape=(2, 4))
        jst, _ = jax_create_pp_state(_f32_vit(), jax.random.key(5), mesh,
                                     data_axis="data", optimizer="sgd")
        jax_ckpts = {
            "npz": _jax_save(jst, root / "jax_npz"),
            "sharded": _jax_save(jst, root / "jax_sharded",
                                 layout="sharded"),
            "delta": _jax_save(jst, root / "jax_delta", publish="delta",
                               chunk_mb=0.01)}
        (root / "jax_ckpts.tmp").write_text(json.dumps(jax_ckpts))
        os.replace(root / "jax_ckpts.tmp", root / "jax_ckpts.json")
        refs = _jax_refs(root, inits, images, labels)
        texts = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
        cli_texts = {name: proc.communicate(timeout=WORLD_TIMEOUT)[0]
                     for name, (proc, _) in clis.items()}
    finally:
        for p in procs + [proc for proc, _ in clis.values()]:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r}:\n{text}"
    cli_rows = {}
    for name, (proc, rows) in clis.items():
        assert proc.returncode == 0, cli_texts[name]
        cli_rows[name] = [json.loads(line) for line in
                          rows.read_text().splitlines()
                          if '"train_loss"' in line]
    return {"ranks": [dict(np.load(root / f"rank{r}.npz"))
                      for r in range(8)],
            "images": images, "labels": labels, "root": root,
            "inits": inits, "jst": jst, "jax_ckpts": jax_ckpts,
            "refs": refs, "cli": cli_rows, "cli_text": cli_texts}


def _rank_rows(rank, shape, n=16):
    dp, pp = shape
    b = n // dp
    d = rank // pp
    return slice(d * b, (d + 1) * b)


def _params(res, tag):
    return {n[len(tag) + 1:]: v for n, v in res.items()
            if n.startswith(f"{tag}/['params']")}


# -- the layout -------------------------------------------------------------------

def test_split_merge_round_trip_bitwise_as_jax(world):
    """The port's split of the JAX model's params (a JAX template's,
    merged) is the JAX split leaf for leaf, and merging gives the params
    back bit for bit."""
    params = jax_merge(world["refs"]["template"].params)
    port = {}
    for key, value in _leaves(params).items():
        keys = re.findall(r"\['([^']*)'\]", key)[1:]
        if keys[-1] == "scale":
            keys[-1] = "weight"
        port[".".join(keys)] = value
    split = split_vit_params(port)
    want = _leaves({"params": jax_split(params)})
    assert len(split) == len(want)
    for name, value in split.items():
        keys = name.split(".")
        if keys[-1] == "weight":
            keys[-1] = "scale"
        key = "['params']" + "".join(f"['{k}']" for k in keys)
        np.testing.assert_array_equal(value, want[key], err_msg=name)
    merged = merge_vit_params(split)
    assert sorted(merged) == sorted(port)
    for name, value in port.items():
        np.testing.assert_array_equal(merged[name], value, err_msg=name)


def _jax_split_of(split) -> dict:
    """A port split tree (``{dotted name: tensor}``) as the JAX split
    params nest it, LayerNorm ``weight`` named ``scale``."""
    tree = {}
    for name, value in split.items():
        *keys, leaf = name.split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node["scale" if leaf == "weight" else leaf] = jnp.asarray(
            np.asarray(value))
    return tree


def test_split_stage_params_and_stage_forwards_chain_to_the_model():
    """``split_stage_params`` cuts the JAX boundaries (embed on stage 0,
    head on the last): each stage's leaves equal the JAX split's by
    value. Each stage forward's output equals the JAX stage forward's on
    the same params and input, and the chained logits equal the JAX
    chain's and the model's."""
    model = create_train_state(
        get_model("vit", compute_dtype=torch.float32, depth=4), 0, CPU).model
    split = {n: p.detach() for n, p in
             split_vit_params(dict(model.named_parameters())).items()}
    stages = split_stage_params(split, 2)
    jstages = jax_split_stage_params(_jax_split_of(split), 2)
    assert len(stages) == len(jstages) == 2
    for s, (mine, theirs) in enumerate(zip(stages, jstages)):
        want = _leaves(_jax_split_of(mine))
        got = _leaves(theirs)
        assert sorted(want) == sorted(got), s
        for key, value in got.items():
            np.testing.assert_array_equal(want[key], value,
                                          err_msg=f"stage {s} {key}")
        assert mine["blocks.mlp1.kernel"].shape[0] == 2
    x = np.random.default_rng(3).normal(size=(4, 28, 28, 1)).astype(
        np.float32)
    h, jh = torch.from_numpy(x), jnp.asarray(x)
    jfwds = jax_make_stage_forward_fns(_f32_vit(4), 2)
    with torch.no_grad():
        for s, (fwd, jfwd, params, jparams) in enumerate(zip(
                make_stage_forward_fns(model, 2), jfwds, stages, jstages)):
            h, jh = fwd(params, h), jax.jit(jfwd)(jparams, jh)
            assert tuple(h.shape) == jh.shape, s
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                                       atol=1e-5, err_msg=f"stage {s}")
        np.testing.assert_allclose(h.numpy(),
                                   model(torch.from_numpy(x)).numpy(),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        split_stage_params(split, 3)


def test_the_stage_rules_and_state_sharding_match_jax(world):
    """Every ``blocks`` leaf, params and moments, is ``P('stage')``; the
    rest replicated, as the JAX sharding tree says leaf by leaf; the
    placed blocks hold this stage's rows."""
    want = world["refs"]["specs"]
    grid = GridMesh(8, 0, CPU, (DataAxis(2, 0, CPU, None, "data"),
                                DataAxis(4, 0, CPU, None, "stage")))
    _, sh = create_pipelined_vit_state(
        get_model("vit", compute_dtype=torch.float32, depth=4), 0, grid,
        CPU, optimizer="sgd", place=False)
    assert sorted(sh) == sorted(want)
    for name, spec in sh.items():
        assert tuple(spec) == want[name], name
    rules = pipeline_stage_rules()
    assert rules(QKV) == P("stage") and rules(MU_QKV) == P("stage")
    assert rules("['params']['head']['head']['kernel']") == P()
    for res in world["ranks"]:
        assert res["placed/qkv"].tolist() == [[1, 64, 192], [4, 64, 192]]
        assert res["placed/spec"].tolist() == ["('stage',)"] * 2


def test_depth_not_divisible_raises():
    grid = GridMesh(8, 0, CPU, (DataAxis(4, 0, CPU, None, "data"),
                                DataAxis(2, 0, CPU, None, "stage")))
    with pytest.raises(ValueError, match="not divisible"):
        make_pipelined_vit_apply(
            get_model("vit", compute_dtype=torch.float32, depth=3), grid)


# -- forward, gradients, steps ------------------------------------------------------

def test_pipelined_forward_matches_sequential(world):
    """On (2, 4), (4, 2) and (1, 8) every rank's logits of its rows equal
    the JAX model's."""
    refs = world["refs"]
    for tag, (shape, depth) in FORWARDS.items():
        for r, res in enumerate(world["ranks"]):
            np.testing.assert_allclose(
                res[f"fwd/{tag}"], refs[f"logits{depth}"][_rank_rows(
                    r, shape)], rtol=1e-5, atol=1e-5, err_msg=f"{tag} {r}")


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_grads_match_unpipelined(world, remat):
    """One DP(2) x PP(4) step's reduced gradients (the embed's summed
    over the stages, the head's counted once, the blocks' on their
    stage) equal the JAX model's gradients, with and without remat, and
    remat changes neither loss nor gradients."""
    refs = world["refs"]
    tag = f"remat{int(remat)}"
    for res in world["ranks"]:
        np.testing.assert_allclose(res[f"{tag}/metrics"][0][0],
                                   refs["loss_sum"], rtol=1e-5)
        for name, value in refs["grads"].items():
            np.testing.assert_allclose(res[f"{tag}/{name}"], value,
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(res[f"{tag}/{name}"],
                                       res[f"remat0/{name}"], rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_pipelined_train_step_matches_unpipelined(world):
    """Three DP(2) x PP(4) SGD steps == the JAX pipelined steps on its
    (2, 4) mesh == the port's unpipelined steps in one process (the same
    params: the pipelined init is the unpipelined one, split)."""
    refs = world["refs"]
    want = _leaves({"params": refs["sgd"].params})
    one = {k: v for k, v in refs["one"].items()
           if k.startswith("['params']")}
    want_one = _leaves({"params": jax_split(
        {"params": _unflatten(one)["params"]["params"]})})
    for res in world["ranks"]:
        got_m = res["pp_sgd/metrics"][-1]
        assert got_m[2] == 16
        for m in (refs["sgd_metrics"], refs["one_metrics"]):
            np.testing.assert_allclose(got_m[0], m[0], rtol=1e-5)
            assert int(got_m[1]) == int(m[1])
        got = _params(res, "pp_sgd")
        for ref in (want, want_one):
            for name, value in ref.items():
                np.testing.assert_allclose(got[name], value, rtol=1e-4,
                                           atol=1e-6, err_msg=name)


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        keys = re.findall(r"\['([^']*)'\]", key)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def _adam_close(got, want, tree, name):
    """Adam's first steps: the moments to rounding (atol 1e-8 after two
    steps); a param where the
    gradient is more than rounding noise within atol 2e-5, and anywhere
    within Adam's largest moves (the k third of a qkv bias has a zero
    gradient, so its update is the sign of noise)."""
    if not name.startswith("['params']"):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-8,
                                   err_msg=name)
        return
    mu = tree[name.replace("['params']",
                           "['opt_state'].inner_state[0].mu", 1)]
    live = np.abs(mu) > 1e-8
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=2e-5,
                               err_msg=name)
    assert np.all(np.abs(got - want) <= 2e-3 + 2e-5), name


def test_pipeline_zero1_matches_pipeline_only(world):
    """PP x ZeRO-1: stage-split block moments gain a data dim (stage x
    data), the embed and head moments shard over data; two Adam steps
    equal the pipeline alone (the JAX suite's rtol 1e-6 / atol 1e-7) and
    the JAX PP x ZeRO-1 steps."""
    refs = world["refs"]
    assert any("stage" in s and "data" in s for s in refs["zero_specs"])
    want = _jax_tree(refs["zero"])
    for res in world["ranks"]:
        assert any("'stage'" in s and "'data'" in s
                   for s in res["zero/specs"].tolist())
        np.testing.assert_allclose(res["adam_zero1/metrics"],
                                   res["adam_zero0/metrics"], rtol=1e-6)
        np.testing.assert_allclose(res["adam_zero1/metrics"][-1][0],
                                   refs["zero_metrics"][0], rtol=1e-5)
        for name in want:
            np.testing.assert_allclose(
                res[f"adam_zero1/{name}"], res[f"adam_zero0/{name}"],
                rtol=1e-6, atol=1e-7, err_msg=name)
            _adam_close(res[f"adam_zero1/{name}"], want[name], want, name)


# -- checkpoints across the packages -------------------------------------------------

def _regions(path):
    with open(os.path.join(path, "meta.json")) as f:
        names = json.load(f)["leaf_names"]
    out = set()
    for name in os.listdir(path):
        if name.startswith("index_p"):
            with open(os.path.join(path, name)) as f:
                for rec in json.load(f)["shards"]:
                    out.add((names[rec["leaf"]], tuple(rec["start"]),
                             tuple(rec["stop"])))
    return out


def test_the_pp_directory_holds_the_jax_slices(world):
    """The port's DP x PP sharded directory holds the slices the JAX DP
    x PP run's holds: each stage's rows of every blocks leaf, once."""
    pdir = port_ckpt.latest_checkpoint(str(world["root"] / "sharded"))
    port = _regions(pdir)
    assert port == _regions(world["jax_ckpts"]["sharded"])
    assert (QKV, (1, 0, 0), (2, 64, 192)) in port


@pytest.mark.parametrize("layout", ["npz", "sharded", "delta"])
def test_the_port_pp_checkpoint_resumes_in_jax(world, layout):
    """A DP x PP checkpoint of the port, in each layout, stamps the
    pipeline's S and loads into the JAX DP x PP template at the same S,
    with the init's leaves."""
    path = port_ckpt.latest_checkpoint(str(world["root"] / layout))
    assert port_ckpt.checkpoint_parallel_layout(path)["pipeline"] == 4
    assert jax_ckpt.checkpoint_parallel_layout(path)["pipeline"] == 4
    restored, epoch, _ = jax_ckpt.load_checkpoint(
        path, world["refs"]["template"])
    assert epoch == 1
    got = _jax_tree(jax.device_get(restored))
    _, want = port_ckpt.read_checkpoint_arrays(world["inits"]["init_sgd4"])
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_serving_refuses_a_pipeline_checkpoint_by_name(world):
    """Until MPMD pipeline serving (ROADMAP Queue 1 item 12), the serve
    gate refuses a pipeline-trained checkpoint, naming its S."""
    from pytorch_distributed_mnist_tpu_torch.serve.programs import (
        check_checkpoint_layout,
    )

    path = port_ckpt.latest_checkpoint(str(world["root"] / "npz"))
    with pytest.raises(ValueError, match="pipeline-parallel 4"):
        check_checkpoint_layout(port_ckpt.checkpoint_parallel_layout(path),
                                "replicated", "vit")


@pytest.mark.parametrize("layout", ["npz", "sharded", "delta"])
def test_a_jax_pp_checkpoint_resumes_in_the_port_pp_world(world, layout):
    want = _jax_tree(jax.device_get(world["jst"]))
    for res in world["ranks"]:
        for name, value in want.items():
            np.testing.assert_array_equal(res[f"jax_{layout}/{name}"],
                                          value, err_msg=name)


# -- the CLI ----------------------------------------------------------------------------

def test_cli_pipeline_flags_match_the_jax_cli(world):
    """``--pipeline-stages 2 --optimizer-sharding zero1 --loss fused
    --attention flash --optimizer adam_pallas`` in a world of 2 ranks
    (mesh (1, 2)) and in the JAX CLI on 8 devices (mesh (4, 2)), from one
    npz: the same epoch."""
    assert "mesh: {'data': 1, 'stage': 2}" in world["cli_text"]["host"]
    (got,), (want,) = world["cli"]["host"], world["cli"]["jax"]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=1e-4)
    assert abs(got["train_acc"] - want["train_acc"]) <= 1 / 256
    assert abs(got["test_acc"] - want["test_acc"]) <= 1 / 128


def test_cli_pipeline_epoch_gather_device_matches_host(world):
    """``--epoch-gather device`` on the pipeline mesh: the same epoch as
    the host gather, exactly."""
    host, device = world["cli"]["host"], world["cli"]["device"]
    for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
        assert device[0][key] == host[0][key], key
