"""The port's PP x TP ViT (``parallel/pipeline_tp.py``) against the JAX
package's, on the CPU: twins of ``tests/test_pipeline_tp.py`` (its
``slow`` cases at small size included), of the PP x TP cases of
``tests/test_device_gather.py`` and ``tests/test_loss.py``, and the PP x
TP checkpoints across the two packages.

The port runs in one gloo world of 8 processes, started by a module
fixture beside two CLI worlds of 4 and the JAX CLI run: the world builds
the ``('data', 'stage', 'model')`` meshes of the JAX tests, (2, 2, 2),
(1, 4, 2) and the wide model axis (1, 2, 4), one after another, each rank
on its data rank's rows. The JAX side runs as its own tests do, on its 8
virtual CPU devices. The Megatron stage body is the ViT's block: forward
rtol/atol 1e-5 against the JAX model; gradients rtol 1e-4 / atol 1e-5;
a float32 SGD step's loss sum rtol 1e-5 against the JAX PP x TP step and
the port's one process, params rtol 1e-4 / atol 1e-6; PP x TP x ZeRO-1
equal to PP x TP alone within rtol 1e-6 / atol 1e-7 and to the JAX
composition within Adam's first-step noise. The head-major leaves meet
the outside in the JAX layout: a sharded directory holds, file by file,
the slices the JAX run writes.

The CLI worlds run ``--pipeline-stages 2 --tensor-parallel 2
--optimizer-sharding zero1 --loss fused --attention flash --optimizer
adam_pallas`` with ``--dtype f32`` from the same npz as the JAX CLI run
of those flags on its 8 devices (train and test loss rtol 1e-4,
accuracy within one example), and again with ``--epoch-gather device``,
which must print the same epoch exactly.
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
from pytorch_distributed_mnist_tpu.parallel.pipeline_tp import (
    create_pipelined_tp_vit_state as jax_create_pptp_state,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_tp import (
    merge_vit_params_tp as jax_merge_tp,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_tp import (
    split_vit_params_tp as jax_split_tp,
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
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_tp import (
    block_param_specs,
    create_pipelined_tp_vit_state,
    make_pipelined_tp_vit_apply,
    merge_vit_params_tp,
    split_vit_params_tp,
)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    P,
    Placements,
)
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
# The meshes of the JAX forward test: (data, stage, model), depth 4. The
# world keeps the last one's mesh and state for the checkpoints and the
# SGD step.
FORWARDS = {"pp4_tp2": (1, 4, 2), "pp2_tp4": (1, 2, 4),
            "dp2_pp2_tp2": (2, 2, 2)}

# One rank: ``python -c _RANK coordinator n rank dir`` runs dir/job.json.
_RANK = r"""
import json, os, sys, time
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    jax_leaf_name, jax_param_order, state_to_jax)
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel import pipeline_vit
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    metric_all_reduce)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_tp import (
    create_pipelined_tp_vit_state)
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
    return make_mesh(("data", "stage", "model"), shape=tuple(shape),
                     device=cpu)

def batch(mesh):
    dp, d = mesh.data.size, mesh.data.rank
    b = z["image"].shape[0] // dp
    rows = slice(d * b, (d + 1) * b)
    return {"image": torch.from_numpy(z["image"][rows]),
            "label": torch.from_numpy(z["label"][rows]).long()}

def state(mesh, init, depth, place=True):
    opt = "adam" if "adam" in init else "sgd"
    st, sh = create_pipelined_tp_vit_state(
        get_model("vit", compute_dtype=torch.float32, depth=depth), 0,
        mesh, cpu, optimizer=opt, place=False)
    ck.load_checkpoint(job[init], st)
    if place:
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
    # The reduced gradients the step left in the flat buffer, each
    # gathered whole over its placement (a collective), JAX layout.
    named = dict(st.model.named_parameters())
    for name, view in zip(jax_param_order(named), st.grad_buffer.views):
        leaf = jax_leaf_name(name, "")
        pl = st.placements.get(leaf)
        g = view if pl is None else pl.gather(view)
        if g.dim() == 4:
            g = g.permute(2, 3, 1, 0)
        res[f"{tag}/{leaf}"] = g.numpy().copy()

for tag, shape in job["forwards"].items():
    mesh = mesh_of(shape)
    st, _ = state(mesh, "init_sgd4", 4)
    with torch.no_grad():
        res[f"fwd/{tag}"] = st.model(batch(mesh)["image"]).numpy()

# The (2, 2, 2) mesh and state of the last forward.
res["placed/qkv"] = np.array(tuple(st.model.blocks.attn.qkv.kernel.shape))
res["placed/specs"] = np.array(sorted(
    f"{k}={tuple(p.spec)}" for k, p in st.placements.items()))
for layout, kw in (("npz", {}), ("sharded", {"layout": "sharded"}),
                   ("delta", {"publish": "delta", "chunk_mb": 0.01})):
    ck.save_checkpoint(st, epoch=0, best_acc=0.0, is_best=False,
                       directory=f"{out}/{layout}",
                       parallel_layout={"pipeline": 2, "tensor": 2},
                       **kw)
steps("sgd", st, mesh, 1)
grads("grads", st)
for zero in (False, True):
    st, sh = state(mesh, "init_adam2", 2, place=not zero)
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
st, _ = state(mesh, "init_sgd4", 4)
for layout, path in json.load(open(ready)).items():
    ck.load_checkpoint(path, st)
    record(f"jax_{layout}", st, [])
np.savez(f"{out}/rank{rank}.npz", **res)
"""

# The JAX CLI in a process of its own, on the suite's 8 virtual devices
# (the environment this file runs in), its compile cache off as here.
_JAX_CLI = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from pytorch_distributed_mnist_tpu.cli import main
main(sys.argv[1:])
"""

_CLI = ["--dataset", "synthetic", "--model", "vit", "--epochs", "1",
        "--batch-size", "64", "--synthetic-train-size", "256",
        "--synthetic-test-size", "128", "--seed", "0", "--dtype", "f32",
        "--pipeline-stages", "2", "--tensor-parallel", "2",
        "--optimizer-sharding", "zero1", "--loss", "fused",
        "--attention", "flash", "--optimizer", "adam_pallas"]


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


def _port_init(root, name, depth, optimizer="sgd", seed=0):
    """A fresh PP x TP state of the port (the head-major tree is the same
    at any S and tp), written with meta epoch 0: the one start both
    packages load."""
    mesh = make_mesh(("data", "stage", "model"), (1, 1, 1), device=CPU)
    state, _ = create_pipelined_tp_vit_state(
        get_model("vit", compute_dtype=torch.float32, depth=depth), seed,
        mesh, CPU, optimizer=optimizer, place=False)
    return port_ckpt.save_checkpoint(state, epoch=-1, best_acc=0.0,
                                     is_best=False,
                                     directory=str(root / name))


def _unflatten(flat) -> dict:
    tree = {}
    for key, value in flat.items():
        keys = re.findall(r"\['([^']*)'\]", key)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def _split_tree(path) -> dict:
    """The head-major params tree of a checkpoint, as the JAX split
    params nest it."""
    _, leaves = port_ckpt.read_checkpoint_arrays(path)
    return _unflatten({k: jnp.asarray(v) for k, v in leaves.items()
                       if k.startswith("['params']")})["params"]


def _launch(n, root):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = launcher.free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, f"127.0.0.1:{port}", str(n), str(r),
         str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]


def _cli_world(root, name, init, *extra, jax_side=False):
    """A CLI run from ``init`` writing its epoch rows: the port's world
    of 4 gloo ranks, or the JAX CLI (``jax_side``)."""
    rows = root / f"{name}.jsonl"
    argv = [*_CLI, "--resume", init, "--root", str(root / "data"),
            "--checkpoint-dir", str(root / name), "--metrics-file",
            str(rows), *extra]
    if jax_side:
        cmd = [sys.executable, "-c", _JAX_CLI, *argv]
        env = dict(os.environ, PYTHONPATH=REPO, TPUMNIST_COMPILE_CACHE="")
    else:
        cmd = [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
               "--spawn", "4", "--agreement-timeout", "60", "--device",
               "cpu", *argv]
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO,
                            env=env)
    return proc, rows


def _jax_pptp_state(optimizer, init, mesh, depth, zero=False):
    """A JAX PP x TP state restored from ``init`` (and ZeRO-1 on it), its
    sharding and the template it was restored onto (which the steps do
    not consume)."""
    tmpl, sharding = jax_create_pptp_state(_f32_vit(depth),
                                           jax.random.key(7), mesh,
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


def _jax_refs(inits, images, labels) -> dict:
    """What the JAX package computes on the world's inputs: logits, one
    step's gradients, a PP x TP SGD step (depth 4, from the logits'
    params), two PP x TP x ZeRO-1 Adam (depth 2)
    steps, the sharding tree; and the port's own unpipelined step."""
    x, y = jnp.asarray(images), jnp.asarray(labels)
    refs = {}
    params = jax_merge_tp(_split_tree(inits["init_sgd4"]))

    def loss_fn(p):
        logits = _f32_vit().apply(p, x)
        return jax_loss.cross_entropy(logits, y), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    refs["logits"] = np.asarray(logits)
    refs["loss_sum"] = float(loss) * len(labels)
    refs["grads"] = _leaves({"params": jax_split_tp(grads, 4)})
    mesh = jax_make_mesh(("data", "stage", "model"), shape=(2, 2, 2))
    state, sharding, refs["template"] = _jax_pptp_state(
        "sgd", inits["init_sgd4"], mesh, 4)
    refs["specs"] = {k: tuple(v.spec) for k, v in jax_ckpt._leaves_with_names(
        {"params": sharding.params, "opt_state": sharding.opt_state,
         "step": sharding.step})}
    refs["sgd"], refs["sgd_metrics"] = _jax_steps(state, sharding, mesh,
                                                  images, labels, 1)
    state, sharding, _ = _jax_pptp_state("adam", inits["init_adam2"], mesh,
                                         2, zero=True)
    refs["zero_specs"] = [str(s.spec)
                          for s in jax.tree.leaves(sharding.opt_state)]
    refs["zero"], refs["zero_metrics"] = _jax_steps(state, sharding, mesh,
                                                    images, labels, 2)
    one = create_train_state(
        get_model("vit", compute_dtype=torch.float32, depth=4), 0, CPU,
        optimizer="sgd")
    m = train_step(one, {"image": torch.from_numpy(images),
                         "label": torch.from_numpy(labels).long()})
    refs["one_metrics"] = [float(t) for t in m]
    refs["one"] = _leaves({"params": jax_split_tp(_unflatten(
        {k: v for k, v in state_to_jax(one)
         if k.startswith("['params']")})["params"], 4)})
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world's per-rank results, the CLI runs' epoch rows and
    the JAX references, made while the worlds run."""
    root = tmp_path_factory.mktemp("pptp_world")
    images, labels = _batch()
    data = root / "data.npz"
    np.savez(data, image=images, label=labels)
    # The JAX CLI run, the longest part, starts first.
    cli_init = _port_init(root, "cli_init", 2, "adam_pallas", seed=3)
    clis = {"jax": _cli_world(root, "jax", cli_init, jax_side=True)}
    inits = {"init_sgd4": _port_init(root, "init_sgd4", 4),
             "init_adam2": _port_init(root, "init_adam2", 2, "adam")}
    (root / "job.json").write_text(json.dumps(
        {"data": str(data), "forwards": FORWARDS, "wait": WORLD_TIMEOUT,
         **inits}))
    procs = _launch(8, root)
    clis.update({name: _cli_world(root, name, cli_init, *extra)
                 for name, extra in (("host", ()),
                                     ("device", ("--epoch-gather",
                                                 "device")))})
    try:
        # A JAX PP x TP state, in each layout, for the world to resume.
        mesh = jax_make_mesh(("data", "stage", "model"), shape=(2, 2, 2))
        jst, _ = jax_create_pptp_state(_f32_vit(), jax.random.key(5), mesh,
                                       optimizer="sgd")
        jax_ckpts = {
            "npz": _jax_save(jst, root / "jax_npz"),
            "sharded": _jax_save(jst, root / "jax_sharded",
                                 layout="sharded"),
            "delta": _jax_save(jst, root / "jax_delta", publish="delta",
                               chunk_mb=0.01)}
        (root / "jax_ckpts.tmp").write_text(json.dumps(jax_ckpts))
        os.replace(root / "jax_ckpts.tmp", root / "jax_ckpts.json")
        refs = _jax_refs(inits, images, labels)
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
    dp, pp, tp = shape
    b = n // dp
    d = rank // (pp * tp)
    return slice(d * b, (d + 1) * b)


def _params(res, tag):
    return {n[len(tag) + 1:]: v for n, v in res.items()
            if n.startswith(f"{tag}/['params']")}


def _grid(dp, pp, tp, coords=(0, 0, 0)) -> GridMesh:
    return GridMesh(dp * pp * tp, 0, CPU, tuple(
        DataAxis(size, c, CPU, None, name) for size, c, name in
        zip((dp, pp, tp), coords, ("data", "stage", "model"))))


# -- the layout -------------------------------------------------------------------

def test_split_merge_tp_round_trip_bitwise_as_jax(world):
    """The port's head-major split of the JAX model's params (the JAX
    template's, merged) is the JAX split leaf for leaf (qkv (depth, C, 3,
    H, D), proj (depth, H, D, C)), and merging gives the params back bit
    for bit."""
    params = jax_merge_tp(world["refs"]["template"].params)
    port = {}
    for key, value in _leaves(params).items():
        keys = re.findall(r"\['([^']*)'\]", key)[1:]
        if keys[-1] == "scale":
            keys[-1] = "weight"
        port[".".join(keys)] = value
    split = split_vit_params_tp(port, 4)
    want = _leaves({"params": jax_split_tp(params, 4)})
    assert len(split) == len(want)
    for name, value in split.items():
        keys = name.split(".")
        if keys[-1] == "weight":
            keys[-1] = "scale"
        key = "['params']" + "".join(f"['{k}']" for k in keys)
        np.testing.assert_array_equal(value, want[key], err_msg=name)
    assert split["blocks.attn.qkv.kernel"].shape == (4, 64, 3, 4, 16)
    merged = merge_vit_params_tp(split)
    for name, value in port.items():
        np.testing.assert_array_equal(merged[name], value, err_msg=name)


def test_block_param_specs_and_state_sharding_match_jax(world):
    """Blocks leaves get the stage dim plus their Megatron model dims,
    params and moments alike, as the JAX sharding tree says leaf by leaf;
    the placed qkv holds this stage's blocks and this model rank's
    heads, a leaf split over two axes."""
    want = world["refs"]["specs"]
    _, sh = create_pipelined_tp_vit_state(
        get_model("vit", compute_dtype=torch.float32, depth=4), 0,
        _grid(2, 2, 2), CPU, optimizer="sgd", place=False)
    assert sorted(sh) == sorted(want)
    for name, spec in sh.items():
        assert tuple(spec) == want[name], name
    specs = block_param_specs({"attn.qkv.kernel": 0, "ln1.weight": 0,
                               "mlp2.kernel": 0}, "stage", "model")
    assert specs == {"attn.qkv.kernel": P("stage", None, None, "model", None),
                     "ln1.weight": P("stage"),
                     "mlp2.kernel": P("stage", "model", None)}
    for res in world["ranks"]:
        assert res["placed/qkv"].tolist() == [2, 64, 3, 2, 16]
        specs = dict(s.split("=") for s in res["placed/specs"].tolist())
        assert specs[QKV] == "('stage', None, None, 'model', None)"
        mu = "['opt_state'].inner_state[1][0].trace['blocks']['attn']" \
             "['proj']['kernel']"
        assert specs[mu] == "('stage', 'model', None, None)"


def test_a_two_axis_placement_cuts_and_gathers_the_jax_block():
    """On coordinate (stage 1, model 1) of a (1, 2, 2) mesh the qkv
    kernel's slice is its blocks [2, 4) and heads [2, 4), and the region
    a sharded directory records is that block."""
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        placement_of,
    )

    full = np.arange(4 * 8 * 3 * 4 * 2, dtype=np.float32).reshape(
        4, 8, 3, 4, 2)
    pl = placement_of(P("stage", None, None, "model", None), full.shape,
                      _grid(1, 2, 2, (0, 1, 1)))
    assert isinstance(pl, Placements) and pl.writes
    np.testing.assert_array_equal(pl.local(full), full[2:, :, :, 2:])
    assert pl.region() == (full.shape, [2, 0, 0, 2, 0], [4, 8, 3, 4, 2])
    assert tuple(pl.spec) == ("stage", None, None, "model", None)
    # Coordinate 1 of the data axis the leaf does not split writes none.
    other = placement_of(P("stage", None, None, "model", None), full.shape,
                         _grid(2, 2, 2, (1, 1, 1)))
    assert not other.writes


def test_heads_not_divisible_raises():
    """2 heads cannot spread over a model axis of 4."""
    with pytest.raises(ValueError, match="heads"):
        make_pipelined_tp_vit_apply(
            get_model("vit", compute_dtype=torch.float32, depth=4,
                      num_heads=2), _grid(1, 2, 4))
    with pytest.raises(ValueError, match="not divisible"):
        make_pipelined_tp_vit_apply(
            get_model("vit", compute_dtype=torch.float32, depth=3),
            _grid(1, 2, 2))


# -- forward, gradients, steps ------------------------------------------------------

def test_pp_tp_forward_matches_sequential(world):
    """On (2, 2, 2), (1, 4, 2) and (1, 2, 4) every rank's logits of its
    rows equal the JAX model's."""
    want = world["refs"]["logits"]
    for tag, shape in FORWARDS.items():
        for r, res in enumerate(world["ranks"]):
            np.testing.assert_allclose(res[f"fwd/{tag}"],
                                       want[_rank_rows(r, shape)],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{tag} {r}")


def test_pp_tp_grads_match_sequential(world):
    """The gradients through the ticks, the hops and the model-axis sums
    (one DP(2) x PP(2) x TP(2) step's reduced buffer) equal the JAX
    model's, split head-major."""
    refs = world["refs"]
    for res in world["ranks"]:
        for name, value in refs["grads"].items():
            np.testing.assert_allclose(res[f"grads/{name}"], value,
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_pp_tp_train_step_matches_unpipelined(world):
    """One PP x TP SGD step == the JAX PP x TP step on its (2, 2, 2) mesh
    == the port's unpipelined step in one process."""
    refs = world["refs"]
    want = _leaves({"params": refs["sgd"].params})
    for res in world["ranks"]:
        got_m = res["sgd/metrics"][-1]
        assert got_m[2] == 16
        for m in (refs["sgd_metrics"], refs["one_metrics"]):
            np.testing.assert_allclose(got_m[0], m[0], rtol=1e-5)
            assert int(got_m[1]) == int(m[1])
        np.testing.assert_allclose(got_m[0], refs["loss_sum"], rtol=1e-5)
        got = _params(res, "sgd")
        for ref in (want, refs["one"]):
            for name, value in ref.items():
                np.testing.assert_allclose(got[name], value, rtol=1e-4,
                                           atol=1e-6, err_msg=name)


def _adam_close(got, want, tree, name):
    """Adam's first steps: the moments to rounding (atol 1e-8 after two
    steps); a param where the gradient is more than rounding noise within
    atol 2e-5, and anywhere within Adam's largest moves (the k third of
    a qkv bias has a zero gradient, so its update is the sign of
    noise)."""
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


def test_pp_tp_zero1_composes(world):
    """PP x TP x ZeRO-1: the moments gain a data dim the stage and model
    splits left free; two Adam steps equal PP x TP alone (rtol 1e-6 /
    atol 1e-7) and the JAX composition on its (2, 2, 2) mesh."""
    refs = world["refs"]
    assert any("stage" in s and "data" in s for s in refs["zero_specs"])
    want = _jax_tree(refs["zero"])
    for res in world["ranks"]:
        specs = res["zero/specs"].tolist()
        assert any("'stage'" in s and "'model'" in s and "'data'" in s
                   for s in specs)
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


def test_the_pp_tp_directory_holds_the_jax_slices(world):
    """The port's PP x TP sharded directory holds the slices the JAX PP x
    TP run's holds: each (stage, model) block of every split leaf."""
    pdir = port_ckpt.latest_checkpoint(str(world["root"] / "sharded"))
    port = _regions(pdir)
    assert port == _regions(world["jax_ckpts"]["sharded"])
    assert (QKV, (2, 0, 0, 2, 0), (4, 64, 3, 4, 16)) in port


@pytest.mark.parametrize("layout", ["npz", "sharded", "delta"])
def test_the_port_pp_tp_checkpoint_resumes_in_jax(world, layout):
    """A PP x TP checkpoint of the port, in each layout, stamps S and tp
    and loads into the JAX PP x TP template at the same S, with the
    init's leaves."""
    path = port_ckpt.latest_checkpoint(str(world["root"] / layout))
    stamp = jax_ckpt.checkpoint_parallel_layout(path)
    assert stamp["pipeline"] == 2 and stamp["tensor"] == 2
    restored, epoch, _ = jax_ckpt.load_checkpoint(
        path, world["refs"]["template"])
    assert epoch == 1
    got = _jax_tree(jax.device_get(restored))
    _, want = port_ckpt.read_checkpoint_arrays(world["inits"]["init_sgd4"])
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("layout", ["npz", "sharded", "delta"])
def test_a_jax_pp_tp_checkpoint_resumes_in_the_port_world(world, layout):
    want = _jax_tree(jax.device_get(world["jst"]))
    for res in world["ranks"]:
        for name, value in want.items():
            np.testing.assert_array_equal(res[f"jax_{layout}/{name}"],
                                          value, err_msg=name)


# -- the CLI ----------------------------------------------------------------------------

def test_cli_pp_tp_flags_match_the_jax_cli(world):
    """``--pipeline-stages 2 --tensor-parallel 2 --optimizer-sharding
    zero1 --loss fused --attention flash --optimizer adam_pallas`` in a
    world of 4 ranks (mesh (1, 2, 2)) and in the JAX CLI on 8 devices
    (mesh (2, 2, 2)), from one npz: the same epoch."""
    assert "mesh: {'data': 1, 'stage': 2, 'model': 2}" in \
        world["cli_text"]["host"]
    (got,), (want,) = world["cli"]["host"], world["cli"]["jax"]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=1e-4)
    assert abs(got["train_acc"] - want["train_acc"]) <= 1 / 256
    assert abs(got["test_acc"] - want["test_acc"]) <= 1 / 128


def test_cli_pp_tp_epoch_gather_device_matches_host(world):
    """``--epoch-gather device`` on the PP x TP mesh: the same epoch as
    the host gather, exactly."""
    host, device = world["cli"]["host"], world["cli"]["device"]
    for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
        assert device[0][key] == host[0][key], key
