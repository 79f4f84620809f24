"""The port's Megatron tensor parallelism (``--tensor-parallel``) against
the JAX package's, on the CPU: twins of ``tests/test_tensor_parallel.py``
and of the flash-under-TP cases of ``tests/test_attention.py`` and
``tests/test_vit.py``.

The port runs in one gloo world of 4 processes, a ``('data', 'model',
'seq')`` mesh of (2, 2, 1) (one module fixture runs every case there),
each rank on its data rank's rows; the JAX side runs as its own tests
do, on its virtual CPU devices (its DP x TP steps on a (4, 2) mesh). TP
is a layout change, not a math change: the DP x TP steps equal the
single-device ones at the JAX suite's tolerances (float32, SGD: loss sums
rtol 1e-4, params rtol 1e-4 / atol 1e-6 after 3 steps); Adam's first
step under ZeRO-1 within atol 2e-5 where the gradient is more than
rounding noise (its normalised update turns the noise of a zero gradient
into a move of up to lr). The
head-aligned ``qkv`` placement meets the outside in the JAX layout: the
npz and the delta manifest hold whole leaves, and the sharded directory
holds, file by file, the contiguous slices the JAX run writes.

The CLI worlds run with ``--dtype f32`` and are held to the one-process
run at the JAX suite's CLI tolerances (train loss rel 1e-4, test accuracy
abs 1e-6): in bfloat16 a rank's partial products round before their sum,
which moves a one-epoch loss by about 1e-4 relative.
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
from pytorch_distributed_mnist_tpu.ops.attention import (
    full_attention as jax_full_attention,
)
from pytorch_distributed_mnist_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from pytorch_distributed_mnist_tpu.parallel.tensor import (
    make_tp_eval_step as jax_make_tp_eval_step,
)
from pytorch_distributed_mnist_tpu.parallel.tensor import (
    make_tp_train_step as jax_make_tp_train_step,
)
from pytorch_distributed_mnist_tpu.parallel.tensor import (
    shard_state as jax_shard_state,
)
from pytorch_distributed_mnist_tpu.parallel.tensor import (
    state_shardings as jax_state_shardings,
)
from pytorch_distributed_mnist_tpu.parallel.tensor import (
    vit_tp_rules as jax_vit_tp_rules,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_eval_step as jax_make_eval_step,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.ops.attention import full_attention
from pytorch_distributed_mnist_tpu_torch.ops.flash import (
    sharded_flash_attention,
)
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
    DataAxis,
    GridMesh,
)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    P,
    Placement,
    placement_of,
    state_shardings,
    vit_tp_rules,
)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 180  # seconds the world (and each CLI world) may take
QKV = "['params']['params']['block0']['attn']['qkv']['kernel']"

# One rank: ``python -c _RANK coordinator n rank dir`` runs dir/job.json.
_RANK = r"""
import functools, json, sys
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.ops.flash import (
    sharded_flash_attention)
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    metric_all_reduce)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    shard_state, vit_tp_rules)
from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
    shard_state_zero)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as ck
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    eval_step, train_step)

torch.set_num_threads(1)
coord, n, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
job = json.load(open(f"{out}/job.json"))
cpu = torch.device("cpu")
distributed.initialize_distributed(coord, n, rank, cpu)
mesh = make_mesh(("data", "model", "seq"), shape=job["shape"], device=cpu)
dp, d = mesh.data.size, mesh.data.rank
z = np.load(job["data"])
res = {}

def rows(a):
    b = a.shape[0] // dp
    return a[d * b:(d + 1) * b]

batch = {"image": torch.from_numpy(rows(z["image"])),
         "label": torch.from_numpy(rows(z["label"])).long()}

def state(optimizer, **kw):
    st = create_train_state(
        get_model("vit", compute_dtype=torch.float32, mesh=mesh, **kw), 0,
        cpu, optimizer=optimizer)
    ck.load_checkpoint(job["init_" + optimizer], st)
    return st

def record(tag, st, ms):
    res[f"{tag}/metrics"] = np.array(ms)
    for name, arr in state_to_jax(st):
        res[f"{tag}/{name}"] = arr

def steps(tag, st, k):
    ms = []
    for _ in range(k):
        m = metric_all_reduce(train_step(st, batch, mesh.data), mesh.data)
        ms.append([float(t) for t in m])
    record(tag, st, ms)

st = state("sgd")
shard_state(st, mesh, vit_tp_rules())
ev = metric_all_reduce(eval_step(st, batch), mesh.data)
res["eval/metrics"] = np.array([[float(t) for t in ev]])
ck.save_checkpoint(st, epoch=0, best_acc=0.0, is_best=False,
                   directory=f"{out}/sharded", layout="sharded")
ck.save_checkpoint(st, epoch=0, best_acc=0.0, is_best=False,
                   directory=f"{out}/npz")
ck.save_checkpoint(st, epoch=0, best_acc=0.0, is_best=False,
                   directory=f"{out}/delta", publish="delta", chunk_mb=0.01)
steps("tp_step", st, 3)

flash = functools.partial(sharded_flash_attention, mesh=mesh,
                          batch_axis="data", head_axis="model")
st = state("sgd", attention_fn=flash)
shard_state(st, mesh, vit_tp_rules())
steps("tp_flash", st, 1)

st = state("adam")
shard_state_zero(st, mesh, rules=vit_tp_rules(), level=1)
steps("tp_zero1", st, 1)

back = state("adam")
shard_state(back, mesh, vit_tp_rules())
ck.load_checkpoint(job["jax_ckpt"], back)
record("jax_ckpt", back, [])
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _f32_vit():
    return jax_get_model("vit", compute_dtype=jnp.float32)


def _batch(n=16, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


def _jbatch(images, labels):
    return {"image": jnp.asarray(images), "label": jnp.asarray(labels)}


def _leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in jax_ckpt._leaves_with_names(tree)}


def _jax_tree(state) -> dict:
    return _leaves({"params": state.params, "opt_state": state.opt_state,
                    "step": state.step})


def _grid(dp=4, tp=2, sp=1) -> GridMesh:
    """A mesh record of the JAX test's shape, this rank at coordinate 0
    (no process groups: the placements it gives are what a rank holds)."""
    return GridMesh(dp * tp * sp, 0, CPU, (
        DataAxis(dp, 0, CPU, None, "data"),
        DataAxis(tp, 0, CPU, None, "model"),
        DataAxis(sp, 0, CPU, None, "seq")))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The (2, 2, 1) world's per-rank results and what it was fed."""
    root = tmp_path_factory.mktemp("tp_world")
    images, labels = _batch()
    inits = {}
    for opt in ("sgd", "adam"):
        st = jax_create_train_state(_f32_vit(), jax.random.key(0),
                                    optimizer=opt)
        inits[opt] = jax_ckpt.save_checkpoint(
            st, epoch=-1, best_acc=0.0, is_best=False,
            directory=str(root / f"init_{opt}"))
    # A JAX DP x TP sharded directory, for the port to resume.
    mesh = jax_make_mesh(("data", "model"), shape=(4, 2))
    jst, _ = jax_shard_state(
        jax_create_train_state(_f32_vit(), jax.random.key(4)), mesh,
        jax_vit_tp_rules())
    jax_dir = jax_ckpt.save_checkpoint(jst, epoch=0, best_acc=0.0,
                                       is_best=False,
                                       directory=str(root / "jax"),
                                       layout="sharded")
    data = root / "data.npz"
    np.savez(data, image=images, label=labels)
    (root / "job.json").write_text(json.dumps(
        {"shape": [2, 2, 1], "data": str(data), "init_sgd": inits["sgd"],
         "init_adam": inits["adam"], "jax_ckpt": jax_dir}))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = launcher.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, f"127.0.0.1:{port}", "4", str(r),
         str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        texts = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r}:\n{text}"
    return {"ranks": [dict(np.load(root / f"rank{r}.npz")) for r in range(4)],
            "images": images, "labels": labels, "inits": inits,
            "jst": jst, "root": root}


def _jax_steps(optimizer, images, labels, k, mesh=None):
    s = jax_create_train_state(_f32_vit(), jax.random.key(0),
                               optimizer=optimizer)
    if mesh is None:
        step = jax_make_train_step()
    else:
        s, sharding = jax_shard_state(s, mesh, jax_vit_tp_rules())
        step = jax_make_tp_train_step(mesh, sharding)
    for _ in range(k):
        s, m = step(s, _jbatch(images, labels))
    return jax.device_get(s), m


def _port_steps(optimizer, init, images, labels, k):
    st = create_train_state(get_model("vit", compute_dtype=torch.float32),
                            0, CPU, optimizer=optimizer)
    port_ckpt.load_checkpoint(init, st)
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels).long()}
    for _ in range(k):
        m = train_step(st, batch)
    return dict(state_to_jax(st)), m


def _params(res, tag):
    return {n[len(tag) + 1:]: v for n, v in res.items()
            if n.startswith(f"{tag}/['params']")}


# -- shardings -----------------------------------------------------------------

def test_state_shardings_match_rules():
    mesh = _grid()
    state = create_train_state(get_model("vit", compute_dtype=torch.float32),
                               0, CPU)
    sh = state_shardings(state, mesh, vit_tp_rules())
    jstate = jax_create_train_state(_f32_vit(), jax.random.key(0))
    tree = jax_state_shardings(
        jstate, jax_make_mesh(("data", "model"), shape=(4, 2)),
        jax_vit_tp_rules())
    jsh = {k: v.spec for k, v in jax_ckpt._leaves_with_names(
        {"params": tree.params, "opt_state": tree.opt_state,
         "step": tree.step})}
    assert sorted(sh) == sorted(jsh)
    for name, spec in sh.items():
        assert tuple(spec) == tuple(jsh[name]), name
    assert sh[QKV] == P(None, "model") and sh[QKV].blocks == 3
    mu_qkv = "['opt_state'].inner_state[0].mu['params']['block0']['attn']" \
             "['qkv']['kernel']"
    assert sh[mu_qkv] == P(None, "model")
    assert sh["['step']"] == P()
    assert sh["['params']['params']['embed']['kernel']"] == P()


def _qkv_placement(c, tp, r):
    mesh = GridMesh(tp, r, CPU, (DataAxis(1, 0, CPU, None, "data"),
                                 DataAxis(tp, r, CPU, None, "model"),
                                 DataAxis(1, 0, CPU, None, "seq")))
    return placement_of(vit_tp_rules()[("qkv", "kernel")], (c, 3 * c), mesh)


def test_the_qkv_placement_holds_whole_heads():
    """Rank r's qkv columns are its heads of q, k and v; the ranks'
    slices put back together are the JAX leaf, and the contiguous slice
    is JAX's."""
    c, h, tp = 8, 4, 2
    full = torch.arange(c * 3 * c, dtype=torch.float32).reshape(c, 3 * c)
    parts = []
    for r in range(tp):
        pl = _qkv_placement(c, tp, r)
        assert isinstance(pl, Placement) and pl.blocks == 3
        mine = pl.local(full)
        want = full.reshape(c, 3, h, c // h)[:, :, r * 2:(r + 1) * 2]
        assert torch.equal(mine.reshape(c, 3, h // tp, c // h), want)
        np.testing.assert_array_equal(pl.local(full.numpy()), mine.numpy())
        assert torch.equal(pl.contiguous(full),
                           full[:, r * 3 * c // tp:(r + 1) * 3 * c // tp])
        parts.append(mine)
    stacked = torch.stack([p.unflatten(1, (3, -1)) for p in parts], dim=2)
    assert torch.equal(stacked.flatten(1, 3), full)


# -- the DP x TP steps ------------------------------------------------------------

def test_tp_step_equals_single_device_step(world):
    """DP(2) x TP(2) train steps == single-device steps (SGD, 3 steps):
    the JAX single-device and DP(4) x TP(2) steps, and the port's one
    process."""
    images, labels = world["images"], world["labels"]
    s1, m1 = _jax_steps("sgd", images, labels, 3)
    stp, mtp = _jax_steps("sgd", images, labels, 3,
                          jax_make_mesh(("data", "model"), shape=(4, 2)))
    one, m_one = _port_steps("sgd", world["inits"]["sgd"], images, labels, 3)
    for res in world["ranks"]:
        loss_sum, correct, _ = res["tp_step/metrics"][-1]
        for want in (m1, mtp, m_one):
            np.testing.assert_allclose(loss_sum, float(want.loss_sum),
                                       rtol=1e-4)
            assert int(correct) == int(want.correct)
        got = _params(res, "tp_step")
        for ref in (_leaves({"params": s1.params}),
                    _leaves({"params": stp.params})):
            for name, value in ref.items():
                np.testing.assert_allclose(got[name], value,
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=name)
        for name, value in one.items():
            if name.startswith("['params']"):
                np.testing.assert_allclose(got[name], value, rtol=1e-4,
                                           atol=1e-6, err_msg=name)


def test_tp_eval_step_equals_single_device(world):
    images, labels = world["images"], world["labels"]
    s = jax_create_train_state(_f32_vit(), jax.random.key(0),
                               optimizer="sgd")
    m1 = jax_make_eval_step()(s, _jbatch(images, labels))
    mesh = jax_make_mesh(("data", "model"), shape=(2, 4))
    ss, sharding = jax_shard_state(s, mesh, jax_vit_tp_rules())
    mt = jax_make_tp_eval_step(mesh, sharding)(ss, _jbatch(images, labels))
    for res in world["ranks"]:
        loss_sum, correct, count = res["eval/metrics"][0]
        assert count == 16
        for want in (m1, mt):
            np.testing.assert_allclose(loss_sum, float(want.loss_sum),
                                       rtol=1e-4)
            assert int(correct) == int(want.correct)


def test_tp_flash_step_equals_single_device_step(world):
    """``--attention flash`` under TP: the kernels (their plain versions
    on the CPU) on each rank's (B/dp, T, H/tp, D) block; the step equals
    the single-device dense one."""
    images, labels = world["images"], world["labels"]
    s1, m1 = _jax_steps("sgd", images, labels, 1)
    for res in world["ranks"]:
        np.testing.assert_allclose(res["tp_flash/metrics"][0][0],
                                   float(m1.loss_sum), rtol=1e-4)
        got = _params(res, "tp_flash")
        for name, value in _leaves({"params": s1.params}).items():
            np.testing.assert_allclose(got[name], value,
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def _adam_close(got, want, tree, name):
    """Adam's first step: the moments to rounding; a param where the
    gradient is more than rounding noise within atol 2e-5, and anywhere
    within Adam's largest move (lr). The k third of a qkv bias has a zero
    gradient (softmax ignores a shift of every key), so its update is the
    sign of noise: the JAX suite keeps Adam out of its layout tests for
    this."""
    if not name.startswith("['params']"):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-9,
                                   err_msg=name)
        return
    mu = tree[name.replace("['params']['params']",
                           "['opt_state'].inner_state[0].mu['params']", 1)]
    live = np.abs(mu) > 1e-8
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=2e-5,
                               err_msg=name)
    assert np.all(np.abs(got - want) <= 1e-3 + 2e-5), name


def test_tp_zero1_step_equals_single_device_step(world):
    """TP x ZeRO-1: the TP-ruled leaves keep their layout, ZeRO shards the
    other moments over data; Adam's first step equals the JAX
    single-device one and the port's one process."""
    images, labels = world["images"], world["labels"]
    s1, m1 = _jax_steps("adam", images, labels, 1)
    one, _ = _port_steps("adam", world["inits"]["adam"], images, labels, 1)
    want = _jax_tree(s1)
    for res in world["ranks"]:
        np.testing.assert_allclose(res["tp_zero1/metrics"][0][0],
                                   float(m1.loss_sum), rtol=1e-5)
        for name, value in want.items():
            got = res[f"tp_zero1/{name}"]
            _adam_close(got, value, want, name)
            _adam_close(got, one[name], want, name)


# -- sharded flash (tests/test_attention.py:131) ----------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_sharded_flash_matches_dense_on_tp_mesh(causal):
    """Each (data, model) coordinate's (B/dp, T, H/tp, D) block through
    ``sharded_flash_attention`` equals that block of dense attention."""
    b, t, h, d = 2, 32, 8, 16
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_full_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
    dense = full_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=causal).numpy()
    np.testing.assert_allclose(dense, want, rtol=2e-5, atol=2e-5)
    dp, tp = 2, 4
    for di in range(dp):
        for mi in range(tp):
            mesh = GridMesh(dp * tp, di * tp + mi, CPU, (
                DataAxis(dp, di, CPU, None, "data"),
                DataAxis(tp, mi, CPU, None, "model")))
            rows = slice(di * b // dp, (di + 1) * b // dp)
            heads = slice(mi * h // tp, (mi + 1) * h // tp)
            got = sharded_flash_attention(
                *(torch.from_numpy(np.ascontiguousarray(a[rows, :, heads]))
                  for a in (q, k, v)), mesh=mesh, batch_axis="data",
                head_axis="model", causal=causal)
            np.testing.assert_allclose(got.numpy(), want[rows, :, heads],
                                       rtol=2e-5, atol=2e-5)


# -- checkpoints across the packages -------------------------------------------

def _regions(path, leaf_filter=None):
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


def test_the_tp_directory_holds_the_jax_slices(world, tmp_path):
    """The port's DP x TP sharded directory holds the slices of the TP
    leaves the JAX DP x TP run's holds: contiguous pieces of qkv."""
    pdir = port_ckpt.latest_checkpoint(str(world["root"] / "sharded"))
    mesh = jax_make_mesh(("data", "model"), shape=(4, 2))
    jst, _ = jax_shard_state(
        jax_create_train_state(_f32_vit(), jax.random.key(0),
                               optimizer="sgd"), mesh, jax_vit_tp_rules())
    jdir = jax_ckpt.save_checkpoint(jst, epoch=0, best_acc=0.0,
                                    is_best=False, directory=str(tmp_path),
                                    layout="sharded")
    port = _regions(pdir)
    assert port == _regions(jdir)
    assert (QKV, (0, 0), (64, 96)) in port
    assert (QKV, (0, 96), (64, 192)) in port


@pytest.mark.parametrize("layout", ["sharded", "npz", "delta"])
def test_the_port_tp_checkpoint_resumes_in_jax_and_one_process(world,
                                                               layout):
    """A DP x TP checkpoint of the port, in each layout, loads into the
    JAX DP x TP template, a JAX single-device one and a one-process port
    state, with the init's params."""
    path = port_ckpt.latest_checkpoint(str(world["root"] / layout))
    want = _leaves({"params": jax_create_train_state(
        _f32_vit(), jax.random.key(0), optimizer="sgd").params})
    mesh = jax_make_mesh(("data", "model"), shape=(4, 2))
    tmpl, _ = jax_shard_state(jax_create_train_state(
        _f32_vit(), jax.random.key(7), optimizer="sgd"), mesh,
        jax_vit_tp_rules())
    for template in (tmpl, jax_create_train_state(
            _f32_vit(), jax.random.key(7), optimizer="sgd")):
        restored, epoch, _ = jax_ckpt.load_checkpoint(path, template)
        assert epoch == 1
        got = _leaves({"params": jax.device_get(restored.params)})
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)
    st = create_train_state(get_model("vit", compute_dtype=torch.float32),
                            5, CPU, optimizer="sgd")
    port_ckpt.load_checkpoint(path, st)
    got = dict(state_to_jax(st))
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value,
                                      err_msg=name)


def test_a_jax_tp_directory_resumes_in_the_port_tp_world(world):
    want = _jax_tree(jax.device_get(world["jst"]))
    for res in world["ranks"]:
        for name, value in want.items():
            np.testing.assert_array_equal(res[f"jax_ckpt/{name}"], value,
                                          err_msg=name)


# -- the CLI ------------------------------------------------------------------------

def _base(tmp_path, *extra, model="vit"):
    return ["--dataset", "synthetic", "--model", model, "--epochs", "1",
            "--batch-size", "64", "--synthetic-train-size", "256",
            "--synthetic-test-size", "128", "--seed", "0", "--dtype", "f32",
            "--device", "cpu", "--root", str(tmp_path / "data"), *extra]


def _cli_world(tmp_path, name, n, *extra):
    """The epoch rows of a spawned world of ``n`` gloo ranks."""
    rows = tmp_path / f"{name}.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
         "--spawn", str(n), *_base(tmp_path), "--checkpoint-dir",
         str(tmp_path / name), "--metrics-file", str(rows), *extra],
        capture_output=True, text=True, timeout=WORLD_TIMEOUT, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [json.loads(line) for line in rows.read_text().splitlines()
            if '"train_loss"' in line]


def _one(tmp_path, name, *extra):
    return cli.run(cli.build_parser().parse_args(_base(
        tmp_path, "--checkpoint-dir", str(tmp_path / name), *extra)))


def test_cli_tensor_parallel_flash_fused_adam_matches_one_process(tmp_path):
    """--tensor-parallel 2 with --attention flash, --loss fused and
    --optimizer adam_pallas trains through the CLI and matches the
    one-process run of the same flags (TP is a layout change)."""
    flags = ("--attention", "flash", "--loss", "fused", "--optimizer",
             "adam_pallas")
    tp = _cli_world(tmp_path, "tp", 2, "--tensor-parallel", "2", *flags)
    one = _one(tmp_path, "one", *flags)["history"]
    assert tp[0]["train_loss"] == pytest.approx(one[0]["train_loss"],
                                                rel=1e-4)
    assert tp[0]["test_acc"] == pytest.approx(one[0]["test_acc"], abs=1e-6)


def test_cli_tensor_parallel_composes_with_zero1(tmp_path):
    rows = _cli_world(tmp_path, "z1", 4, "--tensor-parallel", "2",
                      "--optimizer-sharding", "zero1")
    one = _one(tmp_path, "one")["history"]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    assert rows[0]["train_loss"] == pytest.approx(one[0]["train_loss"],
                                                  rel=1e-4)
    assert rows[0]["test_acc"] == pytest.approx(one[0]["test_acc"],
                                                abs=1e-6)


def _refused(tmp_path, *extra, devices=8, model="vit") -> str:
    """The refusal of the flags on the JAX tests' 8 devices (the check
    takes the world's device count)."""
    args = cli.build_parser().parse_args(_base(
        tmp_path, "--checkpoint-dir", str(tmp_path / "ckpt"), *extra,
        model=model))
    with pytest.raises(SystemExit) as info:
        cli._check_parallel_flags(args, devices)
    return str(info.value)


def test_cli_tensor_parallel_rejects_non_vit(tmp_path):
    assert "require --model vit" in _refused(
        tmp_path, "--tensor-parallel", "2", model="cnn")


def test_cli_tensor_parallel_rejects_an_indivisible_world(tmp_path):
    assert _refused(tmp_path, "--tensor-parallel", "2", devices=3) == (
        "--tensor-parallel 2 x --sequence-parallel 1 does not divide the "
        "3 available devices")


@pytest.mark.parametrize("extra,devices,words", [
    (["--optimizer-sharding", "zero3"], 8, "zero3 composes with data"),
    (["--optimizer-sharding", "zero1", "--zero-overlap"], 8,
     "--zero-overlap composes with data parallelism only"),
    (["--expert-parallel", "2", "--model", "moe_mlp"], 8,
     "--expert-parallel does not combine with"),
    (["--tensor-parallel", "3", "--attention", "flash"], 6,
     "the width must divide 4"),
    (["--attention", "flash", "--batch-size", "62"], 8,
     "must divide evenly over the 4 data slices"),
])
def test_cli_tensor_parallel_refuses_what_jax_refuses(tmp_path, extra,
                                                      devices, words):
    assert words in _refused(tmp_path, "--tensor-parallel", "2", *extra,
                             devices=devices)
