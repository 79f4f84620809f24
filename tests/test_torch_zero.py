"""The port's ZeRO (``parallel/zero.py``) and overlapped ZeRO
(``parallel/zero_overlap.py``) against the JAX package's, on the CPU.

Twins of ``tests/test_zero1.py`` (all 11 cases) and of the flat-mesh
cases of ``tests/test_zero_overlap.py``. The JAX side runs on its
8-device CPU mesh; the port's steps run in one gloo world of 2 processes
(one module fixture runs every case there), each rank on its half of the
same seeded global batches. Placing the optimizer state changes where it
lives, not what the training computes: the sharded steps equal the
replicated ones.

Tolerances (float32 everywhere): the port's sharded paths against its own
replicated path rtol/atol 1e-6 (the JAX suite's bound for its two
layouts; a reduce-scatter sums the same two rank terms as the all-reduce);
against the JAX package loss sums rtol 1e-5 and params/moments rtol 2e-4
/ atol 2e-5 (the overlap suite's ``_assert_trees_close``: Adam's
normalised step turns rounding noise of a near-zero gradient into a move
of up to lr).
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
from pytorch_distributed_mnist_tpu.parallel.zero import (
    shard_state_zero as jax_shard_state_zero,
)
from pytorch_distributed_mnist_tpu.parallel.zero_overlap import (
    bucket_plan as jax_bucket_plan,
)
from pytorch_distributed_mnist_tpu.parallel.zero_overlap import (
    make_overlap_train_step as jax_make_overlap_train_step,
)
from pytorch_distributed_mnist_tpu.parallel.zero_overlap import (
    make_param_gather as jax_make_param_gather,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    jax_param_order,
    state_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.parallel.expert import moe_ep_rules
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
    DataAxis,
    ExpertMesh,
    make_mesh,
)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import P
from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
    ZeroPlane,
    _zero_spec,
    shard_state_zero,
    zero1_state_sharding,
)
from pytorch_distributed_mnist_tpu_torch.parallel.zero_overlap import (
    _shard_dims,
    bucket_plan,
)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 240  # seconds the world of 2 may take for every case

# One rank of the world of 2: ``python -c _RANK coordinator rank dir`` runs
# every case of ``dir/job.json`` and writes rank{r}.npz.
_RANK = r"""
import json, sys
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    metric_all_reduce)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
    shard_state_zero)
from pytorch_distributed_mnist_tpu_torch.parallel.zero_overlap import (
    make_comm_only_program, make_overlap_train_epoch,
    make_overlap_train_step)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as ck
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state)
from pytorch_distributed_mnist_tpu_torch.train.steps import (
    make_train_epoch, train_step)

torch.set_num_threads(1)
coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
job = json.load(open(f"{out}/job.json"))
cpu = torch.device("cpu")
distributed.initialize_distributed(coord, 2, rank, cpu)
axis = make_mesh(device=cpu)
z = np.load(job["data"])
res = {}

def local(a, lead=0):
    b = a.shape[lead] // 2
    return a[(slice(None),) * lead + (slice(rank * b, (rank + 1) * b),)]

def batch(i):
    img, lab = z[f"image{i}"], z[f"label{i}"]
    return {"image": torch.from_numpy(local(img)),
            "label": torch.from_numpy(local(lab)).long(),
            "mask": torch.ones(img.shape[0] // 2)}

for c in job["cases"]:
    tag = c["tag"]
    st = create_train_state(get_model(c["model"], compute_dtype=torch.float32),
                            3, cpu, optimizer=c["optimizer"])
    ck.load_checkpoint(c["init"], st)
    if c["level"]:
        shard_state_zero(st, axis, level=c["level"],
                         bucket_mb=c["bucket_mb"], overlap=c["overlap"])
        if c.get("load"):
            ck.load_checkpoint(c["load"], st)  # into the placed state
        z3 = st.param_leaves()
        res[f"{tag}/shapes"] = np.array(
            [list(z3[n].shape) for n in sorted(z3) if z3[n].dim() == 2][:1])
    overlap = c["overlap"]
    if c["mode"] == "epoch":
        staged = {"image": torch.from_numpy(local(z["stack_image"], 1)),
                  "label": torch.from_numpy(local(z["stack_label"], 1)).long(),
                  "mask": torch.ones(4, 32)}
        epoch = (make_overlap_train_epoch if overlap else make_train_epoch)(
            st, axis)
        ms = [metric_all_reduce(epoch(staged), axis)]
    else:
        if overlap:
            step = make_overlap_train_step(st, axis, c["accum"])
        else:
            step = lambda b: train_step(st, b, axis, c["accum"])
        ms = [metric_all_reduce(step(batch(i)), axis)
              for i in range(c["steps"])]
    res[f"{tag}/metrics"] = np.array([[float(t) for t in m] for m in ms])
    for name, arr in state_to_jax(st):
        res[f"{tag}/{name}"] = arr
    if c.get("comm"):
        res[f"{tag}/comm"] = np.array(float(make_comm_only_program(st)()))
    if c.get("save"):
        ck.save_checkpoint(st, epoch=0, best_acc=0.5, is_best=False,
                           directory=f"{out}/{tag}", layout="sharded")
np.savez(f"{out}/rank{rank}.npz", **res)
distributed.teardown()
"""


def _batch(seed, n=64):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 28, 28, 1)).astype(np.float32),
            r.integers(0, 10, size=(n,)).astype(np.int32))


def _stack():
    r = np.random.default_rng(7)
    return (r.normal(size=(4, 64, 28, 28, 1)).astype(np.float32),
            r.integers(0, 10, size=(4, 64)).astype(np.int32))


def _jax_state(model, seed=0):
    return jax_create_train_state(
        jax_get_model(model, compute_dtype=jnp.float32),
        jax.random.key(seed))


def _jbatch(seed):
    img, lab = _batch(seed)
    return {"image": jnp.asarray(img), "label": jnp.asarray(lab)}


def _jax_leaves(state) -> dict:
    return {k: np.asarray(v) for k, v in jax_ckpt._leaves_with_names(
        jax_ckpt._state_tree(jax.device_get(state)))}


# tag: (model, level, overlap, bucket_mb, accum, mode, steps, extras)
CASES = {
    "rep_cnn": ("cnn", 0, False, None, 1, "steps", 3, {}),
    "z1_cnn": ("cnn", 1, False, None, 1, "steps", 3, {}),
    "z3_cnn": ("cnn", 3, False, None, 1, "steps", 1, {}),
    "rep_cnn1": ("cnn", 0, False, None, 1, "steps", 1, {}),
    "rep_epoch": ("linear", 0, False, None, 1, "epoch", 1, {}),
    "z1_epoch": ("linear", 1, False, None, 1, "epoch", 1, {}),
    "rep_lin": ("linear", 0, False, None, 1, "steps", 3, {}),
    "ov1": ("linear", 1, True, 0.5, 1, "steps", 3, {"comm": True}),
    "ov3": ("linear", 3, True, 0.5, 1, "steps", 3, {}),
    "pr1": ("linear", 1, False, None, 1, "steps", 3, {"save": True}),
    "pr3": ("linear", 3, False, None, 1, "steps", 3, {}),
    "ov1_epoch": ("linear", 1, True, 0.5, 1, "epoch", 1, {}),
    "ov3_epoch": ("linear", 3, True, 0.5, 1, "epoch", 1, {}),
    "ov1_cnn": ("cnn", 1, True, 1.0, 1, "steps", 3, {}),
    "ov3_cnn": ("cnn", 3, True, 1.0, 1, "steps", 3, {}),
    "rep_acc": ("linear", 0, False, None, 2, "steps", 2, {}),
    "ov_acc": ("linear", 1, True, 0.5, 2, "steps", 2, {}),
    "load8": ("linear", 1, False, None, 1, "steps", 0, {"load": True}),
    "rep_moe": ("moe_mlp", 0, False, None, 1, "steps", 2, {}),
    "z1_moe": ("moe_mlp", 1, False, None, 1, "steps", 2, {}),
    "z3_moe": ("moe_mlp", 3, False, None, 1, "steps", 2, {}),
    "ov1_moe": ("moe_mlp", 1, True, 0.05, 1, "steps", 2, {}),
    "ov3_moe": ("moe_mlp", 3, True, 0.05, 1, "steps", 2, {}),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory, mesh8):
    root = tmp_path_factory.mktemp("zero_world")
    # A JAX ZeRO-1 directory from the 8-device mesh, for the world to load.
    jstate, sh = jax_shard_state_zero(_jax_state("linear", seed=4), mesh8,
                                      level=1)
    jstate, _ = jax_make_train_step(mesh8, state_sharding=sh)(jstate,
                                                               _jbatch(5))
    jax8 = jax_ckpt.save_checkpoint(jstate, epoch=0, best_acc=0.25,
                                    is_best=False,
                                    directory=str(root / "jax8"),
                                    process_index=0, layout="sharded")
    arrays = {}
    for i in range(3):
        arrays[f"image{i}"], arrays[f"label{i}"] = _batch(seed=i)
    arrays["stack_image"], arrays["stack_label"] = _stack()
    np.savez(root / "data.npz", **arrays)
    inits = {}
    for model in ("linear", "cnn", "moe_mlp"):
        inits[model] = jax_ckpt.save_checkpoint(
            _jax_state(model), epoch=-1, best_acc=0.0, is_best=False,
            directory=str(root / f"init_{model}"))
    cases = [{"tag": tag, "model": m, "optimizer": "adam", "level": lv,
              "overlap": ov, "bucket_mb": mb, "accum": acc, "mode": mode,
              "steps": n, "init": inits[m],
              **{k: (jax8 if k == "load" else v) for k, v in extra.items()}}
             for tag, (m, lv, ov, mb, acc, mode, n, extra) in CASES.items()]
    (root / "job.json").write_text(json.dumps(
        {"data": str(root / "data.npz"), "cases": cases}))
    port = launcher.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, f"127.0.0.1:{port}", str(r),
         str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        texts = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r}:\n{text}"
    return {"ranks": [dict(np.load(root / f"rank{r}.npz")) for r in range(2)],
            "root": root, "inits": inits, "jax8": _jax_leaves(jstate)}


def _case(res, tag) -> dict:
    pre = f"{tag}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)
            and k[len(pre):].startswith("[")}


def _close(got: dict, want: dict, rtol, atol, params_only=False):
    keys = [k for k in want if not params_only or k.startswith("['params']")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# -- tests/test_zero1.py twins -------------------------------------------------

def test_zero_spec_picks_largest_divisible_dim():
    assert _zero_spec((3, 3, 1, 32), 8, "data", P()) == P(None, None, None,
                                                         "data")
    assert _zero_spec((12544, 128), 8, "data", P()) == P("data", None)
    assert _zero_spec((10,), 8, "data", P()) == P()  # nothing divisible
    assert _zero_spec((), 8, "data", P()) == P()  # scalar (count)
    # A dim the base layout already claims is not re-used.
    assert _zero_spec((64, 128), 8, "data", P(None, "model")) == P("data",
                                                                   "model")


def test_zero_spec_tie_breaks_to_lowest_dim():
    assert _zero_spec((64, 64), 8, "data", P()) == P("data", None)
    assert _zero_spec((8, 32, 32), 8, "data", P()) == P(None, "data", None)
    # A tie where the lowest dim is base-claimed falls to the next one.
    assert _zero_spec((64, 64), 8, "data", P("model")) == P("model", "data")


def test_moments_are_sharded_params_replicated(mesh8):
    """The port's table on an 8-rank data axis equals the JAX one's
    specs, leaf for leaf (in the JAX layout)."""
    from pytorch_distributed_mnist_tpu.parallel.zero import (
        zero1_state_sharding as jax_zero1_state_sharding,
    )

    state = create_train_state(get_model("cnn"), 0, CPU)
    sharding = zero1_state_sharding(state, DataAxis(8, 0, CPU, None))
    for name, spec in sharding.items():
        if name.startswith("['params']"):
            assert spec == P()
    sharded = {n: s for n, s in sharding.items()
               if ("mu" in n or "nu" in n) and s != P()}
    assert sharded, "no moment leaf got sharded"
    for name, spec in sharded.items():
        assert "data" in tuple(spec), (name, spec)
    jsh = jax_zero1_state_sharding(_jax_state("cnn"), mesh8)
    want = {k: tuple(v.spec) for k, v in jax_ckpt._leaves_with_names(
        jax_ckpt._state_tree(jsh))}
    for name, spec in sharding.items():
        trimmed = tuple(spec)
        while trimmed and trimmed[-1] is None:
            trimmed = trimmed[:-1]
        wanted = want[name]
        while wanted and wanted[-1] is None:
            wanted = wanted[:-1]
        assert trimmed == wanted, name


def test_zero1_step_matches_replicated(world, mesh8):
    """3 sharded-optimizer steps == 3 replicated steps, and the JAX ones."""
    rank0 = world["ranks"][0]
    z, ref = _case(rank0, "z1_cnn"), _case(rank0, "rep_cnn")
    np.testing.assert_allclose(rank0["z1_cnn/metrics"][-1][0],
                               rank0["rep_cnn/metrics"][-1][0], rtol=1e-6)
    _close(z, ref, rtol=1e-6, atol=1e-6)  # params AND moments
    jstate = _jax_state("cnn")
    step = jax_make_train_step(mesh8)
    for i in range(3):
        jstate, jm = step(jstate, _jbatch(i))
    np.testing.assert_allclose(rank0["z1_cnn/metrics"][-1][0],
                               float(jm.loss_sum), rtol=1e-5)
    # Across the packages, three Adam steps of the cnn's 1.6 M elements:
    # an element whose gradient is near 0 moves by up to lr = 1e-3 on its
    # rounding noise alone (2 elements land 3e-5 apart): a tenth of lr.
    _close(z, _jax_leaves(jstate), rtol=2e-4, atol=1e-4, params_only=True)


def test_zero1_scan_epoch_matches_replicated(world, mesh8):
    """The scanned epoch accepts the ZeRO layout and agrees."""
    from pytorch_distributed_mnist_tpu.train.steps import (
        make_train_epoch as jax_make_train_epoch,
    )

    rank0 = world["ranks"][0]
    assert rank0["z1_epoch/metrics"][0][2] == rank0["rep_epoch/metrics"][0][2]
    np.testing.assert_allclose(rank0["z1_epoch/metrics"][0][0],
                               rank0["rep_epoch/metrics"][0][0], rtol=1e-6)
    _close(_case(rank0, "z1_epoch"), _case(rank0, "rep_epoch"), rtol=1e-6,
           atol=1e-6, params_only=True)
    img, lab = _stack()
    jstate, jm = jax_make_train_epoch(mesh8)(
        _jax_state("linear"), {"image": jnp.asarray(img),
                               "label": jnp.asarray(lab)})
    np.testing.assert_allclose(rank0["z1_epoch/metrics"][0][0],
                               float(jm.loss_sum), rtol=1e-5)
    _close(_case(rank0, "z1_epoch"), _jax_leaves(jstate), rtol=2e-4,
           atol=2e-5, params_only=True)


def test_zero1_respects_ep_rules():
    """Moment leaves a rule lays out keep the rule's layout (the EP
    table's)."""
    state = create_train_state(get_model("moe_mlp"), 0, CPU)
    mesh = ExpertMesh(4, 0, CPU, DataAxis(2, 0, CPU, None, "data"),
                      DataAxis(2, 0, CPU, None, "expert"))
    sharding = zero1_state_sharding(state, mesh, rules=moe_ep_rules())
    mu = "['opt_state'].inner_state[0].mu['params']"
    assert sharding[mu + "['moe']['w1']"] == P("expert", None, None)
    assert sharding[mu + "['embed']['kernel']"] == P("data", None)
    assert sharding["['params']['params']['moe']['w1']"] == P("expert", None,
                                                              None)


def test_zero1_respects_tp_rules():
    """The TP table's leaves keep its layout, moments and params alike
    (head-aligned qkv included); ZeRO claims the other moments over
    data: the JAX ``shard_state_zero(rules=vit_tp_rules)`` layout."""
    from pytorch_distributed_mnist_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )
    from pytorch_distributed_mnist_tpu.parallel.tensor import (
        vit_tp_rules as jax_vit_tp_rules,
    )
    from pytorch_distributed_mnist_tpu.parallel.zero import (
        zero1_state_sharding as jax_zero1_state_sharding,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import GridMesh
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        vit_tp_rules,
    )

    state = create_train_state(get_model("vit"), 0, CPU)
    mesh = GridMesh(8, 0, CPU, (DataAxis(4, 0, CPU, None, "data"),
                                DataAxis(2, 0, CPU, None, "model"),
                                DataAxis(1, 0, CPU, None, "seq")))
    sharding = zero1_state_sharding(state, mesh, rules=vit_tp_rules())
    mu = "['opt_state'].inner_state[0].mu['params']"
    qkv = "['block0']['attn']['qkv']['kernel']"
    assert sharding[mu + qkv] == P(None, "model")
    assert sharding[mu + qkv].blocks == 3
    assert sharding["['params']['params']" + qkv] == P(None, "model")
    # (16, 64): ZeRO splits the larger dim.
    assert sharding[mu + "['embed']['kernel']"] == P(None, "data")
    assert sharding["['params']['params']['embed']['kernel']"] == P()
    jstate = jax_create_train_state(jax_get_model("vit"), jax.random.key(0))
    tree = jax_zero1_state_sharding(
        jstate, jax_make_mesh(("data", "model"), shape=(4, 2)),
        rules=jax_vit_tp_rules())
    want = {k: v.spec for k, v in jax_ckpt._leaves_with_names(
        {"params": tree.params, "opt_state": tree.opt_state,
         "step": tree.step})}
    assert sorted(sharding) == sorted(want)
    for name, spec in sharding.items():
        assert tuple(spec) == tuple(want[name]), name


def _cli(tmp_path, *extra, model="linear"):
    return cli.build_parser().parse_args([
        "--dataset", "synthetic", "--model", model, "--epochs", "1",
        "--batch-size", "64", "--synthetic-train-size", "256",
        "--synthetic-test-size", "128", "--seed", "0", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--root", str(tmp_path / "data"), *extra])


def test_cli_zero1_end_to_end(tmp_path):
    summary = cli.run(_cli(tmp_path, "--optimizer-sharding", "zero1"))
    assert summary["epochs_run"] == 1
    assert np.isfinite(summary["history"][0]["train_loss"])


def test_cli_zero1_rejects_momentless_optimizer(tmp_path):
    with pytest.raises(SystemExit, match="zero1 requires an Adam"):
        cli.run(_cli(tmp_path, "--optimizer", "sgd",
                     "--optimizer-sharding", "zero1"))


def test_zero3_step_matches_replicated(world):
    """Params sharded over data (level 3): one train step == the
    replicated step."""
    rank0 = world["ranks"][0]
    assert rank0["z3_cnn/metrics"][0][0] == pytest.approx(
        rank0["rep_cnn1/metrics"][0][0], rel=1e-6)
    _close(_case(rank0, "z3_cnn"), _case(rank0, "rep_cnn1"), rtol=1e-4,
           atol=5e-5)


def test_zero3_actually_shards_params(world):
    """fc1's kernel (12544, 128) is stored as this rank's half of dim 0
    between steps; the moments too (the checkpoint layer's record)."""
    for rank, res in enumerate(world["ranks"]):
        assert res["z3_cnn/shapes"].tolist() == [[6272, 128]], rank
        assert res["z1_cnn/shapes"].tolist() == [[12544, 128]], rank


def test_cli_zero3_end_to_end(tmp_path):
    summary = cli.run(_cli(tmp_path, "--optimizer-sharding", "zero3",
                           model="cnn"))
    assert summary["epochs_run"] == 1
    assert np.isfinite(summary["history"][0]["train_loss"])


# -- tests/test_zero_overlap.py twins (the flat data mesh) ---------------------

class _Leaf:
    def __init__(self, shape, dtype=np.float32):
        self.shape = shape
        self.dtype = np.dtype(dtype)


def test_bucket_plan_size_ordered_and_budgeted():
    leaves = [_Leaf((10,)), _Leaf((1024, 256)), _Leaf((1024,)),
              _Leaf((512, 512))]
    plan = bucket_plan(leaves, bucket_mb=1.0)
    assert plan == [[1], [3], [2, 0]] == jax_bucket_plan(leaves, 1.0)
    tensors = [torch.zeros(s.shape) for s in leaves]
    assert bucket_plan(tensors, 1.0) == plan


def test_bucket_plan_oversize_leaf_gets_own_bucket():
    leaves = [_Leaf((4096, 1024)), _Leaf((4,))]
    assert bucket_plan(leaves, bucket_mb=1.0)[0] == [0]


def test_bucket_plan_deterministic_and_validates():
    leaves = [_Leaf((64, 64)) for _ in range(6)]
    assert bucket_plan(leaves, 0.02) == bucket_plan(leaves, 0.02) == \
        jax_bucket_plan(leaves, 0.02)
    with pytest.raises(ValueError, match="bucket_mb"):
        bucket_plan(leaves, 0.0)


def _jax_overlap_steps(model, level, bucket_mb, mesh8, steps=3):
    z = _jax_state(model)
    z, _ = jax_shard_state_zero(z, mesh8, level=level)
    step = jax_make_overlap_train_step(z, mesh8, level=level,
                                       bucket_mb=bucket_mb)
    gathered = jax_make_param_gather(mesh8)(z.params) if level == 3 else None
    for i in range(steps):
        if level == 3:
            z, gathered, zm = step(z, gathered, _jbatch(i))
        else:
            z, zm = step(z, _jbatch(i))
    return z, zm


@pytest.mark.parametrize("level", [1, 3])
def test_overlap_step_matches_propagation(world, mesh8, level):
    """3 overlapped steps == 3 propagation steps on the same layout ==
    the JAX overlapped steps."""
    rank0 = world["ranks"][0]
    ov, pr = _case(rank0, f"ov{level}"), _case(rank0, f"pr{level}")
    np.testing.assert_allclose(rank0[f"ov{level}/metrics"][-1][0],
                               rank0[f"pr{level}/metrics"][-1][0], rtol=1e-5)
    assert rank0[f"ov{level}/metrics"][-1][2] == 64
    _close(ov, pr, rtol=2e-4, atol=2e-5)
    _close(ov, _case(rank0, "rep_lin"), rtol=2e-4, atol=2e-5)
    z, zm = _jax_overlap_steps("linear", level, 0.5, mesh8)
    np.testing.assert_allclose(rank0[f"ov{level}/metrics"][-1][0],
                               float(zm.loss_sum), rtol=1e-5)
    _close(ov, _jax_leaves(z), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("level", [1, 3])
def test_overlap_step_matches_propagation_cnn(world, level):
    """The conv model: multi-bucket plans and dim-0 shards of OIHW
    kernels (dim 3 of JAX's HWIO)."""
    rank0 = world["ranks"][0]
    np.testing.assert_allclose(rank0[f"ov{level}_cnn/metrics"][-1][0],
                               rank0["rep_cnn/metrics"][-1][0], rtol=1e-5)
    _close(_case(rank0, f"ov{level}_cnn"), _case(rank0, "rep_cnn"),
           rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("level", [1, 3])
def test_overlap_scan_epoch_matches_propagation(world, level):
    rank0 = world["ranks"][0]
    m = rank0[f"ov{level}_epoch/metrics"][0]
    assert m[2] == rank0["rep_epoch/metrics"][0][2]
    np.testing.assert_allclose(m[0], rank0["rep_epoch/metrics"][0][0],
                               rtol=1e-5)
    _close(_case(rank0, f"ov{level}_epoch"), _case(rank0, "rep_epoch"),
           rtol=2e-4, atol=2e-5, params_only=True)


def test_overlap_grad_accum_composition(world):
    rank0 = world["ranks"][0]
    np.testing.assert_allclose(rank0["ov_acc/metrics"][-1][0],
                               rank0["rep_acc/metrics"][-1][0], rtol=1e-5)
    assert rank0["ov_acc/metrics"][-1][2] == rank0["rep_acc/metrics"][-1][2]
    _close(_case(rank0, "ov_acc"), _case(rank0, "rep_acc"), rtol=2e-4,
           atol=2e-5)


@pytest.mark.parametrize("tag", ["z1_moe", "z3_moe", "ov1_moe", "ov3_moe"])
def test_leaves_split_off_dim0_match_replicated(world, tag):
    """The MoE's expert leaves split off dim 0 (w1 on dim 2; w2, b1 and
    b2 on dim 1) and go through the packing buffer, beside dim-0 leaves
    that do not: 2 steps equal the replicated ones (the propagation path
    at the sharded-vs-replicated bound, the overlapped one at the overlap
    bound: it divides a per-example sum)."""
    rank0 = world["ranks"][0]
    tol = (2e-4, 2e-5) if tag.startswith("ov") else (1e-6, 1e-6)
    np.testing.assert_allclose(rank0[f"{tag}/metrics"][-1][0],
                               rank0["rep_moe/metrics"][-1][0], rtol=1e-5)
    _close(_case(rank0, tag), _case(rank0, "rep_moe"), rtol=tol[0],
           atol=tol[1])


@pytest.mark.parametrize("model, packed", [
    ("cnn", []),
    ("moe_mlp", ["moe.b1", "moe.b2", "moe.w1", "moe.w2"]),
])
def test_the_plane_packs_only_leaves_split_off_dim0(model, packed):
    """On 2 ranks a dim-0 leaf reduce-scatters from its gradient view and
    all-gathers into its param: the plane's packing buffers hold only the
    other split leaves, so the cnn (every leaf on dim 0) keeps none and
    its extra buffers are the gradients (P) and the shards (2P/2)."""
    state = create_train_state(get_model(model), 0, CPU)
    named = dict(state.model.named_parameters())
    names = jax_param_order(named)
    leaves = [named[n] for n in names]
    plane = ZeroPlane(state, DataAxis(2, 0, CPU, None), 1,
                      _shard_dims(leaves, 2, "data"), bucket_plan(leaves, 1.0))
    got = sorted(names[i] for b in plane.buckets for i in b.packed)
    assert got == packed
    assert sum(t.numel() for t in plane.packing) == sum(
        named[n].numel() for n in packed)
    shards = plane.shard_flat.numel() + plane.grad_flat.numel()
    assert shards == sum(p.numel() for p in leaves)  # 2 x P/2
    assert sum(t.numel() for t in plane.unsplit_flat) == 0


def test_the_overlapped_plane_dies_with_its_state():
    """The backward hooks the overlapped plane puts on the params hold it
    weakly: once the state is dropped, the plane and its buffers go
    (they stayed alive for good while the hooks held the plane)."""
    import gc
    import weakref

    state = create_train_state(get_model("cnn"), 0, CPU)
    named = dict(state.model.named_parameters())
    leaves = [named[n] for n in jax_param_order(named)]
    plane = ZeroPlane(state, DataAxis(1, 0, CPU, None), 1,
                      _shard_dims(leaves, 1, "data"),
                      bucket_plan(leaves, 1.0), overlap=True)
    state.zero = plane
    dead = weakref.ref(plane)
    del plane, state, named, leaves
    gc.collect()
    assert dead() is None


def test_comm_only_program_runs_collective_sequence(world):
    for res in world["ranks"]:
        assert np.isfinite(res["ov1/comm"])
    assert world["ranks"][0]["ov1/comm"] == world["ranks"][1]["ov1/comm"]


@pytest.mark.parametrize("extra, match", [
    ([], "zero1 or zero3"),
    (["--optimizer-sharding", "zero1", "--trainer-mode", "explicit"],
     "explicit"),
    (["--optimizer-sharding", "zero1", "--loss", "fused"], "fused"),
    (["--optimizer-sharding", "zero1", "--epoch-gather", "device"],
     "epoch-gather host"),
    (["--optimizer-sharding", "zero1", "--zero-bucket-mb", "0"],
     "zero-bucket-mb"),
])
def test_cli_zero_overlap_rejects_bad_compositions(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        cli.run(_cli(tmp_path, "--zero-overlap", *extra))


def test_trainer_rejects_overlap_without_zero_sharding():
    from pytorch_distributed_mnist_tpu_torch.data.loader import (
        MNISTDataLoader,
    )

    images, labels = _batch(0)
    loader = MNISTDataLoader(images, labels, batch_size=64, train=True)
    state = create_train_state(get_model("linear"), 0, CPU)
    with pytest.raises(ValueError, match="ZeRO state sharding"):
        Trainer(state, loader, loader, CPU, zero_overlap=True)


def test_external_state_install_invalidates_gathered_carry(tmp_path):
    """The ZeRO-3 carry (the whole params gathered from the shards) is
    derived state: a checkpoint load into the shards marks it stale, and
    the next pass re-derives it from the INSTALLED shards."""
    from pytorch_distributed_mnist_tpu_torch.data.loader import (
        MNISTDataLoader,
    )

    images, labels = _batch(0)
    loader = MNISTDataLoader(images, labels, batch_size=16, train=True,
                             seed=0)
    state = create_train_state(get_model("linear",
                                         compute_dtype=torch.float32), 0, CPU)
    shard_state_zero(state, make_mesh(device=CPU), level=3, bucket_mb=0.5,
                     overlap=True)
    trainer = Trainer(state, loader, loader, CPU, mode="stepwise",
                      zero_overlap=True)
    trainer.train()
    assert not state.zero.stale  # the carry survives the epoch
    saved = port_ckpt.save_checkpoint(state, epoch=0, best_acc=0.0,
                                      is_best=False,
                                      directory=str(tmp_path / "a"))
    halved = port_ckpt.read_checkpoint_arrays(saved)[1]
    halved = {k: (v * 0.5 if k.startswith("['params']") else v)
              for k, v in halved.items()}
    port_ckpt._write_npz(list(halved.items()), epoch=1, best_acc=0.0,
                         directory=str(tmp_path / "b"))
    port_ckpt.load_checkpoint(str(tmp_path / "b" / "checkpoint_1.npz"),
                              state)
    assert state.zero.stale  # the load dropped the stale copy
    trainer.train()  # re-derives from the installed shards and trains
    for i, shard in state.zero.shards.items():
        np.testing.assert_array_equal(
            state.zero._rank_major(state.zero.params[i], i)[0].detach(),
            shard)
    trainer.close()


def test_checkpoint_roundtrip_overlapped_zero3(tmp_path):
    """Save under the overlapped ZeRO-3 plane (async writer), --resume
    auto, and the resumed epoch's metrics equal an uninterrupted run's."""
    def args(ckpt, epochs):
        return cli.build_parser().parse_args([
            "--dataset", "synthetic", "--model", "linear", "--device", "cpu",
            "--batch-size", "64", "--synthetic-train-size", "256",
            "--synthetic-test-size", "128", "--seed", "0",
            "--optimizer-sharding", "zero3", "--zero-overlap",
            "--async-checkpoint", "--resume", "auto",
            "--checkpoint-dir", str(ckpt), "--epochs", str(epochs),
            "--root", str(tmp_path / "data")])

    full = cli.run(args(tmp_path / "full", 3))
    cli.run(args(tmp_path / "cut", 2))
    resumed = cli.run(args(tmp_path / "cut", 3))
    assert resumed["start_epoch"] == 2 and resumed["epochs_run"] == 1
    row_full, row_res = full["history"][2], resumed["history"][0]
    assert row_res["epoch"] == 2
    for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
        np.testing.assert_allclose(row_res[key], row_full[key], rtol=1e-6,
                                   err_msg=key)


def test_cli_zero_overlap_zero3_stepwise(tmp_path):
    """ZeRO-3 overlapped through the stepwise path equals the scan run."""
    scan = cli.run(_cli(tmp_path / "a", "--optimizer-sharding", "zero3",
                        "--zero-overlap", "--epochs", "2"))
    stepw = cli.run(_cli(tmp_path / "b", "--optimizer-sharding", "zero3",
                         "--zero-overlap", "--trainer-mode", "stepwise",
                         "--epochs", "2"))
    for h_a, h_b in zip(scan["history"], stepw["history"]):
        np.testing.assert_allclose(h_a["train_loss"], h_b["train_loss"],
                                   rtol=1e-4)


# -- ZeRO checkpoints across the packages and worlds ---------------------------

def test_a_jax_zero1_world_of_8_directory_loads_in_port_worlds(
        world, mesh8, tmp_path):
    """A JAX ZeRO-1 ``.ckpt`` from the 8-device mesh loads in a port world
    of 1 and of 2 (ZeRO-1 placed: each rank keeps its slices); the port's
    world-of-2 ZeRO-1 directory (``pr1``, saved after three steps) loads
    in JAX and in a port world of 1 (ZeRO-3 placed)."""
    for res in world["ranks"]:
        got = _case(res, "load8")
        for name, arr in world["jax8"].items():
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
    jstate, _ = jax_shard_state_zero(_jax_state("linear"), mesh8, level=1)
    path = jax_ckpt.save_checkpoint(jstate, epoch=0, best_acc=0.25,
                                    is_best=False, directory=str(tmp_path),
                                    process_index=0, layout="sharded")
    state = create_train_state(get_model("linear",
                                         compute_dtype=torch.float32), 3, CPU)
    shard_state_zero(state, make_mesh(device=CPU), level=1)
    _, epoch, _ = port_ckpt.load_checkpoint(path, state)
    assert epoch == 1
    want = _jax_leaves(jstate)
    for name, arr in state_to_jax(state):
        np.testing.assert_array_equal(arr, want[name], err_msg=name)

    port_dir = os.path.join(world["root"], "pr1", "checkpoint_0.ckpt")
    idx = json.load(open(os.path.join(port_dir, "index_p00001.json")))
    assert idx["shards"], "rank 1 wrote its moment slices"
    restored, epoch, _ = jax_ckpt.load_checkpoint(
        port_dir, _jax_state("linear", seed=9))
    assert epoch == 1
    got = _jax_leaves(restored)
    for name, arr in _case(world["ranks"][0], "pr1").items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    one = create_train_state(get_model("linear", compute_dtype=torch.float32),
                             3, CPU)
    shard_state_zero(one, make_mesh(device=CPU), level=3)
    port_ckpt.load_checkpoint(port_dir, one)
    for name, arr in state_to_jax(one):
        np.testing.assert_array_equal(
            arr, _case(world["ranks"][0], "pr1")[name], err_msg=name)
