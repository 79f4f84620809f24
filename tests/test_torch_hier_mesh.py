"""The port's two-tier ``('dcn', 'ici')`` meshes (``parallel/mesh.py::
make_hier_mesh``), the two-tier ZeRO schedule (``parallel/zero.py``,
``parallel/zero_overlap.py``) and ``--dcn-slices`` against the JAX
package's, on the CPU: twins of ``tests/test_hier_mesh.py``.

The pure cases hold the port's slice resolution, mesh coordinates,
composed data axis and DCN bucket plans to the JAX functions on the same
inputs. The port's steps run in one gloo world of 4 processes (one module
fixture runs every case there, beside the CLI worlds), where each case
runs on the flat ``('data',)`` mesh of 4 and on the 2 x 2 two-tier mesh
from the same init and batches; the JAX side runs on its virtual CPU
devices (``make_hier_mesh(2, devices=jax.devices()[:4])``).

Tolerances are the JAX suite's: two-tier against flat (and against the
JAX two-tier step) rtol 2e-4 / atol 2e-5 on params and moments (Adam's
normalised step turns the rounding noise of a near-zero gradient into a
move of up to lr), loss sums rtol 1e-5, CLI histories train loss rtol
1e-4 and test accuracy rtol 1e-6, a resumed epoch against the
uninterrupted run rtol 2e-4.
"""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.parallel import mesh as jax_mesh
from pytorch_distributed_mnist_tpu.parallel.zero import (
    shard_state_zero as jax_shard_state_zero,
)
from pytorch_distributed_mnist_tpu.parallel.zero import (
    zero_state_sharding as jax_zero_state_sharding,
)
from pytorch_distributed_mnist_tpu.parallel.zero_overlap import (
    _dcn_bucket_plan as jax_dcn_bucket_plan,
)
from pytorch_distributed_mnist_tpu.parallel.zero_overlap import (
    _shard_dims as jax_shard_dims,
)
from pytorch_distributed_mnist_tpu.parallel.zero_overlap import (
    bucket_plan as jax_bucket_plan,
)
from pytorch_distributed_mnist_tpu.parallel.zero_overlap import (
    make_overlap_train_epoch as jax_make_overlap_train_epoch,
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
from pytorch_distributed_mnist_tpu_torch.parallel import mesh as port_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import P
from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
    shard_state_zero,
    zero_state_sharding,
)
from pytorch_distributed_mnist_tpu_torch.parallel.zero_overlap import (
    _dcn_bucket_plan,
    _shard_dims,
    _tier_axes,
    bucket_plan,
    make_comm_only_program,
    make_overlap_train_step,
)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 240  # seconds any one world of processes may take
ENV = "TPUMNIST_DCN_SLICES"

# One rank of the world of 4: ``python -c _RANK coordinator rank dir`` runs
# every case of dir/job.json on the flat mesh and on the 2 x 2 two-tier
# mesh, and writes rank{r}.npz.
_RANK = r"""
import json, sys
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.parallel import collectives as C
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.expert import moe_ep_rules
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
    make_hier_mesh, make_mesh)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    shard_state, vit_tp_rules)
from pytorch_distributed_mnist_tpu_torch.parallel.zero import (
    shard_state_zero)
from pytorch_distributed_mnist_tpu_torch.parallel.zero_overlap import (
    make_comm_only_program, make_overlap_train_epoch,
    make_overlap_train_step)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as ck
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state)
from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

torch.set_num_threads(1)
coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
job = json.load(open(f"{out}/job.json"))
cpu = torch.device("cpu")
distributed.initialize_distributed(coord, 4, rank, cpu)
# Every rank makes every mesh, in one order: each makes its subgroups.
meshes = {
    "flat": make_mesh(device=cpu),
    "hier": make_hier_mesh(2, device=cpu),
    "tp_flat": make_mesh(("data", "model", "seq"), (2, 2, 1), device=cpu),
    "tp_hier": make_hier_mesh(2, ("model", "seq"), (2, 1), device=cpu),
    "ep_flat": make_mesh(("data", "expert"), (2, 2), device=cpu),
    "ep_hier": make_hier_mesh(2, ("expert",), (2,), device=cpu),
}
z = np.load(job["data"])
res = {}
for name, m in meshes.items():
    res[f"mesh/{name}"] = np.array([m.data.size, m.data.rank])

def rows(a, axis, lead=0):
    b = a.shape[lead] // axis.size
    return a[(slice(None),) * lead
             + (slice(axis.rank * b, (axis.rank + 1) * b),)]

def batch(i, axis):
    img, lab = rows(z[f"image{i}"], axis), rows(z[f"label{i}"], axis)
    return {"image": torch.from_numpy(img),
            "label": torch.from_numpy(lab).long(),
            "mask": torch.ones(img.shape[0])}

def counts():
    rs = C.shard_collective.route_launches
    return [C.count_all_reduce.launches, C.grad_all_reduce.launches,
            rs["reduce_scatter"], rs["all_reduce"], rs["all_gather"],
            C.dcn_all_reduce.launches]

def record(tag, st, ms, per_step=()):
    res[f"{tag}/metrics"] = np.array(ms)
    if per_step:
        res[f"{tag}/counts"] = np.array(per_step)
    for name, arr in state_to_jax(st):
        res[f"{tag}/{name}"] = arr
    plane = st.zero
    if plane is not None:
        res[f"{tag}/plane"] = np.array([
            sum(1 for b in plane.buckets if b.packed),
            sum(len(b.direct) for b in plane.buckets),
            sum(1 for b in plane.buckets if b.unsplit), len(plane.params),
            len(plane.dcn_plan)])
        res[f"{tag}/moments"] = np.concatenate([
            t.detach().numpy().ravel()
            for _, v in st.optimizer.inner_leaves() if isinstance(v, list)
            for t in v])

def state(model, init, **kw):
    st = create_train_state(
        get_model(model, compute_dtype=torch.float32, **kw), 3, cpu)
    ck.load_checkpoint(init, st)
    return st

for c in job["cases"]:
    for where in ("flat", "hier"):
        mesh = meshes[where]
        axis = mesh.data
        tag = f"{c['tag']}/{where}"
        st = state("linear", job["init"])
        if c["level"]:
            shard_state_zero(st, mesh, level=c["level"],
                             bucket_mb=c["bucket_mb"], overlap=c["overlap"],
                             bucket_mb_dcn=c["bucket_mb_dcn"])
        dcn_mb = c["bucket_mb_dcn"] if where == "hier" else None
        ms, per = [], []
        if c["mode"] == "epoch":
            staged = {"image": torch.from_numpy(
                          rows(z["stack_image"], axis, 1)),
                      "label": torch.from_numpy(
                          rows(z["stack_label"], axis, 1)).long(),
                      "mask": torch.ones(4, 64 // axis.size)}
            epoch = make_overlap_train_epoch(st, axis, bucket_mb_dcn=dcn_mb)
            ms.append([float(t) for t in C.metric_all_reduce(epoch(staged),
                                                             axis)])
            carried = [p.detach().clone() for p in st.zero.params]
            st.zero.gather_params()
            res[f"{tag}/carry_equal"] = np.array(all(
                torch.equal(a, b) for a, b in zip(carried, st.zero.params)))
        else:
            if c["overlap"]:
                step = make_overlap_train_step(st, axis, bucket_mb_dcn=dcn_mb)
            else:
                step = lambda b: train_step(st, b, axis)
            for i in range(c["steps"]):
                before = counts()
                m = step(batch(i, axis))
                per.append([a - b for a, b in zip(counts(), before)])
                ms.append([float(t) for t in C.metric_all_reduce(m, axis)])
        record(tag, st, ms, per)
        if c.get("comm"):
            for tier in ((None, "ici", "dcn") if where == "hier" else (None,)):
                before = counts()
                val = float(make_comm_only_program(
                    st, bucket_mb_dcn=c["comm"], tier=tier)())
                res[f"{tag}/comm_{tier}"] = np.array(
                    [val] + [a - b for a, b in zip(counts(), before)]
                    + [len(st.zero.dcn_plan)])
        if c.get("save"):
            ck.save_checkpoint(st, epoch=0, best_acc=0.5, is_best=False,
                               directory=f"{out}/{c['tag']}_{where}",
                               layout="sharded")
        if c.get("load") and where == "hier":
            back = state("linear", job["init"])
            shard_state_zero(back, mesh, level=1)
            ck.load_checkpoint(job["jax_hier"], back)
            record(f"{c['tag']}/loaded", back, [])

# TP 2 (dense attention) and EP 2 (dense dispatch), nested in a slice.
for fam, model, rules, kw in (
        ("tp", "vit", vit_tp_rules, {"patch_size": 7}),
        ("ep", "moe_mlp", moe_ep_rules, {})):
    for where in ("flat", "hier"):
        mesh = meshes[f"{fam}_{where}"]
        axis = mesh.data
        for zero in (0, 1):
            st = state(model, job[f"init_{model}"], mesh=mesh, **kw)
            if zero:
                shard_state_zero(st, mesh, rules=rules(), level=1)
            else:
                shard_state(st, mesh, rules())
            ms = [[float(t) for t in C.metric_all_reduce(
                train_step(st, batch(i, axis), axis), axis)]
                for i in range(2)]
            record(f"{fam}{zero}/{where}", st, ms)
np.savez(f"{out}/rank{rank}.npz", **res)
distributed.teardown()
"""

# tag: (level, overlap, bucket_mb, bucket_mb_dcn, mode, steps, extras).
# On the 2 x 2 mesh the linear model's owner shards are 15,680 and 20
# bytes: a DCN budget of 0.01 MiB cuts them into 2 buckets, 0.125 MiB
# keeps them in 1 (and the propagation path has 1). ``comm``: the
# comm-only program's own DCN budget, the plan the state was not placed
# with.
CASES = {
    "plain": (0, False, None, None, "steps", 3, {}),
    "z1": (1, False, None, None, "steps", 3, {"save": True, "load": True}),
    "z3": (3, False, None, None, "steps", 3, {}),
    "ov1": (1, True, 0.5, 0.01, "steps", 3, {}),
    "ov3": (3, True, 0.5, 0.125, "steps", 3, {"comm": 0.01}),
    "ov3_epoch": (3, True, 0.5, 0.25, "epoch", 1, {}),
}
DCN_BUCKETS = {"z1": 1, "z3": 1, "ov1": 2, "ov3": 1}

CLI_BASE = ["--dataset", "synthetic", "--model", "linear",
            "--batch-size", "64", "--synthetic-train-size", "256",
            "--synthetic-test-size", "128", "--seed", "0", "--device", "cpu",
            "--agreement-timeout", "30"]


def _batch(seed, n=64):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 28, 28, 1)).astype(np.float32),
            r.integers(0, 10, size=(n,)).astype(np.int32))


def _stack():
    r = np.random.default_rng(7)
    return (r.normal(size=(4, 64, 28, 28, 1)).astype(np.float32),
            r.integers(0, 10, size=(4, 64)).astype(np.int32))


def _jbatch(seed):
    img, lab = _batch(seed)
    return {"image": jnp.asarray(img), "label": jnp.asarray(lab)}


def _jax_state(model="linear", seed=0, **kw):
    return jax_create_train_state(
        jax_get_model(model, compute_dtype=jnp.float32, **kw),
        jax.random.key(seed))


def _jax_leaves(state) -> dict:
    return {k: np.asarray(v) for k, v in jax_ckpt._leaves_with_names(
        jax_ckpt._state_tree(jax.device_get(state)))}


def _cli_world(flags, ckpt, metrics, n=4):
    """``--spawn n`` of the port's CLI on the CPU, as a process."""
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
         "--spawn", str(n)] + CLI_BASE + flags
        + ["--checkpoint-dir", str(ckpt), "--metrics-file", str(metrics)],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(procs):
    try:
        texts = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
    return texts


def _history(path):
    with open(path) as f:
        return [r for r in (json.loads(ln) for ln in f if ln.strip())
                if "train_loss" in r]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 4's per-rank results, and the CLI worlds' histories:
    a flat and a two-tier ZeRO-1 overlapped run (3 and 2 epochs) first,
    beside the case world, then each one's checkpoint resumed on the
    other mesh."""
    root = tmp_path_factory.mktemp("hier_world")
    arrays = {}
    for i in range(3):
        arrays[f"image{i}"], arrays[f"label{i}"] = _batch(seed=i)
    arrays["stack_image"], arrays["stack_label"] = _stack()
    np.savez(root / "data.npz", **arrays)
    inits = {}
    for model, kw in (("linear", {}), ("vit", {"patch_size": 7}),
                      ("moe_mlp", {})):
        inits[model] = jax_ckpt.save_checkpoint(
            _jax_state(model, **kw), epoch=-1, best_acc=0.0, is_best=False,
            directory=str(root / f"init_{model}"))
    # A JAX two-tier ZeRO-1 directory (one step on the 2 x 2 mesh).
    hier = jax_mesh.make_hier_mesh(2, devices=jax.devices()[:4])
    jst, sh = jax_shard_state_zero(_jax_state(seed=4), hier, level=1)
    jst, _ = jax_make_train_step(hier, state_sharding=sh)(jst, _jbatch(5))
    jax_hier = jax_ckpt.save_checkpoint(jst, epoch=0, best_acc=0.25,
                                        is_best=False,
                                        directory=str(root / "jax_hier"),
                                        process_index=0, layout="sharded")
    cases = [{"tag": tag, "level": lv, "overlap": ov, "bucket_mb": mb,
              "bucket_mb_dcn": dmb, "mode": mode, "steps": n, **extra}
             for tag, (lv, ov, mb, dmb, mode, n, extra) in CASES.items()]
    (root / "job.json").write_text(json.dumps(
        {"data": str(root / "data.npz"), "cases": cases,
         "init": inits["linear"], "init_vit": inits["vit"],
         "init_moe_mlp": inits["moe_mlp"], "jax_hier": jax_hier}))
    port = launcher.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, f"127.0.0.1:{port}", str(r),
         str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    overlap = ["--optimizer-sharding", "zero1", "--zero-overlap",
               "--resume", "auto"]
    cli_dirs = {k: root / f"cli_{k}" for k in ("flat", "hier", "grow")}
    flat = _cli_world(overlap + ["--epochs", "3"], cli_dirs["flat"],
                      root / "flat.jsonl")
    hier_cli = _cli_world(overlap + ["--epochs", "2", "--dcn-slices", "2",
                                     "--zero-bucket-mb-dcn", "1"],
                          cli_dirs["hier"], root / "hier.jsonl")
    texts = _finish(procs + [flat, hier_cli])
    # Each checkpoint resumed on the other mesh: the flat run's epoch-1
    # file on the two-tier world, the two-tier run's on a flat world of
    # one (in this process, below).
    cli_dirs["grow"].mkdir()
    shutil.copy(cli_dirs["flat"] / "checkpoint_1.npz", cli_dirs["grow"])
    grow = _cli_world(overlap + ["--epochs", "3", "--dcn-slices", "2"],
                      cli_dirs["grow"], root / "grow.jsonl")
    grow_text = _finish([grow])[0]
    return {"ranks": [dict(np.load(root / f"rank{r}.npz")) for r in range(4)],
            "root": root, "jax_hier": _jax_leaves(jst), "inits": inits,
            "cli": {k: _history(root / f"{k}.jsonl")
                    for k in ("flat", "hier", "grow")},
            "cli_dirs": cli_dirs, "hier_log": texts[-1],
            "grow_log": grow_text}


def _case(res, tag) -> dict:
    pre = f"{tag}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)
            and k[len(pre):].startswith("[")}


def _close(got: dict, want: dict, rtol=2e-4, atol=2e-5):
    assert want
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# -- slice resolution: tests/test_hier_mesh.py's pure cases -----------------

def _fake(slice_index=None, pid=0, did=0):
    return SimpleNamespace(slice_index=slice_index, process_index=pid,
                           id=did)


def _raised(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as info:
        fn(*a, **kw)
    return str(info.value)


def test_infer_dcn_slices_matches_jax(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert port_mesh.infer_dcn_slices() == jax_mesh.infer_dcn_slices() == 1
    monkeypatch.setenv(ENV, "2")
    assert port_mesh.infer_dcn_slices() == jax_mesh.infer_dcn_slices() == 2
    monkeypatch.setenv(ENV, "nope")
    assert _raised(port_mesh.infer_dcn_slices) == _raised(
        jax_mesh.infer_dcn_slices)
    monkeypatch.delenv(ENV)
    stamped = [_fake(i // 2, did=i) for i in range(4)]
    assert port_mesh.infer_dcn_slices(stamped) == \
        jax_mesh.infer_dcn_slices(stamped) == 2
    assert port_mesh.DCN_SLICES_ENV == jax_mesh.DCN_SLICES_ENV
    assert port_mesh.HIER_DATA_AXES == jax_mesh.HIER_DATA_AXES
    # A CUDA device carries no stamp: the port's slices are the env's.
    assert port_mesh.device_slice_index(torch.device("cuda", 1)) is None


def test_slice_blocks_and_validation_match_jax():
    devs = [_fake(1, did=2), _fake(0, did=0), _fake(1, did=3),
            _fake(0, did=1)]
    ordered = port_mesh._slice_blocks(devs, 2)
    assert ordered == jax_mesh._slice_blocks(devs, 2)
    assert [d.slice_index for d in ordered] == [0, 0, 1, 1]
    uneven = [_fake(0), _fake(0), _fake(0), _fake(1)]
    real8 = [_fake(i // 4, did=i) for i in range(8)]
    for fn, args, match in (
            ("_slice_blocks", (devs, 4), "distinct slice_index"),
            ("_slice_blocks", (uneven, 2), "unequal slice sizes"),
            ("_slice_blocks", (devs, 0), ">= 1"),
            ("validate_dcn_slices", (4, real8), "distinct slice_index"),
            ("validate_dcn_slices", (3, real8), "split into")):
        got = _raised(getattr(port_mesh, fn), *args)
        assert match in got and got == _raised(getattr(jax_mesh, fn), *args)
    port_mesh.validate_dcn_slices(2, real8)
    port_mesh.validate_dcn_slices(1)  # this process's world of one


def _world_of(monkeypatch, n, rank):
    """The port's mesh functions as rank ``rank`` of a world of ``n`` sees
    them (no process group: the coordinates and rank lists only)."""
    monkeypatch.setattr(port_mesh, "process_count", lambda: n)
    monkeypatch.setattr(port_mesh, "process_index", lambda: rank)


HIER_LAYOUTS = [(4, 2, (), ()), (4, 4, (), ()), (4, 1, (), ()),
                (4, 2, ("model",), (2,)), (4, 2, ("expert",), (2,)),
                (8, 2, (), ()), (8, 4, (), ()), (8, 8, (), ()),
                (8, 2, ("model",), (2,)), (8, 2, ("model", "seq"), (2, 1)),
                (8, 2, ("expert",), (4,)), (8, 4, ("model",), (2,))]


@pytest.mark.parametrize("n, dcn, extra, extra_shape", HIER_LAYOUTS)
def test_hier_mesh_coordinates_match_jax(monkeypatch, n, dcn, extra,
                                         extra_shape):
    """Every rank's coordinate on every axis, the ranks along each axis
    and the composed data coordinate equal the JAX mesh's device ids
    (device i is rank i)."""
    jm = jax_mesh.make_hier_mesh(dcn, extra_axes=extra,
                                 extra_shape=extra_shape,
                                 devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    data_ids = ids.reshape((-1,) + ids.shape[2:])
    for r in range(n):
        _world_of(monkeypatch, n, r)
        m = port_mesh.make_hier_mesh(dcn, extra, extra_shape, device=CPU)
        assert tuple(m.shape) == tuple(jm.axis_names)
        assert tuple(m.shape.values()) == ids.shape
        coords = tuple(int(c) for c in np.argwhere(ids == r)[0])
        for d, name in enumerate(jm.axis_names):
            axis = m.axis(name)
            assert axis.rank == coords[d], (r, name)
            along = tuple(coords[:d]) + (slice(None),) + tuple(coords[d + 1:])
            assert list(axis.peer(k) for k in range(axis.size)) == \
                list(ids[along]), (r, name)
        dc = int(np.argwhere(data_ids == r)[0][0])
        assert (m.data.size, m.data.rank) == (data_ids.shape[0], dc)
        extra_at = tuple(np.argwhere(data_ids == r)[0][1:])
        assert list(m.data.ranks) == list(
            data_ids[(slice(None),) + extra_at])
        assert port_mesh.is_hier_mesh(m)
        assert port_mesh.resolve_data_axis(m) == jax_mesh.resolve_data_axis(
            jm) == ("dcn", "ici")
        procs = np.vectorize(lambda i: SimpleNamespace(process_index=i),
                             otypes=[object])(data_ids)
        assert port_mesh.data_replica_coords(m) == jax_mesh._data_groups(
            procs, r)
        # The emulated slice map and the mesh cut the ranks alike.
        assert port_mesh._emulated_slice(r, n, dcn) == m.axis("dcn").rank


def test_hier_mesh_refusals_match_jax(monkeypatch):
    _world_of(monkeypatch, 8, 0)
    monkeypatch.delenv(ENV, raising=False)
    for args, kw, match in (((3,), {}, "split into"), ((0,), {}, ">= 1"),
                            ((4,), {"extra_axes": ("model",),
                                    "extra_shape": (4,)}, "straddle"),
                            ((2,), {"extra_axes": ("dcn",),
                                    "extra_shape": (2,)}, "collides"),
                            ((2,), {"extra_axes": ("model",),
                                    "extra_shape": ()}, "pair up"),
                            ((), {}, "slice topology")):
        got = _raised(port_mesh.make_hier_mesh, *args, device=CPU, **kw)
        want = _raised(jax_mesh.make_hier_mesh, *args, **kw)
        assert match in got and got == want
    monkeypatch.setenv(ENV, "2")
    assert port_mesh.make_hier_mesh(device=CPU).shape == {"dcn": 2, "ici": 4}


def test_make_mesh_points_at_make_hier_mesh():
    with pytest.raises(ValueError, match="make_hier_mesh"):
        port_mesh.make_mesh(("dcn", "ici"), (1, 1), device=CPU)
    m = port_mesh.make_hier_mesh(1, device=CPU)
    assert m.shape == {"dcn": 1, "ici": 1} and not m.reduces
    assert port_mesh.is_hier_mesh(m) and not port_mesh.is_hier_mesh(
        port_mesh.make_mesh(device=CPU))
    assert port_mesh.resolve_data_axis(port_mesh.make_mesh(device=CPU)) \
        == "data"
    assert port_mesh.resolve_data_axis(m, "model") == "model"


def _procs(shape):
    """A JAX-shaped mesh of ``shape`` with one device per process (device
    i on process i), as every port mesh is laid out."""
    n = int(np.prod(shape))
    return np.array([SimpleNamespace(process_index=i) for i in range(n)],
                    dtype=object).reshape(shape)


@pytest.mark.parametrize("names, shape", [
    (("dcn", "ici"), (2, 2)),
    (("dcn", "ici"), (4, 2)),
    (("dcn", "ici", "model"), (2, 1, 2)),
    (("data", "expert"), (2, 2))])
def test_composed_data_replica_coords_match_jax(monkeypatch, names, shape):
    """Every rank's ``(num_replicas, rank)`` equals the JAX
    ``data_replica_coords`` of the same grid: the composed ``(dcn, ici)``
    pair collapsed into the one data axis."""
    fake = SimpleNamespace(axis_names=names, devices=_procs(shape))
    for r in range(int(np.prod(shape))):
        _world_of(monkeypatch, int(np.prod(shape)), r)
        if names[0] == "dcn":
            m = port_mesh.make_hier_mesh(shape[0], names[2:], shape[2:],
                                         device=CPU)
        else:
            m = port_mesh.make_mesh(names, shape, device=CPU)
        assert port_mesh.data_replica_coords(m) == \
            jax_mesh.data_replica_coords(fake, process_index=r), (names, r)


# -- the DCN bucket plan ------------------------------------------------------

@pytest.mark.parametrize("model", ["linear", "cnn", "vit"])
@pytest.mark.parametrize("ici", [1, 2, 4])
@pytest.mark.parametrize("mb", [0.01, 0.125, 1.0])
def test_dcn_bucket_plan_equals_jax(model, ici, mb):
    """The DCN buckets over shard-sized views, leaf for leaf the JAX
    plan (and the ICI tier's whole-leaf plan too)."""
    jleaves = jax.tree_util.tree_leaves(_jax_state(model).params)
    jdims = jax_shard_dims(jleaves, ici, "ici")
    st = create_train_state(get_model(model), 0, CPU)
    named = dict(st.model.named_parameters())
    leaves = [named[n] for n in jax_param_order(named)]
    dims = _shard_dims(leaves, ici, "ici")
    assert [d is None for d in dims] == [d is None for d in jdims]
    assert _dcn_bucket_plan(leaves, dims, ici, mb) == jax_dcn_bucket_plan(
        jleaves, jdims, ici, mb)
    assert bucket_plan(leaves, mb) == jax_bucket_plan(jleaves, mb)


def test_dcn_bucket_plan_budgets_shard_bytes():
    class _Leaf:
        def __init__(self, shape):
            self.shape = shape
            self.dtype = np.dtype(np.float32)

    leaves = [_Leaf((1024, 256)), _Leaf((512, 512))]
    dims = _shard_dims(leaves, 4, "ici")
    assert len(bucket_plan(leaves, 1.0)) == 2
    assert len(_dcn_bucket_plan(leaves, dims, 4, 1.0)) == 1
    assert _dcn_bucket_plan(leaves, dims, 4, 1.0) == jax_dcn_bucket_plan(
        leaves, jax_shard_dims(leaves, 4, "ici"), 4, 1.0)


def test_tier_axes_and_comm_tier_refusals(monkeypatch):
    hier = port_mesh.make_hier_mesh(1, device=CPU)
    flat = port_mesh.make_mesh(device=CPU)
    assert _tier_axes(hier) == ("ici", "dcn", ("dcn", "ici"))
    assert _tier_axes(flat) == ("data", None, "data")
    with pytest.raises(NotImplementedError, match="propagation path"):
        _tier_axes(port_mesh.make_hier_mesh(1, ("model", "seq"), (1, 1),
                                            device=CPU))
    z = create_train_state(get_model("linear", compute_dtype=torch.float32),
                           0, CPU)
    shard_state_zero(z, flat, level=3, bucket_mb=0.5, overlap=True)
    with pytest.raises(ValueError, match="hierarchical"):
        make_comm_only_program(z, tier="ici")
    h = create_train_state(get_model("linear", compute_dtype=torch.float32),
                           0, CPU)
    shard_state_zero(h, hier, level=3, bucket_mb=0.5, overlap=True,
                     bucket_mb_dcn=0.01)
    with pytest.raises(ValueError, match="tier must be"):
        make_comm_only_program(h, tier="bogus")
    # The DCN plan is the placed state's: 0.01 MiB cuts the linear
    # model's two leaves apart, the kernel (leaf 1) first (2 buckets);
    # 0.5 keeps them together.
    assert h.zero.dcn_plan == [[1], [0]]
    make_overlap_train_step(h, None, bucket_mb_dcn=0.01)
    make_overlap_train_step(h, None)
    with pytest.raises(ValueError, match="placed with 2"):
        make_overlap_train_step(h, None, bucket_mb_dcn=0.5)
    with pytest.raises(ValueError, match="placed with 2"):
        Trainer(h, [], [], CPU, axis=hier.data, zero_overlap=True,
                zero_bucket_mb_dcn=0.5)
    make_comm_only_program(h, bucket_mb_dcn=0.5)
    assert h.zero.dcn_plan == [[1], [0]]


def test_hier_state_layout_shards_over_ici_only(monkeypatch):
    """The two-tier ZeRO layout names 'ici' alone, leaf for leaf the JAX
    specs on the (2, 4) mesh."""
    _world_of(monkeypatch, 8, 0)
    hier = port_mesh.make_hier_mesh(2, device=CPU)
    state = create_train_state(get_model("linear"), 0, CPU)
    sharding = zero_state_sharding(state, hier, level=3)
    assert {a for spec in sharding.values() for a in spec if a} == {"ici"}
    jsh = jax_zero_state_sharding(_jax_state(), jax_mesh.make_hier_mesh(2),
                                  level=3)
    want = {k: tuple(v.spec) for k, v in jax_ckpt._leaves_with_names(
        jax_ckpt._state_tree(jsh))}
    def trimmed(spec):
        spec = tuple(spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return spec

    for name, spec in sharding.items():
        assert trimmed(spec) == trimmed(want[name]), name
    assert sharding["['step']"] == P()


# -- the world of 4: two-tier against flat, and against JAX -------------------

def _jax_run(tag, level, overlap, mb, dmb, mode, n):
    """JAX's two-tier run of a case on the 2 x 2 mesh: (loss sums, the
    state's leaves)."""
    hier = jax_mesh.make_hier_mesh(2, devices=jax.devices()[:4])
    st = _jax_state()
    if level:
        st, sh = jax_shard_state_zero(st, hier, level=level)
    else:
        sh = None
    if mode == "epoch":
        img, lab = _stack()
        epoch = jax_make_overlap_train_epoch(st, hier, level=level,
                                             bucket_mb=mb, bucket_mb_dcn=dmb)
        g = jax_make_param_gather(hier)(st.params)
        st, g, m = epoch(st, g, {"image": jnp.asarray(img),
                                 "label": jnp.asarray(lab)})
        return [float(m.loss_sum)], _jax_leaves(st)
    if overlap:
        step = jax_make_overlap_train_step(st, hier, level=level,
                                           bucket_mb=mb, bucket_mb_dcn=dmb)
        g = jax_make_param_gather(hier)(st.params) if level == 3 else None
    else:
        step = jax_make_train_step(hier, state_sharding=sh)
    losses = []
    for i in range(n):
        if overlap and level == 3:
            st, g, m = step(st, g, _jbatch(i))
        else:
            st, m = step(st, _jbatch(i))
        losses.append(float(m.loss_sum))
    return losses, _jax_leaves(st)


@pytest.mark.parametrize("tag", list(CASES))
def test_two_tier_equals_flat_and_jax(world, tag):
    """Each case's two-tier run equals the flat world's (params, moments,
    metrics) and JAX's two-tier run on the same init and batches; every
    rank of a slice position holds the same state."""
    level, overlap, mb, dmb, mode, n, _ = CASES[tag]
    ranks = world["ranks"]
    flat, hier = _case(ranks[0], f"{tag}/flat"), _case(ranks[0], f"{tag}/hier")
    _close(hier, flat)
    fm, hm = ranks[0][f"{tag}/flat/metrics"], ranks[0][f"{tag}/hier/metrics"]
    np.testing.assert_allclose(hm[:, 0], fm[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(hm[:, 2], fm[:, 2])  # counts
    for r in range(1, 4):
        for k, v in _case(ranks[r], f"{tag}/hier").items():
            np.testing.assert_array_equal(v, hier[k], err_msg=(r, k))
    losses, leaves = _jax_run(tag, level, overlap, mb, dmb, mode, n)
    np.testing.assert_allclose(hm[:, 0], losses, rtol=1e-5)
    _close(hier, leaves)
    if mode == "epoch":
        # The carry leaving the epoch IS the gather of the shards.
        for res in ranks:
            assert bool(res[f"{tag}/hier/carry_equal"])


@pytest.mark.parametrize("tag", ["z1", "z3", "ov1", "ov3"])
def test_moments_split_over_ici_replicated_over_dcn(world, tag):
    """Rank r (dcn 0) and rank r + 2 (dcn 1) hold the same moment shards;
    the two ici coordinates hold different ones."""
    mom = [res[f"{tag}/hier/moments"] for res in world["ranks"]]
    np.testing.assert_array_equal(mom[0], mom[2])
    np.testing.assert_array_equal(mom[1], mom[3])
    assert mom[0].shape == mom[1].shape and not np.array_equal(mom[0],
                                                               mom[1])


@pytest.mark.parametrize("tag", ["plain", "z1", "z3", "ov1", "ov3"])
def test_each_tier_collective_count_per_step(world, tag):
    """Per step, the count all-reduce over the composed axis; then either
    one gradient all-reduce over it (no ZeRO), or the plane's ICI tier
    (a reduce-scatter and an all-gather per packed bucket and per dim-0
    leaf, an all-reduce per bucket of unsplit leaves) and, on the
    two-tier mesh alone, one DCN all-reduce per bucket of the DCN plan
    the state was placed with: 2 at a budget of 0.01 MiB, 1 at 0.125."""
    for res in world["ranks"]:
        for where in ("flat", "hier"):
            got = res[f"{tag}/{where}/counts"]
            if tag == "plain":
                want = [1, 1, 0, 0, 0, 0]
            else:
                packed, direct, unsplit, _, dcn = res[f"{tag}/{where}/plane"]
                if where == "hier":
                    assert dcn == DCN_BUCKETS[tag], (tag, dcn)
                want = [1, 0, packed + direct, unsplit, packed + direct,
                        dcn if where == "hier" else 0]
            assert got.tolist() == [want] * len(got), (tag, where)


def test_comm_only_tiers(world):
    """Each tier alone runs its collectives only: the ICI tier no DCN
    all-reduce, the DCN tier no reduce-scatter or all-gather. The program
    plans its own DCN buckets (0.01 MiB: 2, one collective each) and
    leaves the state's plan (1 bucket) as it was."""
    res = world["ranks"][0]
    packed, direct, unsplit, _, placed = res["ov3/hier/plane"]
    whole = res["ov3/hier/comm_None"]
    ici = res["ov3/hier/comm_ici"]
    dcn = res["ov3/hier/comm_dcn"]
    for row in (whole, ici, dcn):
        assert np.isfinite(row[0])
        assert row[-1] == placed == 1
    assert whole[1:-1].tolist() == [0, 0, packed + direct, unsplit,
                                    packed + direct, 2]
    assert ici[1:-1].tolist() == [0, 0, packed + direct, unsplit,
                                  packed + direct, 0]
    assert dcn[1:-1].tolist() == [0, 0, 0, 0, 0, 2]


@pytest.mark.parametrize("fam", ["tp0", "tp1", "ep0", "ep1"])
def test_tp_and_ep_nested_in_a_slice_equal_flat(world, fam):
    """TP 2 (dense attention, the ViT at patch 7) on ('dcn', 'ici',
    'model', 'seq') = (2, 1, 2, 1) and EP 2 (dense dispatch) on ('dcn',
    'ici', 'expert') = (2, 1, 2), plain and with ZeRO-1 (over ici, one
    rank: the owner shards cross slices), equal the flat (2, 2) worlds."""
    for res in world["ranks"]:
        flat, hier = _case(res, f"{fam}/flat"), _case(res, f"{fam}/hier")
        _close(hier, flat)
        np.testing.assert_allclose(res[f"{fam}/hier/metrics"][:, 0],
                                   res[f"{fam}/flat/metrics"][:, 0],
                                   rtol=1e-5)
    for name in ("flat", "hier"):
        np.testing.assert_array_equal(
            world["ranks"][0][f"mesh/tp_{name}"], [2, 0])


def test_checkpoints_load_both_ways(world, tmp_path):
    """The two-tier ZeRO-1 ``.ckpt`` holds each ici shard once (written
    by the dcn-0 ranks) and loads in JAX and in a flat port world; a JAX
    two-tier directory loads into the port's two-tier placed state."""
    for res in world["ranks"]:
        got = _case(res, "z1/loaded")
        for name, arr in world["jax_hier"].items():
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
    port_dir = os.path.join(world["root"], "z1_hier", "checkpoint_0.ckpt")
    shards = {p: json.load(open(os.path.join(
        port_dir, f"index_p{p:05d}.json")))["shards"] for p in range(4)}
    assert shards[1] and not shards[2] and not shards[3]
    want = _case(world["ranks"][0], "z1/hier")
    restored, epoch, _ = jax_ckpt.load_checkpoint(port_dir, _jax_state(seed=9))
    assert epoch == 1
    got = _jax_leaves(restored)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    one = create_train_state(get_model("linear", compute_dtype=torch.float32),
                             3, CPU)
    shard_state_zero(one, port_mesh.make_mesh(device=CPU), level=1)
    port_ckpt.load_checkpoint(port_dir, one)
    for name, arr in state_to_jax(one):
        np.testing.assert_array_equal(arr, want[name], err_msg=name)


# -- the CLI -----------------------------------------------------------------

def _rows_close(got, want, key_tols=(("train_loss", 1e-4),
                                     ("test_acc", 1e-6))):
    for g, w in zip(got, want):
        for key, rtol in key_tols:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=key)


def test_cli_dcn_slices_zero_overlap_matches_flat(world):
    """``--spawn 4 --dcn-slices 2`` under ``--zero-overlap
    --zero-bucket-mb-dcn 1``: the two-tier mesh's history equals the
    flat world's."""
    hier, flat = world["cli"]["hier"], world["cli"]["flat"]
    assert [r["epoch"] for r in hier] == [0, 1]
    _rows_close(hier, flat[:2])
    log = world["hier_log"]
    assert "mesh: {'dcn': 2, 'ici': 2}" in log
    assert "hierarchical mesh: 2 DCN slice(s) x 2 chip(s)/slice" in log


def test_cli_flat_checkpoint_resumes_on_the_hier_world(world):
    grow = world["cli"]["grow"]
    assert [r["epoch"] for r in grow] == [2]
    _rows_close(grow, world["cli"]["flat"][2:],
                (("train_loss", 2e-4), ("train_acc", 2e-4),
                 ("test_loss", 2e-4), ("test_acc", 2e-4)))
    assert "mesh: {'dcn': 2, 'ici': 2}" in world["grow_log"]


def _port_run(ckpt, *extra, epochs=3):
    return cli.run(cli.build_parser().parse_args(
        CLI_BASE + ["--optimizer-sharding", "zero1", "--resume", "auto",
                    "--epochs", str(epochs), "--checkpoint-dir", str(ckpt),
                    *extra]))


def _jax_run_cli(ckpt, *extra, epochs=3):
    from pytorch_distributed_mnist_tpu.cli import build_parser, run

    base = [a for a in CLI_BASE if a not in ("--device", "cpu",
                                             "--agreement-timeout", "30")]
    return run(build_parser().parse_args(
        base + ["--optimizer-sharding", "zero1", "--resume", "auto",
                "--epochs", str(epochs), "--checkpoint-dir", str(ckpt),
                "--root", str(ckpt) + "_data", *extra]))


def test_cli_hier_checkpoints_resume_across_worlds_and_packages(world,
                                                                tmp_path):
    """The port's two-tier run's epoch-1 checkpoint resumes on a flat
    world of one in the port and in JAX, each resumed epoch 2 equal to the
    uninterrupted flat run's; a JAX two-tier run's epoch-1 checkpoint
    resumes in the port, its epoch 2 equal to the JAX run's own."""
    full = world["cli"]["flat"][2]
    keys = (("train_loss", 2e-4), ("train_acc", 2e-4), ("test_loss", 2e-4),
            ("test_acc", 2e-4))
    port_dir = tmp_path / "port"
    shutil.copytree(world["cli_dirs"]["hier"], port_dir)
    resumed = _port_run(port_dir)
    assert resumed["start_epoch"] == 2 and resumed["epochs_run"] == 1
    _rows_close(resumed["history"], [full], keys)
    in_jax = tmp_path / "in_jax"
    shutil.copytree(world["cli_dirs"]["hier"], in_jax)
    jres = _jax_run_cli(in_jax)
    assert jres["start_epoch"] == 2 and jres["epochs_run"] == 1
    _rows_close(jres["history"], [full], keys)
    jax_dir, back_dir = tmp_path / "jax", tmp_path / "back"
    jax_full = _jax_run_cli(jax_dir, "--dcn-slices", "2")["history"][2]
    back_dir.mkdir()
    shutil.copy(jax_dir / "checkpoint_1.npz", back_dir)
    back = _port_run(back_dir)
    assert back["start_epoch"] == 2 and back["epochs_run"] == 1
    _rows_close(back["history"], [jax_full], keys)


def _jax_refusal(flags, tmp_path) -> str:
    from pytorch_distributed_mnist_tpu.cli import build_parser, run

    base = [a for a in CLI_BASE if a not in ("--device", "cpu",
                                             "--agreement-timeout", "30")]
    with pytest.raises(SystemExit) as info:
        run(build_parser().parse_args(
            base + ["--epochs", "2", "--checkpoint-dir", str(tmp_path / "j"),
                    "--root", str(tmp_path / "d")] + flags))
    return str(info.value)


@pytest.mark.parametrize("extra, match", [
    (["--dcn-slices", "3"], "split into"),
    (["--dcn-slices", "-1"], "dcn-slices"),
    (["--dcn-slices", "2", "--trainer-mode", "explicit"], "explicit"),
    (["--dcn-slices", "2", "--loss", "fused"], "fused"),
    (["--dcn-slices", "2", "--model", "vit", "--pipeline-stages", "2"],
     "pipeline"),
    (["--dcn-slices", "2", "--model", "vit", "--sequence-parallel", "2",
      "--patch-size", "7"], "sequence-parallel"),
    (["--dcn-slices", "2", "--model", "moe_mlp", "--expert-parallel", "4",
      "--moe-dispatch", "capacity"], "capacity"),
    (["--dcn-slices", "4", "--model", "moe_mlp", "--expert-parallel", "4"],
     "straddle"),
    (["--dcn-slices", "2", "--model", "vit", "--tensor-parallel", "2",
      "--attention", "flash"], "flash"),
    (["--zero-bucket-mb-dcn", "1"], "zero-overlap"),
    (["--optimizer-sharding", "zero1", "--zero-overlap",
      "--zero-bucket-mb-dcn", "-1"], "zero-bucket-mb-dcn"),
])
def test_cli_dcn_rejection_matrix(tmp_path, capsys, extra, match):
    """JAX's 11 refusals, in the same words, from the parent of an
    8-rank ``--spawn`` before any rank starts (JAX's world: 8 devices)."""
    with pytest.raises(SystemExit) as info:
        cli.main(CLI_BASE + ["--epochs", "2", "--spawn", "8",
                             "--checkpoint-dir", str(tmp_path / "p")]
                 + extra)
    got = str(info.value)
    assert match in got
    assert got == _jax_refusal(extra, tmp_path)


def test_one_process_refuses_two_slices(tmp_path):
    with pytest.raises(SystemExit, match="split into"):
        cli.run(cli.build_parser().parse_args(
            CLI_BASE + ["--epochs", "1", "--dcn-slices", "2",
                        "--checkpoint-dir", str(tmp_path)]))
