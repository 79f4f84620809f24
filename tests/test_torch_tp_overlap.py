"""The port's overlapped tensor parallelism (``--tp-overlap``) against the
JAX package's, on the CPU: twins of ``tests/test_tp_overlap.py``.

The port runs in one gloo world of 2 processes, a ``('data', 'model',
'seq')`` mesh of (1, 2, 1) (one module fixture runs every case there);
the JAX side runs as its own tests do, on its virtual CPU devices. The
overlapped schedule is a scheduling rewrite, not a math change:
``allgather_matmul`` equals gather-then-matmul bit for bit (its
gradients too), the overlapped apply equals the dense model, and the
train trajectory equals the single-device step at the plain-TP suite's
tolerances (float32: logits rtol/atol 1e-5, loss sums rtol 1e-4, params
rtol 1e-4 / atol 1e-6 after 3 SGD steps). The split head-major tree
(``parallel/pipeline_tp.py``) is what both packages checkpoint, so each
resumes the other's overlapped checkpoint.

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
from pytorch_distributed_mnist_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_tp import (
    merge_vit_params_tp as jax_merge_vit_params_tp,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline_tp import (
    split_vit_params_tp as jax_split_vit_params_tp,
)
from pytorch_distributed_mnist_tpu.parallel.tensor import (
    create_overlap_tp_vit_state as jax_create_overlap_tp_vit_state,
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
    jax_param_path,
)
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_tp import (
    merge_vit_params_tp,
    split_vit_params_tp,
)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 180  # seconds the world (and each CLI world) may take

# One rank: ``python -c _RANK coordinator n rank dir`` runs dir/job.json.
_RANK = r"""
import json, sys
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
    gather_scatter)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    allgather_matmul, make_overlap_tp_vit_apply, overlap_tp_rules,
    shard_state)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as ck
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state)
from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

torch.set_num_threads(1)
coord, n, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
job = json.load(open(f"{out}/job.json"))
cpu = torch.device("cpu")
distributed.initialize_distributed(coord, n, rank, cpu)
mesh = make_mesh(("data", "model", "seq"), shape=job["shape"], device=cpu)
tp = mesh.model
z = np.load(job["data"])
res = {}

# allgather_matmul against gather-then-matmul, forward and gradients.
x, w = torch.from_numpy(z["x"]), torch.from_numpy(z["w"])
tl = x.shape[1] // tp.size
for tag in ("agmm", "ref"):
    xs = x[:, tp.rank * tl:(tp.rank + 1) * tl].clone().requires_grad_(True)
    ws = w.clone().requires_grad_(True)
    if tag == "agmm":
        o = allgather_matmul(xs, ws, tp)
    else:
        o = torch.tensordot(gather_scatter(xs, tp, dim=1), ws,
                            dims=([2], [0]))
    (o * o).sum().backward()
    res[f"{tag}/out"] = o.detach().numpy()
    res[f"{tag}/dx"] = xs.grad.numpy()
    res[f"{tag}/dw"] = ws.grad.numpy()

def overlap_state(init):
    dense = create_train_state(
        get_model("vit", compute_dtype=torch.float32, patch_size=7), 0, cpu,
        optimizer="sgd")
    ck.load_checkpoint(init, dense)
    st = create_train_state(make_overlap_tp_vit_apply(dense.model, mesh), 0,
                            cpu, optimizer="sgd", init=False)
    shard_state(st, mesh, overlap_tp_rules())
    return dense, st

dense, st = overlap_state(job["init"])
images = torch.from_numpy(z["image"])
labels = torch.from_numpy(z["label"]).long()
with torch.no_grad():
    res["logits"] = st.model(images).numpy()
    res["dense_logits"] = dense.model(images).numpy()
ck.save_checkpoint(st, epoch=0, best_acc=0.0, is_best=False,
                   directory=f"{out}/npz")
ms = []
for _ in range(3):
    m = train_step(st, {"image": images, "label": labels}, mesh.data)
    ms.append([float(t) for t in m])
res["step/metrics"] = np.array(ms)
for name, arr in state_to_jax(st):
    if name.startswith("['params']"):
        res[f"step/{name}"] = arr
ck.save_checkpoint(st, epoch=1, best_acc=0.0, is_best=False,
                   directory=f"{out}/sharded", layout="sharded")
_, back = overlap_state(job["init"])
ck.load_checkpoint(job["jax_ckpt"], back)
for name, arr in state_to_jax(back):
    res[f"jax_ckpt/{name}"] = arr
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _f32_vit():
    # patch 7 -> 16 tokens, divisible by tp = 2 (the sequence shard).
    return jax_get_model("vit", compute_dtype=jnp.float32, patch_size=7)


def _batch(n=16, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


def _leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in jax_ckpt._leaves_with_names(tree)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The (1, 2, 1) world's per-rank results and the inputs it was fed."""
    root = tmp_path_factory.mktemp("tp_overlap_world")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 12)).astype(np.float32)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    images, labels = _batch()
    jstate = jax_create_train_state(_f32_vit(), jax.random.key(0),
                                    optimizer="sgd")
    init = jax_ckpt.save_checkpoint(jstate, epoch=-1, best_acc=0.0,
                                    is_best=False,
                                    directory=str(root / "init"))
    mesh = jax_make_mesh(("data", "model"), shape=(4, 2))
    ostate, _ = jax_create_overlap_tp_vit_state(
        _f32_vit(), jax.random.key(3), mesh, optimizer="sgd")
    jax_dir = jax_ckpt.save_checkpoint(ostate, epoch=0, best_acc=0.0,
                                       is_best=False,
                                       directory=str(root / "jax"),
                                       layout="sharded")
    data = root / "data.npz"
    np.savez(data, x=x, w=w, image=images, label=labels)
    (root / "job.json").write_text(json.dumps(
        {"shape": [1, 2, 1], "data": str(data), "init": init,
         "jax_ckpt": jax_dir}))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = launcher.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, f"127.0.0.1:{port}", "2", str(r),
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
            "x": x, "w": w, "images": images, "labels": labels,
            "jstate": jstate, "ostate": ostate, "mesh": mesh, "root": root}


@pytest.mark.parametrize("rank", [0, 1])
def test_allgather_matmul_bitwise_equals_gather_then_matmul(world, rank):
    """Row blocks of a matmul are independent: the ring decomposition is
    BITWISE the gather-then-matmul, its gradients too."""
    res = world["ranks"][rank]
    for key in ("out", "dx", "dw"):
        np.testing.assert_array_equal(res[f"agmm/{key}"], res[f"ref/{key}"],
                                      err_msg=key)
    full = np.tensordot(world["x"], world["w"], axes=([2], [0]))
    np.testing.assert_allclose(res["agmm/out"], full, rtol=1e-5, atol=1e-5)


def test_allgather_matmul_gradients_match(world):
    """The weight's gradient is every row block's contribution: the JAX
    reference's value (rtol 1e-4 / atol 1e-5, its own bound)."""
    x, w = jnp.asarray(world["x"]), jnp.asarray(world["w"])
    gw = jax.grad(lambda ww: jnp.sum(jnp.tensordot(x, ww, 1) ** 2))(w)
    for res in world["ranks"]:
        np.testing.assert_allclose(res["agmm/dw"], np.asarray(gw),
                                   rtol=1e-4, atol=1e-5)


def test_overlap_apply_matches_dense_model(world):
    """The head-major overlapped apply reproduces the dense model's
    logits (float32; reduce-scatter reassociation only), and the JAX
    model's on the same params."""
    jstate = world["jstate"]
    want = np.asarray(jstate.apply_fn(jstate.params,
                                      jnp.asarray(world["images"])))
    for res in world["ranks"]:
        np.testing.assert_allclose(res["logits"], res["dense_logits"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["logits"], want, rtol=1e-5,
                                   atol=1e-5)


def test_overlap_tp_step_equals_single_device_step(world):
    """TP(2) overlapped train steps == single-device steps over a 3-step
    SGD trajectory (the plain-TP suite's conventions)."""
    # The fixture's state from the same key: the step donates its input.
    s1 = jax_create_train_state(_f32_vit(), jax.random.key(0),
                                optimizer="sgd")
    step = jax_make_train_step()
    batch = {"image": jnp.asarray(world["images"]),
             "label": jnp.asarray(world["labels"])}
    for _ in range(3):
        s1, m1 = step(s1, batch)
    want = _leaves({"params": jax_split_vit_params_tp(
        jax.device_get(s1.params), 4)})
    for res in world["ranks"]:
        loss_sum, correct, _ = res["step/metrics"][-1]
        np.testing.assert_allclose(loss_sum, float(m1.loss_sum), rtol=1e-4)
        assert int(correct) == int(m1.correct)
        for name, value in want.items():
            np.testing.assert_allclose(res[f"step/{name}"], value,
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_split_and_merge_are_exact_inverses_and_equal_jax():
    """Pure reshapes: port split/merge are bitwise inverses and give the
    JAX functions' tree, leaf by leaf."""
    jstate = jax_create_train_state(_f32_vit(), jax.random.key(1),
                                    optimizer="sgd")
    jparams = jax.device_get(jstate.params)
    jsplit = _leaves({"params": jax_split_vit_params_tp(jparams, 4)})
    model = get_model("vit", compute_dtype=torch.float32, patch_size=7)
    flat = _leaves({"params": jparams})
    params = {n: flat["['params']" + jax_param_path(n)]
              for n, _ in model.named_parameters()}
    split = split_vit_params_tp(params, 4)
    assert len(split) == len(jsplit)
    for name, value in split.items():
        np.testing.assert_array_equal(
            value, jsplit["['params']" + jax_param_path(name, root="")],
            err_msg=name)
    merged = merge_vit_params_tp(split)
    assert sorted(merged) == sorted(params)
    for name, value in params.items():
        np.testing.assert_array_equal(merged[name], value, err_msg=name)
    jmerged = _leaves(jax_merge_vit_params_tp(
        jax_split_vit_params_tp(jparams, 4)))
    for name, value in _leaves(jparams).items():
        np.testing.assert_array_equal(jmerged[name], value)
    # Torch tensors take the same path.
    tsplit = split_vit_params_tp({n: torch.tensor(v)
                                  for n, v in params.items()}, 4)
    np.testing.assert_array_equal(tsplit["blocks.attn.qkv.kernel"].numpy(),
                                  split["blocks.attn.qkv.kernel"])


def test_the_port_overlapped_checkpoint_resumes_in_jax(world):
    """The port's split-tree checkpoints (npz gathered whole and the
    sharded directory) load into the JAX overlapped state template."""
    root, mesh = world["root"], world["mesh"]
    rank0 = world["ranks"][0]
    for sub, tag in (("npz", None), ("sharded", "step")):
        path = port_ckpt.latest_checkpoint(str(root / sub))
        template, _ = jax_create_overlap_tp_vit_state(
            _f32_vit(), jax.random.key(9), mesh, optimizer="sgd")
        restored, _, _ = jax_ckpt.load_checkpoint(path, template)
        got = _leaves({"params": jax.device_get(restored.params)})
        if tag is None:
            # The init: the split of the JAX init params.
            want = _leaves({"params": jax_split_vit_params_tp(
                jax.device_get(world["jstate"].params), 4)})
        else:
            want = {n[len("step/"):]: v for n, v in rank0.items()
                    if n.startswith("step/['params']")}
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_a_jax_overlapped_checkpoint_resumes_in_the_port(world):
    want = _leaves({"params": jax.device_get(world["ostate"].params),
                    "opt_state": jax.device_get(world["ostate"].opt_state),
                    "step": world["ostate"].step})
    for res in world["ranks"]:
        got = {k[len("jax_ckpt/"):]: v for k, v in res.items()
               if k.startswith("jax_ckpt/")}
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_the_sharded_directory_holds_the_jax_slices(world, tmp_path):
    """Per file, a slice of the split tree's placed leaves is the one the
    JAX overlapped run's files hold (contiguous head ranges)."""
    ostate = world["ostate"]
    jdir = jax_ckpt.save_checkpoint(ostate, epoch=0, best_acc=0.0,
                                    is_best=False, directory=str(tmp_path),
                                    layout="sharded")
    pdir = port_ckpt.latest_checkpoint(str(world["root"] / "sharded"))

    def regions(path):
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

    assert regions(pdir) == regions(jdir)


def _base(tmp_path, *extra):
    return ["--dataset", "synthetic", "--model", "vit", "--epochs", "1",
            "--batch-size", "64", "--synthetic-train-size", "256",
            "--synthetic-test-size", "128", "--seed", "0", "--patch-size",
            "7", "--dtype", "f32", "--device", "cpu", "--root",
            str(tmp_path / "data"), *extra]


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


def test_cli_tp_overlap_matches_unoverlapped_tp(tmp_path):
    """--tp-overlap trains through the CLI and matches the plain
    --tensor-parallel run's metrics: the overlap is a schedule."""
    ov = _cli_world(tmp_path, "ov", 2, "--tensor-parallel", "2",
                    "--tp-overlap")
    tp = _cli_world(tmp_path, "tp", 2, "--tensor-parallel", "2")
    assert ov[0]["train_loss"] == pytest.approx(tp[0]["train_loss"],
                                                rel=1e-4)
    assert ov[0]["test_acc"] == pytest.approx(tp[0]["test_acc"], abs=1e-6)


def _refused(tmp_path, *extra, devices=8) -> str:
    """The refusal of the flags on the JAX tests' 8 devices (the check
    takes the world's device count)."""
    args = cli.build_parser().parse_args(_base(
        tmp_path, "--checkpoint-dir", str(tmp_path / "ckpt"), *extra))
    with pytest.raises(SystemExit) as info:
        cli._check_parallel_flags(args, devices)
    return str(info.value)


def test_cli_tp_overlap_requires_tp(tmp_path):
    assert "tensor-parallel >= 2" in _refused(tmp_path, "--tp-overlap")


def test_cli_tp_overlap_rejects_indivisible_tokens(tmp_path):
    # patch 4 -> 49 tokens.
    assert "patch-size 7" in _refused(
        tmp_path, "--tensor-parallel", "2", "--tp-overlap", "--patch-size",
        "4")


@pytest.mark.parametrize("extra,words", [
    (["--sequence-parallel", "2"], "does not compose with\n"
                                   "--sequence-parallel"),
    (["--trainer-mode", "explicit"], "--trainer-mode explicit"),
    (["--attention", "flash"], "GSPMD wrapper does not apply"),
    (["--optimizer-sharding", "zero1"], "drop --optimizer-sharding"),
])
def test_cli_tp_overlap_refuses_what_jax_refuses(tmp_path, extra, words):
    got = _refused(tmp_path, "--tensor-parallel", "2", "--tp-overlap",
                   *extra)
    assert words.replace("\n", " ") in got
