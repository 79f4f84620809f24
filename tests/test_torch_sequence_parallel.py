"""The port's sequence parallelism (``--sequence-parallel``, ring and
Ulysses) against the JAX package's, on the CPU: twins of
``tests/test_attention.py:72-131`` and ``tests/test_vit.py:50-170``, and
of the sequence-parallel CLI cases of ``tests/test_tensor_parallel.py``.

The port runs in two gloo worlds started together by one module fixture:
a ``('data', 'model', 'seq')`` mesh of (1, 1, 4), whose ring makes three
hops, and the full (2, 2, 2) mesh of 8 processes (DP x TP x SP: the ring
over each rank's local heads). The JAX side runs as its own tests do, on
its virtual CPU devices. Ring and Ulysses attention are the same softmax
as dense attention, blockwise or on a head subset (rtol/atol 1e-5, the
JAX suite's; with flash as Ulysses's local attention 2e-5); a ViT whose
tokens shard over ``seq`` trains as the single-device one does (float32,
SGD: logits rtol/atol 2e-4, loss sums rtol 1e-4, params rtol 1e-4 / atol
1e-6), gradients included.

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
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import DataAxis
from pytorch_distributed_mnist_tpu_torch.parallel.ulysses import (
    ulysses_attention_local,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 240  # seconds the worlds (and each CLI world) may take
B, T, H, D = 2, 64, 8, 16
WORLDS = {"sp4": (1, 1, 4), "dp_tp_sp": (2, 2, 2)}

# One rank: ``python -c _RANK coordinator n rank dir`` runs dir/job.json.
_RANK = r"""
import functools, json, sys
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import state_to_jax
from pytorch_distributed_mnist_tpu_torch.ops.flash import flash_attention
from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.collectives import (
    metric_all_reduce)
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.ring import ring_attention
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    shard_state, vit_tp_rules)
from pytorch_distributed_mnist_tpu_torch.parallel.ulysses import (
    ulysses_attention)
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
dp, d = mesh.data.size, mesh.data.rank
sp, s = mesh.seq.size, mesh.seq.rank
z = np.load(job["data"])
res = {}

def tokens(a):
    t = a.shape[1] // sp
    return torch.from_numpy(np.ascontiguousarray(a[:, s * t:(s + 1) * t]))

if job["attention"]:
    ring = functools.partial(ring_attention, mesh=mesh)
    uly = functools.partial(ulysses_attention, mesh=mesh)
    uly_flash = functools.partial(ulysses_attention, mesh=mesh,
                                  local_attention=flash_attention)
    for tag, fn in (("ring", ring), ("ulysses", uly),
                    ("ulysses_flash", uly_flash)):
        for causal in (False, True):
            qkv = [tokens(z[k]).requires_grad_(True) for k in ("q", "k", "v")]
            o = fn(*qkv, causal=causal)
            (o * torch.from_numpy(np.ascontiguousarray(
                tokens(z["g"])))).sum().backward()
            res[f"{tag}/{causal}/out"] = o.detach().numpy()
            for k, t in zip("qkv", qkv):
                res[f"{tag}/{causal}/d{k}"] = t.grad.numpy()
    res["ring_uneven"] = ring(*(tokens(z[k]) for k in ("q3", "k3", "v3"))
                              ).numpy()
    try:
        uly(*(tokens(z[k]) for k in ("q3", "k3", "v3")))
        res["ulysses_uneven"] = np.array("accepted")
    except ValueError as exc:
        res["ulysses_uneven"] = np.array(str(exc))

def rows(a):
    b = a.shape[0] // dp
    return a[d * b:(d + 1) * b]

batch = {"image": torch.from_numpy(rows(z["image"])),
         "label": torch.from_numpy(rows(z["label"])).long()}
for tag, impl, local in job["vits"]:
    if impl == "ring":
        attn = functools.partial(ring_attention, mesh=mesh, axis="seq",
                                 batch_axis="data", head_axis="model")
    else:
        attn = functools.partial(
            ulysses_attention, mesh=mesh, axis="seq", batch_axis="data",
            local_attention=flash_attention if local == "flash" else None)
    st = create_train_state(get_model(
        "vit", compute_dtype=torch.float32, patch_size=7, mesh=mesh,
        attention_fn=attn), 0, cpu, optimizer="sgd")
    ck.load_checkpoint(job["init"], st)
    if mesh.model.size > 1:
        shard_state(st, mesh, vit_tp_rules())
    with torch.no_grad():
        res[f"{tag}/logits"] = st.model(batch["image"]).numpy()
    ms = []
    for _ in range(job["steps"]):
        m = metric_all_reduce(train_step(st, batch, mesh.data), mesh.data)
        ms.append([float(t) for t in m])
    res[f"{tag}/metrics"] = np.array(ms)
    for name, arr in state_to_jax(st):
        if name.startswith("['params']"):
            res[f"{tag}/{name}"] = arr
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _f32_vit():
    # patch 7 -> 16 tokens, divisible by the seq axis.
    return jax_get_model("vit", compute_dtype=jnp.float32, patch_size=7)


def _batch(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


def _leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in jax_ckpt._leaves_with_names(tree)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' per-rank results, and what they were fed."""
    root = tmp_path_factory.mktemp("sp_worlds")
    rng = np.random.default_rng(0)
    arrays = {k: rng.normal(size=(B, T, H, D)).astype(np.float32)
              for k in ("q", "k", "v", "g")}
    arrays.update({k: rng.normal(size=(1, 16, 3, 8)).astype(np.float32)
                   for k in ("q3", "k3", "v3")})
    images, labels = _batch()
    jstate = jax_create_train_state(_f32_vit(), jax.random.key(0),
                                    optimizer="sgd")
    init = jax_ckpt.save_checkpoint(jstate, epoch=-1, best_acc=0.0,
                                    is_best=False,
                                    directory=str(root / "init"))
    data = root / "data.npz"
    np.savez(data, image=images, label=labels, **arrays)
    jobs = {
        "sp4": {"attention": True, "steps": 3,
                "vits": [["ring", "ring", None],
                         ["ulysses", "ulysses", None],
                         ["ulysses_flash", "ulysses", "flash"]]},
        "dp_tp_sp": {"attention": False, "steps": 2,
                     "vits": [["ring", "ring", None]]},
    }
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {}
    for name, shape in WORLDS.items():
        out = root / name
        out.mkdir()
        (out / "job.json").write_text(json.dumps(
            {"shape": list(shape), "data": str(data), "init": init,
             **jobs[name]}))
        port = launcher.free_port()
        n = int(np.prod(shape))
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
    return {"results": results, "arrays": arrays, "images": images,
            "labels": labels}


def _dense_and_grads(arrays, causal):
    """JAX dense attention on the whole arrays and its q/k/v gradients
    for the cotangent ``g``."""
    q, k, v, g = (jnp.asarray(arrays[n]) for n in ("q", "k", "v", "g"))

    def loss(q, k, v):
        return jnp.sum(jax_full_attention(q, k, v, causal=causal) * g)

    out = jax_full_attention(q, k, v, causal=causal)
    return np.asarray(out), [np.asarray(x) for x in
                             jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _token_slice(a, rank, n=4):
    t = a.shape[1] // n
    return a[:, rank * t:(rank + 1) * t]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_dense(worlds, impl, causal):
    """Each rank's token block of ring / Ulysses attention, and its q/k/v
    gradients, equal that block of dense attention's."""
    want, grads = _dense_and_grads(worlds["arrays"], causal)
    for r, res in enumerate(worlds["results"]["sp4"]):
        np.testing.assert_allclose(res[f"{impl}/{causal}/out"],
                                   _token_slice(want, r), rtol=1e-5,
                                   atol=1e-5)
        for k, g in zip("qkv", grads):
            np.testing.assert_allclose(res[f"{impl}/{causal}/d{k}"],
                                       _token_slice(g, r), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_ring_attention_uneven_heads_ok(worlds):
    """The ring has no head-divisibility constraint (unlike Ulysses)."""
    a = worlds["arrays"]
    want = np.asarray(jax_full_attention(*(jnp.asarray(a[k])
                                           for k in ("q3", "k3", "v3"))))
    for r, res in enumerate(worlds["results"]["sp4"]):
        np.testing.assert_allclose(res["ring_uneven"], _token_slice(want, r),
                                   rtol=1e-5, atol=1e-5)


def test_ulysses_rejects_indivisible_heads(worlds):
    for res in worlds["results"]["sp4"]:
        assert "not divisible" in str(res["ulysses_uneven"])
    axis = DataAxis(4, 0, None, None, "seq")
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention_local(*(torch.zeros(1, 4, 3, 8)
                                  for _ in range(3)), axis=axis)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_with_flash_local_matches_dense(worlds, causal):
    """Ulysses with the flash kernels (their plain versions on the CPU)
    as each rank's local attention: full T, H/sp heads."""
    want, grads = _dense_and_grads(worlds["arrays"], causal)
    for r, res in enumerate(worlds["results"]["sp4"]):
        np.testing.assert_allclose(res[f"ulysses_flash/{causal}/out"],
                                   _token_slice(want, r), rtol=2e-5,
                                   atol=2e-5)
        for k, g in zip("qkv", grads):
            np.testing.assert_allclose(res[f"ulysses_flash/{causal}/d{k}"],
                                       _token_slice(g, r), rtol=1e-4,
                                       atol=2e-5, err_msg=k)


def _jax_steps(images, labels, k):
    s = jax_create_train_state(_f32_vit(), jax.random.key(0),
                               optimizer="sgd")
    step = jax_make_train_step()
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    logits = np.asarray(s.apply_fn(s.params, batch["image"]))
    for _ in range(k):
        s, m = step(s, batch)
    return logits, jax.device_get(s), m


@pytest.mark.parametrize("world,tag", [("sp4", "ring"), ("sp4", "ulysses"),
                                       ("sp4", "ulysses_flash"),
                                       ("dp_tp_sp", "ring")])
def test_vit_trains_with_sequence_parallel_attention(worlds, world, tag):
    """A ViT whose tokens shard over seq: its logits equal the dense
    model's on the same params, and its SGD steps (gradients through the
    ring's hops or Ulysses's all-to-alls, summed over data x seq) equal
    the single-device steps."""
    images, labels = worlds["images"], worlds["labels"]
    steps = 3 if world == "sp4" else 2
    logits, s1, m1 = _jax_steps(images, labels, steps)
    want = _leaves({"params": s1.params})
    dp = WORLDS[world][0]
    b = images.shape[0] // dp
    for r, res in enumerate(worlds["results"][world]):
        d = r // (WORLDS[world][1] * WORLDS[world][2])
        np.testing.assert_allclose(res[f"{tag}/logits"],
                                   logits[d * b:(d + 1) * b], rtol=2e-4,
                                   atol=2e-4)
        loss_sum, correct, _ = res[f"{tag}/metrics"][-1]
        np.testing.assert_allclose(loss_sum, float(m1.loss_sum), rtol=1e-4)
        assert int(correct) == int(m1.correct)
        for name, value in want.items():
            np.testing.assert_allclose(res[f"{tag}/{name}"], value,
                                       rtol=1e-4, atol=1e-6, err_msg=name)


# -- the CLI ------------------------------------------------------------------------

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


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_cli_sequence_parallel_matches_dense(tmp_path, impl):
    """--sequence-parallel 2 (ring, or Ulysses with the flash kernels as
    its local attention) matches the dense one-process run's metrics."""
    extra = (["--sequence-parallel-impl", "ulysses", "--attention", "flash"]
             if impl == "ulysses" else [])
    sp = _cli_world(tmp_path, impl, 2, "--sequence-parallel", "2", *extra)
    dense = cli.run(cli.build_parser().parse_args(_base(
        tmp_path, "--checkpoint-dir", str(tmp_path / "dense"))))["history"]
    assert sp[0]["train_loss"] == pytest.approx(dense[0]["train_loss"],
                                                rel=1e-4)
    assert sp[0]["test_acc"] == pytest.approx(dense[0]["test_acc"],
                                              abs=1e-6)


def _refused(tmp_path, *extra, devices=8) -> str:
    """The refusal of the flags on the JAX tests' 8 devices (the check
    takes the world's device count)."""
    args = cli.build_parser().parse_args(_base(
        tmp_path, "--checkpoint-dir", str(tmp_path / "ckpt"), *extra))
    with pytest.raises(SystemExit) as info:
        cli._check_parallel_flags(args, devices)
    return str(info.value)


def test_ring_flash_cli_still_rejected(tmp_path):
    assert "ulysses" in _refused(tmp_path, "--sequence-parallel", "2",
                                 "--attention", "flash")


def test_cli_sequence_parallel_rejects_indivisible_tokens(tmp_path):
    # patch 4 -> 49 tokens.
    assert "patch-size 7" in _refused(tmp_path, "--sequence-parallel", "2",
                                      "--patch-size", "4")


def test_cli_ulysses_rejects_tp(tmp_path):
    assert "re-shards the" in _refused(
        tmp_path, "--sequence-parallel", "2", "--sequence-parallel-impl",
        "ulysses", "--tensor-parallel", "2")


@pytest.mark.parametrize("extra,devices,words", [
    (["--trainer-mode", "explicit"], 8, "--trainer-mode explicit"),
    (["--sequence-parallel-impl", "ulysses", "--sequence-parallel", "8"], 8,
     "--sequence-parallel 8 must divide 4"),
    (["--tensor-parallel", "4"], 4,
     "does not divide the 4 available devices"),
])
def test_cli_sequence_parallel_refuses_what_jax_refuses(tmp_path, extra,
                                                        devices, words):
    assert words in _refused(tmp_path, "--sequence-parallel", "2", *extra,
                             devices=devices)
