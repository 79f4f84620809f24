"""The port's GPipe schedule (``parallel/pipeline.py``) against the JAX
package's, on the CPU: twins of ``tests/test_moe_pipeline.py:85-135``,
the pipeline flags' refusals of the JAX CLI, and the pipeline's CLI
worlds that need no JAX run.

The port runs in gloo worlds started together by one module fixture: a
``('data', 'stage')`` mesh of (1, 4), where the toy MLP stage of the JAX
test runs its 4 stages at 4 and 8 microbatches (forward rtol 1e-5 / atol
1e-6 against the JAX pipeline and ``sequential_apply``, gradients rtol
1e-4 / atol 1e-5, the JAX suite's), and two worlds of 2 whose process
groups time out after a few seconds: one runs the real schedule's
forward and backward and counts every rank's hops; the other a copy
whose stage 0 picks its input with a Python ``if``, so its backward skips
a hop, and must end in an error, not hang. The CLI worlds run with
``--dtype f32``.
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

from pytorch_distributed_mnist_tpu.cli import build_parser as jax_parser
from pytorch_distributed_mnist_tpu.cli import run as jax_run
from pytorch_distributed_mnist_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline import (
    pipeline_apply as jax_pipeline_apply,
)
from pytorch_distributed_mnist_tpu.parallel.pipeline import (
    sequential_apply as jax_sequential_apply,
)
from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.parallel import launcher
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
    DataAxis,
    GridMesh,
)
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    sequential_apply,
    stack_stage_params,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120  # seconds each world may take
HOP_TIMEOUT = 6  # seconds a hop world's process groups wait
EXPLICIT_WORDS = ("mode='explicit' is the replicated-DP shard_map path; "
                  "use scan/stepwise with a sharded state")

# The toy world: ``python -c _RANK coordinator n rank dir``.
_RANK = r"""
import json, sys
import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.parallel import distributed
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline import (
    pipeline_apply)

torch.set_num_threads(1)
coord, n, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cpu = torch.device("cpu")
distributed.initialize_distributed(coord, n, rank, cpu)
mesh = make_mesh(("data", "stage"), shape=(1, n), device=cpu)
z = np.load(f"{out}/toy.npz")
res = {}

def stage_fn(p, h):
    return torch.relu(h @ p["w"] + p["b"])

params = {k: torch.from_numpy(z[k]) for k in ("w", "b")}
x = torch.from_numpy(z["x"])
for m in (4, 8):
    with torch.no_grad():
        res[f"fwd{m}"] = pipeline_apply(stage_fn, params, x, mesh=mesh,
                                        num_microbatches=m).numpy()
# This stage's row alone (a placed state's leaves) gives the same.
mine = {k: v[rank:rank + 1] for k, v in params.items()}
with torch.no_grad():
    res["fwd_row"] = pipeline_apply(stage_fn, mine, x, mesh=mesh).numpy()
gp = {k: torch.from_numpy(z["g" + k]).requires_grad_() for k in ("w", "b")}
y = pipeline_apply(stage_fn, gp, torch.from_numpy(z["gx"]), mesh=mesh)
(y ** 2).sum().backward()
for k in ("w", "b"):
    res["grad_" + k] = gp[k].grad.numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
"""

# A hop world: ``python -c _HOPS coordinator n rank dir variant``. Every
# process group it makes times out after HOP_TIMEOUT seconds.
_HOPS = r"""
import datetime, functools, os, sys, traceback
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
coord, n, rank, out, variant, limit = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), sys.argv[4],
                                       sys.argv[5], float(sys.argv[6]))
timeout = datetime.timedelta(seconds=limit)
dist.new_group = functools.partial(dist.new_group, timeout=timeout)
from pytorch_distributed_mnist_tpu_torch.parallel import pipeline, regions
from pytorch_distributed_mnist_tpu_torch.parallel.mesh import make_mesh

hops = {"n": 0}
exchange = regions.ring_exchange

def counted(*args, **kwargs):
    hops["n"] += 1
    return exchange(*args, **kwargs)

regions.ring_exchange = counted

def skipping_apply(stage_fn, params, x, *, mesh, axis="stage"):
    # pipeline_apply with one change: stage 0 picks its input with a
    # Python branch, so what its hops receive never reaches its loss and
    # its graph lacks those hops' backward.
    st = mesh.axis(axis)
    p = {k: v[st.rank] for k, v in params.items()}
    s = torch.full((), st.rank)
    m, last = st.size, st.size - 1
    xm = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    buf = torch.zeros_like(xm[0])
    outs = torch.zeros_like(xm)
    for t in range(m + last):
        h = stage_fn(p, xm[min(t, m - 1)] if st.rank == 0 else buf)
        updated = outs.index_copy(
            0, torch.tensor([min(max(t - last, 0), m - 1)]), h[None])
        outs = torch.where((s == last) & (t >= last), updated, outs)
        (buf,) = regions.ppermute((h,), st, 1, wrap=False)
    outs = regions.reduce_from_region(
        torch.where(s == last, outs, torch.zeros_like(outs)), st)
    return outs.reshape(x.shape)

try:
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=n, rank=rank, timeout=timeout)
    mesh = make_mesh(("data", "stage"), shape=(1, n),
                     device=torch.device("cpu"))
    apply = (pipeline.pipeline_apply if variant == "real"
             else skipping_apply)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(n, 8, 8, generator=g).requires_grad_(),
              "b": torch.zeros(n, 8).requires_grad_()}
    x = torch.randn(4, 8, generator=g)
    y = apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), params, x,
              mesh=mesh)
    forward = hops["n"]
    (y ** 2).sum().backward()
    counts = torch.tensor([forward, hops["n"] - forward])
    dist.all_reduce(counts.clone())  # the backward ended on every rank
    with open(f"{out}/hops{rank}.json", "w") as f:
        f.write(f"[{forward}, {hops['n'] - forward}]")
except BaseException:
    traceback.print_exc()
    sys.stdout.flush()
    os._exit(1)
"""


def _launch(script, n, root, *extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = launcher.free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", script, f"127.0.0.1:{port}", str(n), str(r),
         str(root), *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]


def _join(procs):
    try:
        texts = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, text) for p, text in zip(procs, texts)]


def _cli(tmp_path, name, *extra, spawn=2):
    """A spawned CLI world: ``(returncode, output, epoch rows)``."""
    rows = tmp_path / f"{name}.jsonl"
    argv = ["--dataset", "synthetic", "--model", "vit", "--epochs", "1",
            "--batch-size", "32", "--synthetic-train-size", "128",
            "--synthetic-test-size", "64", "--seed", "0", "--dtype", "f32",
            "--device", "cpu", "--root", str(tmp_path / "data"),
            "--checkpoint-dir", str(tmp_path / name), "--metrics-file",
            str(rows), *extra]
    if spawn:
        argv = ["--spawn", str(spawn), "--agreement-timeout", "60"] + argv
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           OMP_NUM_THREADS="1")), rows


def _rows(rows):
    return [json.loads(line) for line in rows.read_text().splitlines()
            if '"train_loss"' in line]


def _toy(rng, s, f, n):
    w = (rng.normal(size=(s, f, f)) / np.sqrt(f)).astype(np.float32)
    b = (rng.normal(size=(s, f)) * 0.1).astype(np.float32)
    return w, b, rng.normal(size=(n, f)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every world of this file, started together: the toy (1, 4) world,
    the two hop worlds, and the CLI worlds."""
    root = tmp_path_factory.mktemp("pipeline_world")
    rng = np.random.default_rng(0)
    w, b, x = _toy(rng, 4, 32, 16)
    gw, gb, gx = _toy(rng, 4, 16, 8)
    np.savez(root / "toy.npz", w=w, b=b, x=x, gw=gw, gb=gb, gx=gx)
    worlds = {"toy": _launch(_RANK, 4, root)}
    for variant in ("real", "skip"):
        (root / variant).mkdir()
        worlds[variant] = _launch(_HOPS, 2, root / variant, variant,
                                  str(HOP_TIMEOUT))
    cli_root = root / "cli"
    cli_root.mkdir()
    flags = ("--remat", "--grad-accum", "2", "--trainer-mode", "stepwise")
    clis = {"accum": _cli(cli_root, "accum", "--pipeline-stages", "2",
                          *flags),
            "accum_one": _cli(cli_root, "accum_one", *flags, spawn=0),
            "explicit": _cli(cli_root, "explicit", "--pipeline-stages", "2",
                             "--trainer-mode", "explicit")}
    done = {name: _join(procs) for name, procs in worlds.items()}
    for r, (rc, text) in enumerate(done["toy"]):
        assert rc == 0, f"toy rank {r}:\n{text}"
    out = {}
    for name, (proc, rows) in clis.items():
        try:
            text = proc.communicate(timeout=WORLD_TIMEOUT)[0]
        finally:
            proc.kill()
        out[name] = (proc.returncode, text, rows)
    return {"ranks": [dict(np.load(root / f"rank{r}.npz"))
                      for r in range(4)],
            "toy": dict(np.load(root / "toy.npz")), "hops": done,
            "root": root, "cli": out}


def _jax_toy(z, prefix=""):
    params = {"w": jnp.asarray(z[prefix + "w"]),
              "b": jnp.asarray(z[prefix + "b"])}
    return params, jnp.asarray(z[prefix + "x"])


def _jax_stage(p, h):
    return jax.nn.relu(h @ p["w"] + p["b"])


@pytest.mark.parametrize("microbatches", [4, 8])
def test_pipeline_matches_sequential(world, microbatches):
    """Four stages at 4 and 8 microbatches: every rank's output equals the
    JAX pipeline's and both packages' sequential application."""
    z = world["toy"]
    params, x = _jax_toy(z)
    mesh = jax_make_mesh(("stage",), devices=jax.devices()[:4])
    want = np.asarray(jax.jit(lambda p, x: jax_pipeline_apply(
        _jax_stage, p, x, mesh=mesh, num_microbatches=microbatches))(
            params, x))
    seq = np.asarray(jax_sequential_apply(_jax_stage, params, x))
    port_seq = sequential_apply(
        lambda p, h: torch.relu(h @ p["w"] + p["b"]),
        {k: torch.from_numpy(z[k]) for k in ("w", "b")},
        torch.from_numpy(z["x"])).numpy()
    np.testing.assert_allclose(port_seq, seq, rtol=1e-5, atol=1e-6)
    for res in world["ranks"]:
        for ref in (want, seq):
            np.testing.assert_allclose(res[f"fwd{microbatches}"], ref,
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(res["fwd_row"], res["fwd4"])


def test_pipeline_grads_match_sequential(world):
    """Backprop through the ticks and the hops == backprop through the
    plain chain: each stage rank's gradient is its row's, and the rows
    summed over the ranks equal the JAX gradients of both programs."""
    z = world["toy"]
    params, x = _jax_toy(z, "g")
    mesh = jax_make_mesh(("stage",), devices=jax.devices()[:4])

    def loss_pipe(p):
        return jnp.sum(jax_pipeline_apply(_jax_stage, p, x, mesh=mesh) ** 2)

    def loss_seq(p):
        return jnp.sum(jax_sequential_apply(_jax_stage, p, x) ** 2)

    gp = jax.jit(jax.grad(loss_pipe))(params)
    gs = jax.jit(jax.grad(loss_seq))(params)
    for k in ("w", "b"):
        got = sum(res["grad_" + k] for res in world["ranks"])
        for r, res in enumerate(world["ranks"]):
            others = np.delete(res["grad_" + k], r, axis=0)
            assert not others.any(), (k, r)  # only this stage's row
        for want in (gp[k], gs[k]):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_pipeline_rejects_bad_microbatch():
    mesh = GridMesh(4, 0, CPU, (DataAxis(1, 0, CPU, None, "data"),
                                DataAxis(4, 0, CPU, None, "stage")))
    params = stack_stage_params([{"w": torch.zeros(8, 8)}] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(lambda p, h: h @ p["w"], params, torch.zeros(10, 8),
                       mesh=mesh, num_microbatches=4)
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_apply(lambda p, h: h @ p["w"],
                       {"w": torch.zeros(3, 8, 8)}, torch.zeros(8, 8),
                       mesh=mesh)


def test_a_backward_that_skips_a_hop_fails_and_does_not_hang(world):
    """The real schedule runs the same hops on every rank, forward and
    backward: 2 stages at 2 microbatches make 3 ticks, so 3 hops forward
    and 2 back (the last tick's hop reaches no loss on any rank). A
    copy that picks stage 0's input with a Python ``if`` leaves stage 0's
    graph without the hops' backward: its world must end in an error
    within the process groups' timeout, not wait forever."""
    for r, (rc, text) in enumerate(world["hops"]["real"]):
        assert rc == 0, f"rank {r}:\n{text}"
        counts = json.loads((world["root"] / "real" /
                             f"hops{r}.json").read_text())
        assert counts == [3, 2], (r, counts)
    skipped = world["hops"]["skip"]
    assert any(rc != 0 for rc, _ in skipped), skipped


def test_cli_pipeline_remat_grad_accum_stepwise_matches_one_process(world):
    """``--pipeline-stages 2 --remat --grad-accum 2`` in stepwise mode:
    each accumulation micro-batch is cut again into the pipeline's 2
    microbatches, and the epoch equals the one-process run's."""
    rc, text, rows = world["cli"]["accum"]
    assert rc == 0, text
    assert "mesh: {'data': 1, 'stage': 2}" in text
    rc1, text1, rows1 = world["cli"]["accum_one"]
    assert rc1 == 0, text1
    got, want = _rows(rows), _rows(rows1)
    assert len(got) == len(want) == 1
    assert got[0]["train_loss"] == pytest.approx(want[0]["train_loss"],
                                                 rel=1e-4)
    assert got[0]["test_acc"] == pytest.approx(want[0]["test_acc"],
                                               abs=1e-6)


def test_cli_explicit_mode_refuses_the_pipeline_as_jax_does(world):
    """The JAX CLI's ``--trainer-mode explicit --pipeline-stages 2`` on 8
    CPU devices builds the mesh and the state, then its Trainer refuses
    the sharded state; the port's world does the same, in its words."""
    rc, text, _ = world["cli"]["explicit"]
    assert rc != 0
    assert "mesh: {'data': 1, 'stage': 2}" in text
    assert EXPLICIT_WORDS in text


def _base(tmp_path, *extra, model="vit"):
    return ["--dataset", "synthetic", "--model", model, "--epochs", "1",
            "--batch-size", "64", "--synthetic-train-size", "256",
            "--synthetic-test-size", "128", "--seed", "0",
            "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--root", str(tmp_path / "data"), *extra]


def _port_refusal(tmp_path, extra, devices, model) -> str:
    args = cli.build_parser().parse_args(_base(tmp_path, *extra,
                                               model=model))
    with pytest.raises(SystemExit) as info:
        cli._check_parallel_flags(args, devices)
    return str(info.value)


# The pipeline's refusals in the JAX CLI's order (cli.py:993-1307), each
# reached on its 8 CPU devices.
_REFUSALS = [
    (["--tp-overlap", "--tensor-parallel", "2"], "vit"),
    (["--expert-parallel", "2"], "moe_mlp"),
    (["--grad-accum", "2", "--batch-size", "24"], "vit"),
    (["--zero-overlap", "--optimizer-sharding", "zero1"], "vit"),
    (["--sequence-parallel", "2"], "vit"),
    ([], "cnn"),
    (["--optimizer-sharding", "zero3"], "vit"),
    (["--tensor-parallel", "3"], "vit"),
]


@pytest.mark.parametrize("extra,model", _REFUSALS)
def test_cli_pipeline_refuses_in_the_jax_words(tmp_path, extra, model):
    flags = ["--pipeline-stages", "2", *extra]
    with pytest.raises(SystemExit) as info:
        jax_run(jax_parser().parse_args(_base(tmp_path, *flags,
                                              model=model)))
    assert _port_refusal(tmp_path, flags, 8, model) == str(info.value)


def test_cli_pipeline_refuses_an_indivisible_world_and_heads(tmp_path):
    assert _port_refusal(tmp_path, ["--pipeline-stages", "3"], 8,
                         "vit") == ("--pipeline-stages 3 does not divide "
                                    "the 8 available devices")
    # 6 devices: 2 stages x 3 model ranks fit, the ViT's 4 heads do not.
    assert _port_refusal(
        tmp_path, ["--pipeline-stages", "2", "--tensor-parallel", "3"], 6,
        "vit") == ("--tensor-parallel 3 with --pipeline-stages: the "
                   "Megatron stage body shards the ViT's 4 attention heads "
                   "over the model axis, so the width must divide 4")
