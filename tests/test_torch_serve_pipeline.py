"""The port's pipeline serving (``serve/pipeline.py``, ``--serve-mode
pipeline``) on the CPU, against the JAX package's ``PipelineEngine`` on
its CPU devices: each stage's program alone and the chain, at every
precision, on exact and padded buckets; the coordinated hot-reload swap
under traffic (no batch computed on two epochs); a chain's death under
the pool (the whole chain quarantined, every stage rebuilt) and
``resize(mesh_size=2)``; and the chaos tool's pipeline twin.

The ViT is at its registered widths (patch 4, embed 64, 4 heads, depth
2, MLP 256) with float32 compute, split into 2 stages of one block each
(the checkpoint's ``{embed, blocks, head}`` tree, cut by
``split_stage_params``). On ``int8`` both packages' ViTs run their Dense
layers through the int8 product (the JAX one through the Pallas
``matmul_i8`` in interpret mode) and hop bfloat16 between stages."""

import functools
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import (
    normalize_images,
    synthetic_dataset,
)
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.ops.pallas import int8_dot_general
from pytorch_distributed_mnist_tpu.serve.pipeline import (
    PipelineEngine as JaxPipelineEngine,
)
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    jax_param_path,
    key_path,
)
from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import int8_linear
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
    split_vit_params,
)
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    load_params_for_serving,
)
from pytorch_distributed_mnist_tpu_torch.serve.pipeline import (
    PipelineEngine,
    make_pipeline_template,
)
from pytorch_distributed_mnist_tpu_torch.serve.pool import (
    SERVE_FAULT_ENV,
    EnginePool,
)
from pytorch_distributed_mnist_tpu_torch.serve.programs import (
    get_precision,
)
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    save_params_checkpoint,
)

pytestmark = pytest.mark.serve

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: torch's CPU GEMMs split their sums
    by the threads they get, so on a loaded host two calls on the same
    inputs can differ in the last bits (9.4e-6 on the ViT's logits with
    2 threads); with one they do not."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PRECISIONS = ("f32", "bf16", "int8w", "int8")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(precision):
    kwargs = {"matmul": int8_linear} if precision == "int8" else {}
    return get_model("vit", compute_dtype=torch.float32, **kwargs)


def _jax_model(precision):
    kwargs = {"dot_general": int8_dot_general} if precision == "int8" \
        else {}
    return jax_get_model("vit", compute_dtype=jnp.float32, **kwargs)


def _jax_split(split):
    """The port's split tree -> the JAX one (``{embed, blocks, head}``
    nested, paths from the state's params)."""
    tree: dict = {}
    for name, arr in split.items():
        keys = key_path(jax_param_path(name, ""))
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = jnp.asarray(arr)
    return tree


def _engine(split, precision, stages=2, fuse=True, **kw):
    eng = PipelineEngine(_model(precision), split, [CPU] * stages,
                         buckets=(8,), precision=precision, fuse=fuse, **kw)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def setup():
    images, _ = synthetic_dataset(8, seed=17)
    split = split_vit_params(init_params("vit", 5))
    return split, images


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- (c) stage by stage and chained, against JAX ---------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
def test_each_stage_and_the_chain_match_the_jax_pipeline(setup, precision):
    """Stage 0 on the staged batch, stage 1 on the SAME hop (the port's
    stage-0 output fed to both), then the whole chain on an exact
    (8-row) and a padded (5-row) batch through the fused plane.
    Tolerances: float32 compute on both sides, sums in another order
    (activations atol 2e-5, logits 5e-6 as the replicated ViT engines';
    measured 1.8e-6 and 4.8e-7). On int8 every Dense input is quantized
    per tensor, so an input a rounding away from a boundary moves a
    product's row by one step of its scale, block 0 stacks four such
    products, and the bfloat16 hop rounds the result: the hop within 0.1
    (measured 0.0625 on 5% of its elements), logits within the
    replicated int8 engines' 2e-2 (measured 1.1e-2), argmax on 99% of
    rows."""
    split, images = setup
    spec = get_precision(precision)
    eng = _engine(split, precision)
    jeng = JaxPipelineEngine(_jax_model(precision), _jax_split(split),
                             jax.local_devices()[:2], buckets=(8,),
                             precision=precision, fuse=True)
    jeng.warmup()
    assert eng.stage_names() == jeng.stage_names() == \
        ["pipeline.s0", "pipeline.s1"]
    x = spec.stage_host(normalize_images(images))
    port_x = torch.from_numpy(np.ascontiguousarray(x))
    jstage = jeng._stages
    with torch.inference_mode():
        hop = eng._stages[0].run(eng._stage_params[0], port_x)
        got1 = eng._stages[1].run(eng._stage_params[1], hop)
    want0 = jstage[0].run(jeng._stage_params[0],
                          jax.device_put(x, jstage[0].sharding))
    jhop = jnp.asarray(_as_np(hop)).astype(jnp.asarray(want0).dtype)
    want1 = jstage[1].run(jeng._stage_params[1],
                          jax.device_put(jhop, jstage[1].sharding))
    assert str(hop.dtype).split(".")[-1] == str(jnp.asarray(want0).dtype)
    quant = precision == "int8"
    np.testing.assert_allclose(_as_np(hop), _as_np(want0),
                               atol=0.1 if quant else 2e-5, rtol=0)
    np.testing.assert_allclose(_as_np(got1), _as_np(want1),
                               atol=2e-2 if quant else 5e-6, rtol=0)
    for rows in (images, images[:5]):
        got = eng.logits(rows)
        want = np.asarray(jeng.logits(rows))
        assert got.dtype == np.float32 and got.shape == (len(rows), 10)
        if quant:
            np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
            assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.99
        else:
            np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
            assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_the_fused_chain_is_the_split_chain(setup):
    """The fused stage 0 normalizes on the device, bitwise the host's:
    on a full bucket the two planes give the same bits; the split plane
    takes normalized floats."""
    split, images = setup
    for precision in ("f32", "int8"):
        eng = _engine(split, precision)
        assert eng.logits(images).tobytes() == \
            eng.logits(normalize_images(images)).tobytes()
    names = set(eng.warmup_log.stats()["programs"])
    assert {"serve_forward_b8@pipeline.s0", "serve_forward_b8@pipeline.s1",
            "serve_forward_b8.fused@pipeline.s0"} <= names
    walls = eng.stage_step_ms(8, reps=2)
    assert sorted(walls) == ["s0", "s1"] and min(walls.values()) > 0


def test_each_stage_holds_and_quantizes_its_own_slice(setup):
    """Stage 0 holds the embed and block 0, stage 1 block 1 and the head;
    on int8w each stage's slice has its own per-leaf scale."""
    split, _ = setup
    eng = _engine(split, "int8w")
    s0, s1 = eng._stage_params
    assert {n.split(".")[0] for n in s0} == {"blocks", "embed"}
    assert {n.split(".")[0] for n in s1} == {"blocks", "head"}
    for name in ("blocks.attn.qkv.kernel", "blocks.mlp2.kernel"):
        assert tuple(s0[name].q.shape)[0] == 1
        for k, leaf in enumerate((s0[name], s1[name])):
            whole = split[name][k]
            assert float(leaf.s) == pytest.approx(
                float(np.abs(whole).max()) / 127.0, rel=1e-6)


def test_the_pipeline_template_loads_a_split_checkpoint(setup, tmp_path):
    """A checkpoint of the split tree (the leaves a pipeline-trained
    state writes, straight under the state's params) loads onto the
    pipeline template, and not onto the model's own."""
    split, _ = setup
    template = make_pipeline_template("vit")
    assert template.shapes == {n: v.shape for n, v in split.items()}
    assert template.root == "" and template.split
    flat = {"['params']" + jax_param_path(n, ""): v for n, v in split.items()}
    path = save_params_checkpoint(flat, epoch=3, directory=str(tmp_path))
    params, epoch = load_params_for_serving(path, template)
    assert epoch == 3
    for name, value in split.items():
        np.testing.assert_array_equal(params[name], value)
    with pytest.raises(ValueError, match="checkpoint has no leaf"):
        load_params_for_serving(path, "vit")
    fresh = template.fresh(0)
    assert {n: v.shape for n, v in fresh.items()} == template.shapes


# -- (d) the coordinated swap under traffic --------------------------------------


def test_the_swap_never_mixes_epochs_within_a_batch(setup):
    """Two dispatching threads while a third installs epochs 1..24
    (params A on odd epochs, B on even ones): every batch's logits are
    exactly A's or B's, as its reported epoch says; never stage 0 of one
    with stage 1 of the other. A stale epoch installs nothing."""
    split, images = setup
    other = split_vit_params(init_params("vit", 9))
    ref_a = _engine(split, "f32").logits(images)
    ref_b = _engine(other, "f32").logits(images)
    assert not np.allclose(ref_a, ref_b)
    eng = _engine(split, "f32", params_epoch=0)
    seen, errors, done = [], [], threading.Event()

    def client():
        while not done.is_set():
            try:
                logits, epoch = eng.logits_with_epoch(images)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))
                return
            seen.append((epoch, logits))

    threads = [threading.Thread(target=client) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for epoch in range(1, 25):
            assert eng.swap_params(other if epoch % 2 == 0 else split,
                                   epoch=epoch)
            # Let a batch or two run on each epoch (bounded).
            mark, deadline = len(seen), time.monotonic() + 30.0
            while len(seen) < mark + 2 and not errors \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
    finally:
        done.set()
        for t in threads:
            t.join(60.0)
    assert not errors and len(seen) >= 48
    epochs = {epoch for epoch, _ in seen}
    assert len(epochs) > 2
    for epoch, logits in seen:
        want = ref_b if epoch % 2 == 0 and epoch else ref_a
        assert logits.tobytes() == want.tobytes(), epoch
    assert not eng.swap_params(other, epoch=3)
    assert eng.params_epoch == 24


# -- (e) the chain under the pool -------------------------------------------------


def _wait_healed(pool, seconds=60.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        topo = pool.topology()
        if topo["regroups"] >= 1 and not topo["quarantined_groups"]:
            return topo
        time.sleep(0.05)
    raise AssertionError(f"the pool never healed: {pool.topology()}")


def test_a_dead_chain_is_quarantined_whole_and_regrouped(setup,
                                                         monkeypatch):
    """Chain 0 of two (4 slots, 2 stages each) dies after 2 batches: its
    batches fail over to chain 1, the whole chain is quarantined and
    rebuilt (both stages, generation 1), and every answer equals the
    one-chain engine's."""
    split, images = setup
    want = _engine(split, "f32").logits(images)
    monkeypatch.setenv(SERVE_FAULT_ENV, "0:2")
    pool = EnginePool(functools.partial(_model, "f32"), split,
                      devices=[CPU] * 4, buckets=(8,),
                      serve_mode="pipeline", mesh_size=2, model_name="vit",
                      quarantine_after=2, fuse=True)
    pool.warmup()
    assert [r.name for r in pool.replicas] == ["pipeline.g0",
                                               "pipeline.g1"]
    assert pool.topology()["pipeline_stages"] == 2
    for _ in range(8):
        got, _ = pool.complete(pool.dispatch(pool.preprocess(images)))
        assert got.tobytes() == want.tobytes()
    topo = _wait_healed(pool)
    assert topo["failovers"] >= 2 and topo["active_groups"] == 2
    chain = pool.replicas[0]
    assert chain.generation == 1 and len(chain.devices) == 2
    assert chain.engine.n_stages == 2
    assert pool.snapshot()["pipeline.g0"]["stages"] == 2
    got, _ = pool.complete(pool.dispatch(pool.preprocess(images)))
    assert got.tobytes() == want.tobytes()


def test_resize_reshapes_the_chains(setup):
    """``resize(mesh_size=2)`` turns 2 one-stage chains into one 2-stage
    chain; a mesh that does not divide the devices and a stage count
    the depth does not divide are refused, leaving the pool as it was."""
    split, images = setup
    want = _engine(split, "f32").logits(images)
    pool = EnginePool(functools.partial(_model, "f32"), split,
                      devices=[CPU] * 2, buckets=(8,),
                      serve_mode="pipeline", mesh_size=1, model_name="vit",
                      fuse=True)
    pool.warmup()
    assert pool.n_replicas == 2
    out = pool.resize(mesh_size=2, devices=[CPU] * 2)
    assert (out["old"]["groups"], out["new"]["groups"]) == (2, 1)
    assert out["new"]["pipeline_stages"] == 2
    assert pool.replicas[0].engine.n_stages == 2
    got, _ = pool.complete(pool.dispatch(pool.preprocess(images)))
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    with pytest.raises(ValueError, match="must divide"):
        pool.resize(n_devices=3, mesh_size=2, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="does not divide evenly"):
        pool.resize(n_devices=4, mesh_size=4, devices=[CPU] * 4)
    assert pool.topology()["mesh_devices"] == 2


def test_the_chaos_tool_kills_a_chain_under_traffic():
    """``runtime/chaos.py --serve --serve-mode pipeline``: 4 CPU slots as
    2 chains of 2 stages, chain 0 dead after 5 batches under loadgen;
    every request answered, the chain regrouped, then the no-fault
    twin."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch.runtime."
         "chaos", "--serve", "--device", "cpu", "--serve-devices", "4",
         "--serve-mode", "pipeline", "--serve-mesh", "2", "--serve-model",
         "vit", "--serve-fault", "0:5", "--expect-groups", "2",
         "--requests", "60", "--timeout", "120"],
        capture_output=True, text=True, timeout=240, cwd=_REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])["chaos"]
    assert line["ok"] and line["serve"]["serve_mode"] == "pipeline"
    assert line["faulted"]["answered"] == 60
    assert line["faulted"]["topology"]["regroups"] >= 1
    assert line["twin"]["topology"]["regroups"] == 0
