"""The port's sharded serve modes (``--serve-mode tensor|expert``) on the
CPU, against the JAX package on its 8 CPU devices: the mode registry and
its refusals word for word, the mesh groups with and without an emulated
slice map, ``tensor`` (the ViT) and ``expert`` (``moe_mlp``) pools at
mesh 2 and 4 at every precision on exact and padded buckets against the
JAX ``EnginePool`` of the same mode, the int8 plane's products against
the unsharded ones and the plain route, and the server under
``--serve-mode`` (``/stats``, ``/resize`` with ``serve_mesh``, the
layout gate at boot).

Weights start as the port's seeded params and cross to the JAX package
through ``models/convert.py``. The JAX pools are built as the JAX server
builds them: on ``int8`` the ViT gets ``int8_dot_general`` through its
``dot_general`` field (the Pallas ``matmul_i8`` in interpret mode).
Models are at their registered widths with float32 compute; one bucket
of 8 serves an exact batch (8 rows) and a padded one (5 rows)."""

import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import synthetic_dataset
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.ops.pallas import int8_dot_general
from pytorch_distributed_mnist_tpu.parallel import mesh as jax_mesh
from pytorch_distributed_mnist_tpu.parallel.pipeline_vit import (
    split_vit_params as jax_split_vit_params,
)
from pytorch_distributed_mnist_tpu.serve import programs as ref
from pytorch_distributed_mnist_tpu.serve.pool import EnginePool as JaxPool
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    key_path,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
    int8_linear,
    matmul_i8_plain,
)
from pytorch_distributed_mnist_tpu_torch.parallel import mesh as port_mesh
from pytorch_distributed_mnist_tpu_torch.serve import programs as port
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    InferenceEngine,
    load_params_for_serving,
)
from pytorch_distributed_mnist_tpu_torch.serve.pool import EnginePool
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
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
MODE_MODEL = {"tensor": "vit", "expert": "moe_mlp"}


def _jax_variables(params):
    """Port params -> the JAX model's variables ``{'params': {...}}``."""
    tree: dict = {}
    for name, arr in params_to_jax(params).items():
        keys = key_path(name)[1:]  # below the train state's 'params'
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = jnp.asarray(arr)
    return tree


def _port_factory(model_name, precision, matmul=int8_linear):
    kwargs = {}
    if precision == "int8" and model_name == "vit":
        kwargs["matmul"] = matmul
    return functools.partial(get_model, model_name,
                             compute_dtype=torch.float32, **kwargs)


def _jax_model(model_name, precision):
    kwargs = {}
    if precision == "int8" and model_name == "vit":
        kwargs["dot_general"] = int8_dot_general
    return jax_get_model(model_name, compute_dtype=jnp.float32, **kwargs)


def _served(pool, images):
    return pool.complete(pool.dispatch(pool.preprocess(images)))[0]


@pytest.fixture(scope="module")
def setup():
    images, _ = synthetic_dataset(8, seed=11)
    params = {name: init_params(name, 3) for name in ("vit", "moe_mlp")}
    return params, images


# -- (a) the registry --------------------------------------------------------


def _error(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


def test_the_registry_matches_the_jax_registry():
    assert port.serve_modes() == ref.serve_modes() == port.SERVE_MODES
    for model_name in ("vit", "moe_mlp", "cnn", "linear"):
        assert port.servable_modes(model_name) == \
            ref.servable_modes(model_name)
    for mesh in (2, 4, 8):
        got = port.build_group_placements("expert", "moe_mlp", [CPU] * 8,
                                          mesh, init_params("moe_mlp", 0))
        assert [g.name for g in got] == [
            ref.group_name("expert", i, 8 // mesh) for i in range(8 // mesh)]
        assert [len(g.devices) for g in got] == [mesh] * (8 // mesh)
    for mode in port.serve_modes()[1:]:
        assert port.staged_mode(mode) == ref.staged_mode(mode)
        assert port.get_serve_mode(mode).axis == ref.get_serve_mode(mode).axis
    assert not port.staged_mode("replicated")
    assert port.precision_engine_name(
        port.group_name("tensor", 1, 2), "int8") == "tensor.g1.int8"
    for args in (("tensor", 0, 1), ("tensor", 1, 4), ("pipeline", 3, 4)):
        assert port.group_name(*args) == ref.group_name(*args)
    for name, axis in (("tensor", "model"), ("replicated", "x")):
        assert _error(port.register_serve_mode, name, axis, {}) == \
            _error(ref.register_serve_mode, name, axis, {})
    from pytorch_distributed_mnist_tpu_torch.serve import SERVE_MODES

    assert SERVE_MODES == ref.SERVE_MODES


def test_validate_serve_mode_speaks_the_jax_words():
    jvit = jax.jit(jax_get_model("vit").init)(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1), jnp.float32))
    jmoe = jax.jit(jax_get_model("moe_mlp").init)(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1), jnp.float32))
    jsplit = jax_split_vit_params(jvit)
    vit, moe = port.model_template("vit"), port.model_template("moe_mlp")
    split = port.make_serve_template("pipeline", "vit")
    cases = [
        (("tensor", "cnn", 2), ("tensor", "cnn", 2)),
        (("expert", "vit", 2), ("expert", "vit", 2)),
        (("ring", "vit", 2), ("ring", "vit", 2)),
        (("replicated", "cnn", 2), ("replicated", "cnn", 2)),
        (("tensor", "vit", 7, vit), ("tensor", "vit", 7, jvit)),
        (("tensor", "vit", 3, vit), ("tensor", "vit", 3, jvit)),
        (("expert", "moe_mlp", 3, moe), ("expert", "moe_mlp", 3, jmoe)),
        (("expert", "moe_mlp", 16, moe), ("expert", "moe_mlp", 16, jmoe)),
        (("pipeline", "vit", 3, split), ("pipeline", "vit", 3, jsplit)),
    ]
    for got, want in cases:
        assert _error(port.validate_serve_mode, *got) == \
            _error(ref.validate_serve_mode, *want), got
    # A params dict speaks like its template.
    assert _error(port.validate_serve_mode, "tensor", "vit", 7,
                  init_params("vit", 0)) == \
        _error(port.validate_serve_mode, "tensor", "vit", 7, vit)
    for ok in (("tensor", "vit", 8, vit), ("expert", "moe_mlp", 8, moe),
               ("pipeline", "vit", 2, split), ("replicated", "cnn", 1)):
        port.validate_serve_mode(*ok)


@pytest.mark.parametrize("layout,mode,model_name", [
    ({"tensor": 2}, "replicated", "vit"),
    ({"tensor": 2}, "pipeline", "vit"),
    ({"pipeline": 2}, "tensor", "vit"),
    ({"pipeline": 4}, "replicated", "vit"),
    ({"expert": 2}, "replicated", "moe_mlp"),
    ({"expert": 2, "tensor": 1}, "tensor", "moe_mlp"),
])
def test_the_layout_gate_speaks_the_jax_words(layout, mode, model_name):
    assert _error(port.check_checkpoint_layout, layout, mode, model_name) \
        == _error(ref.check_checkpoint_layout, layout, mode, model_name)
    trained = next(k for k, v in layout.items() if v > 1)
    port.check_checkpoint_layout(layout, trained, model_name)
    port.check_checkpoint_layout({"sequence": 2}, "replicated", model_name)
    port.check_checkpoint_layout(None, mode, model_name)


def _shape(groups, index):
    return [[index(d, i) for i, d in enumerate(g)] for g in groups]


def test_partition_groups_and_slice_maps_match_jax(monkeypatch):
    """The CPU's slots are one device repeated, so a slot's position
    stands for the JAX device id; the groups, the slice map and the
    refusals match the JAX package's over ids 0..7."""
    jdevs, cpus = jax.devices()[:8], [CPU] * 8
    for mesh in (1, 2, 4, 8):
        want = [[d.id for d in g] for g in ref.partition_groups(jdevs, mesh)]
        # Without a slice map both keep the given order.
        assert [[i * mesh + j for j in range(mesh)]
                for i in range(8 // mesh)] == want
        assert [len(g) for g in port.partition_groups(cpus, mesh)] == \
            [len(g) for g in want]
    assert _error(port.partition_groups, cpus[:3], 2) == \
        _error(ref.partition_groups, jdevs[:3], 2)
    assert _error(port.partition_groups, cpus, 0) == \
        _error(ref.partition_groups, jdevs, 0)
    assert port_mesh.DCN_SLICES_ENV == jax_mesh.DCN_SLICES_ENV
    assert port_mesh.device_slice_map(cpus) is None
    for slices in ("2", "4", "8", "3", "x", "1"):
        monkeypatch.setenv(port_mesh.DCN_SLICES_ENV, slices)
        assert port_mesh.device_slice_map(cpus) == \
            jax_mesh.device_slice_map(jdevs), slices
        assert port_mesh.device_slice_map(cpus[:4]) == \
            jax_mesh.device_slice_map(jdevs[:4]), slices


def test_pool_topology_flags_slice_straddling_groups(setup, monkeypatch):
    params, _ = setup

    def topology(mesh):
        return EnginePool(_port_factory("moe_mlp", "f32"),
                          params["moe_mlp"], devices=[CPU] * 4,
                          buckets=(4,), serve_mode="expert", mesh_size=mesh,
                          model_name="moe_mlp").topology()

    monkeypatch.setenv(port_mesh.DCN_SLICES_ENV, "8")  # 8 slices of 1
    assert topology(2)["slice_straddling_groups"] == ["expert.g0",
                                                      "expert.g1"]
    monkeypatch.setenv(port_mesh.DCN_SLICES_ENV, "2")  # slots 0-3: slice 0
    assert topology(2)["slice_straddling_groups"] == []
    monkeypatch.delenv(port_mesh.DCN_SLICES_ENV)
    assert "slice_straddling_groups" not in topology(2)


# -- (b) the pools against the JAX pools ---------------------------------------


def _jax_pool(model_name, mode, mesh, precision, jparams):
    model = _jax_model(model_name, precision)
    pool = JaxPool(model.apply, jparams, devices=jax.local_devices()[:mesh],
                   buckets=(8,), serve_mode=mode, mesh_size=mesh,
                   model_name=model_name, model=model, precision=precision,
                   fuse=True)
    pool.warmup()
    return pool


@pytest.mark.parametrize("mesh", [2, 4])
@pytest.mark.parametrize("mode", ["tensor", "expert"])
def test_sharded_pools_match_the_jax_pools(setup, mode, mesh):
    """Every precision, the fused plane, an exact (8-row) and a padded
    (5-row) batch. Tolerances are the replicated engines' (the ViT's:
    ``tests/test_torch_serve_vit.py``, the MoE's:
    ``tests/test_torch_serve_moe.py``): float32 compute on both sides,
    the products and sums in another order (ViT atol 5e-6, MoE 1e-5,
    argmax equal); on int8 the ViT quantizes every Dense input per
    tensor, and an input a rounding away from a quantization boundary
    moves the logits by a step of that product's scale (atol 2e-2,
    argmax on 99% of rows). The port's int8 plane is its unsharded
    engine's bit for bit."""
    params, images = setup
    model_name = MODE_MODEL[mode]
    jparams = _jax_variables(params[model_name])
    for precision in PRECISIONS:
        pool = EnginePool(_port_factory(model_name, precision),
                          params[model_name], devices=[CPU] * mesh,
                          buckets=(8,), serve_mode=mode, mesh_size=mesh,
                          model_name=model_name, precision=precision,
                          fuse=True)
        pool.warmup()
        jpool = _jax_pool(model_name, mode, mesh, precision, jparams)
        assert [r.name for r in pool.replicas] == \
            [r.name for r in jpool.replicas]
        for rows in (images, images[:5]):
            got = _served(pool, rows)
            want = np.asarray(_served(jpool, rows))
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.all(np.isfinite(got))
            if precision == "int8" and model_name == "vit":
                np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
                agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
                assert agree >= 0.99, (precision, agree)
                one = InferenceEngine(
                    _port_factory(model_name, precision)(),
                    params[model_name], buckets=(8,), precision=precision,
                    fuse=True, device="cpu")
                assert one.logits(rows).tobytes() == got.tobytes()
                continue
            atol = 5e-6 if model_name == "vit" else 1e-5
            np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                       err_msg=precision)
            assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_tensor_int8_kernel_route_is_the_plain_route_bitwise(setup):
    """The int8 plane's products through ``int8_linear`` with the kernel
    (on the CPU its wrapper takes the plain version) and with
    ``matmul_i8_plain`` named: the same bits, and ``2 + 4 * m * depth``
    int8 products per forward at mesh m (embed and head once, each
    block's four Dense layers once per shard, at the per-shard K or N)."""
    params, images = setup
    plain = functools.partial(int8_linear, matmul=matmul_i8_plain)
    shapes = []

    def counting(x, w, out_dtype=None, **kw):
        shapes.append((x.reshape(-1, x.shape[-1]).shape[0],) + tuple(w.shape))
        return plain(x, w, out_dtype, **kw)

    for mesh in (2, 4):
        out = {}
        for route, matmul in (("kernel", int8_linear), ("plain", counting)):
            pool = EnginePool(_port_factory("vit", "int8", matmul),
                              params["vit"], devices=[CPU] * mesh,
                              buckets=(8,), serve_mode="tensor",
                              mesh_size=mesh, model_name="vit",
                              precision="int8", fuse=True)
            shapes.clear()
            out[route] = _served(pool, images)
        assert out["kernel"].tobytes() == out["plain"].tobytes()
        assert len(shapes) == 2 + 4 * mesh * 2
        m = 8 * 49
        per_block = ([(m, 64, 192 // mesh)] * mesh
                     + [(m, 64 // mesh, 64)] * mesh
                     + [(m, 64, 256 // mesh)] * mesh
                     + [(m, 256 // mesh, 64)] * mesh)
        assert shapes == [(m, 16, 64)] + per_block * 2 + [(8, 64, 10)]


def test_tensor_mesh_8_over_4_heads_gathers_the_attention(setup):
    """Mesh 8 passes the reference's divisibility walk (192, 64 and 256
    all divide by 8) but splits the 4 heads in halves: the shards' q, k
    and v columns are gathered for the attention, and the pool answers
    as the JAX pool does. Eight partial products are summed on each side
    in its own order, and the CPU GEMMs of both packages split their
    sums by the threads they get: 6e-7 apart on an idle host, 1.07e-5 on
    a loaded one (atol 2e-5)."""
    params, images = setup
    pool = EnginePool(_port_factory("vit", "f32"), params["vit"],
                      devices=[CPU] * 8, buckets=(8,), serve_mode="tensor",
                      mesh_size=8, model_name="vit")
    assert not pool.replicas[0].engine._apply.whole_heads
    jpool = _jax_pool("vit", "tensor", 8, "f32",
                      _jax_variables(params["vit"]))
    got = _served(pool, images)
    want = np.asarray(_served(jpool, images))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


# -- the server ---------------------------------------------------------------


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def _post(base, path, payload):
    req = urllib.request.Request(base + path,
                                 data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _save(directory, model_name, layout):
    state = create_train_state(get_model(model_name), 0, CPU)
    return port_ckpt.save_checkpoint(state, epoch=0, best_acc=0.0,
                                     is_best=False, directory=str(directory),
                                     parallel_layout=layout)


def _args(directory, model_name, *extra):
    return build_parser().parse_args([
        "--model", model_name, "--device", "cpu", "--port", "0",
        "--checkpoint-dir", str(directory), "--buckets", "1,8",
        "--no-reload", *extra])


def test_serve_tensor_mode_boots_reshapes_and_gates(tmp_path, setup):
    """``serve --device cpu --serve-mode tensor --serve-devices 2`` on a
    checkpoint the port's trainer wrote stamped tensor-parallel: one
    2-device group (window 2), ``/stats`` naming the mode and the mesh,
    replies equal to the replicated engine's, a ``/resize`` to
    ``serve_mesh`` 1 (two groups) under the same mode, and a non-dividing
    ``serve_mesh`` refused (400). The same checkpoint under
    ``replicated`` is refused at boot with the JAX words."""
    _, images = setup
    path = _save(tmp_path, "vit", {"tensor": 2, "sequence": 1,
                                   "expert": 1, "pipeline": 1})
    with pytest.raises(SystemExit) as info:
        create_server(_args(tmp_path, "vit"))
    assert str(path) in str(info.value)
    assert _error(ref.check_checkpoint_layout, {"tensor": 2}, "replicated",
                  "vit") in str(info.value)
    httpd = create_server(_args(tmp_path, "vit", "--serve-mode", "tensor",
                                "--serve-devices", "2", "--serve-precision",
                                "int8"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        stats = _get(base, "/stats")
        assert (stats["serve_mode"], stats["mesh_devices"],
                stats["mesh_groups"], stats["max_inflight"]) == \
            ("tensor", 2, 1, 2)
        assert "serve_forward_b8.fused@tensor.int8" in \
            stats["warmup"]["programs"]
        code, reply = _post(base, "/predict", {"images": images.tolist()})
        assert code == 200 and reply["model_epoch"] == 0
        loaded, _ = load_params_for_serving(path, "vit")
        one = InferenceEngine(get_model("vit", matmul=int8_linear), loaded,
                              buckets=(1, 8), precision="int8", fuse=True,
                              device="cpu")
        assert reply["predictions"] == one.predict(images).tolist()
        code, resized = _post(base, "/resize", {"serve_mesh": 1})
        assert code == 200 and resized["new"]["groups"] == 2
        assert resized["new"]["serve_mode"] == "tensor"
        assert _get(base, "/stats")["mesh_devices"] == 1
        code, refused = _post(base, "/resize", {"serve_mesh": 3})
        assert code == 400 and "must divide" in refused["error"]
        code, reply = _post(base, "/predict", {"images": images.tolist()})
        assert code == 200
        assert reply["predictions"] == one.predict(images).tolist()
    finally:
        httpd.shutdown()
        httpd.ctx.close()
        httpd.server_close()


def test_serve_refuses_unservable_shapes_with_flag_words(tmp_path):
    """The boot's refusals, each before any engine is built: an
    unservable pair in the JAX words, a mesh that does not divide the
    serve devices, a weight dim the mesh does not divide, a mesh on the
    replicated plane, and an expert-parallel checkpoint under
    ``replicated``."""
    for extra, needle in (
            (("--model", "vit", "--serve-mode", "expert"),
             _error(ref.validate_serve_mode, "expert", "vit", 1)),
            (("--model", "vit", "--serve-mode", "tensor", "--serve-devices",
              "4", "--serve-mesh", "3"), "must divide --serve-devices"),
            (("--model", "vit", "--serve-mode", "tensor", "--serve-devices",
              "6", "--serve-mesh", "6"), "does not divide evenly"),
            (("--model", "cnn", "--serve-devices", "2", "--serve-mesh",
              "2"), "serves one engine per chip")):
        args = build_parser().parse_args([
            "--device", "cpu", "--port", "0", "--checkpoint-dir",
            str(tmp_path / "none"), *extra])
        with pytest.raises(SystemExit) as info:
            create_server(args)
        assert needle in str(info.value), (extra, str(info.value))
    _save(tmp_path / "moe", "moe_mlp", {"expert": 2})
    with pytest.raises(SystemExit, match="serve it with --serve-mode expert"):
        create_server(_args(tmp_path / "moe", "moe_mlp"))
    httpd = create_server(_args(tmp_path / "moe", "moe_mlp", "--serve-mode",
                                "expert", "--serve-devices", "2"))
    try:
        assert httpd.ctx.pool.topology()["mesh_devices"] == 2
    finally:
        httpd.ctx.close()
        httpd.server_close()


def test_sharded_and_staged_engines_resolve_the_card(setup):
    """With no devices named, a sharded pool takes the cards
    (``local_devices("cuda")``), and a chain or a placement asked for
    ``cuda`` resolves it: with no card visible each raises; none falls
    back to the CPU."""
    if torch.cuda.is_available():
        return
    from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
        split_vit_params,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.pipeline import (
        PipelineEngine,
    )

    params, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA card"):
        EnginePool(_port_factory("vit", "int8"), params["vit"],
                   serve_mode="tensor", mesh_size=1, model_name="vit",
                   precision="int8")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port.build_placement("tensor", "vit", ["cuda", "cuda"],
                             params["vit"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PipelineEngine(_port_factory("vit", "f32")(),
                       split_vit_params(params["vit"]), ["cuda", "cuda"])
