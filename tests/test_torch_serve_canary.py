"""The port's shadow-traffic canary (``serve/canary.py``): the cases of
``tests/test_serve_canary.py`` (the sampler and state machine on stub
planes; the loopback-server runs in which a quantized publish promotes
after clean shadow traffic and an injected-disagreement publish rolls
back, both under live ``tools/loadgen.py`` traffic with zero dropped
requests), and the port's canary against the JAX one on real engines
from one JAX checkpoint: the same shadow judgments on inputs whose
logits are not near a tie.

The servers run ``linear`` on ``--device cpu`` (float32 compute, the split
plane, as the JAX suite does); every wait is bounded."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

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
from pytorch_distributed_mnist_tpu.serve.canary import (
    ShadowCanary as JaxCanary,
)
from pytorch_distributed_mnist_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from pytorch_distributed_mnist_tpu.serve.engine import (
    load_params_for_serving as jax_load_params,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import create_train_state
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    init_params,
    params_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import int8_linear
from pytorch_distributed_mnist_tpu_torch.serve.canary import (
    CANARY_FAULT_ENV,
    PRIMARY,
    ROLLED_BACK,
    SHADOW,
    ShadowCanary,
)
from pytorch_distributed_mnist_tpu_torch.serve.engine import (
    InferenceEngine,
    load_params_for_serving,
)
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)
from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
    save_params_checkpoint,
)

pytestmark = pytest.mark.serve
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds any one loadgen run or wait may take


# -- stub planes -------------------------------------------------------------


class _Plane:
    """An engine/pool stand-in: deterministic logits from a row
    transform, the full canary-facing surface."""

    def __init__(self, logits_fn, epoch=0, fail_dispatch=False,
                 fail_complete=False):
        self.logits_fn = logits_fn
        self.epoch = epoch
        self.fail_dispatch = fail_dispatch
        self.fail_complete = fail_complete
        self.buckets = (1, 8)
        self.max_batch = 8
        self.dispatches = 0
        self.swaps = []
        self.warmed = False

    @property
    def params_epoch(self):
        return self.epoch

    def preprocess(self, images):
        return np.asarray(images, np.float32)

    def warmup(self):
        self.warmed = True

    def dispatch(self, images):
        if self.fail_dispatch:
            raise RuntimeError("injected dispatch death")
        self.dispatches += 1
        return np.asarray(images, np.float32)

    def complete(self, handle):
        if self.fail_complete:
            raise RuntimeError("injected completion death")
        return self.logits_fn(handle), self.epoch

    def swap_params(self, params, epoch=None, path=None):
        self.swaps.append(epoch)
        self.epoch = epoch
        return 1


def _base_logits(x):
    n = x.shape[0]
    out = np.zeros((n, 10), np.float32)
    out[np.arange(n), np.arange(n) % 10] = 5.0
    return out


def _agreeing(x):
    return _base_logits(x) + 0.01  # same argmax, tiny logit delta


def _disagreeing(x):
    out = _base_logits(x)
    return -out  # argmax moves off the spiked class for every row


def _batch(n=4):
    return np.zeros((n, 4), np.float32)


# -- unit: sampling + state machine ------------------------------------------


def test_fraction_sampler_is_exact():
    canary = ShadowCanary(_Plane(_base_logits), _Plane(_agreeing), "bf16",
                          fraction=0.25, promote_after=10_000)
    for handle in (canary.dispatch(_batch()) for _ in range(16)):
        canary.complete(handle)
    snap = canary.snapshot()
    assert snap["shadow_batches"] == 4  # exactly a quarter
    assert canary.candidate.dispatches == 4
    assert snap["state"] == SHADOW


def test_promotes_after_clean_rows_and_routes_to_candidate():
    base, cand = _Plane(_base_logits), _Plane(_agreeing)
    canary = ShadowCanary(base, cand, "bf16", fraction=1.0,
                          promote_after=12, budget=0.1)
    while canary.state == SHADOW:
        canary.complete(canary.dispatch(_batch(4)))
    snap = canary.snapshot()
    assert snap["state"] == PRIMARY and snap["promotions"] == 1
    assert snap["compared_rows"] >= 12 and snap["disagreed_rows"] == 0
    assert snap["logit_delta"]["max"] == pytest.approx(0.01, abs=1e-4)
    # Promoted: replies now COME FROM the candidate (its logits differ
    # by the 0.01 offset), and no further shadow dispatches happen.
    base_dispatches = base.dispatches
    logits, _ = canary.complete(canary.dispatch(_batch(2)))
    assert logits[0, 0] == pytest.approx(5.01)
    assert base.dispatches == base_dispatches


def test_rolls_back_when_disagreement_blows_the_budget():
    canary = ShadowCanary(_Plane(_base_logits), _Plane(_disagreeing),
                          "int8", fraction=1.0, promote_after=100,
                          budget=0.05)  # allowance: 5 rows
    for _ in range(3):  # 12 rows, all disagreeing
        canary.complete(canary.dispatch(_batch(4)))
        if canary.state == ROLLED_BACK:
            break
    snap = canary.snapshot()
    assert snap["state"] == ROLLED_BACK and snap["rollbacks"] == 1
    assert snap["disagreed_rows"] > 5
    # Permanent for this publish: no further shadowing, baseline answers.
    cand_dispatches = canary.candidate.dispatches
    logits, _ = canary.complete(canary.dispatch(_batch(2)))
    assert logits[0, 0] == pytest.approx(5.0)  # baseline's
    assert canary.candidate.dispatches == cand_dispatches
    assert canary.snapshot()["shadow_batches"] == snap["shadow_batches"]


def test_shadow_dispatch_errors_count_and_never_fail_the_reply():
    base = _Plane(_base_logits)
    cand = _Plane(_agreeing, fail_dispatch=True)
    canary = ShadowCanary(base, cand, "int8w", fraction=1.0,
                          promote_after=100, budget=0.0)
    logits, epoch = canary.complete(canary.dispatch(_batch(4)))
    assert logits.shape == (4, 10)  # the reply arrived regardless
    snap = canary.snapshot()
    assert snap["shadow_errors"] == 1
    assert snap["state"] == ROLLED_BACK  # zero budget: first error rolls


def test_shadow_completion_errors_count_toward_budget():
    cand = _Plane(_agreeing, fail_complete=True)
    canary = ShadowCanary(_Plane(_base_logits), cand, "int8w",
                          fraction=1.0, promote_after=100, budget=0.0)
    logits, _ = canary.complete(canary.dispatch(_batch(4)))
    assert logits.shape == (4, 10)
    assert canary.snapshot()["state"] == ROLLED_BACK


def test_epoch_skew_skips_the_comparison():
    cand = _Plane(_agreeing, epoch=1)  # baseline serves epoch 0
    canary = ShadowCanary(_Plane(_base_logits, epoch=0), cand, "bf16",
                          fraction=1.0, promote_after=4, budget=0.0)
    canary.complete(canary.dispatch(_batch(4)))
    snap = canary.snapshot()
    assert snap["skewed_comparisons"] == 1
    assert snap["compared_rows"] == 0  # judged nothing
    assert snap["state"] == SHADOW


def test_swap_params_resets_the_cycle_per_publish():
    base, cand = _Plane(_base_logits), _Plane(_disagreeing)
    canary = ShadowCanary(base, cand, "int8", fraction=1.0,
                          promote_after=100, budget=0.0)
    canary.complete(canary.dispatch(_batch(4)))
    assert canary.state == ROLLED_BACK
    installed = canary.swap_params({"w": 1}, epoch=7, path="ckpt_7")
    assert installed == 1
    assert base.swaps == [7] and cand.swaps == [7]  # fanned to BOTH
    snap = canary.snapshot()
    assert snap["state"] == SHADOW  # the new publish re-earns promotion
    assert snap["publishes"] == 1 and snap["rollbacks"] == 1
    assert snap["compared_rows"] == 0 and snap["disagreed_rows"] == 0


def test_stale_publish_does_not_reset_a_promoted_canary():
    """A checkpoint both planes refuse as STALE (the engines'
    swap-ordering rule — e.g. an old file copied back, or a stale NFS
    readdir view) must not demote a promoted candidate or count as a
    publish: nothing installed, so nothing re-earns."""

    class _StalePlane(_Plane):
        def swap_params(self, params, epoch=None, path=None):
            self.swaps.append(epoch)
            return 0  # refused as stale

    base, cand = _StalePlane(_base_logits), _StalePlane(_agreeing)
    canary = ShadowCanary(base, cand, "bf16", fraction=1.0,
                          promote_after=4, budget=0.1)
    canary.complete(canary.dispatch(_batch(4)))  # promotes
    assert canary.state == PRIMARY
    assert canary.swap_params({"w": 1}, epoch=0) == 0
    snap = canary.snapshot()
    assert snap["state"] == PRIMARY  # still serving the quantized plane
    assert snap["publishes"] == 0  # the stale file never served
    assert base.swaps == [0] and cand.swaps == [0]  # it WAS offered


def test_injected_fault_env_forces_disagreement(monkeypatch):
    monkeypatch.setenv(CANARY_FAULT_ENV, "disagree")
    canary = ShadowCanary(_Plane(_base_logits), _Plane(_agreeing), "bf16",
                          fraction=1.0, promote_after=100, budget=0.0)
    canary.complete(canary.dispatch(_batch(4)))
    assert canary.state == ROLLED_BACK  # despite identical argmax


def test_constructor_rejections():
    planes = (_Plane(_base_logits), _Plane(_agreeing))
    with pytest.raises(ValueError, match="fraction"):
        ShadowCanary(*planes, "bf16", fraction=0.0)
    with pytest.raises(ValueError, match="fraction"):
        ShadowCanary(*planes, "bf16", fraction=1.5)
    with pytest.raises(ValueError, match="promote_after"):
        ShadowCanary(*planes, "bf16", promote_after=0)
    with pytest.raises(ValueError, match="budget"):
        ShadowCanary(*planes, "bf16", budget=-0.1)


def test_fault_env_name_matches_chaos_cli():
    """``tools/chaos.py`` and the port's ``runtime/chaos.py`` spell the
    variable out; the literals must never drift."""
    import importlib.util

    from pytorch_distributed_mnist_tpu_torch.runtime import chaos as port

    spec = importlib.util.spec_from_file_location(
        "chaos", os.path.join(REPO, "tools", "chaos.py"))
    chaos = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chaos)
    assert chaos.CANARY_FAULT_ENV == port.CANARY_FAULT_ENV \
        == CANARY_FAULT_ENV


def test_serve_canary_events_ride_the_sink(tmp_path):
    """Promote/rollback/reset land as serve_canary JSONL lines in the
    shared metrics stream."""
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        JsonlSink,
        ServeLog,
    )

    path = tmp_path / "metrics.jsonl"
    serve_log = ServeLog()
    serve_log.set_sink(JsonlSink(str(path)), source="serve")
    canary = ShadowCanary(_Plane(_base_logits), _Plane(_agreeing), "bf16",
                          fraction=1.0, promote_after=4, budget=0.1,
                          serve_log=serve_log)
    canary.complete(canary.dispatch(_batch(4)))  # promotes
    canary.swap_params({"w": 1}, epoch=1)  # resets
    lines = [json.loads(line) for line in
             path.read_text().strip().splitlines()]
    kinds = [(r["kind"], r["event"]) for r in lines]
    assert ("serve_canary", "promoted") in kinds
    assert ("serve_canary", "reset") in kinds
    assert all(r["precision"] == "bf16" for r in lines)


# -- loopback server acceptance ----------------------------------------------


def _publish(ckpt_dir, epoch, seed):
    params = init_params("linear", seed)
    save_params_checkpoint(params_to_jax(params), epoch=epoch,
                           directory=str(ckpt_dir))
    return params


def _want(params, images):
    model = get_model("linear", compute_dtype=torch.float32).eval()
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    with torch.no_grad():
        logits = torch.func.functional_call(
            model, tensors, (torch.from_numpy(normalize_images(images)),))
    return [int(v) for v in logits.argmax(-1)]


def _serve_args(ckpt_dir, **overrides):
    argv = ["--checkpoint-dir", str(ckpt_dir), "--model", "linear",
            "--dtype", "f32", "--device", "cpu", "--host", "127.0.0.1",
            "--port", "0", "--buckets", "1,8,32", "--max-wait-ms", "2",
            "--max-queue", "128", "--poll-interval", "0.1", "--no-fuse"]
    for k, v in overrides.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return build_parser().parse_args(argv)


class _Server:
    def __init__(self, args):
        self.httpd = create_server(args)
        host, port = self.httpd.server_address[:2]
        self.url = f"http://{host}:{port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.ctx.close()
        self.httpd.server_close()
        self.thread.join(10.0)

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return json.loads(r.read())

    def post(self, path, payload):
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())


def _loadgen_smoke(url, requests, extra=()):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "loadgen.py"),
         "--smoke", "--url", url, "--requests", str(requests),
         "--concurrency", "8", *extra],
        capture_output=True, text=True, timeout=TIMEOUT)
    return proc.returncode, json.loads(proc.stdout.strip().splitlines()[-1])


def test_canary_promotes_under_live_loadgen(tmp_path):
    ckpt = tmp_path / "ckpt"
    params = _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_precision="bf16",
                              canary_fraction=1.0,
                              canary_promote_after=40,
                              canary_budget=0.1))
    try:
        rc, report = _loadgen_smoke(
            srv.url, 120, extra=("--expect-precision", "bf16"))
        assert rc == 0, report
        assert report["ok"] == 120 and report["transport_errors"] == 0
        assert report["serve_precision"] == "bf16"
        assert report["canary"]["precision"] == "bf16"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            canary = srv.get("/stats")["canary"]
            if canary["state"] == PRIMARY:
                break
            srv.post("/predict",
                     {"images": synthetic_dataset(1, seed=0)[0].tolist()})
        assert canary["state"] == PRIMARY
        assert canary["promotions"] == 1 and canary["rollbacks"] == 0
        assert canary["compared_rows"] >= 40
        # Promoted replies come from the bf16 plane; on this linear model
        # its weight rounding keeps the argmax of these rows.
        images, _ = synthetic_dataset(4, seed=1)
        reply = srv.post("/predict", {"images": images.tolist()})
        assert reply["predictions"] == _want(params, images)
        assert reply["model_epoch"] == 0
    finally:
        srv.close()


def test_canary_rolls_back_under_live_loadgen(tmp_path, monkeypatch):
    monkeypatch.setenv(CANARY_FAULT_ENV, "disagree")
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_precision="int8w",
                              canary_fraction=1.0,
                              canary_promote_after=100000,
                              canary_budget=0.0))
    try:
        rc, report = _loadgen_smoke(
            srv.url, 120, extra=("--expect-precision", "int8w"))
        assert rc == 0, report  # every request answered 200
        assert report["ok"] == 120 and report["transport_errors"] == 0
        canary = srv.get("/stats")["canary"]
        assert canary["state"] == ROLLED_BACK
        assert canary["rollbacks"] == 1 and canary["promotions"] == 0
        assert canary["disagreed_rows"] > 0
        assert srv.get("/stats")["serve_precision"] == "int8w"
        shadow_before = canary["shadow_batches"]
        rc, _ = _loadgen_smoke(srv.url, 40)
        assert rc == 0
        assert srv.get("/stats")["canary"]["shadow_batches"] \
            == shadow_before
        _publish(ckpt, epoch=1, seed=11)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            canary = srv.get("/stats")["canary"]
            if canary["publishes"] == 1:
                break
            time.sleep(0.2)
        assert canary["publishes"] == 1
        assert canary["state"] in (SHADOW, ROLLED_BACK)  # fault still on
        assert srv.get("/healthz")["model_epoch"] == 1
    finally:
        srv.close()


def test_canary_flag_rejections_and_resize_refusal(tmp_path):
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=10)
    with pytest.raises(SystemExit, match="quantized --serve-precision"):
        create_server(_serve_args(ckpt, canary_fraction=0.5))
    with pytest.raises(SystemExit, match="0, 1"):
        create_server(_serve_args(ckpt, serve_precision="bf16",
                                  canary_fraction=1.5))
    with pytest.raises(SystemExit, match="promote-after"):
        create_server(_serve_args(ckpt, serve_precision="bf16",
                                  canary_fraction=0.5,
                                  canary_promote_after=0))
    with pytest.raises(SystemExit, match="canary-budget"):
        create_server(_serve_args(ckpt, serve_precision="bf16",
                                  canary_fraction=0.5, canary_budget=-1))
    srv = _Server(_serve_args(ckpt, serve_precision="bf16",
                              canary_fraction=0.5, serve_devices=2))
    try:
        req = urllib.request.Request(
            srv.url + "/resize",
            data=json.dumps({"serve_devices": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(req, timeout=30)
        assert exc_info.value.code == 400
        assert "canary" in json.loads(exc_info.value.read())["error"]
        # The pooled canary's /stats: the baseline pool's replica rows
        # and topology, both planes warmed.
        stats = srv.get("/stats")
        assert stats["groups"] == 2 and sorted(stats["replicas"]) \
            == ["r0", "r1"]
        assert {"serve_forward_b8@r0", "serve_forward_b8@r0.bf16"} \
            <= set(stats["warmup"]["programs"])
    finally:
        srv.close()


def test_direct_quantized_serving_without_canary(tmp_path):
    ckpt = tmp_path / "ckpt"
    params = _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_precision="bf16"))
    try:
        stats = srv.get("/stats")
        assert stats["serve_precision"] == "bf16"
        assert "canary" not in stats
        images, _ = synthetic_dataset(3, seed=2)
        reply = srv.post("/predict", {"images": images.tolist()})
        assert reply["predictions"] == _want(params, images)
    finally:
        srv.close()


def test_shadowing_canary_bypasses_the_response_cache(tmp_path):
    """While the canary shadows, repeats are computed (and judged), not
    answered from the cache; once it has promoted, the cache answers."""
    ckpt = tmp_path / "ckpt"
    _publish(ckpt, epoch=0, seed=10)
    srv = _Server(_serve_args(ckpt, serve_precision="bf16",
                              canary_fraction=1.0, canary_promote_after=6,
                              canary_budget=1.0))
    try:
        body = {"images": synthetic_dataset(2, seed=3)[0].tolist()}
        for _ in range(3):
            srv.post("/predict", body)
        stats = srv.get("/stats")
        assert stats["canary"]["state"] == PRIMARY
        assert stats["canary"]["compared_rows"] == 6
        assert stats["cache"]["hits"] == 0
        srv.post("/predict", body)
        srv.post("/predict", body)
        assert srv.get("/stats")["cache"]["hits"] == 1
    finally:
        srv.close()


# -- against the JAX canary ---------------------------------------------------

MARGIN = 0.1  # top-2 logit gap: far above the planes' 2e-2 int8 bound


def _margins(logits):
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.fixture(scope="module")
def judged(tmp_path_factory):
    """One JAX checkpoint per plane (the baseline's and a candidate's
    drawn from another seed, at the same epoch, so the planes disagree on
    many rows), JAX and port engines on each, and batches of images
    whose logits are no near-tie on any plane of either package."""
    directory = tmp_path_factory.mktemp("canary_ckpt")
    out = {}
    for plane, seed, precision in (("base", 0, "f32"), ("cand", 1, "int8")):
        kwargs = {"dot_general": int8_dot_general} \
            if precision == "int8" else {}
        jmodel = jax_get_model("linear", compute_dtype=jnp.float32,
                               **kwargs)
        state = create_train_state(jmodel, jax.random.key(seed))
        path = jax_ckpt.save_checkpoint(
            state, epoch=0, best_acc=0.0, is_best=False,
            directory=str(directory / plane))
        jparams, _ = jax_load_params(path, state)
        params, _ = load_params_for_serving(path, "linear")
        matmul = {"matmul": int8_linear} if precision == "int8" else {}
        out[plane] = (
            JaxEngine(jmodel.apply, jparams, buckets=(8,),
                      precision=precision, fuse=True, params_epoch=0),
            InferenceEngine(get_model("linear", compute_dtype=torch.float32,
                                      **matmul), params, buckets=(8,),
                            precision=precision, fuse=True, params_epoch=0,
                            device="cpu"))
    images, _ = synthetic_dataset(256, seed=12)
    keep = np.ones(len(images), bool)
    for jax_engine, _ in out.values():
        logits = np.concatenate([np.asarray(jax_engine.logits(images[i:i + 8]))
                                 for i in range(0, len(images), 8)])
        keep &= _margins(logits) > MARGIN
    clear = images[keep]
    batches = [clear[i:i + 8] for i in range(0, len(clear) - 7, 8)]
    assert len(batches) >= 6, len(clear)
    return out, batches


def test_shadow_judgments_match_the_jax_canary(judged):
    """The same batches through a JAX canary and a port canary (f32
    baseline, int8 candidate): equal disagreement counts, equal replies'
    argmax, and logit-delta quantiles within the planes' int8 bound."""
    planes, batches = judged
    canaries = [
        JaxCanary(planes["base"][0], planes["cand"][0], "int8",
                  fraction=1.0, promote_after=10_000, budget=1.0),
        ShadowCanary(planes["base"][1], planes["cand"][1], "int8",
                     fraction=1.0, promote_after=10_000, budget=1.0)]
    replies = [[], []]
    for raw in batches:
        for canary, out in zip(canaries, replies):
            logits, epoch = canary.complete(canary.dispatch(raw))
            assert epoch == 0
            out.append(np.asarray(logits))
    snaps = [c.snapshot() for c in canaries]
    for key in ("compared_rows", "disagreed_rows", "shadow_batches",
                "shadow_errors", "skewed_comparisons", "state"):
        assert snaps[0][key] == snaps[1][key], key
    assert snaps[1]["compared_rows"] == 8 * len(batches)
    assert snaps[1]["disagreed_rows"] > 0  # the planes do disagree
    np.testing.assert_allclose(np.concatenate(replies[1]),
                               np.concatenate(replies[0]), atol=5e-6,
                               rtol=0)
    for q in ("p50", "p95", "max"):
        assert abs(snaps[0]["logit_delta"][q]
                   - snaps[1]["logit_delta"][q]) <= 2e-2, q


def test_rollback_and_promotion_match_the_jax_canary(judged):
    """Small windows walk both state machines to the same verdict on the
    same batches: a budget below the disagreement rate rolls both back
    on the same batch; a budget above it promotes both."""
    planes, batches = judged
    for budget, verdict in ((0.0, ROLLED_BACK), (1.0, PRIMARY)):
        canaries = [
            JaxCanary(planes["base"][0], planes["cand"][0], "int8",
                      fraction=1.0, promote_after=16, budget=budget),
            ShadowCanary(planes["base"][1], planes["cand"][1], "int8",
                         fraction=1.0, promote_after=16, budget=budget)]
        walks = [[], []]
        for raw in batches[:3]:
            for canary, walk in zip(canaries, walks):
                canary.complete(canary.dispatch(raw))
                walk.append(canary.state)
        assert walks[0] == walks[1]
        assert walks[1][-1] == verdict
