"""The port's server on delta-published checkpoints (``serve/server.py``
with ``distrib/fetch.py``), on the CPU: it boots from a manifest the JAX
package published and answers as the JAX engine does on the same
params, serves ``GET /chunks/<sha256>`` (200, 206 and 416 for ``Range``,
404 otherwise), and two in-process servers gossip: one with an empty
watch directory and ``--chunk-peers`` on the other fetches a copied
manifest's chunks from its peer, and only the changed leaf of the next
publish. Mirrors ``tests/test_serve_delta_fleet.py``'s chunk route and
gossip tests."""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import synthetic_dataset
from pytorch_distributed_mnist_tpu.distrib.publish import (
    publish_arrays as jax_publish_arrays,
)
from pytorch_distributed_mnist_tpu.distrib.publish import publish_state
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.ops.pallas import int8_dot_general
from pytorch_distributed_mnist_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from pytorch_distributed_mnist_tpu.serve.engine import (
    load_params_for_serving as jax_load_params,
)
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import create_train_state
from pytorch_distributed_mnist_tpu_torch.distrib.cas import (
    ChunkStore,
    read_manifest,
)
from pytorch_distributed_mnist_tpu_torch.serve.server import (
    build_parser,
    create_server,
)

pytestmark = pytest.mark.serve
torch.set_num_threads(2)

BUCKETS = (1, 8)
SIZES = (1, 3, 8, 5, 13, 8, 2, 7)


class _Server:
    def __init__(self, directory, *extra) -> None:
        self.httpd = create_server(build_parser().parse_args([
            "--model", "cnn", "--serve-precision", "int8", "--port", "0",
            "--device", "cpu", "--checkpoint-dir", str(directory),
            "--buckets", ",".join(map(str, BUCKETS)), "--poll-interval",
            "0.05", "--dtype", "f32", *extra]))
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def get(self, path, headers=None):
        req = urllib.request.Request(self.base + path, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as err:
            return err.code, dict(err.headers), err.read()

    def predict(self, images):
        """``(predictions, model_epoch)`` of one ``/predict``."""
        req = urllib.request.Request(
            self.base + "/predict",
            data=json.dumps({"images": images.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
        return reply["predictions"], reply["model_epoch"]

    def wait_epoch(self, epoch):
        deadline = time.monotonic() + 30
        while self.httpd.ctx.engine.params_epoch != epoch:
            assert time.monotonic() < deadline, f"no epoch {epoch}"
            time.sleep(0.02)

    def close(self):
        self.httpd.shutdown()
        self.httpd.ctx.close()
        self.httpd.server_close()
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A JAX-published manifest of a JAX cnn state, and server A booted on
    its directory."""
    src = tmp_path_factory.mktemp("src")
    jmodel = jax_get_model("cnn", dot_general=int8_dot_general,
                           compute_dtype=jnp.float32)
    state = create_train_state(jmodel, jax.random.key(0))
    path = publish_state(state, epoch=0, best_acc=0.0, directory=str(src),
                         chunk_mb=1.0, process_index=0)
    a = _Server(src, "--require-checkpoint")
    yield {"src": src, "path": path, "state": state, "jmodel": jmodel,
           "a": a}
    a.close()


def test_the_server_boots_from_a_jax_manifest_and_answers_as_jax(fleet):
    a = fleet["a"]
    health = json.loads(a.get("/healthz")[2])
    assert health["model_epoch"] == 0
    assert health["checkpoint"] == fleet["path"]
    assert a.httpd.ctx.fetcher.last["dirty_leaves"] == 8
    jparams, jepoch = jax_load_params(fleet["path"], fleet["state"])
    jax_engine = JaxEngine(fleet["jmodel"].apply, jparams, buckets=BUCKETS,
                           precision="int8", fuse=True, params_epoch=jepoch)
    images, _ = synthetic_dataset(sum(SIZES), seed=3)
    batches = np.split(images, np.cumsum(SIZES)[:-1])
    got = np.concatenate([a.httpd.ctx.engine.logits(b) for b in batches])
    want = np.concatenate([np.asarray(jax_engine.logits(b))
                           for b in batches])
    # test_torch_serve_engine.py's tolerance for the int8 fused plane:
    # the convolutions sum in another order, so an fc1 input at a
    # rounding boundary may round the other way (one step of the int8
    # product's scale).
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert float(np.mean(got.argmax(-1) == want.argmax(-1))) >= 0.99
    for b in batches:
        assert a.predict(b) == \
            (a.httpd.ctx.engine.logits(b).argmax(-1).tolist(), 0)


def test_the_chunk_route_serves_ranges(fleet):
    a = fleet["a"]
    digest = next(r["chunks"][0]
                  for r in read_manifest(fleet["path"])["leaves"]
                  if r["name"] == "['params']['params']['fc2']['kernel']")
    data = ChunkStore(str(fleet["src"])).get(digest)
    code, headers, body = a.get(f"/chunks/{digest}")
    assert code == 200 and body == data
    assert headers["Content-Type"] == "application/octet-stream"
    code, headers, body = a.get(f"/chunks/{digest}",
                                {"Range": "bytes=5-"})
    assert code == 206 and body == data[5:]
    assert headers["Content-Range"] == \
        f"bytes 5-{len(data) - 1}/{len(data)}"
    code, headers, _ = a.get(f"/chunks/{digest}",
                             {"Range": f"bytes={len(data)}-"})
    assert code == 416 and headers["Content-Range"] == f"bytes */{len(data)}"
    code, _, body = a.get(f"/chunks/{digest}", {"Range": "bytes=0-3"})
    assert code == 200 and body == data  # not a suffix range: whole
    assert a.get("/chunks/not-a-digest")[0] == 404
    assert a.get("/chunks/" + "0" * 64)[0] == 404
    # Draining closes /predict, not the chunk route.
    a.httpd.ctx.set_draining(True)
    try:
        assert a.get(f"/chunks/{digest}")[0] == 200
    finally:
        a.httpd.ctx.set_draining(False)


def _copy(path, directory):
    dest = os.path.join(directory, os.path.basename(path))
    shutil.copyfile(path, dest + ".tmp")
    os.replace(dest + ".tmp", dest)


def test_two_servers_gossip_the_chunks_of_a_publish(fleet, tmp_path):
    a = fleet["a"]
    b = _Server(tmp_path, "--chunk-peers", a.base, "-j", "2")
    try:
        assert b.httpd.ctx.engine.params_epoch is None  # fresh params
        _copy(fleet["path"], tmp_path)
        b.wait_epoch(0)
        got = b.httpd.ctx.fetcher.last
        params_bytes = sum(
            int(np.prod(r["shape"])) * 4
            for r in read_manifest(fleet["path"])["leaves"]
            if r["name"].startswith("['params']"))
        assert got["bytes_peer"] == params_bytes and got["bytes_source"] == 0
        images, _ = synthetic_dataset(16, seed=5)
        assert b.predict(images) == a.predict(images)
        # The next publish moves one leaf: both reload it alone, B from A.
        meta, leaves = jax_ckpt.read_checkpoint_arrays(fleet["path"])
        named = list(zip(meta["leaf_names"], leaves))
        i = meta["leaf_names"].index("['params']['params']['fc2']['bias']")
        named[i] = (named[i][0], named[i][1] + np.float32(0.5))
        path = jax_publish_arrays(named, epoch=1, best_acc=0.0,
                                  directory=str(fleet["src"]), chunk_mb=1.0)
        a.wait_epoch(1)
        _copy(path, tmp_path)
        b.wait_epoch(1)
        for server in (a, b):
            last = server.httpd.ctx.fetcher.last
            assert (last["dirty_leaves"], last["clean_leaves"]) == (1, 7)
        assert b.httpd.ctx.fetcher.last["bytes_peer"] == 40
        stats = json.loads(b.get("/stats")[2])
        assert stats["delta_fetch"]["total"]["bytes_source"] == 0
        assert b.predict(images) == a.predict(images)
    finally:
        b.close()
