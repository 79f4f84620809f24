"""The port's serving side of delta distribution (``distrib/fetch.py``)
against the JAX package's ``DeltaFetcher``, on the CPU, after
``tests/test_distrib_delta.py``: params only, the same dirty and clean
counts on the same publishes, clean ``QuantLeaf`` objects kept under
``int8w``, peers before the source over a loopback ``http.server``, the
``missing chunk`` error, a torn body resumed with ``Range`` (and a peer
that ignores it), and the reload watcher's two delta failures
(``test_watcher_skips_torn_manifest_until_clean_publish``,
``test_watcher_skips_missing_chunk_publish_then_recovers``)."""

import http.server
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.distrib.fetch import (
    DeltaFetcher as JaxDeltaFetcher,
)
from pytorch_distributed_mnist_tpu.models import get_model as jax_get_model
from pytorch_distributed_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_mnist_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.distrib.cas import (
    ChunkStore,
    read_manifest,
)
from pytorch_distributed_mnist_tpu_torch.distrib.fetch import (
    DeltaFetcher,
    fetch_chunk_http,
)
from pytorch_distributed_mnist_tpu_torch.distrib.publish import publish_arrays
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.models.convert import (
    params_from_jax,
    state_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.serve.programs import (
    QuantLeaf,
    get_precision,
)
from pytorch_distributed_mnist_tpu_torch.serve.reload import CheckpointWatcher
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)

pytestmark = pytest.mark.distrib
torch.set_num_threads(2)


def _named(model: str = "linear", seed: int = 3):
    state = create_train_state(get_model(model, compute_dtype=torch.float32),
                               seed=seed, device=torch.device("cpu"))
    return state_to_jax(state)


def _perturbed(named, delta: float, which: str = "bias"):
    """``named`` with its ``which`` params leaf (of the last layer) moved
    by ``delta``."""
    out = list(named)
    i = max(i for i, (n, _) in enumerate(named)
            if n.startswith("['params']") and n.endswith(f"['{which}']"))
    out[i] = (out[i][0], (out[i][1] + np.float32(delta)).astype(np.float32))
    return out


def _publish(named, epoch, directory, **kw):
    return publish_arrays(named, epoch=epoch, best_acc=0.5,
                          directory=str(directory), chunk_mb=0.001, **kw)


def _params_bytes(named) -> int:
    return sum(a.nbytes for n, a in named if n.startswith("['params']"))


def test_a_fetch_pulls_params_only(tmp_path):
    named = _named()
    path = _publish(named, 1, tmp_path)
    fetcher = DeltaFetcher(str(tmp_path / "backend"),
                           source_dir=str(tmp_path))
    params, epoch = fetcher.load(path, "linear")
    assert epoch == 1
    state_bytes = sum(a.nbytes for _, a in named)
    assert fetcher.last["bytes_fetched"] == _params_bytes(named) < \
        state_bytes
    want = params_from_jax("linear", dict(named))
    assert sorted(params) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(params[k], want[k])


def test_dirty_and_clean_counts_equal_jax_s_fetcher(tmp_path):
    named = _named()
    jstate = jax_create_train_state(
        jax_get_model("linear", compute_dtype=jnp.float32),
        jax.random.key(0))
    paths = [_publish(named, 1, tmp_path),
             _publish(_perturbed(named, 1e-3), 2, tmp_path),
             _publish(_perturbed(named, 1e-3), 3, tmp_path),  # unchanged
             _publish(_perturbed(_perturbed(named, 1e-3), 1e-3, "kernel"),
                      4, tmp_path)]
    # A whole-file publish between two manifests resets both caches.
    npz = port_ckpt._write_npz(named, epoch=5, best_acc=0.5,
                               directory=str(tmp_path))
    paths += [npz, _publish(named, 6, tmp_path)]
    port = DeltaFetcher(str(tmp_path))
    jaxf = JaxDeltaFetcher(str(tmp_path))
    seen = []
    for path in paths:
        _, pe = port.load(path, "linear")
        _, je = jaxf.load(path, jstate)
        assert pe == je
        seen.append((port.last["dirty_leaves"], port.last["clean_leaves"]))
        assert (port.last["dirty_leaves"], port.last["clean_leaves"]) == \
            (jaxf.last["dirty_leaves"], jaxf.last["clean_leaves"])
        assert port.total["full_loads"] == jaxf.total["full_loads"]
    assert seen[:4] == [(2, 0), (1, 1), (0, 2), (1, 1)]
    assert seen[5] == (2, 0)


def test_only_dirty_leaves_are_quantized_again(tmp_path):
    named = _named("cnn")
    p1 = _publish(named, 1, tmp_path)
    p2 = _publish(_perturbed(named, 1e-3), 2, tmp_path)
    fetcher = DeltaFetcher(str(tmp_path), precision=get_precision("int8w"),
                           workers=2)
    params1, _ = fetcher.load(p1, "cnn")
    assert fetcher.last["dirty_leaves"] == 8
    assert all(isinstance(v, QuantLeaf) for v in params1.values())
    params2, _ = fetcher.load(p2, "cnn")
    assert (fetcher.last["dirty_leaves"], fetcher.last["clean_leaves"]) == \
        (1, 7)
    same = sorted(n for n in params1 if params1[n] is params2[n])
    assert len(same) == 7 and "fc2.bias" not in same
    # The engine's own quantize passes them through.
    again = get_precision("int8w").quantize(params2)
    assert all(again[n] is params2[n] for n in params2)


class _StoreHandler(http.server.BaseHTTPRequestHandler):
    """A peer that serves ``GET /chunks/<digest>`` from ``store``."""

    store = None
    hits = []

    def log_message(self, *args):
        pass

    def do_GET(self):
        digest = self.path.rsplit("/", 1)[-1]
        type(self).hits.append(digest)
        if not self.store.has(digest):
            self.send_response(404)
            self.end_headers()
            return
        data = self.store.get(digest)
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def _serve(handler):
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_peers_come_before_the_source(tmp_path):
    named = _named()
    path = _publish(named, 1, tmp_path / "src")
    _StoreHandler.store = ChunkStore(str(tmp_path / "src"))
    _StoreHandler.hits = []
    live, live_url = _serve(_StoreHandler)
    dead, dead_url = _serve(_StoreHandler)
    dead.shutdown()
    dead.server_close()
    try:
        local = tmp_path / "b1"
        os.makedirs(local)
        os.replace(path, local / os.path.basename(path))
        fetcher = DeltaFetcher(str(local), peers=(dead_url, live_url),
                               source_dir=str(tmp_path / "src"))
        fetcher.load(str(local / os.path.basename(path)), "linear")
        assert fetcher.last["bytes_peer"] == _params_bytes(named)
        assert fetcher.last["bytes_source"] == 0
        assert _StoreHandler.hits
        # With no live peer every chunk falls back to the source.
        other = DeltaFetcher(str(tmp_path / "b2"), peers=(dead_url,),
                             source_dir=str(tmp_path / "src"))
        other.load(str(local / os.path.basename(path)), "linear")
        assert other.last["bytes_source"] == _params_bytes(named)
        assert other.last["bytes_peer"] == 0
    finally:
        live.shutdown()
        live.server_close()


def test_a_chunk_found_nowhere_is_a_missing_chunk(tmp_path):
    named = _named()
    path = _publish(named, 1, tmp_path)
    manifest = read_manifest(path)
    rec = next(r for r in manifest["leaves"]
               if r["name"] == "['params']['params']['fc']['kernel']")
    os.remove(ChunkStore(str(tmp_path)).path(rec["chunks"][0]))
    with pytest.raises(ValueError, match="missing chunk") as info:
        DeltaFetcher(str(tmp_path)).load(path, "linear")
    assert "missing shards" not in str(info.value)
    assert not port_ckpt.is_corrupt_checkpoint_error(info.value)


def _tearing_peer(data, plan):
    """A scripted ``GET /chunks/<digest>`` peer (the JAX test's): each
    request pops ``(mode, arg)`` from ``plan``: ``("tear", k)`` sends the
    full length but closes after ``k`` body bytes, ``("ignore-range",
    None)`` answers a range with a plain 200 and the whole body,
    ``("full", None)`` serves honestly. Returns ``(httpd, url,
    requests)``."""
    requests = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            rng = self.headers.get("Range")
            requests.append((self.path, rng))
            mode, arg = plan.pop(0) if plan else ("full", None)
            start = 0
            if rng and mode != "ignore-range":
                start = int(rng.split("=", 1)[1].rstrip("-"))
            body = data[start:]
            self.send_response(206 if start else 200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if mode == "tear":
                self.wfile.write(body[:arg])
                self.wfile.flush()
                self.connection.close()
            else:
                self.wfile.write(body)

    httpd, url = _serve(Handler)
    httpd.handle_error = lambda *args: None  # torn sockets are the point
    return httpd, url, requests


@pytest.mark.parametrize("plan, ranges", [
    ([("tear", 100_000)], [None, "bytes=100000-"]),
    ([("tear", 100_000), ("ignore-range", None)], [None, "bytes=100000-"]),
])
def test_a_torn_body_resumes_with_range(plan, ranges):
    data = bytes(range(256)) * 650  # more than two 64 KiB pieces
    httpd, url, requests = _tearing_peer(data, list(plan))
    try:
        assert fetch_chunk_http(url, "deadbeef") == data
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert [r[1] for r in requests] == ranges
    assert [r[0] for r in requests] == ["/chunks/deadbeef"] * 2


class _Installs:
    def __init__(self):
        self.epochs = []

    def __call__(self, params, epoch, path):
        self.epochs.append(epoch)
        return True


def test_the_watcher_skips_a_torn_manifest_until_a_clean_publish(tmp_path):
    named = _named()
    installs = _Installs()
    fetcher = DeltaFetcher(str(tmp_path))
    watcher = CheckpointWatcher(str(tmp_path), "linear", installs,
                                loader=fetcher.load)
    _publish(named, 1, tmp_path)
    assert watcher.poll_once() and installs.epochs == [1]
    whole = (tmp_path / "checkpoint_1.manifest").read_bytes()
    (tmp_path / "checkpoint_2.manifest").write_bytes(whole[:len(whole) // 2])
    assert not watcher.poll_once()
    assert not watcher.poll_once()  # permanent for the file
    assert installs.epochs == [1]
    _publish(_perturbed(named, 1e-3), 3, tmp_path)
    assert watcher.poll_once() and installs.epochs == [1, 3]


def test_the_watcher_skips_a_missing_chunk_publish_then_recovers(tmp_path):
    named = _named()
    installs = _Installs()
    fetcher = DeltaFetcher(str(tmp_path))
    watcher = CheckpointWatcher(str(tmp_path), "linear", installs,
                                loader=fetcher.load)
    store = ChunkStore(str(tmp_path))
    _publish(named, 1, tmp_path)
    assert watcher.poll_once() and installs.epochs == [1]
    before = store.digests()
    _publish(_perturbed(named, 1e-3), 2, tmp_path)
    for digest in store.digests() - before:
        os.remove(store.path(digest))
    assert not watcher.poll_once()
    assert not watcher.poll_once()  # permanent for this publish
    assert installs.epochs == [1]
    _publish(_perturbed(named, 2e-3), 3, tmp_path)
    assert watcher.poll_once() and installs.epochs == [1, 3]
    assert fetcher.last["dirty_leaves"] == 1


def test_a_jax_publish_is_fetched_as_the_jax_fetcher_fetches_it(tmp_path):
    from pytorch_distributed_mnist_tpu.distrib.publish import publish_state

    jstate = jax_create_train_state(jax_get_model("cnn"),
                                    jax.random.key(1))
    path = publish_state(jstate, epoch=0, best_acc=0.1,
                         directory=str(tmp_path / "src"), process_index=0)
    fetcher = DeltaFetcher(str(tmp_path / "b"),
                           source_dir=str(tmp_path / "src"))
    params, epoch = fetcher.load(path, "cnn")
    jaxf = JaxDeltaFetcher(str(tmp_path / "j"),
                           source_dir=str(tmp_path / "src"))
    jaxf.load(path, jstate)
    assert epoch == 0
    assert fetcher.last["bytes_fetched"] == jaxf.last["bytes_fetched"]
    flat = dict(jax_ckpt._leaves_with_names(
        {"params": jstate.params}))
    want = params_from_jax("cnn", {k: np.asarray(v) for k, v in flat.items()})
    for k in want:
        np.testing.assert_array_equal(params[k], want[k])
    # A template of another model is refused by name.
    with pytest.raises(ValueError, match="mismatch"):
        DeltaFetcher(str(tmp_path / "src")).load(path, "linear")
