"""The server's side of delta distribution: the reload watcher's manifest
loader.

Counterpart of ``pytorch_distributed_mnist_tpu/distrib/fetch.py``.
:meth:`DeltaFetcher.load` has the signature of
``serve/engine.py::load_params_for_serving`` (``(path, model_name) ->
(params, epoch)``) and plugs into ``serve/reload.py::CheckpointWatcher``'s
``loader=``, so discovery, the epoch order, the layout gate and the one
atomic ``swap_params`` stay as they are; only the way the bytes arrive
differs:

- the manifest's chunk lists are diffed against the local store and the
  previous install's per-leaf chunk lists;
- only missing chunks are fetched: from peer servers first (``GET
  /chunks/<sha256>``, so a fleet's publish costs the source O(chunks),
  not O(replicas)), then from the source directory, each checked against
  its digest before it enters the local store;
- only the dirty leaves of the cached host tree are rebuilt, and only
  they are quantized again: on a quantized plane a clean leaf rides
  through as the previous install's ``QuantLeaf`` object
  (``ServePrecision.quantize`` passes it through);
- only ``['params']`` leaves are fetched: the optimizer's moments never
  ship to a server.

Failures: a torn manifest raises ``json.JSONDecodeError``; a chunk that
no peer and no source holds raises a ``ValueError`` saying ``missing
chunk``. Both skip that publish for good at the watcher, and the server
keeps answering on the params it has.
"""

from __future__ import annotations

import http.client
import time
import urllib.request
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pytorch_distributed_mnist_tpu_torch.distrib.cas import (
    ChunkStore,
    assemble_leaf,
    digest_of,
    is_manifest,
    read_manifest,
)

# Streaming read size of a chunk fetch: a torn connection loses at most
# one piece.
_FETCH_PIECE_BYTES = 1 << 16
# Seconds a peer may keep a chunk request waiting before the next peer.
_PEER_TIMEOUT_S = 5.0


def fetch_chunk_http(base_url: str, digest: str,
                     timeout_s: float = _PEER_TIMEOUT_S,
                     max_resumes: int = 3) -> bytes:
    """One chunk from a peer's ``GET /chunks/<digest>``. A body torn
    mid-way is resumed with ``Range: bytes=N-`` from the bytes already
    read (the bytes behind a digest never change, so splicing attempts is
    safe; the caller checks the digest anyway); a peer that ignores the
    range (a plain 200) restarts the buffer. Raises on a failure before
    the first byte, on a resume that brings nothing, or past
    ``max_resumes``: the caller moves on to the next peer or the
    source."""
    url = f"{base_url.rstrip('/')}/chunks/{digest}"
    buf = bytearray()
    resumes = 0
    while True:
        req = urllib.request.Request(url)
        if buf:
            req.add_header("Range", f"bytes={len(buf)}-")
        got = 0
        expected = None
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                if buf and getattr(resp, "status", 200) != 206:
                    del buf[:]  # the peer ignored the range: from byte 0
                length = resp.headers.get("Content-Length")
                if length is not None:
                    expected = len(buf) + int(length)
                while True:
                    piece = resp.read(_FETCH_PIECE_BYTES)
                    if not piece:
                        break
                    buf += piece
                    got += len(piece)
            if expected is None or len(buf) == expected:
                return bytes(buf)
            # A body shorter than its Content-Length: http.client reports
            # a tear on a sized read as a plain end of stream. Resume.
        except http.client.IncompleteRead as exc:
            buf += exc.partial
            got += len(exc.partial)
        except (OSError, http.client.HTTPException):
            if not buf:
                raise  # failed before any byte: the peer failed
        resumes += 1
        if got == 0 or resumes > max_resumes:
            raise OSError(f"torn chunk fetch {digest} from {base_url}: "
                          f"{len(buf)} byte(s) after {resumes} attempt(s)")


def _zeroed() -> Dict[str, float]:
    return {"dirty_leaves": 0, "clean_leaves": 0, "chunks_fetched": 0,
            "bytes_fetched": 0, "bytes_peer": 0, "bytes_source": 0,
            "bytes_local": 0, "full_loads": 0, "delta_loads": 0,
            "fetch_ms": 0.0, "install_ms": 0.0}


class DeltaFetcher:
    """The manifest loader of one watch directory.

    Manifests arrive in ``directory`` (a trainer's publish on a shared
    filesystem, or a copied manifest); fetched chunks go into
    ``<directory>/chunks/``, which is what this server's own ``GET
    /chunks/<sha256>`` serves: every fetcher seeds its peers as soon as
    its fetch is done.

    ``precision`` (a ``serve/programs.py::ServePrecision``) quantizes in
    the fetcher, with ``workers`` threads, so that clean leaves keep the
    previous install's quantized objects and only dirty ones are
    quantized again; the engine's own quantize then passes them through.
    ``source_dir`` is the chunk store of last resort (the trainer's
    checkpoint directory). ``last`` holds the last load's counters and
    ``total`` their sums: leaves dirty and clean, chunks and bytes
    fetched from peers and from the source, and the fetch's and the
    leaves' install wall ms."""

    def __init__(self, directory: str, *, precision=None,
                 peers: Sequence[str] = (), source_dir: Optional[str] = None,
                 workers: int = 4) -> None:
        self.store = ChunkStore(directory)
        self.peers = [p for p in peers if p]
        self.source = ChunkStore(source_dir) if source_dir else None
        self._precision = precision
        self._workers = workers
        # Per leaf (JAX name), from the previous manifest load: its chunk
        # list (the diff key) and the value installed (QuantLeaf, cast or
        # float32 array: whatever the precision made of it).
        self._hashes: Dict[str, tuple] = {}
        self._values: Dict[str, object] = {}
        self.total = _zeroed()
        self.last = _zeroed()

    def _obtain(self, digest: str, stats: Dict[str, float]) -> None:
        """Put ``digest`` into the local store: a local hit, else a peer
        (the rotation, keyed by the digest, spreads a fleet's pulls over
        its seeders), else the source. Checked on put, so a peer's
        corrupt bytes count as a miss."""
        if self.store.has(digest):
            return
        n = len(self.peers)
        start = int(digest[:8], 16) % n if n else 0
        for k in range(n):
            peer = self.peers[(start + k) % n]
            try:
                data = fetch_chunk_http(peer, digest)
                if digest_of(data) != digest:
                    raise ValueError("digest mismatch")
                self.store.put(digest, data)
            except Exception:  # noqa: BLE001 - any peer failure: the next
                continue
            stats["chunks_fetched"] += 1
            stats["bytes_fetched"] += len(data)
            stats["bytes_peer"] += len(data)
            return
        if self.source is not None and self.source.has(digest):
            data = self.source.get(digest)
            self.store.put(digest, data)
            stats["chunks_fetched"] += 1
            stats["bytes_fetched"] += len(data)
            stats["bytes_source"] += len(data)
            return
        raise ValueError(
            f"missing chunk {digest}: not in the local store, "
            f"{len(self.peers)} peer(s), or the source dir; skipping this "
            f"publish until a newer manifest appears")

    def load(self, path: str, template) -> Tuple[dict, int]:
        """The watcher's loader: the delta path for a manifest; for an npz
        file or a ``.ckpt`` directory the whole-file load, which also
        drops the cached leaves (the next manifest rebuilds every
        leaf). ``template`` is a model name or a ``serve/programs.py::
        ServeTemplate`` (the pipeline plane's split tree)."""
        from pytorch_distributed_mnist_tpu_torch.models.convert import (
            _to_port_layout,
            jax_leaf_name,
        )
        from pytorch_distributed_mnist_tpu_torch.serve.engine import (
            load_params_for_serving,
        )
        from pytorch_distributed_mnist_tpu_torch.serve.programs import (
            template_of,
        )

        if not is_manifest(path):
            self._hashes, self._values = {}, {}
            self.total["full_loads"] += 1
            return load_params_for_serving(path, template)
        tpl = template_of(template)
        t0 = time.perf_counter()
        manifest = read_manifest(path)  # torn: JSONDecodeError
        stats = _zeroed()
        records = {rec["name"]: rec for rec in manifest["leaves"]}
        params, hashes = {}, {}
        for name, shape in tpl.shapes.items():
            key = jax_leaf_name(name, tpl.root)
            rec = records.get(key)
            if rec is None:
                raise ValueError(f"{path}: no leaf {key!r} in the manifest: "
                                 f"model/checkpoint mismatch")
            hashes[key] = tuple(rec["chunks"])
            if self._hashes.get(key) == hashes[key] and key in self._values:
                params[name] = self._values[key]
                stats["clean_leaves"] += 1
                continue
            for dg in rec["chunks"]:
                self._obtain(dg, stats)
            arr = _to_port_layout(np.asarray(assemble_leaf(rec, self.store),
                                             dtype=np.float32))
            if arr.shape != tuple(shape):
                raise ValueError(f"{path}: leaf {key} has shape {arr.shape} "
                                 f"in the port's layout, expected {shape}")
            stats["bytes_local"] += arr.nbytes
            params[name] = arr
            stats["dirty_leaves"] += 1
        t1 = time.perf_counter()
        if self._precision is not None and not self._precision.identity:
            # Quantized here, so that clean leaves keep their objects and
            # only dirty ones pay.
            params = self._precision.quantize(params, workers=self._workers)
        self._hashes = hashes
        self._values = {jax_leaf_name(n, tpl.root): v
                        for n, v in params.items()}
        stats["fetch_ms"] = (t1 - t0) * 1e3
        stats["install_ms"] = (time.perf_counter() - t0) * 1e3
        stats["delta_loads"] = 1
        self.last = stats
        for k, v in stats.items():
            self.total[k] += v
        print(f"delta fetch: {path!r} {stats['dirty_leaves']} dirty / "
              f"{stats['clean_leaves']} clean leaves, "
              f"{stats['chunks_fetched']} chunks fetched "
              f"({stats['bytes_peer']}B peer, {stats['bytes_source']}B "
              f"source)", flush=True)
        return params, int(manifest["epoch"]) - 1
