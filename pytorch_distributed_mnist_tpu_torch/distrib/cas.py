"""Content-addressed chunk store and the manifest format.

Counterpart of ``pytorch_distributed_mnist_tpu/distrib/cas.py``; the two
read and write the same files. A checkpoint leaf's canonical bytes (the
C-order ``tobytes()`` of the host array in the JAX layout that
``models/convert.py::state_to_jax`` gives: HWIO convolution kernels, fc1
rows in the reference's NHWC flatten order) are cut at fixed offsets of a
``--chunk-mb`` budget. Each chunk is named by its sha256 and written once
into ``<dir>/chunks/``. Leaves are walked in :func:`bucket_plan`'s order
(largest first, ties by flat index), so for a model of fixed shapes the
chunk boundaries and every unchanged leaf's chunk list repeat from epoch
to epoch: a publish writes only the chunks the store lacks, and a
fetcher's diff of a manifest against its inventory is exact.

The manifest (``checkpoint_{e}.manifest``, JSON) is the atomic publish
unit: the meta the npz layout stamps (``epoch`` as ``e + 1``,
``best_acc``, ``leaf_names``, ``world``, ``parallel_layout``) plus, per
leaf, ``{name, shape, dtype, chunks, lengths}``. It is renamed into place
after every chunk it names is on disk. A torn manifest reads as a
``json.JSONDecodeError`` (damage: resume quarantines it, the serving
watcher skips it for good); a missing chunk is a ``ValueError`` saying
``missing chunk`` (absence: permanent for that publish at the watcher, a
loud abort at resume).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST_SUFFIX = ".manifest"
CHUNK_DIR = "chunks"
MANIFEST_VERSION = 1

_DIGEST_RE = re.compile(r"[0-9a-f]{64}")


def is_manifest(path: str) -> bool:
    return path.endswith(MANIFEST_SUFFIX)


def digest_of(data) -> str:
    """The sha256 hex digest that names a chunk."""
    return hashlib.sha256(data).hexdigest()


def is_digest(name: str) -> bool:
    """True for a well-formed chunk name (64 lowercase hex digits)."""
    return _DIGEST_RE.fullmatch(name) is not None


class ChunkStore:
    """Write-once, sha256-named chunk files under ``<directory>/chunks/``.

    ``directory`` is the checkpoint directory: chunks live beside the
    manifests that name them, so the prune window and the chunk GC see
    one namespace. :meth:`put` checks the bytes against the digest (a
    fetcher installs a peer's bytes through it, so a corrupt peer cannot
    poison the store) and publishes with tmp + rename; a digest already
    present is never rewritten."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self.root = os.path.join(directory, CHUNK_DIR)

    def path(self, digest: str) -> str:
        return os.path.join(self.root, digest)

    def has(self, digest: str) -> bool:
        return os.path.isfile(self.path(digest))

    def put(self, digest: str, data: bytes) -> bool:
        """Store ``data`` under ``digest``; True when bytes were written,
        False when the chunk was already there."""
        if self.has(digest):
            return False
        if digest_of(data) != digest:
            raise ValueError(f"chunk content does not match its digest "
                             f"{digest}: refusing to store corrupt bytes")
        os.makedirs(self.root, exist_ok=True)
        path = self.path(digest)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return True

    def get(self, digest: str) -> bytes:
        try:
            with open(self.path(digest), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ValueError(
                f"missing chunk {digest} in {self.root}: the manifest "
                f"names a chunk this store does not hold") from None

    def digests(self) -> set:
        if not os.path.isdir(self.root):
            return set()
        return {name for name in os.listdir(self.root) if is_digest(name)}

    def gc(self, referenced: set) -> int:
        """Delete the chunk files not in ``referenced``; returns the bytes
        freed."""
        freed = 0
        for digest in self.digests() - set(referenced):
            path = self.path(digest)
            try:
                freed += os.path.getsize(path)
                os.remove(path)
            except OSError:
                pass  # raced by a concurrent publish's put: keep it
        return freed


def _leaf_bytes(leaf) -> int:
    """Bytes of a leaf: an array, a tensor (read without importing torch),
    or anything with ``shape`` and a numpy ``dtype``."""
    if hasattr(leaf, "element_size"):
        return leaf.numel() * leaf.element_size()
    shape = tuple(np.shape(leaf))
    dtype = np.dtype(getattr(leaf, "dtype", np.float32))
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape \
        else dtype.itemsize


def bucket_plan(leaves, bucket_mb: float) -> List[List[int]]:
    """Flat leaf indices packed into byte-budgeted buckets: largest leaf
    first (ties by index, so every host plans alike), a bucket closing
    when the next leaf would take it past ``bucket_mb`` MiB, a leaf
    larger than the budget alone in its own. The one plan of the
    package: the publish walks leaves in its order and the overlapped
    ZeRO plane (``parallel/zero_overlap.py``) groups its collectives by
    it, as the reference's ``parallel/zero_overlap.py::bucket_plan``
    does."""
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
    budget = int(bucket_mb * (1 << 20))
    order = sorted(range(len(leaves)),
                   key=lambda i: (-_leaf_bytes(leaves[i]), i))
    plan: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in order:
        nbytes = _leaf_bytes(leaves[i])
        if cur and cur_bytes + nbytes > budget:
            plan.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        plan.append(cur)
    return plan


def chunk_budget_bytes(chunk_mb: float) -> int:
    if chunk_mb <= 0:
        raise ValueError(f"chunk_mb must be > 0, got {chunk_mb}")
    return int(chunk_mb * (1 << 20))


def chunk_leaf(data: bytes, budget: int) -> Tuple[List[str], List[int]]:
    """A leaf's bytes cut at fixed ``budget`` offsets: ``(digests,
    lengths)``. The boundaries depend on the length and the budget only,
    never on the content, so a changed leaf dirties only the chunks whose
    bytes changed."""
    digests, lengths = [], []
    for off in range(0, max(len(data), 1), budget):
        piece = data[off:off + budget]
        digests.append(digest_of(piece))
        lengths.append(len(piece))
    return digests, lengths


def leaf_bytes(arr: np.ndarray) -> bytes:
    """A leaf's canonical bytes: C-order raw bytes, dtype kept (the
    manifest records it, so assembly is ``frombuffer`` and ``reshape``)."""
    return np.ascontiguousarray(arr).tobytes()


def plan_order(arrays: Sequence[np.ndarray], chunk_mb: float) -> List[int]:
    """The leaf walk: :func:`bucket_plan`'s buckets flattened."""
    return [i for bucket in bucket_plan(arrays, chunk_mb) for i in bucket]


def build_manifest(
    named: Sequence[Tuple[str, np.ndarray]],
    *,
    epoch: int,
    best_acc: float,
    chunk_mb: float,
    world: Optional[Dict[str, int]] = None,
    parallel_layout: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], List[Tuple[str, bytes]]]:
    """Chunk every leaf of ``named`` (``[(JAX leaf name, host array)]`` in
    flatten order); returns ``(manifest, stream)``, ``stream`` being
    ``[(digest, bytes)]`` in plan order, each digest once (identical
    leaves share chunks). The manifest's ``leaves`` keep ``named``'s
    order."""
    budget = chunk_budget_bytes(chunk_mb)
    arrays = [np.asarray(v) for _, v in named]
    records: List[Dict[str, Any]] = []
    by_digest: Dict[str, bytes] = {}
    per_leaf: List[List[str]] = []
    for (name, _), arr in zip(named, arrays):
        data = leaf_bytes(arr)
        digests, lengths = chunk_leaf(data, budget)
        per_leaf.append(digests)
        for j, (dg, ln) in enumerate(zip(digests, lengths)):
            if dg not in by_digest:
                by_digest[dg] = data[j * budget:j * budget + ln]
        records.append({"name": name, "shape": list(arr.shape),
                        "dtype": arr.dtype.name, "chunks": digests,
                        "lengths": lengths})
    manifest = {
        "epoch": epoch + 1,
        "best_acc": float(best_acc),
        "leaf_names": [k for k, _ in named],
        "format_version": MANIFEST_VERSION,
        "chunk_mb": float(chunk_mb),
        "leaves": records,
    }
    if world is not None:
        manifest["world"] = dict(world)
    if parallel_layout is not None:
        manifest["parallel_layout"] = dict(parallel_layout)
    stream: List[Tuple[str, bytes]] = []
    emitted = set()
    for i in plan_order(arrays, chunk_mb):
        for dg in per_leaf[i]:
            if dg not in emitted:
                emitted.add(dg)
                stream.append((dg, by_digest[dg]))
    return manifest, stream


def write_manifest(manifest: Dict[str, Any], directory: str,
                   epoch: int) -> str:
    """Publish ``checkpoint_{epoch}.manifest`` (tmp + rename). Every chunk
    it names must be stored first: the rename is the instant the epoch
    becomes visible to watchers."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"checkpoint_{epoch}{MANIFEST_SUFFIX}")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)
    return path


def read_manifest(path: str) -> Dict[str, Any]:
    """Parse a manifest; a torn one raises ``json.JSONDecodeError``."""
    with open(path) as f:
        return json.load(f)


def manifest_digests(manifest: Dict[str, Any]) -> set:
    return {dg for rec in manifest["leaves"] for dg in rec["chunks"]}


def assemble_leaf(rec: Dict[str, Any], store: ChunkStore) -> np.ndarray:
    """One leaf from its ordered chunks; a missing chunk raises
    :meth:`ChunkStore.get`'s ``missing chunk`` error."""
    data = b"".join(store.get(dg) for dg in rec["chunks"])
    return np.frombuffer(data, dtype=np.dtype(rec["dtype"])).reshape(
        rec["shape"])


def load_manifest_arrays(path: str, store: Optional[ChunkStore] = None) \
        -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """``(manifest, arrays in leaf_names order)``, assembled from the
    store beside the manifest unless ``store`` is given."""
    manifest = read_manifest(path)
    if store is None:
        store = ChunkStore(os.path.dirname(os.path.abspath(path)))
    return manifest, [assemble_leaf(rec, store) for rec in manifest["leaves"]]
