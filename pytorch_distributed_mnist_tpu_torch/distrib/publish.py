"""The trainer's side of delta distribution: store the chunks the store
lacks, then publish the manifest.

Counterpart of ``pytorch_distributed_mnist_tpu/distrib/publish.py``.
:func:`publish_arrays` stores only absent chunks (adjacent epochs share
the bytes of every unchanged leaf), renames the manifest into place (the
one atomic instant), prunes manifests by the window rule of every layout
(``train/checkpoint.py::prune_checkpoints``) and extends that window to
chunks: :func:`gc_chunks` deletes only chunks that no manifest still on
disk names. A chunk that a manifest inside the keep-last window names,
one a serving watcher may be fetching, lives exactly as long as that
manifest.

:func:`publish_from_checkpoint` turns a published npz file or sharded
``.ckpt`` directory (or a manifest) into a manifest.
"""

from __future__ import annotations

import glob
import os
import shutil
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from pytorch_distributed_mnist_tpu_torch.distrib.cas import (
    MANIFEST_SUFFIX,
    ChunkStore,
    build_manifest,
    manifest_digests,
    read_manifest,
    write_manifest,
)
from pytorch_distributed_mnist_tpu_torch.utils.logging import log0

# What the last publish of this process did: chunk bytes written and in
# all, chunks written and shared with the store, and its wall time.
last_publish: Dict[str, float] = {}


def gc_chunks(directory: str) -> int:
    """Delete the chunks no manifest in ``directory`` names; returns the
    bytes freed. Every ``*.manifest`` on disk counts: the epochs the prune
    window kept and the ``model_best`` copy. A torn manifest pins nothing,
    and a quarantined one (``.corrupt``) is not a live reference."""
    referenced: set = set()
    for path in glob.glob(os.path.join(directory, f"*{MANIFEST_SUFFIX}")):
        try:
            referenced |= manifest_digests(read_manifest(path))
        except Exception:  # noqa: BLE001 - a torn manifest pins nothing
            continue
    return ChunkStore(directory).gc(referenced)


def publish_arrays(
    named: Sequence[Tuple[str, np.ndarray]],
    *,
    epoch: int,
    best_acc: float,
    directory: str,
    chunk_mb: float = 4.0,
    is_best: bool = False,
    keep_last: int = 0,
    world: Optional[Dict[str, int]] = None,
    parallel_layout: Optional[Dict[str, Any]] = None,
) -> str:
    """Chunk, store and publish ``named`` (``[(JAX leaf name, host
    array)]`` in flatten order); returns the manifest's path. Every chunk
    it names is on disk before the manifest's rename, so a watcher that
    sees the manifest can assemble it; a crash in between leaves only
    unnamed chunks, which the next publish's GC collects."""
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        prune_checkpoints,
    )

    t0 = time.perf_counter()
    store = ChunkStore(directory)
    manifest, stream = build_manifest(
        named, epoch=epoch, best_acc=best_acc, chunk_mb=chunk_mb,
        world=world, parallel_layout=parallel_layout)
    written = new_chunks = 0
    for digest, data in stream:
        if store.put(digest, data):
            written += len(data)
            new_chunks += 1
    path = write_manifest(manifest, directory, epoch)
    total = sum(len(data) for _, data in stream)
    log0(f"delta publish: epoch {epoch} -> {path} "
         f"({written}/{total} chunk bytes new)")
    if is_best:
        best = os.path.join(directory, f"model_best{MANIFEST_SUFFIX}")
        shutil.copyfile(path, best + ".tmp")
        os.replace(best + ".tmp", best)
    prune_checkpoints(directory, keep_last)
    freed = gc_chunks(directory) if keep_last > 0 else 0
    last_publish.clear()
    last_publish.update(
        bytes_new=written, bytes_total=total, chunks_new=new_chunks,
        chunks_shared=len(stream) - new_chunks, bytes_freed=freed,
        ms=(time.perf_counter() - t0) * 1e3)
    return path


def publish_state(
    state,
    *,
    epoch: int,
    best_acc: float,
    directory: str,
    chunk_mb: float = 4.0,
    is_best: bool = False,
    keep_last: int = 0,
    parallel_layout: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    """Delta-publish a live train state (``--publish delta``): the leaves
    of ``models/convert.py::state_to_jax``, so the port and the JAX
    package give one state the same leaf names and digests. Process 0
    publishes (others return None without touching the card), as with
    the npz layout; every leaf of a port state is whole on every
    process."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        state_to_jax,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
        process_index,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        _world_stamp,
    )

    if process_index() != 0:
        return None
    return publish_arrays(
        state_to_jax(state), epoch=epoch, best_acc=best_acc,
        directory=directory, chunk_mb=chunk_mb, is_best=is_best,
        keep_last=keep_last, world=_world_stamp(),
        parallel_layout=parallel_layout)


def publish_from_checkpoint(path: str, directory: Optional[str] = None, *,
                            chunk_mb: float = 4.0,
                            keep_last: int = 0) -> str:
    """Re-publish a checkpoint of any layout as a manifest in
    ``directory`` (default: its own). Epoch, best_acc, world and
    parallel_layout carry over from the source's meta."""
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        read_checkpoint_arrays,
    )

    meta, leaves = read_checkpoint_arrays(path)
    directory = directory or os.path.dirname(os.path.abspath(path))
    return publish_arrays(
        list(leaves.items()), epoch=int(meta["epoch"]) - 1,
        best_acc=float(meta.get("best_acc", 0.0)), directory=directory,
        chunk_mb=chunk_mb, keep_last=keep_last, world=meta.get("world"),
        parallel_layout=meta.get("parallel_layout"))
