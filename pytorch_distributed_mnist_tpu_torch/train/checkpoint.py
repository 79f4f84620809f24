"""Checkpoint IO in the JAX package's three layouts.

Counterpart of ``pytorch_distributed_mnist_tpu/train/checkpoint.py``; each
package reads what the other writes:

- **npz file** (``checkpoint_{e}.npz``, format version 1): a zip of
  ``leaf_{i}`` arrays plus a ``__meta__`` JSON (``epoch`` stored as
  ``e + 1``, ``best_acc``, ``leaf_names``, ``format_version``, ``world``:
  the saving world's processes and devices, one device per process).
- **sharded directory** (``checkpoint_{e}.ckpt/``, format version 2):
  per process a ``shards_p{pid}.npz`` and a slice index
  ``index_p{pid}.json``, and process 0's ``meta.json`` (``global_shapes``,
  ``dtypes``). A leaf whole on every process is written once, by process
  0, as one slice; a leaf split over a mesh axis (the expert weights of
  expert parallelism, the Megatron weights of tensor parallelism, ZeRO's
  shards: ``state.placements``) is written as each rank's slice of the
  JAX layout by the ranks at coordinate 0 of the other axes (a
  head-aligned ``qkv`` slice is gathered and cut contiguous first). The
  directory is renamed into place by process 0 once every process's
  index is visible.
  The port writes it only when asked (``layout="sharded"``); reading
  stitches whatever slices the indexes name, so a JAX directory written
  by any mesh loads here.
- **manifest** (``checkpoint_{e}.manifest``, ``--publish delta``):
  content-addressed chunks beside it (``distrib/``).

Every write goes to a tmp name and is published with ``os.replace``, so a
reader (the serving reload watcher, a resume) never sees half a
checkpoint. In a world of processes every rank holds the same train
state, but for its slices of the split leaves; process 0 writes whole
leaves (the reference's ``:248-249``; split leaves are gathered first,
on every rank), and
:func:`save_checkpoint` returns on every rank only once the checkpoint is
published, so no rank reads a file before it is whole. A checkpoint saved
by a world of N loads in a world of one and the other way round.

- Training (:func:`save_checkpoint`, :func:`load_checkpoint`) carries the
  full train state: params, optimizer state and step, leaf by leaf in the
  JAX package's flatten order (``models/convert.py::state_leaves``),
  because the JAX loader restores by position.
- Serving (:func:`load_params`) reads the ``['params']`` leaves by name;
  :func:`save_params_checkpoint` writes params only.
- :class:`AsyncCheckpointer` (``--async-checkpoint``) copies the state off
  the device in ``save`` and writes on a thread while the next epoch
  trains.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pytorch_distributed_mnist_tpu_torch.models.convert import (
    key_path,
    load_state_from_jax,
    state_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
)
from pytorch_distributed_mnist_tpu_torch.runtime import supervision
from pytorch_distributed_mnist_tpu_torch.runtime.supervision import (
    maybe_fault,
)
from pytorch_distributed_mnist_tpu_torch.utils.logging import log0
from pytorch_distributed_mnist_tpu_torch.utils.profiling import failure_events
from pytorch_distributed_mnist_tpu_torch.utils.watchdog import (
    retry_with_backoff,
)

FORMAT_VERSION = 1
SHARDED_FORMAT_VERSION = 2
LAYOUTS = (None, "npz", "sharded")
PUBLISH_MODES = (None, "full", "delta")
# Quarantine suffix for corrupt checkpoints; the ``checkpoint_{e}.<layout>``
# pattern never matches it.
CORRUPT_SUFFIX = ".corrupt"

Named = List[Tuple[str, np.ndarray]]


def _read_meta(path: str) -> Dict[str, Any]:
    """The checkpoint's meta dict, without reading any array: the sharded
    directory's ``meta.json``, the manifest itself, or the npz's
    ``__meta__``."""
    if os.path.isdir(path):
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)
    if path.endswith(".manifest"):
        with open(path) as f:
            return json.load(f)
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def _check_version(path: str, meta: Dict[str, Any], want: int) -> None:
    version = meta.get("format_version")
    if version != want:
        raise ValueError(f"{path}: checkpoint format_version {version!r}, "
                         f"this reader takes {want}")


def read_checkpoint_arrays(path: str) \
        -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """``(meta, {leaf name: array})`` of a checkpoint of any layout: an
    npz file, a sharded ``.ckpt`` directory (stitched) or a manifest
    (assembled from the chunks beside it)."""
    if os.path.isdir(path):
        meta, arrays = _stitch_sharded(path)
    elif path.endswith(".manifest"):
        from pytorch_distributed_mnist_tpu_torch.distrib.cas import (
            MANIFEST_VERSION,
            load_manifest_arrays,
        )

        meta, arrays = load_manifest_arrays(path)
        _check_version(path, meta, MANIFEST_VERSION)
    else:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            _check_version(path, meta, FORMAT_VERSION)
            arrays = [z[f"leaf_{i}"] for i in range(len(meta["leaf_names"]))]
    return meta, dict(zip(meta["leaf_names"], arrays))


def load_params(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """``({JAX leaf name: array} of the ``['params']`` leaves, epoch)``.
    ``epoch`` is the checkpoint's own ``checkpoint_{e}`` index: meta
    stores the resume epoch ``e + 1``."""
    meta, leaves = read_checkpoint_arrays(path)
    params = {name: arr for name, arr in leaves.items()
              if name.startswith("['params']")}
    if not params:
        raise ValueError(f"{path}: checkpoint holds no ['params'] leaves")
    return params, int(meta["epoch"]) - 1


def _world_stamp() -> Dict[str, int]:
    """The saving world's shape, stamped into the meta as provenance (the
    JAX package's ``_world_stamp``): every process drives one device."""
    n = process_count()
    return {"processes": n, "devices": n}


def _meta(named: Named, epoch: int, best_acc: float, version: int,
          parallel_layout: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    meta = {
        "epoch": epoch + 1,
        "best_acc": float(best_acc),
        "leaf_names": [name for name, _ in named],
        "format_version": version,
        "world": _world_stamp(),
    }
    if version == SHARDED_FORMAT_VERSION:
        meta["global_shapes"] = [list(np.shape(a)) for _, a in named]
        meta["dtypes"] = [np.asarray(a).dtype.name for _, a in named]
    if parallel_layout is not None:
        meta["parallel_layout"] = dict(parallel_layout)
    return meta


def _write_npz(leaves: Named, *, epoch: int, best_acc: float,
               directory: str,
               parallel_layout: Optional[Dict[str, Any]] = None) -> str:
    """Publish ``checkpoint_{epoch}.npz`` holding ``leaves`` in the given
    order; returns its path. Written to a tmp name and renamed."""
    os.makedirs(directory, exist_ok=True)
    meta = _meta(leaves, epoch, best_acc, FORMAT_VERSION, parallel_layout)
    payload = {f"leaf_{i}": np.asarray(arr)
               for i, (_, arr) in enumerate(leaves)}
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **payload)
    path = os.path.join(directory, f"checkpoint_{epoch}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic publish
    return path


def save_params_checkpoint(flat: Dict[str, np.ndarray], *, epoch: int,
                           directory: str, best_acc: float = 0.0) -> str:
    """Publish ``checkpoint_{epoch}.npz`` holding ``flat`` (JAX-named
    param leaves) in the v1 layout, in the order JAX flattens nested
    dicts (sorted keys at each level); returns its path."""
    names = sorted(flat, key=key_path)
    return _write_npz([(name, flat[name]) for name in names], epoch=epoch,
                      best_acc=best_acc, directory=directory)


def _check_modes(layout: Optional[str], publish: Optional[str]) -> None:
    """The JAX saver's refusals of a layout and publish mode."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown checkpoint layout {layout!r}")
    if publish not in PUBLISH_MODES:
        raise ValueError(f"unknown publish mode {publish!r}")
    if publish == "delta" and layout == "sharded":
        raise ValueError(
            "--publish delta replaces the npz layout and cannot write "
            "layout='sharded'; save the sharded layout and convert via "
            "publish_from_checkpoint")


def _write_whole(named: Named, *, epoch: int, best_acc: float,
                 is_best: bool, directory: str, keep_last: int,
                 parallel_layout: Optional[Dict[str, Any]],
                 publish: Optional[str], chunk_mb: float) -> str:
    """Process 0's write of a whole host state: an npz file, or with
    ``publish="delta"`` the chunks and the manifest; then the best copy
    and the prune. Touches no device and no collective, so the
    asynchronous saver runs it on its thread."""
    if publish == "delta":
        from pytorch_distributed_mnist_tpu_torch.distrib.publish import (
            publish_arrays,
        )

        return publish_arrays(
            named, epoch=epoch, best_acc=best_acc, directory=directory,
            chunk_mb=chunk_mb, is_best=is_best, keep_last=keep_last,
            world=_world_stamp(), parallel_layout=parallel_layout)
    path = _write_npz(named, epoch=epoch, best_acc=best_acc,
                      directory=directory, parallel_layout=parallel_layout)
    if is_best:
        best = os.path.join(directory, "model_best.npz")
        shutil.copyfile(path, best + ".tmp")
        os.replace(best + ".tmp", best)
    prune_checkpoints(directory, keep_last)
    return path


def save_checkpoint(state, *, epoch: int, best_acc: float, is_best: bool,
                    directory: str, keep_last: int = 0,
                    parallel_layout: Optional[Dict[str, Any]] = None,
                    layout: Optional[str] = None,
                    publish: Optional[str] = None,
                    chunk_mb: float = 4.0) -> Optional[str]:
    """Write the full train state as ``checkpoint_{epoch}`` (meta epoch
    ``epoch + 1``, the epoch a resume continues at), copy it to
    ``model_best`` when ``is_best``, then prune past ``keep_last``;
    returns the path on process 0 (and the sharded directory's on every
    rank), else None. Every rank returns once it is published.

    ``publish="delta"`` writes the chunks the store lacks and a
    ``.manifest`` instead of the npz file (``chunk_mb`` MiB chunks);
    ``layout="sharded"`` writes a ``.ckpt`` directory. The leaves come off
    the device here: one host sync per save, on process 0 only."""
    _check_modes(layout, publish)
    pid = process_index()
    if layout == "sharded":
        return _save_sharded(state, epoch=epoch, best_acc=best_acc,
                             is_best=is_best, directory=directory, pid=pid,
                             keep_last=keep_last,
                             parallel_layout=parallel_layout)
    path, err = None, None
    named = None
    if _placed(state):
        # Split leaves gather over their mesh axes: every rank takes part.
        named = state_to_jax(state)
    if pid == 0:
        try:
            path = _write_whole(
                named if named is not None else state_to_jax(state),
                epoch=epoch, best_acc=best_acc,
                is_best=is_best, directory=directory, keep_last=keep_last,
                parallel_layout=parallel_layout, publish=publish,
                chunk_mb=chunk_mb)
        except Exception as exc:  # noqa: BLE001 - agreed on below
            err = exc
    if process_count() > 1:
        # The publish agreement: no rank goes on until process 0's file
        # is published, and every rank learns if it failed.
        maybe_fault("ckpt_publish")
        _agree(err, epoch, "publish",
               f"checkpoint {epoch} may not have been published")
    elif err is not None:
        raise err
    return path


# -- the sharded directory ------------------------------------------------

def _agree(error: Optional[BaseException], epoch: int, phase: str,
           detail: str) -> None:
    """Every rank learns whether any rank failed this phase before any
    goes on, so no rank waits at the next collective for a peer that
    raised: a failed rank raises its own error, its peers ``PeerFailure``
    naming it and the phase it reported. The exchange is the run
    supervision's agreement ``ckpt_{phase}`` (``runtime/supervision.py``:
    the records over the gloo group, under the agreement watchdog, so a
    poison pill from a rank that failed outside checkpointing is
    attributed to its real phase), and is itself a barrier."""
    if process_count() > 1:
        failed = supervision.agree(f"ckpt_{phase}", error)
        if failed and error is None:
            raise supervision.PeerFailure(
                supervision.peer_failure_message(
                    failed,
                    f"checkpoint {phase} for epoch {epoch} failed "
                    f"on host(s) {[h for h, _, _ in failed]}; {detail}"),
                hosts=[h for h, _, _ in failed],
                # The failed peer's own phase: a pill from a rank that
                # died outside checkpointing names its real failure site.
                phase=failed[0][1], reason=failed[0][2])
    if error is not None:
        raise error


def _sharded_prepare(directory: str, epoch: int, pid: int) -> Tuple[str, str]:
    """Phase 1 (every rank, a collective): process 0 makes a clean tmp
    directory; returns ``(tmp, final)``."""
    maybe_fault("ckpt_prepare")
    final = os.path.join(directory, f"checkpoint_{epoch}.ckpt")
    tmp = final + ".tmp"
    err: Optional[BaseException] = None
    if pid == 0:
        try:
            # An earlier crashed attempt's stale shards must not be
            # published beside fresh ones.
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        except Exception as exc:  # noqa: BLE001 - agreed on below
            err = exc
    _agree(err, epoch, "prepare", f"tmp dir {tmp} could not be prepared")
    return tmp, final


def _placed(state) -> bool:
    """True when some leaf of ``state`` lives split over a mesh axis
    (``parallel/tensor.py::Placement``): whole leaves then take a
    collective, and a sharded directory holds each rank's slices."""
    return bool(getattr(state, "placements", None))


def _sharded_collect(state, pid: int) -> Tuple[Named, Dict[str, np.ndarray],
                                              list]:
    """Phase 2 (device reads): ``(named, payload, index)``. Process 0 owns
    every leaf (each is whole, and the same, on every rank), so it copies
    the state off the device and indexes each leaf as one slice; the
    others own nothing. The copy is a snapshot: the train loop may update
    the device state as soon as this returns."""
    maybe_fault("ckpt_collect")
    if _placed(state):
        return _sharded_collect_placed(state, pid)
    if pid != 0:
        return [], {}, []
    named = state_to_jax(state)
    payload, index = {}, []
    for i, (_, arr) in enumerate(named):
        key = f"leaf{i}_s0"
        payload[key] = arr
        index.append({"leaf": i, "key": key, "start": [0] * arr.ndim,
                      "stop": list(arr.shape)})
    return named, payload, index


def _sharded_collect_placed(state, pid: int):
    """Phase 2 of a state with split leaves: each rank indexes the slices
    it writes (``Placement.writes``: coordinate 0 on every other mesh
    axis), in the JAX layout; process 0 also writes every whole leaf and
    returns shape-only stand-ins of them all for the meta."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        _to_jax_layout,
        state_leaves,
    )

    placements = state.placements
    named: Named = []
    payload, index = {}, []
    for i, (name, t) in enumerate(state_leaves(state)):
        pl = placements.get(name)
        if pl is not None and pl.blocks > 1:
            # A head-aligned slice is not the JAX layout's: the file holds
            # the contiguous one, cut from the whole leaf (a collective
            # over the placement's axis: every rank of it is here).
            t = pl.contiguous(pl.gather(t))
        arr = _to_jax_layout(t.detach().cpu().numpy())
        if pl is None:
            shape = arr.shape
            if pid == 0:
                key = f"leaf{i}_s0"
                payload[key] = arr
                index.append({"leaf": i, "key": key,
                              "start": [0] * arr.ndim,
                              "stop": list(arr.shape)})
        else:
            jax_dim = [d for d, a in enumerate(pl.spec) if a is not None][0]
            shape = list(arr.shape)
            shape[jax_dim] = pl.shape[pl.dim]
            shape = tuple(shape)
            if pl.writes:
                key = f"leaf{i}_s{pl.index}"
                start = [0] * arr.ndim
                stop = list(shape)
                start[jax_dim] = pl.index * pl.chunk
                stop[jax_dim] = (pl.index + 1) * pl.chunk
                payload[key] = arr
                index.append({"leaf": i, "key": key, "start": start,
                              "stop": stop})
        if pid == 0:
            named.append((name, np.broadcast_to(np.zeros((), arr.dtype),
                                                shape)))
    return named, payload, index


def _sharded_write_files(tmp: str, pid: int, payload, index,
                         meta: Optional[Dict[str, Any]]) -> None:
    """Phase 3 (any thread): file IO only, no device and no collective:
    what the asynchronous saver overlaps with the next epoch."""
    maybe_fault("ckpt_write")
    shard_file = f"shards_p{pid:05d}.npz"
    if payload:
        with open(os.path.join(tmp, shard_file), "wb") as f:
            np.savez(f, **payload)
    with open(os.path.join(tmp, f"index_p{pid:05d}.json"), "w") as f:
        json.dump({"file": shard_file if payload else None,
                   "shards": index}, f)
    if meta is not None:  # process 0
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)


def _publish_dir(tmp: str, final: str, directory: str, is_best: bool,
                 keep_last: int) -> None:
    """Process 0's publish: every rank's index must be visible here (the
    checkpoint directory must be one filesystem for all ranks), then the
    atomic rename, the best copy and the prune."""
    missing = [p for p in range(process_count())
               if not os.path.isfile(os.path.join(tmp,
                                                  f"index_p{p:05d}.json"))]
    if missing:
        raise RuntimeError(
            f"sharded checkpoint save: index files from processes {missing} "
            f"are not visible in {tmp}; --checkpoint-dir must be a "
            f"filesystem shared by all ranks")
    if os.path.isdir(final):
        shutil.rmtree(final)

    # The rename is the one retry-safe step on a network filesystem (a
    # transient ESTALE or EIO on a busy NFS export): failing here aborts
    # every rank through the publish agreement, while a retry publishes a
    # checkpoint that is already whole on disk.
    def _replace_once() -> None:
        try:
            os.replace(tmp, final)
        except OSError:
            if os.path.isdir(final) and not os.path.exists(tmp):
                # A lost NFS reply: the server made the rename, the
                # client's retry sees tmp gone. The publish landed.
                return
            raise

    retry_with_backoff(
        _replace_once, attempts=3, retry_on=(OSError,),
        on_retry=lambda attempt, exc, delay: failure_events.record(
            "publish_retry",
            f"rename to {final} attempt {attempt} failed ({exc!r}); "
            f"retrying in {delay:.2f}s"))
    try:
        if is_best:
            best = os.path.join(directory, "model_best.ckpt")
            best_tmp = best + ".copy_tmp"
            if os.path.isdir(best_tmp):
                shutil.rmtree(best_tmp)
            shutil.copytree(final, best_tmp)
            if os.path.isdir(best):
                shutil.rmtree(best)
            os.replace(best_tmp, best)
        prune_checkpoints(directory, keep_last)
    except Exception as exc:
        # The rename landed: say so, or the phase failure would send a
        # postmortem to discard a checkpoint that is valid on disk.
        raise RuntimeError(
            f"checkpoint {final} WAS published, but a post-publish step "
            f"(best copy / prune) failed: {exc!r}") from exc


def _sharded_publish(tmp: str, final: str, directory: str, epoch: int,
                     is_best: bool, keep_last: int, pid: int) -> str:
    """Phase 4 (every rank, a collective): process 0 publishes, and every
    rank learns the outcome. The write phase's agreement, just before,
    is the all-files-on-disk barrier."""
    maybe_fault("ckpt_publish")
    err: Optional[BaseException] = None
    if pid == 0:
        try:
            _publish_dir(tmp, final, directory, is_best, keep_last)
        except Exception as exc:  # noqa: BLE001 - agreed on below
            err = exc
    _agree(err, epoch, "publish",
           f"checkpoint dir {final} may not have been published")
    return final


def _save_sharded(state, *, epoch: int, best_acc: float, is_best: bool,
                  directory: str, pid: int, keep_last: int = 0,
                  parallel_layout: Optional[Dict[str, Any]] = None) -> str:
    """The four phases in a row (the asynchronous saver runs phase 3 on
    its thread and phase 4 at its next drain)."""
    tmp, final = _sharded_prepare(directory, epoch, pid)
    err: Optional[BaseException] = None
    try:
        named, payload, index = _sharded_collect(state, pid)
        meta = (_meta(named, epoch, best_acc, SHARDED_FORMAT_VERSION,
                      parallel_layout) if pid == 0 else None)
        _sharded_write_files(tmp, pid, payload, index, meta)
    except Exception as exc:  # noqa: BLE001 - agreed on below
        err = exc
    _agree(err, epoch, "write", f"dropping unpublished {tmp}")
    return _sharded_publish(tmp, final, directory, epoch, is_best,
                            keep_last, pid)


def _stitch_sharded(path: str) -> Tuple[Dict[str, Any], list]:
    """``(meta, whole arrays in leaf_names order)`` of a sharded
    directory, stitched from every index file it holds, whatever world
    wrote it. A leaf with elements that no slice covers raises
    (``missing shards``: an incomplete save, or an incomplete view of a
    shared filesystem)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    _check_version(path, meta, SHARDED_FORMAT_VERSION)
    arrays = [np.zeros(shape, dtype=np.dtype(dt))
              for shape, dt in zip(meta["global_shapes"], meta["dtypes"])]
    filled = [0] * len(arrays)
    index_files = 0
    for name in sorted(os.listdir(path)):
        if not name.startswith("index_p"):
            continue
        index_files += 1
        with open(os.path.join(path, name)) as f:
            idx = json.load(f)
        if idx["file"] is None:
            continue
        shard_path = os.path.join(path, idx["file"])
        if not os.path.isfile(shard_path):
            continue  # the coverage check below names what is missing
        with np.load(shard_path) as z:
            for rec in idx["shards"]:
                i = rec["leaf"]
                region = tuple(slice(a, b)
                               for a, b in zip(rec["start"], rec["stop"]))
                data = z[rec["key"]]
                arrays[i][region] = data.reshape(arrays[i][region].shape)
                filled[i] += data.size
    saved = (meta.get("world") or {}).get("processes")
    for i, (total, arr) in enumerate(zip(filled, arrays)):
        if total < arr.size:
            world = (f" (saved by a {saved}-process world; {index_files} "
                     f"index file(s) visible here: an incomplete "
                     f"shared-filesystem view?)"
                     if saved and index_files != saved
                     else ": incomplete save?")
            raise ValueError(f"{path}: leaf {meta['leaf_names'][i]} is "
                             f"missing shards ({total}/{arr.size} elements "
                             f"present){world}")
    return meta, arrays


# -- loading ----------------------------------------------------------------

def load_checkpoint(path: str, state) -> Tuple[Any, int, float]:
    """Restore ``state`` in place from a full-state checkpoint of any
    layout, of the same model and optimizer (the port's or the JAX
    package's); returns ``(state, start_epoch, best_acc)``. Raises
    ``ValueError`` on a leaf count, name or shape mismatch and leaves the
    state untouched."""
    meta, leaves = read_checkpoint_arrays(path)
    load_state_from_jax(state, list(leaves), list(leaves.values()), path)
    return state, int(meta["epoch"]), float(meta["best_acc"])


def try_resume(path: str, state) -> Tuple[Any, int, float]:
    """The reference's resume policy: load ``path`` (a file or a
    ``.ckpt`` directory) if it exists, else warn and continue fresh with
    ``(state, 0, 0.0)``."""
    if path and (os.path.isfile(path) or os.path.isdir(path)):
        state, start_epoch, best_acc = load_checkpoint(path, state)
        log0(f"=> loaded checkpoint '{path}' (epoch {start_epoch})")
        return state, start_epoch, best_acc
    if path:
        log0(f"=> no checkpoint found at '{path}'")
    return state, 0, 0.0


def checkpoint_world(path: str) -> Optional[Dict[str, int]]:
    """The ``world`` stamp of a checkpoint's meta (``{"processes",
    "devices"}`` of the world that saved it), or ``None`` for checkpoints
    saved without one."""
    world = _read_meta(path).get("world")
    return dict(world) if world else None


def checkpoint_parallel_layout(path: str) -> Optional[Dict[str, Any]]:
    """The ``parallel_layout`` stamp of a checkpoint's meta, or ``None``
    for checkpoints saved without one."""
    layout = _read_meta(path).get("parallel_layout")
    return dict(layout) if layout is not None else None


def is_corrupt_checkpoint_error(exc: BaseException) -> bool:
    """True when a load failure means the checkpoint is damaged (bytes
    present but undecodable: a torn npz or manifest) rather than the
    caller being wrong (a checkpoint of another model -> name/shape
    ValueErrors) or a part being absent (a sharded directory's
    ``missing shards``, a manifest's ``missing chunk``)."""
    import zipfile
    import zlib

    if isinstance(exc, (zipfile.BadZipFile, zlib.error, EOFError,
                        json.JSONDecodeError, KeyError)):
        return True
    if isinstance(exc, ValueError):
        msg = str(exc)
        return ("Cannot load file" in msg
                or "Failed to interpret" in msg or "allow_pickle" in msg)
    return False


def _epoch_checkpoints(directory: str) -> list:
    """All published per-epoch checkpoints in ``directory`` (``.npz``
    files, ``.ckpt`` directories, ``.manifest`` files) as sorted ``(epoch,
    path)`` pairs: the one rule of resume, the serving watcher and
    pruning. The writers' in-flight ``.tmp`` names never match."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"checkpoint_(\d+)\.(npz|ckpt|manifest)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the highest-epoch ``checkpoint_{e}`` of any layout, or
    None."""
    found = _epoch_checkpoints(directory)
    return found[-1][1] if found else None


def quarantine_checkpoint(path: str) -> str:
    """Rename a corrupt checkpoint (file or directory) out of the
    resolution namespace: ``checkpoint_{e}.npz`` ->
    ``checkpoint_{e}.npz.corrupt`` (then ``.corrupt2``...), so
    ``latest_checkpoint`` falls back to the next-older epoch and pruning
    never touches the evidence. Returns the quarantine path."""
    dest = path + CORRUPT_SUFFIX
    n = 2
    while os.path.exists(dest):
        dest = f"{path}{CORRUPT_SUFFIX}{n}"
        n += 1
    os.replace(path, dest)
    return dest


def prune_checkpoints(directory: str, keep_last: int) -> None:
    """Delete per-epoch checkpoints strictly older than the latest
    published epoch minus ``keep_last`` (``keep_last <= 0`` keeps all;
    ``model_best`` is never pruned). Keyed to the latest published epoch
    ``L`` of any layout, the window ``[L - keep_last, L]`` always
    survives, so a serving reload watcher mid-load on the previous latest
    keeps it for ``keep_last`` further publishes. A manifest's chunks go
    with the delta publish's GC (``distrib/publish.py::gc_chunks``)."""
    if keep_last <= 0:
        return
    found = _epoch_checkpoints(directory)
    if not found:
        return
    latest_epoch = found[-1][0]
    for epoch, path in found:
        if epoch >= latest_epoch - keep_last:
            break  # sorted: everything from here on is inside the window
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)


# -- the asynchronous saver -------------------------------------------------

class AsyncCheckpointer:
    """Overlap checkpoint writes with the next epoch's training.

    ``save()`` takes :func:`save_checkpoint`'s arguments. It copies the
    state off the device first, synchronously (``state_to_jax``: a
    blocking copy into fresh host arrays, so the copy has landed before
    ``save`` returns and before the next epoch's first step, or replay
    of a captured graph, updates the params and moments in place), then
    writes on one thread. At most one write is in flight: ``save`` and
    :meth:`wait` join the previous one first, and a write's error is
    raised there (or at the context's exit).

    The sharded layout's phases hold collectives, which must stay on the
    main thread: ``save`` prepares the tmp directory and snapshots inline,
    the thread writes the files, and the publish (the write agreement,
    the rename) runs at the next drain (``save``, ``wait`` or the exit),
    where every rank arrives at the same point. A crash loses at most the
    one write in flight, as with the npz file.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._result: Optional[str] = None
        self._error: Optional[BaseException] = None
        self._pending_publish: Optional[Dict[str, Any]] = None
        # Wall ms of each drain (a wait for the write in flight).
        self.drain_ms: List[float] = []

    def _start(self, write, epoch: int) -> None:
        def run() -> None:
            try:
                write()
            except BaseException as exc:  # raised by the next drain
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"checkpoint-write-{epoch}")
        self._thread.start()

    def save(self, state, *, epoch: int, best_acc: float, is_best: bool,
             directory: str, keep_last: int = 0,
             parallel_layout: Optional[Dict[str, Any]] = None,
             layout: Optional[str] = None, publish: Optional[str] = None,
             chunk_mb: float = 4.0) -> None:
        self.wait()
        # From here on _result holds this save's outcome only.
        self._result = None
        _check_modes(layout, publish)
        pid = process_index()
        if layout == "sharded":
            self._save_sharded(state, pid, epoch=epoch, best_acc=best_acc,
                               is_best=is_best, directory=directory,
                               keep_last=keep_last,
                               parallel_layout=parallel_layout)
            return
        if _placed(state):
            # Split leaves gather over their mesh axes: every rank takes
            # part, and only process 0 keeps the copy.
            named = state_to_jax(state)
            if pid != 0:
                return
        elif pid != 0:
            return  # process 0 writes; the others keep no copy
        else:
            named = state_to_jax(state)

        def write() -> None:
            self._result = _write_whole(
                named, epoch=epoch, best_acc=best_acc, is_best=is_best,
                directory=directory, keep_last=keep_last,
                parallel_layout=parallel_layout, publish=publish,
                chunk_mb=chunk_mb)

        self._start(write, epoch)

    def _save_sharded(self, state, pid: int, *, epoch: int, best_acc: float,
                      is_best: bool, directory: str, keep_last: int,
                      parallel_layout) -> None:
        tmp, final = _sharded_prepare(directory, epoch, pid)
        # Armed even when the snapshot fails: the next drain's write
        # agreement then fails every rank together.
        self._pending_publish = dict(
            tmp=tmp, final=final, directory=directory, epoch=epoch,
            is_best=is_best, keep_last=keep_last, pid=pid)
        try:
            named, payload, index = _sharded_collect(state, pid)
            meta = (_meta(named, epoch, best_acc, SHARDED_FORMAT_VERSION,
                          parallel_layout) if pid == 0 else None)
        except Exception as exc:  # noqa: BLE001 - agreed at the drain
            self._error = exc
            return
        self._start(lambda: _sharded_write_files(tmp, pid, payload, index,
                                                 meta), epoch)

    def wait(self) -> Optional[str]:
        """Join the write in flight (and publish a sharded one); raise its
        error if it failed; return its path (process 0), else None."""
        t0 = time.perf_counter()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending_publish is not None:
            pub, self._pending_publish = self._pending_publish, None
            err, self._error = self._error, None
            _agree(err, pub["epoch"], "write",
                   f"dropping unpublished {pub['tmp']}")
            self._result = _sharded_publish(**pub)
        self.drain_ms.append((time.perf_counter() - t0) * 1e3)
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc
        return self._result

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc_info) -> None:
        if exc_info[0] is None:
            self.wait()
            return
        # The body is unwinding on its own exception: land the write in
        # flight, but mask nothing and run no collective (the peers may
        # be unwinding too and would never arrive).
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            print(f"WARNING: async checkpoint write failed while the run "
                  f"was unwinding; discarded in favor of the run's own "
                  f"exception: {self._error!r}", file=sys.stderr)
            self._error = None
        if self._pending_publish is not None:
            print(f"WARNING: unpublished checkpoint "
                  f"{self._pending_publish['tmp']} dropped during unwind "
                  f"(publish skipped)", file=sys.stderr)
            self._pending_publish = None
