"""Checkpoint IO in the JAX package's ``.npz`` layout, format version 1.

Counterpart of the npz paths of ``pytorch_distributed_mnist_tpu/train/
checkpoint.py``. A ``checkpoint_{e}.npz`` is a zip of ``leaf_{i}`` arrays
plus a ``__meta__`` JSON (``epoch`` stored as ``e + 1``, ``best_acc``,
``leaf_names``, ``format_version``, ``world``: the saving world's
processes and devices, one device per process). Every write goes to a tmp
name and is published with ``os.replace``, so a reader (the serving
reload watcher, a resume) never sees half a file.

In a world of processes every rank holds the same train state; only
process 0 writes (the reference's ``:248-249``), and :func:`save_checkpoint`
returns on every rank only once the file is published (a barrier), so no
rank reads a file before process 0 has finished writing it. A checkpoint
saved by a world of N loads in a world of one and the other way round.

- Training (:func:`save_checkpoint`, :func:`load_checkpoint`) carries the
  full train state: params, optimizer state and step, leaf by leaf in the
  JAX package's flatten order (``models/convert.py::state_leaves``),
  because the JAX loader restores by position. A checkpoint written here
  resumes in the JAX package and the other way round.
- Serving (:func:`load_params`) reads the ``['params']`` leaves by name;
  :func:`save_params_checkpoint` writes params only.

Sharded ``.ckpt`` and delta ``.manifest`` layouts are not ported yet.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pytorch_distributed_mnist_tpu_torch.models.convert import (
    key_path,
    load_state_from_jax,
    state_to_jax,
)
from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    barrier,
    process_count,
    process_index,
)
from pytorch_distributed_mnist_tpu_torch.utils.logging import log0

FORMAT_VERSION = 1
# Quarantine suffix for corrupt checkpoints; the ``checkpoint_{e}.npz``
# pattern never matches it.
CORRUPT_SUFFIX = ".corrupt"


def _read_meta(path: str) -> Dict[str, Any]:
    """The checkpoint's meta dict, without reading any array."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def read_checkpoint_arrays(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """``(meta, {leaf name: array})`` of a v1 npz checkpoint."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        version = meta.get("format_version")
        if version != FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint format_version {version!r}, "
                             f"this reader takes {FORMAT_VERSION}")
        names = meta["leaf_names"]
        return meta, {name: z[f"leaf_{i}"] for i, name in enumerate(names)}


def load_params(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """``({JAX leaf name: array} of the ``['params']`` leaves, epoch)``.
    ``epoch`` is the file's own ``checkpoint_{e}`` index: meta stores the
    resume epoch ``e + 1``."""
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


def _write_npz(leaves: List[Tuple[str, np.ndarray]], *, epoch: int,
               best_acc: float, directory: str,
               parallel_layout: Optional[Dict[str, Any]] = None) -> str:
    """Publish ``checkpoint_{epoch}.npz`` holding ``leaves`` in the given
    order; returns its path. Written to a tmp name and renamed."""
    os.makedirs(directory, exist_ok=True)
    meta = {
        "epoch": epoch + 1,
        "best_acc": float(best_acc),
        "leaf_names": [name for name, _ in leaves],
        "format_version": FORMAT_VERSION,
        "world": _world_stamp(),
    }
    if parallel_layout is not None:
        meta["parallel_layout"] = dict(parallel_layout)
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


def save_checkpoint(state, *, epoch: int, best_acc: float, is_best: bool,
                    directory: str, keep_last: int = 0,
                    parallel_layout: Optional[Dict[str, Any]] = None) \
        -> Optional[str]:
    """Write the full train state to ``checkpoint_{epoch}.npz`` (meta
    epoch ``epoch + 1``, the epoch a resume continues at), copy it to
    ``model_best.npz`` when ``is_best``, then prune past ``keep_last``;
    returns the path. Only process 0 writes (the others return None),
    and every rank returns once it has (a barrier in a world of
    processes). The leaves come off the device here: one host sync per
    save."""
    path = None
    if process_index() == 0:
        path = _write_npz(state_to_jax(state), epoch=epoch,
                          best_acc=best_acc, directory=directory,
                          parallel_layout=parallel_layout)
        if is_best:
            best = os.path.join(directory, "model_best.npz")
            shutil.copyfile(path, best + ".tmp")
            os.replace(best + ".tmp", best)
        prune_checkpoints(directory, keep_last)
    barrier()
    return path


def load_checkpoint(path: str, state) -> Tuple[Any, int, float]:
    """Restore ``state`` in place from a full-state checkpoint of the same
    model and optimizer (the port's or the JAX package's); returns
    ``(state, start_epoch, best_acc)``. Raises ``ValueError`` on a leaf
    count, name or shape mismatch and leaves the state untouched."""
    meta, leaves = read_checkpoint_arrays(path)
    load_state_from_jax(state, list(leaves), list(leaves.values()), path)
    return state, int(meta["epoch"]), float(meta["best_acc"])


def try_resume(path: str, state) -> Tuple[Any, int, float]:
    """The reference's resume policy: load ``path`` if it exists, else
    warn and continue fresh with ``(state, 0, 0.0)``."""
    if path and os.path.isfile(path):
        state, start_epoch, best_acc = load_checkpoint(path, state)
        log0(f"=> loaded checkpoint '{path}' (epoch {start_epoch})")
        return state, start_epoch, best_acc
    if path:
        log0(f"=> no checkpoint found at '{path}'")
    return state, 0, 0.0


def checkpoint_parallel_layout(path: str) -> Optional[Dict[str, Any]]:
    """The ``parallel_layout`` stamp of a checkpoint's meta, or ``None``
    for checkpoints saved without one."""
    layout = _read_meta(path).get("parallel_layout")
    return dict(layout) if layout is not None else None


def is_corrupt_checkpoint_error(exc: BaseException) -> bool:
    """True when a load failure means the FILE is damaged (bytes present
    but undecodable) rather than the caller being wrong (a checkpoint of
    another model -> name/shape ValueErrors)."""
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
    """All published ``checkpoint_{e}.npz`` files in ``directory`` as
    sorted ``(epoch, path)`` pairs. The writers' in-flight ``.tmp`` names
    never match."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"checkpoint_(\d+)\.npz", name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the highest-epoch ``checkpoint_{e}.npz``, or None."""
    found = _epoch_checkpoints(directory)
    return found[-1][1] if found else None


def quarantine_checkpoint(path: str) -> str:
    """Rename a corrupt checkpoint out of the resolution namespace:
    ``checkpoint_{e}.npz`` -> ``checkpoint_{e}.npz.corrupt`` (then
    ``.corrupt2``...), so ``latest_checkpoint`` falls back to the
    next-older epoch and pruning never touches the evidence. Returns the
    quarantine path."""
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
    ``L``, the window ``[L - keep_last, L]`` always survives, so a serving
    reload watcher mid-load on the previous latest keeps its file for
    ``keep_last`` further publishes."""
    if keep_last <= 0:
        return
    found = _epoch_checkpoints(directory)
    if not found:
        return
    latest_epoch = found[-1][0]
    for epoch, path in found:
        if epoch >= latest_epoch - keep_last:
            break  # sorted: everything from here on is inside the window
        os.remove(path)
