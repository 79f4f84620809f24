"""Checkpoint IO in the JAX package's ``.npz`` layout, format version 1.

Counterpart of the npz paths of ``pytorch_distributed_mnist_tpu/train/
checkpoint.py``. A ``checkpoint_{e}.npz`` is a zip of ``leaf_{i}`` arrays
plus a ``__meta__`` JSON (``epoch`` stored as ``e + 1``, ``leaf_names``,
``format_version``, ``world``). Serving reads the ``['params']`` leaves by
name and ignores ``opt_state`` and ``step``. The writer stores params
only, with the same atomic tmp + ``os.replace`` publish, so a directory
written here is served by the port's reload watcher exactly as a training
run's is. Sharded ``.ckpt`` and delta ``.manifest`` layouts are not
ported yet.
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

FORMAT_VERSION = 1


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


def save_params_checkpoint(flat: Dict[str, np.ndarray], *, epoch: int,
                           directory: str, best_acc: float = 0.0) -> str:
    """Publish ``checkpoint_{epoch}.npz`` holding ``flat`` (JAX-named
    param leaves) in the v1 layout; returns its path. Written to a tmp
    name and renamed, so a watcher never sees half a file."""
    os.makedirs(directory, exist_ok=True)
    names = sorted(flat)
    meta = {
        "epoch": epoch + 1,
        "best_acc": float(best_acc),
        "leaf_names": names,
        "format_version": FORMAT_VERSION,
        "world": {"processes": 1, "devices": 1},
    }
    payload = {f"leaf_{i}": np.asarray(flat[name])
               for i, name in enumerate(names)}
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **payload)
    path = os.path.join(directory, f"checkpoint_{epoch}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic publish
    return path


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
