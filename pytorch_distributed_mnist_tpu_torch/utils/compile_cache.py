"""The build directory of the port's compiled artifacts: one wiring for
every entry point (the CLI's train and serve commands, the smoke).

Counterpart of ``pytorch_distributed_mnist_tpu/utils/compile_cache.py``.
PyTorch compiles no programs; what the port compiles is its libraries:
one per hand-written CUDA kernel source (``ops/cuda_build.py``, ``nvcc``)
and the native host data library (``data/native.py``, ``g++``). Each is
keyed on a hash of its source and flags, so a directory that holds a
library is reused by every later run, and ``--compile-cache DIR`` /
``TPUMNIST_COMPILE_CACHE`` choose that directory. :func:`configure` sets
``ops/cuda_build.py``'s ``BUILD_ROOT``, which both builds read.

The resolution order is the reference's:

1. the explicit argument (the ``--compile-cache`` flag);
2. the ``TPUMNIST_COMPILE_CACHE`` environment variable;
3. an ambient directory a harness pinned with :func:`configure_ambient`;
4. the default ``<checkout>/build/torch_kernels/`` (gitignored).

An empty string (flag or variable) means a fresh temporary directory,
removed at exit: every library is built anew.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from typing import Optional

ENV_VAR = "TPUMNIST_COMPILE_CACHE"

_lock = threading.Lock()
_ambient: Optional[str] = None  # pinned by a harness
_pinned = False


def default_cache_dir() -> str:
    """``<checkout>/build/torch_kernels`` (gitignored)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)), "build",
                        "torch_kernels")


def resolve_cache_dir(flag: Optional[str] = None) -> str:
    """The directory :func:`configure` would use for ``flag``, with no
    side effect: ``""`` stands for a fresh temporary one."""
    if flag is not None:
        return flag
    env = os.environ.get(ENV_VAR)
    if env is not None:
        return env
    if _pinned and _ambient is not None:
        return _ambient
    return default_cache_dir()


def _fresh_dir() -> str:
    path = tempfile.mkdtemp(prefix="tpumnist-build-")
    atexit.register(shutil.rmtree, path, True)
    return path


def configure(flag: Optional[str] = None) -> str:
    """Make the resolved directory the build directory of this process
    (``ops/cuda_build.py``'s ``BUILD_ROOT``) and return it. Safe to call
    again: a later run follows its own flag, and a library already loaded
    stays loaded (its source hash is the same wherever it was built)."""
    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

    with _lock:
        path = resolve_cache_dir(flag)
        path = os.path.abspath(path) if path else _fresh_dir()
        cuda_build.BUILD_ROOT = path
        return path


def configure_ambient(path: Optional[str]) -> str:
    """The harness's entry: activate ``path`` and pin it, so later
    flag-less :func:`configure` calls follow it instead of the default
    (``None`` or ``""`` pins a fresh temporary directory)."""
    global _ambient, _pinned
    with _lock:
        _ambient = os.path.abspath(path) if path else _fresh_dir()
        _pinned = True
    return configure(_ambient)
