"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface; kernels
may share headers of ``csrc/`` (``#include "mma_common.cuh"``, which
includes ``stage_common.cuh``). At first use it is compiled with ``nvcc``
for ``sm_90a`` (Hopper) into a shared library under the checkout's
``build/torch_kernels/`` and loaded with ``ctypes``. The library's
directory is keyed on a hash of the source, of the headers it includes
from ``csrc/`` (directly or through another header) and of the flags, so
an edited source or header rebuilds and an unchanged one is reused.
No PyTorch header is compiled: a build takes seconds, not minutes.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``. :func:`build` starts one ``nvcc`` per source, all at
once, so a caller that needs several kernels (``chip_smoke.py``) pays for
the slowest build only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# The flash entries' shape, scale and type arguments: b, h, t, d, the
# element strides sb, st, sh of q/k/v, scale, causal, bf16, device, stream.
_FLASH_TAIL = [_I, _I, _I, _I, _L, _L, _L, _F, _I, _I, _I, _P]

# name -> {C symbol: (argtypes, restype)}. Every pointer and the stream are
# c_void_p: left undeclared, ctypes would pass a Python int as a 32-bit int
# and cut the pointer.
KERNELS: Dict[str, Dict[str, tuple]] = {
    "matmul_i8": {
        # a, b, c, m, n, k, lda, ldb, ldc, splits, cluster, device, stream
        "matmul_i8_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P], _I),
    },
    "xent": {
        # logits, labels, loss, lse, b, c, ld, device, stream
        "xent_fwd_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        # logits, labels, lse, g, dlogits, b, c, ld, ldd, device, stream
        "xent_bwd_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                            _I),
    },
    "adam": {
        # rows, n_leaves, first, hypers, lr, b1, b2, eps, eps_root, count,
        # hypers_out, device, stream
        "adam_leaves_launch": ([_P, _I, _P] + [_P] * 8 + [_I, _P], _I),
    },
    "flash": {
        # q, k, v, o, lse, then the tail
        "flash_fwd_launch": ([_P] * 5 + _FLASH_TAIL, _I),
        # q, k, v, o, dout, lse, delta, dq, then the tail
        "flash_dq_launch": ([_P] * 8 + _FLASH_TAIL, _I),
        # q, k, v, dout, lse, delta, dk, dv, then the tail
        "flash_dkv_launch": ([_P] * 8 + _FLASH_TAIL, _I),
    },
    "flash_fwd": {
        # q, k, v, o, lse, then the tail (bf16 must be 1)
        "flash_fwd_mma_launch": ([_P] * 5 + _FLASH_TAIL, _I),
    },
    "flash_bwd": {
        # q, k, v, o, dout, lse, dq, dk, dv, then the tail (bf16 must be 1)
        "flash_bwd_launch": ([_P] * 9 + _FLASH_TAIL, _I),
    },
    "flash_bwd_tiled": {
        # q, k, v, o, dout, lse, delta, dq, dk, dv, then the tail (bf16
        # must be 1)
        "flash_bwd_tiled_launch": ([_P] * 10 + _FLASH_TAIL, _I),
    },
    "flash_tf32": {
        # q, k, v, o, lse, then the tail (bf16 must be 0)
        "flash_fwd_tf32_launch": ([_P] * 5 + _FLASH_TAIL, _I),
        # q, k, v, o, dout, lse, delta, dq, dk, dv, then the tail (bf16
        # must be 0)
        "flash_bwd_tf32_launch": ([_P] * 10 + _FLASH_TAIL, _I),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": wall time of the build (0.0 when cached),
#: "log": nvcc's output (ptxas register and shared-memory lines)}
build_info: Dict[str, dict] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(source: bytes) -> list:
    """The ``csrc/`` headers a source includes (``#include "x.cuh"``),
    sorted."""
    return sorted(m.decode() for m in _INCLUDE.findall(source))


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    with open(source_path(name), "rb") as f:
        source = f.read()
    digest.update(source)
    # Every csrc/ header the source includes, directly or through another
    # header, each once, in the order they are first found.
    where = os.path.dirname(source_path(name))
    pending, seen = local_headers(source), []
    while pending:
        header = pending.pop(0)
        if header in seen:
            continue
        seen.append(header)
        with open(os.path.join(where, header), "rb") as f:
            text = f.read()
        digest.update(text)
        pending.extend(local_headers(text))
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, f"{name}-{digest.hexdigest()[:16]}",
                        f"lib{name}.so")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's usual place; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the "
        "port's CUDA kernels are built from source at first use")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every kernel in ``names`` (default: all) that has no
    library yet, one ``nvcc`` process per source, all started together.
    Returns :data:`build_info` for those names; raises with nvcc's output
    when any build fails."""
    names = list(KERNELS if names is None else names)
    with _lock:
        running = {}
        for name in names:
            target = library_path(name)
            if os.path.isfile(target):
                build_info.setdefault(name, {"seconds": 0.0, "log": ""})
                continue
            os.makedirs(os.path.dirname(target), exist_ok=True)
            tmp = f"{target}.tmp{os.getpid()}"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, target, time.perf_counter())
        failed = []
        for name, (proc, tmp, target, t0) in running.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, target)  # atomic: a reader never sees half a file
            build_info[name] = {"seconds": seconds, "log": log}
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: build_info[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use, with every symbol's
    ``argtypes``/``restype`` declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            for symbol, (argtypes, restype) in KERNELS[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = restype
            _loaded[name] = lib
    return lib
