"""ctypes binding of the native C++ host data library
(``native/tpumnist_native.cpp``).

Counterpart of ``pytorch_distributed_mnist_tpu/data/native.py``: IDX
parsing (raw and gzip), the normalize, the epoch gather, and the serving
plane's pad, quantize and cast run in multithreaded C++, over the worker
count of the CLI's ``-j/--workers``.

The library is built from the source in the checkout at first use
(``g++ -O3 -std=c++17 -fPIC -shared -pthread -lz``, the flags of
``native/Makefile``) into the build directory of ``ops/cuda_build.py``
(``utils/compile_cache.py`` picks it), under ``native-<hash>/``, keyed on
a hash of the source and the flags, written to ``<lib>.tmp<pid>`` and
renamed into place. A prebuilt ``native/libtpumnist_native.so`` is never
loaded: nothing says it matches the source. A failed build raises with
the compiler's output, and a library whose ``tm_version()`` is below 4 is
rejected whole (raises): a partial surface would mix native and NumPy
behavior per call site.

The NumPy path runs only when asked for: ``TPUMNIST_NATIVE=0`` (then
every entry point here returns ``None``/``False`` and the caller runs its
NumPy expression), or an input the C entry point does not take (a dtype
or layout other than its own), where each function returns ``None`` or
``False`` exactly as the reference's does. Every C entry point is
bitwise equal to its NumPy expression. ctypes releases the GIL for the
call, so a gather on the scan trainer's prefetch thread does not hold
the interpreter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "tpumnist_native.cpp")
LIB_NAME = "libtpumnist_native.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
LD_FLAGS = ("-lz",)
VERSION = 4
ENV = "TPUMNIST_NATIVE"
DEFAULT_WORKERS = 4

_lock = threading.Lock()
_lib = None
#: {"path", "seconds" (0.0 when an earlier build was reused)} of the load.
build_info: dict = {}


def enabled() -> bool:
    """False when ``TPUMNIST_NATIVE=0`` asks for the NumPy path."""
    return os.environ.get(ENV, "") != "0"


def library_path() -> str:
    """Where the library of this source and these flags lives in the
    build directory."""
    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(cuda_build.BUILD_ROOT,
                        f"native-{digest.hexdigest()[:16]}", LIB_NAME)


def build() -> str:
    """Compile the library unless the build directory holds it; returns
    its path. Raises with the compiler's output when the build fails."""
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        compile_log,
    )

    if not os.path.isfile(SOURCE):
        raise RuntimeError(f"native library source {SOURCE} is missing: the "
                           f"host data path is built from the checkout")
    target = library_path()
    if os.path.isfile(target):
        compile_log.record_build("native", 0.0, built=False)
        build_info.update(path=target, seconds=0.0)
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.tmp{os.getpid()}"
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native library build failed ({' '.join(cmd)}, "
                           f"exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, target)  # atomic: a reader never sees half a file
    compile_log.record_build("native", seconds, built=True)
    build_info.update(path=target, seconds=seconds)
    return target


def _declare(lib) -> None:
    """Every entry point's ``argtypes``/``restype``: pointers the per-batch
    serve calls pass as raw integers are ``c_void_p`` (left undeclared,
    ctypes would cut a pointer to a 32-bit int)."""
    P, I64, I, F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_float)
    lib.tm_idx_load.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.tm_idx_load.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), I, ctypes.POINTER(ctypes.c_int64)]
    lib.tm_free.restype = None
    lib.tm_free.argtypes = [P]
    lib.tm_normalize.restype = I
    lib.tm_normalize.argtypes = [P, P, I64, F, F, I]
    lib.tm_gather.restype = I
    lib.tm_gather.argtypes = [P, P, P, I64, I64, I64, P, P, I]
    lib.tm_pad_copy.restype = I
    lib.tm_pad_copy.argtypes = [P, I64, I64, P, I64, I]
    lib.tm_cast_f32.restype = I
    lib.tm_cast_f32.argtypes = [P, P, I64, I]
    lib.tm_quant_i8.restype = I
    lib.tm_quant_i8.argtypes = [P, P, I64, F, I]
    lib.tm_dequant_f32.restype = I
    lib.tm_dequant_f32.argtypes = [P, P, I64, F, I]


def load():
    """The loaded library, built at first use; ``None`` when
    ``TPUMNIST_NATIVE=0``. Raises when the build fails or the library is
    stale (``tm_version() < 4``)."""
    global _lib
    if not enabled():
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.tm_version.restype = ctypes.c_int
            lib.tm_version.argtypes = []
            version = lib.tm_version()
            if version < VERSION:
                raise RuntimeError(
                    f"native library {build_info.get('path')} reports "
                    f"tm_version() {version}, below {VERSION}: rejected "
                    f"whole (rebuild it from {SOURCE})")
            _declare(lib)
            _lib = lib
    return _lib


def available() -> bool:
    """True when the native path runs (built at first call)."""
    return load() is not None


def parse_idx(path: str) -> Optional[np.ndarray]:
    """Native IDX parse (uint8 payloads, the MNIST files), one read and
    inflate pass; None for anything the C reader does not take (another
    dtype, a damaged file: the NumPy parser then raises the real error)
    or under ``TPUMNIST_NATIVE=0``."""
    lib = load()
    if lib is None:
        return None
    dims = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int(0)
    count = ctypes.c_int64(0)
    buf = lib.tm_idx_load(path.encode(), dims, ctypes.byref(ndim), 8,
                          ctypes.byref(count))
    if not buf:
        return None
    try:
        shape = tuple(int(dims[i]) for i in range(ndim.value))
        arr = np.ctypeslib.as_array(buf, shape=(int(count.value),)).copy() \
            if count.value else np.empty(0, np.uint8)
    finally:
        lib.tm_free(ctypes.cast(buf, ctypes.c_void_p))
    return arr.reshape(shape)


def normalize_images(images: np.ndarray, mean: float, std: float,
                     workers: int = DEFAULT_WORKERS) -> Optional[np.ndarray]:
    """``(x / 255 - mean) / std`` of uint8 images in float32, the NumPy
    expression's op sequence; ``images.shape + (1,)``, or None."""
    lib = load()
    if lib is None or images.dtype != np.uint8:
        return None
    flat = np.ascontiguousarray(images).reshape(-1)
    out = np.empty(flat.size, np.float32)
    lib.tm_normalize(flat.ctypes.data, out.ctypes.data, flat.size, mean, std,
                     workers)
    return out.reshape(images.shape + (1,))


def gather_epoch(images: np.ndarray, labels: np.ndarray,
                 index_matrix: np.ndarray, workers: int = DEFAULT_WORKERS,
                 out_images: Optional[np.ndarray] = None,
                 out_labels: Optional[np.ndarray] = None) \
        -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The stacked-epoch gather: images ``(N, ...)`` float32, labels
    ``(N,)`` int32 and an ``(S, B)`` index matrix give ``((S, B, ...)
    images, (S, B) labels)``. ``out_images`` / ``out_labels`` (C-contiguous
    float32 / int32 of those sizes, such as pinned host buffers) receive
    the gather. None for non-float32 images or labels that are not int32.
    An index out of range raises ``IndexError``."""
    lib = load()
    if lib is None or images.dtype != np.float32 \
            or labels.dtype != np.int32:
        return None
    images = np.ascontiguousarray(images)
    labels = np.ascontiguousarray(labels)
    idx = np.ascontiguousarray(index_matrix, np.int64).reshape(-1)
    row = int(np.prod(images.shape[1:]))
    shape = index_matrix.shape + images.shape[1:]
    if out_images is None:
        out_images = np.empty(shape, np.float32)
    if out_labels is None:
        out_labels = np.empty(index_matrix.shape, np.int32)
    if (out_images.dtype != np.float32 or out_labels.dtype != np.int32
            or out_images.size != idx.size * row
            or out_labels.size != idx.size
            or not out_images.flags["C_CONTIGUOUS"]
            or not out_labels.flags["C_CONTIGUOUS"]):
        raise ValueError("gather_epoch: out_images/out_labels must be "
                         "C-contiguous float32/int32 of the gather's size")
    rc = lib.tm_gather(images.ctypes.data, labels.ctypes.data,
                       idx.ctypes.data, idx.size, row, images.shape[0],
                       out_images.ctypes.data, out_labels.ctypes.data,
                       workers)
    if rc != 0:
        raise IndexError(f"gather_epoch: an index is outside "
                         f"[0, {images.shape[0]})")
    return out_images.reshape(shape), out_labels.reshape(index_matrix.shape)


def pad_into(dst: np.ndarray, src: np.ndarray,
             workers: int = DEFAULT_WORKERS) -> bool:
    """The serve staging fill ``dst[:len(src)] = src; dst[len(src):] = 0``.
    False (the caller runs the NumPy fill) unless both are float32,
    C-contiguous, ``dst`` writeable, and the rows fit."""
    lib = load()
    if lib is None:
        return False
    if dst.dtype != np.float32 or src.dtype != np.float32:
        return False
    if not (dst.flags["C_CONTIGUOUS"] and src.flags["C_CONTIGUOUS"]):
        return False
    if not dst.flags["WRITEABLE"]:
        return False
    if dst.ndim < 1 or src.shape[1:] != dst.shape[1:] \
            or src.shape[0] > dst.shape[0]:
        return False
    row = int(np.prod(dst.shape[1:], dtype=np.int64))
    rc = lib.tm_pad_copy(src.ctypes.data, src.shape[0], row, dst.ctypes.data,
                         dst.shape[0], workers)
    return rc == 0


def quant_i8(arr: np.ndarray, scale: float,
             workers: int = DEFAULT_WORKERS) -> Optional[np.ndarray]:
    """float32 -> int8: ``clip(rint(x * (1/scale)), -127, 127)``, round
    half to even, NaN -> 0. None unless ``arr`` is C-contiguous float32
    and ``scale > 0``."""
    lib = load()
    if lib is None:
        return None
    if arr.dtype != np.float32 or not arr.flags["C_CONTIGUOUS"]:
        return None
    if not (scale > 0.0):
        return None
    out = np.empty(arr.shape, np.int8)
    rc = lib.tm_quant_i8(arr.ctypes.data, out.ctypes.data, arr.size, scale,
                         workers)
    return out if rc == 0 else None


def dequant_f32(arr: np.ndarray, scale: float,
                workers: int = DEFAULT_WORKERS) -> Optional[np.ndarray]:
    """int8 -> float32: ``float(q) * scale``. None unless ``arr`` is
    C-contiguous int8."""
    lib = load()
    if lib is None:
        return None
    if arr.dtype != np.int8 or not arr.flags["C_CONTIGUOUS"]:
        return None
    out = np.empty(arr.shape, np.float32)
    rc = lib.tm_dequant_f32(arr.ctypes.data, out.ctypes.data, arr.size,
                            scale, workers)
    return out if rc == 0 else None


def cast_f32(arr: np.ndarray,
             workers: int = DEFAULT_WORKERS) -> Optional[np.ndarray]:
    """float64 -> float32, round to nearest even (NumPy's ``astype``).
    None unless ``arr`` is C-contiguous float64."""
    lib = load()
    if lib is None:
        return None
    if arr.dtype != np.float64 or not arr.flags["C_CONTIGUOUS"]:
        return None
    out = np.empty(arr.shape, np.float32)
    rc = lib.tm_cast_f32(arr.ctypes.data, out.ctypes.data, arr.size, workers)
    return out if rc == 0 else None
