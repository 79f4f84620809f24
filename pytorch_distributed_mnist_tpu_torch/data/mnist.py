"""MNIST-family dataset IO: the IDX format, the reference normalize, a
deterministic synthetic dataset and ``load_dataset`` over ``--root``.

Counterpart of ``pytorch_distributed_mnist_tpu/data/mnist.py`` (the
pure-NumPy paths; the port has no native loader). ``normalize_images`` is
the reference transform ``ToTensor`` + ``Normalize((0.1307,), (0.3081,))``
as one float32 NumPy expression; the serving plane's on-device normalize
(``serve/programs.py::fused_normalize``) is bitwise equal to it.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081

_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def parse_idx(path: str) -> np.ndarray:
    """Parse an IDX file (the MNIST on-disk format), gunzipping ``.gz``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    zero, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    if zero != 0 or dtype_code not in _IDX_DTYPES:
        raise ValueError(f"{path}: not an IDX file (magic {data[:4]!r})")
    dims = struct.unpack(f">{ndim}I", data[4 : 4 + 4 * ndim])
    dtype = _IDX_DTYPES[dtype_code]
    arr = np.frombuffer(data, dtype, offset=4 + 4 * ndim).reshape(dims)
    if arr.dtype.byteorder == ">":
        return arr.astype(arr.dtype.newbyteorder("="))
    return arr


def write_idx(path: str, arr: np.ndarray) -> None:
    """Write ``arr`` (uint8) in IDX format; inverse of ``parse_idx``."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


# 5x7 bitmap glyphs for digits 0-9; rendered, jittered, and noised into
# 28x28 uint8 images. Deterministic in (n, seed).
_GLYPHS = [
    "01110 10001 10011 10101 11001 10001 01110",
    "00100 01100 00100 00100 00100 00100 01110",
    "01110 10001 00001 00010 00100 01000 11111",
    "11111 00010 00100 00010 00001 10001 01110",
    "00010 00110 01010 10010 11111 00010 00010",
    "11111 10000 11110 00001 00001 10001 01110",
    "00110 01000 10000 11110 10001 10001 01110",
    "11111 00001 00010 00100 01000 01000 01000",
    "01110 10001 10001 01110 10001 10001 01110",
    "01110 10001 10001 01111 00001 00010 01100",
]


def _glyph_array(digit: int) -> np.ndarray:
    rows = _GLYPHS[digit].split()
    return np.array([[int(c) for c in row] for row in rows], dtype=np.float32)


def synthetic_dataset(
    n: int, seed: int = 0, num_classes: int = 10
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped synthetic data: (images u8 (n,28,28), labels u8)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.uint8)
    images = np.zeros((n, 28, 28), dtype=np.uint8)
    glyphs = [np.kron(_glyph_array(d), np.ones((3, 3), np.float32)) for d in range(10)]
    gh, gw = glyphs[0].shape  # 21 x 15
    offs = rng.integers(0, [28 - gh + 1, 28 - gw + 1], size=(n, 2))
    intensity = rng.uniform(0.6, 1.0, size=n)
    noise = rng.normal(0.0, 12.0, size=(n, 28, 28))
    for i in range(n):
        r, c = offs[i]
        canvas = np.zeros((28, 28), np.float32)
        canvas[r : r + gh, c : c + gw] = glyphs[labels[i]] * 255.0 * intensity[i]
        images[i] = np.clip(canvas + noise[i], 0, 255).astype(np.uint8)
    return images, labels


_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def dataset_dir(root: str, name: str) -> str:
    """Directory holding the IDX files of dataset ``name`` under ``root``:
    torchvision's layout (``root/MNIST/raw``), ``root/<name>/`` or
    ``root/`` itself."""
    tv = {"mnist": "MNIST/raw", "fashion_mnist": "FashionMNIST/raw"}.get(
        name, name)
    for sub in (tv, name, ""):
        d = os.path.join(root, sub) if sub else root
        if os.path.isfile(os.path.join(d, _FILES[True][0])) or os.path.isfile(
                os.path.join(d, _FILES[True][0] + ".gz")):
            return d
    return os.path.join(root, name)


def load_dataset(root: str, name: str = "mnist", train: bool = True,
                 synthesize_if_missing: bool = True,
                 synthetic_train_size: int = 60000,
                 synthetic_test_size: int = 10000,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``(images u8 (N, 28, 28), labels u8)`` from the split's IDX files
    under ``root`` (plain or ``.gz``), else the synthetic dataset (train
    and test drawn from disjoint seeds), else ``FileNotFoundError``. Real
    files always win. There is no download: nothing is fetched."""
    d = dataset_dir(root, name)
    img_name, lbl_name = _FILES[train]
    for suffix in ("", ".gz"):
        ip = os.path.join(d, img_name + suffix)
        lp = os.path.join(d, lbl_name + suffix)
        if os.path.isfile(ip) and os.path.isfile(lp):
            images, labels = parse_idx(ip), parse_idx(lp)
            if images.shape[0] != labels.shape[0]:
                raise ValueError(f"{ip}: image/label count mismatch")
            return images, labels
    if not synthesize_if_missing:
        raise FileNotFoundError(
            f"no {name} IDX files under {root!r} (looked in {d!r}); place "
            "train-images-idx3-ubyte[.gz] etc. there, or enable the "
            "synthetic fallback")
    n = synthetic_train_size if train else synthetic_test_size
    return synthetic_dataset(n, seed=seed + (0 if train else 1_000_003))


def normalize_images(images: np.ndarray) -> np.ndarray:
    """uint8 (N,28,28) -> float32 (N,28,28,1), reference transform."""
    x = images.astype(np.float32) / 255.0
    x = (x - MNIST_MEAN) / MNIST_STD
    return x[..., None]
