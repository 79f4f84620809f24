"""The port's native host data library (``data/native.py``): built from
``native/tpumnist_native.cpp`` into the build directory, a stale library
rejected whole, ``TPUMNIST_NATIVE=0`` as the only switch to NumPy, and
every entry point bitwise equal to its NumPy expression and to the JAX
package's ``data/native.py`` on the same seeded inputs; then the loader's
stacked epoch and the serving engine's staging, native against NumPy.
Twin of ``tests/test_native.py``."""

import gzip
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data import native as jax_native
from pytorch_distributed_mnist_tpu_torch.data import native
from pytorch_distributed_mnist_tpu_torch.data.loader import MNISTDataLoader
from pytorch_distributed_mnist_tpu_torch.data.mnist import (
    MNIST_MEAN,
    MNIST_STD,
    normalize_images,
    parse_idx,
    synthetic_dataset,
    write_idx,
)
from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
from pytorch_distributed_mnist_tpu_torch.utils.profiling import compile_log


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    """The port's library, built for this module, and the JAX package's:
    its own prebuilt file, or else (its ``TPUMNIST_NATIVE_LIB`` override)
    the port's build of the same source."""
    saved = os.environ.pop("TPUMNIST_NATIVE", None)
    saved_lib = os.environ.get("TPUMNIST_NATIVE_LIB")
    jax_native._lib = None
    try:
        assert native.available()
        if not jax_native.available():
            os.environ["TPUMNIST_NATIVE_LIB"] = native.build_info["path"]
            jax_native._lib = None
        assert jax_native.available()
        yield
    finally:
        if saved is not None:
            os.environ["TPUMNIST_NATIVE"] = saved
        if saved_lib is None:
            os.environ.pop("TPUMNIST_NATIVE_LIB", None)
        jax_native._lib = None


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 1: np.uint8, 8: np.uint64}[a.itemsize])


def _numpy_mode(monkeypatch):
    monkeypatch.setenv("TPUMNIST_NATIVE", "0")


# -- the build -----------------------------------------------------------------


def test_version():
    assert native.load().tm_version() == 4 == jax_native._load().tm_version()


def test_library_lives_in_the_build_directory_keyed_on_the_source():
    path = native.library_path()
    assert path == native.build_info["path"]
    assert path.startswith(cuda_build.BUILD_ROOT + os.sep)
    assert os.path.basename(os.path.dirname(path)).startswith("native-")
    assert os.path.isfile(path)
    # Never the untracked prebuilt file beside the source.
    native_dir = os.path.dirname(native.SOURCE)
    assert os.path.dirname(path) != native_dir


def test_library_path_changes_with_the_source(tmp_path, monkeypatch):
    src = tmp_path / "tpumnist_native.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", str(src))
    first = native.library_path()
    assert native.library_path() == first  # stable
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.library_path() != first


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "tpumnist_native.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native library build failed") \
            as info:
        native.build()
    assert "error" in str(info.value)
    assert not any(name.endswith(".so") for _, _, files in
                   os.walk(tmp_path / "build") for name in files)


def test_a_second_build_reuses_the_library_and_says_so():
    compile_log.reset()
    native.build()
    assert compile_log.stats()["builds"]["native"] == {
        "built": 0, "reused": 1, "seconds": 0.0}


@pytest.mark.parametrize("stale_version", [2, 3])
def test_stale_library_rejected_whole(monkeypatch, stale_version):
    class _StubLib:
        def __init__(self):
            self.tm_version = lambda: stale_version

    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: _StubLib())
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="rejected whole"):
        native.load()
    assert native._lib is None  # no entry point of it is ever used


@pytest.mark.slow
def test_library_builds_from_source(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", str(tmp_path))
    compile_log.reset()
    path = native.build()
    assert path.startswith(str(tmp_path)) and os.path.isfile(path)
    assert compile_log.stats()["builds"]["native"]["built"] == 1
    import ctypes

    lib = ctypes.CDLL(path)
    lib.tm_version.restype = ctypes.c_int
    assert lib.tm_version() == 4
    for sym in ("tm_pad_copy", "tm_cast_f32", "tm_normalize", "tm_gather",
                "tm_quant_i8", "tm_dequant_f32", "tm_idx_load"):
        assert hasattr(lib, sym)


def test_tpumnist_native_zero_is_the_numpy_switch(monkeypatch):
    _numpy_mode(monkeypatch)
    assert not native.available()
    assert native.cast_f32(np.zeros((2, 2), np.float64)) is None
    assert not native.pad_into(np.zeros((4, 2), np.float32),
                               np.zeros((2, 2), np.float32))
    assert native.quant_i8(np.zeros((2, 2), np.float32), 1.0) is None
    assert native.dequant_f32(np.zeros((2, 2), np.int8), 1.0) is None
    assert native.normalize_images(np.zeros((1, 2), np.uint8), 0.0,
                                   1.0) is None
    monkeypatch.delenv("TPUMNIST_NATIVE")
    assert native.available()


# -- IDX parse -------------------------------------------------------------------


def test_parse_idx_zero_length_dim(tmp_path):
    p = str(tmp_path / "empty-idx3-ubyte")
    write_idx(p, np.zeros((0, 28, 28), np.uint8))
    got = native.parse_idx(p)
    assert got is not None and got.shape == (0, 28, 28)
    assert jax_native.parse_idx(p).shape == got.shape


def test_parse_idx_truncated_payload(tmp_path):
    p = str(tmp_path / "trunc-idx3-ubyte")
    with open(p, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3))
        f.write(struct.pack(">III", 100, 28, 28))
        f.write(b"\x00" * 10)
    assert native.parse_idx(p) is None
    assert jax_native.parse_idx(p) is None


def test_parse_idx_huge_ndim_byte(tmp_path):
    p = str(tmp_path / "badndim")
    with open(p, "wb") as f:
        f.write(b"\x00\x00\x08\xff\x01")
    assert native.parse_idx(p) is None


@pytest.mark.parametrize("gz", [False, True])
def test_parse_idx_matches_numpy_and_jax(tmp_path, gz, monkeypatch):
    arr = np.random.default_rng(0).integers(0, 256, (7, 28, 28)).astype(
        np.uint8)
    p = str(tmp_path / "imgs-idx3-ubyte")
    write_idx(p, arr)
    if gz:
        with open(p, "rb") as f, gzip.open(p + ".gz", "wb") as g:
            g.write(f.read())
        p += ".gz"
    got = native.parse_idx(p)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, jax_native.parse_idx(p))
    _numpy_mode(monkeypatch)
    np.testing.assert_array_equal(parse_idx(p), arr)


def test_parse_idx_other_dtypes_take_numpy(tmp_path):
    # An int32 IDX payload is one the C reader does not take.
    p = str(tmp_path / "i4-idx1")
    with open(p, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x0C, 1) + struct.pack(">I", 3))
        f.write(np.array([1, -2, 3], ">i4").tobytes())
    assert native.parse_idx(p) is None
    np.testing.assert_array_equal(parse_idx(p), [1, -2, 3])


def test_parse_idx_bad_file_returns_none(tmp_path):
    p = str(tmp_path / "bad")
    with open(p, "wb") as f:
        f.write(b"\x01\x02garbage")
    assert native.parse_idx(p) is None


# -- normalize and gather ----------------------------------------------------------


def test_normalize_matches_numpy_and_jax_bitwise(monkeypatch):
    images = np.arange(256, dtype=np.uint8).repeat(16).reshape(-1, 16, 4)
    got = native.normalize_images(images, MNIST_MEAN, MNIST_STD, workers=4)
    want = ((images.astype(np.float32) / 255.0 - MNIST_MEAN)
            / MNIST_STD)[..., None]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(
        jax_native.normalize_images(images, MNIST_MEAN, MNIST_STD, 4)))
    np.testing.assert_array_equal(_bits(normalize_images(images)),
                                  _bits(got))
    _numpy_mode(monkeypatch)
    np.testing.assert_array_equal(_bits(normalize_images(images)),
                                  _bits(got))


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_gather_matches_numpy_and_jax_bitwise(workers):
    rng = np.random.default_rng(8 + workers)
    images = rng.normal(size=(64, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    idx = rng.integers(0, 64, (3, 16))
    got_imgs, got_lbls = native.gather_epoch(images, labels, idx, workers)
    want = images[idx.reshape(-1)].reshape(3, 16, 28, 28, 1)
    np.testing.assert_array_equal(_bits(got_imgs), _bits(want))
    np.testing.assert_array_equal(got_lbls,
                                  labels[idx.reshape(-1)].reshape(3, 16))
    j_imgs, j_lbls = jax_native.gather_epoch(images, labels, idx, workers)
    np.testing.assert_array_equal(_bits(got_imgs), _bits(j_imgs))
    np.testing.assert_array_equal(got_lbls, j_lbls)


def test_gather_into_caller_buffers():
    rng = np.random.default_rng(3)
    images = rng.normal(size=(40, 5)).astype(np.float32)
    labels = rng.integers(0, 10, 40).astype(np.int32)
    idx = rng.integers(0, 40, (4, 6))
    out_i = np.full((4, 6, 5), np.nan, np.float32)
    out_l = np.full((4, 6), -1, np.int32)
    got_i, got_l = native.gather_epoch(images, labels, idx, 2, out_i, out_l)
    assert np.shares_memory(got_i, out_i) and np.shares_memory(got_l, out_l)
    np.testing.assert_array_equal(out_i, images[idx])
    np.testing.assert_array_equal(out_l, labels[idx])
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_epoch(images, labels, idx, 2,
                            np.empty((4, 6, 5), np.float64), out_l)


def test_gather_out_of_bounds_raises():
    images = np.zeros((5, 2), np.float32)
    labels = np.zeros(5, np.int32)
    idx = np.array([[0, 99]])
    with pytest.raises(IndexError, match=r"outside \[0, 5\)"):
        native.gather_epoch(images, labels, idx)
    assert jax_native.gather_epoch(images, labels, idx) is None


def test_gather_takes_only_its_dtypes():
    idx = np.array([[0, 1]])
    assert native.gather_epoch(np.zeros((2, 2), np.float64),
                               np.zeros(2, np.int32), idx) is None
    assert native.gather_epoch(np.zeros((2, 2), np.float32),
                               np.zeros(2, np.int64), idx) is None


# -- serve staging entry points ----------------------------------------------------


@pytest.mark.parametrize("rows", [0, 1, 100, 128])
def test_pad_into_matches_numpy_and_jax_bitwise(rows):
    rng = np.random.default_rng(rows)
    src = rng.normal(size=(rows, 28, 28, 1)).astype(np.float32)
    got = np.full((128, 28, 28, 1), np.nan, np.float32)
    ref = np.full((128, 28, 28, 1), np.nan, np.float32)
    want = np.full((128, 28, 28, 1), np.nan, np.float32)
    assert native.pad_into(got, src, workers=4)
    assert jax_native.pad_into(ref, src, workers=4)
    want[:rows] = src
    want[rows:] = 0.0
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_pad_into_rejects_bad_layouts():
    dst = np.zeros((8, 4), np.float32)
    assert not native.pad_into(dst, np.zeros((9, 4), np.float32))
    assert not native.pad_into(dst, np.zeros((2, 5), np.float32))
    assert not native.pad_into(dst, np.zeros((2, 4), np.float64))
    assert not native.pad_into(dst, np.zeros((2, 8), np.float32)[:, ::2])
    assert not native.pad_into(np.zeros((8, 4), np.float64),
                               np.zeros((2, 4), np.float32))
    frozen = np.zeros((8, 4), np.float32)
    frozen.flags.writeable = False
    assert not native.pad_into(frozen, np.zeros((2, 4), np.float32))


def test_cast_f32_matches_numpy_and_jax_bitwise():
    arr = np.random.default_rng(11).normal(size=(129, 28, 28, 1)) * 1e3
    got = native.cast_f32(arr, workers=4)
    np.testing.assert_array_equal(_bits(got), _bits(arr.astype(np.float32)))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax_native.cast_f32(arr, 4)))


def test_cast_f32_rejects_other_dtypes():
    assert native.cast_f32(np.zeros((2, 2), np.float32)) is None
    assert native.cast_f32(np.zeros((2, 2), np.int64)) is None
    assert native.cast_f32(np.zeros((2, 8), np.float64)[:, ::2]) is None


def test_quant_i8_matches_numpy_and_jax_bitwise():
    from pytorch_distributed_mnist_tpu_torch.serve import programs

    rng = np.random.default_rng(12)
    arr = (rng.normal(size=(65, 28, 28, 1)) * 2.5).astype(np.float32)
    scale = np.float32(np.abs(arr).max() / np.float32(127.0))
    got = native.quant_i8(arr, float(scale), workers=4)
    inv = np.float32(1.0) / scale
    want = np.clip(np.rint(arr * inv), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.quant_i8(arr, float(scale),
                                                           4))
    np.testing.assert_array_equal(got, programs._quant_i8_host(arr, scale))
    half = np.arange(-8, 8, dtype=np.float32) + np.float32(0.5)
    np.testing.assert_array_equal(native.quant_i8(half, 1.0, workers=1),
                                  np.rint(half).astype(np.int8))


def test_quant_i8_non_finite_pinned(monkeypatch):
    from pytorch_distributed_mnist_tpu_torch.serve import programs

    x = np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)
    want = np.array([0, 127, -127, 1], np.int8)
    np.testing.assert_array_equal(native.quant_i8(x, 1.0, workers=1), want)
    _numpy_mode(monkeypatch)
    np.testing.assert_array_equal(
        programs._quant_i8_host(x, np.float32(1.0)), want)


def test_quant_i8_rejects_bad_inputs():
    assert native.quant_i8(np.zeros((2, 2), np.float64), 1.0) is None
    assert native.quant_i8(np.zeros((2, 2), np.float32), 0.0) is None
    assert native.quant_i8(np.zeros((2, 2), np.float32), -1.0) is None
    assert native.quant_i8(np.zeros((2, 8), np.float32)[:, ::2], 1.0) is None


def test_dequant_f32_matches_numpy_and_jax_bitwise():
    q = np.arange(-127, 128, dtype=np.int8).reshape(5, 51)
    scale = np.float32(0.0123)
    got = native.dequant_f32(q, float(scale), workers=2)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(q.astype(np.float32) * scale))
    np.testing.assert_array_equal(
        _bits(got), _bits(jax_native.dequant_f32(q, float(scale), 2)))


def test_dequant_f32_rejects_other_dtypes():
    assert native.dequant_f32(np.zeros((2, 2), np.uint8), 1.0) is None
    assert native.dequant_f32(np.zeros((2, 2), np.float32), 1.0) is None


# -- the loader and the engine -------------------------------------------------------


@pytest.mark.parametrize("into", [False, True])
def test_loader_stacked_epoch_native_equals_numpy(into, monkeypatch):
    from pytorch_distributed_mnist_tpu_torch.data.staging import host_buffer

    images, labels = synthetic_dataset(120, seed=5)
    loader = MNISTDataLoader(normalize_images(images), labels,
                             batch_size=32, train=True, seed=9, workers=3)
    loader.set_sample_epoch(2)

    def epoch():
        if not into:
            return loader.stacked_epoch()
        buf = host_buffer(loader, (loader.steps_per_epoch,
                                   loader.local_batch_size), pin=False)
        out = {k: t.numpy() for k, t in buf.items()}
        got = loader.stacked_epoch(out=out)
        assert got is out
        return out

    ep_native = epoch()
    _numpy_mode(monkeypatch)
    ep_numpy = epoch()
    for k in ("image", "label", "mask"):
        assert ep_native[k].dtype == ep_numpy[k].dtype
        np.testing.assert_array_equal(_bits(ep_native[k]),
                                      _bits(ep_numpy[k]))


def _engine(precision="int8"):
    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
    )
    from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
        int8_linear,
    )
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
    )

    kwargs = {"compute_dtype": torch.float32}
    if precision == "int8":
        kwargs["matmul"] = int8_linear
    return InferenceEngine(get_model("cnn", **kwargs),
                           init_params("cnn", 0), precision=precision,
                           fuse=False, device="cpu", workers=3)


def test_engine_preprocess_native_equals_numpy_bitwise(monkeypatch):
    engine = _engine()
    raw, _ = synthetic_dataset(33, seed=6)
    f64 = np.random.default_rng(6).normal(size=(33, 28, 28, 1))
    nat = [engine.preprocess(raw), engine.preprocess(f64)]
    _numpy_mode(monkeypatch)
    for got, want in zip(nat, [engine.preprocess(raw),
                               engine.preprocess(f64)]):
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_engine_predict_native_equals_numpy_bitwise(precision, monkeypatch):
    engine = _engine(precision)
    raw, _ = synthetic_dataset(13, seed=7)  # pads 13 -> bucket 32
    nat = engine.logits(raw)
    _numpy_mode(monkeypatch)
    np.testing.assert_array_equal(_bits(nat), _bits(engine.logits(raw)))
