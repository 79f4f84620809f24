"""The port's dataset downloader (``data/download.py``), tested offline:
a local directory of gzipped IDX files served through ``file://`` plays
the HTTP mirror, and ``urllib.request.urlopen`` is patched so that no test
reaches the network (any other scheme raises). Twin of
``tests/test_download.py`` and of the download cases of
``tests/test_supervision.py``; the port's files equal the JAX package's
byte for byte."""

import gzip
import hashlib
import os

import numpy as np
import pytest

from pytorch_distributed_mnist_tpu.data import download as jax_download
from pytorch_distributed_mnist_tpu_torch.data import download as dl
from pytorch_distributed_mnist_tpu_torch.data.download import (
    dataset_present,
    download_dataset,
)
from pytorch_distributed_mnist_tpu_torch.data.mnist import (
    load_dataset,
    synthetic_dataset,
    write_idx,
)
from pytorch_distributed_mnist_tpu_torch.runtime import supervision as sup

_GZ = (
    "train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte.gz",
)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Only ``file://`` URLs open; a test that fakes a server patches
    ``urlopen`` itself, over this."""
    import urllib.request

    real = urllib.request.urlopen

    def local_only(url, timeout=None):
        if not str(url).startswith("file:"):
            raise AssertionError(f"a test tried to reach {url}")
        return real(url, timeout=timeout)

    monkeypatch.setattr(urllib.request, "urlopen", local_only)


@pytest.fixture()
def mirror(tmp_path):
    """A file:// mirror of tiny-but-real gzipped IDX files + their md5s."""
    mdir = tmp_path / "mirror"
    mdir.mkdir()
    imgs, labels = synthetic_dataset(32, seed=7)
    t_imgs, t_labels = synthetic_dataset(16, seed=8)
    payload = {
        "train-images-idx3-ubyte.gz": imgs,
        "train-labels-idx1-ubyte.gz": labels,
        "t10k-images-idx3-ubyte.gz": t_imgs,
        "t10k-labels-idx1-ubyte.gz": t_labels,
    }
    checksums = {}
    for name, arr in payload.items():
        raw = str(mdir / name[: -len(".gz")])
        write_idx(raw, arr)
        with open(raw, "rb") as f:
            data = f.read()
        gz = gzip.compress(data)
        (mdir / name).write_bytes(gz)
        os.remove(raw)
        checksums[name] = hashlib.md5(gz).hexdigest()
    return {"url": mdir.as_uri(), "checksums": checksums,
            "expected": {"train_n": 32, "test_n": 16}}


def test_download_fetches_and_verifies(tmp_path, mirror):
    root = str(tmp_path / "data")
    d = download_dataset(root, "mnist", mirrors=[mirror["url"]],
                         checksums=mirror["checksums"])
    assert dataset_present(d)
    # The full loader path reads what was downloaded (gzip IDX).
    images, labels = load_dataset(root, "mnist", train=True,
                                  synthesize_if_missing=False)
    assert images.shape == (32, 28, 28)
    assert labels.shape == (32,)
    images, _ = load_dataset(root, "mnist", train=False,
                             synthesize_if_missing=False)
    assert images.shape == (16, 28, 28)


def test_download_idempotent(tmp_path, mirror):
    root = str(tmp_path / "data")
    d = download_dataset(root, "mnist", mirrors=[mirror["url"]],
                         checksums=mirror["checksums"])
    mtimes = {f: os.path.getmtime(os.path.join(d, f)) for f in _GZ}
    download_dataset(root, "mnist", mirrors=[mirror["url"]],
                     checksums=mirror["checksums"])
    assert mtimes == {f: os.path.getmtime(os.path.join(d, f)) for f in _GZ}


def test_download_checksum_mismatch_raises(tmp_path, mirror):
    root = str(tmp_path / "data")
    bad = dict(mirror["checksums"])
    bad["train-images-idx3-ubyte.gz"] = "0" * 32
    with pytest.raises(OSError, match="checksum mismatch"):
        download_dataset(root, "mnist", mirrors=[mirror["url"]], checksums=bad)
    # The corrupt file must not have been left behind.
    assert not os.path.isfile(
        os.path.join(root, "mnist", "train-images-idx3-ubyte.gz")
    )


def test_download_repairs_corrupt_file(tmp_path, mirror):
    root = str(tmp_path / "data")
    d = os.path.join(root, "mnist")
    os.makedirs(d)
    target = os.path.join(d, "train-images-idx3-ubyte.gz")
    with open(target, "wb") as f:
        f.write(b"truncated garbage")
    download_dataset(root, "mnist", mirrors=[mirror["url"]],
                     checksums=mirror["checksums"])
    assert hashlib.md5(open(target, "rb").read()).hexdigest() == (
        mirror["checksums"]["train-images-idx3-ubyte.gz"]
    )


def test_download_no_checksum_sanity_gate(tmp_path, mirror):
    """Without pinned checksums the gunzip-IDX-magic gate still rejects junk."""
    mdir = tmp_path / "junk_mirror"
    mdir.mkdir()
    for name in _GZ:
        (mdir / name).write_bytes(gzip.compress(b"<html>not found</html>"))
    with pytest.raises(OSError, match="not a gzipped IDX"):
        download_dataset(str(tmp_path / "data2"), "mnist",
                         mirrors=[mdir.as_uri()], checksums={})


def test_download_nonzero_process_is_noop(tmp_path, mirror):
    root = str(tmp_path / "data")
    download_dataset(root, "mnist", mirrors=[mirror["url"]],
                     checksums=mirror["checksums"], process_index=1)
    assert not dataset_present(os.path.join(root, "mnist"))


def test_load_dataset_download_flag(tmp_path, mirror, monkeypatch):
    """load_dataset(download=True) pulls from the mirror list when absent."""
    monkeypatch.setitem(dl.MIRRORS, "mnist", (mirror["url"],))
    monkeypatch.setitem(dl.CHECKSUMS, "mnist", mirror["checksums"])
    root = str(tmp_path / "data")
    images, labels = load_dataset(root, "mnist", train=True,
                                  synthesize_if_missing=False, download=True)
    assert images.shape == (32, 28, 28)
    # Second call takes the already-present fast path.
    images2, _ = load_dataset(root, "mnist", train=True,
                              synthesize_if_missing=False, download=True)
    np.testing.assert_array_equal(images, images2)


def test_download_unreachable_mirror_raises(tmp_path):
    with pytest.raises(OSError):
        download_dataset(str(tmp_path / "data"), "mnist",
                         mirrors=[(tmp_path / "missing").as_uri()],
                         checksums={})


def test_fetch_retries_flaky_server(tmp_path, mirror, monkeypatch):
    """Run-supervision satellite: one mirror used to get exactly one shot
    per file. A flaky server — connection reset on the first attempt, a
    TRUNCATED body on the second (which publishes a file that only the
    per-attempt re-verification can reject), good bytes on the third —
    must be survived by the bounded backoff retry inside _fetch_verified,
    without ever falling through to the next mirror or the caller."""
    import io
    import time as _time
    import urllib.parse
    import urllib.request

    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        failure_events,
    )

    mdir = urllib.parse.urlparse(mirror["url"]).path
    good = {name: open(os.path.join(mdir, name), "rb").read()
            for name in _GZ}

    class _Resp(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    per_url = {}

    def flaky_urlopen(url, timeout=None):
        name = url.rsplit("/", 1)[1]
        n = per_url[name] = per_url.get(name, 0) + 1
        if n == 1:
            raise urllib.error.URLError("connection reset (fake)")
        if n == 2:
            return _Resp(good[name][: len(good[name]) // 2])  # truncated
        return _Resp(good[name])

    delays = []
    monkeypatch.setattr(urllib.request, "urlopen", flaky_urlopen)
    monkeypatch.setattr(_time, "sleep", delays.append)
    failure_events.reset()
    root = str(tmp_path / "data")
    d = download_dataset(root, "mnist", mirrors=["http://fake.test/m"],
                         checksums=mirror["checksums"])
    assert dataset_present(d)
    # Every file needed exactly 3 attempts, each retry backed off, and
    # the near-misses are visible in the failure-event log.
    assert all(n == 3 for n in per_url.values())
    assert len(delays) == 2 * len(_GZ)
    assert all(dl >= 0.5 for dl in delays)
    kinds = [e["kind"] for e in failure_events.snapshot()]
    assert kinds.count("download_retry") == 2 * len(_GZ)
    # The verified files actually load.
    images, _ = load_dataset(root, "mnist", train=True,
                             synthesize_if_missing=False)
    assert images.shape == (32, 28, 28)


def test_fetch_retries_exhausted_tries_next_mirror(tmp_path, mirror,
                                                   monkeypatch):
    """A mirror that stays bad for all attempts is given up on, and the
    next mirror serves the file — retries nest INSIDE the mirror loop."""
    import io
    import time as _time
    import urllib.parse
    import urllib.request

    mdir = urllib.parse.urlparse(mirror["url"]).path
    good = {name: open(os.path.join(mdir, name), "rb").read()
            for name in _GZ}

    class _Resp(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    calls = {"bad": 0, "good": 0}

    def urlopen(url, timeout=None):
        if url.startswith("http://bad.test"):
            calls["bad"] += 1
            raise urllib.error.URLError("down (fake)")
        calls["good"] += 1
        return _Resp(good[url.rsplit("/", 1)[1]])

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(_time, "sleep", lambda _d: None)
    d = download_dataset(str(tmp_path / "data"), "mnist",
                         mirrors=["http://bad.test/m", "http://good.test/m"],
                         checksums=mirror["checksums"], attempts=2)
    assert dataset_present(d)
    assert calls["bad"] == 2 * len(_GZ)  # attempts per file, then moved on
    assert calls["good"] == len(_GZ)


def test_the_port_and_jax_download_the_same_bytes(tmp_path, mirror):
    port_dir = download_dataset(str(tmp_path / "port"), "mnist",
                                mirrors=[mirror["url"]],
                                checksums=mirror["checksums"])
    jax_dir = jax_download.download_dataset(
        str(tmp_path / "jax"), "mnist", mirrors=[mirror["url"]],
        checksums=mirror["checksums"])
    for name in _GZ:
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read()
    assert dl.CHECKSUMS == jax_download.CHECKSUMS
    assert dl.MIRRORS == jax_download.MIRRORS


def test_fetch_is_a_fault_point(tmp_path, mirror, monkeypatch):
    monkeypatch.setenv("TPUMNIST_FAULT", "download_fetch:*:raise:1")
    sup.configure(0)
    try:
        with pytest.raises(sup.InjectedFault):
            download_dataset(str(tmp_path / "data"), "mnist",
                             mirrors=[mirror["url"]],
                             checksums=mirror["checksums"])
        # The first fetch went through; the second fired.
        assert os.path.isfile(os.path.join(
            tmp_path, "data", "mnist", _GZ[0]))
    finally:
        monkeypatch.delenv("TPUMNIST_FAULT")
        sup.configure(0)


def test_mnist_download_handler_reraises_injected_fault(tmp_path,
                                                        monkeypatch):
    def boom(root, name):
        raise sup.InjectedFault("injected fault at download_fetch")

    monkeypatch.setattr(dl, "download_dataset", boom)
    with pytest.raises(sup.InjectedFault):
        load_dataset(str(tmp_path), "mnist", train=True,
                     synthesize_if_missing=True, download=True)


def test_mnist_download_handler_still_funnels_real_failures(
        tmp_path, monkeypatch, capsys):
    import zlib

    def boom(root, name):
        raise zlib.error("Error -3 while decompressing data")

    monkeypatch.setattr(dl, "download_dataset", boom)
    images, labels = load_dataset(str(tmp_path), "mnist", train=True,
                                  synthesize_if_missing=True, download=True)
    assert images.shape[0] == labels.shape[0] > 0  # synthetic fallback
    assert "WARNING: download" in capsys.readouterr().out


def test_cli_download_stage_reraises_injected_fault(tmp_path, monkeypatch):
    import argparse

    from pytorch_distributed_mnist_tpu_torch import cli

    def boom(root, name):
        raise sup.InjectedFault("injected fault at download_fetch")

    monkeypatch.setattr(dl, "download_dataset", boom)
    args = argparse.Namespace(dataset="mnist", download=True,
                              root=str(tmp_path))
    with pytest.raises(sup.InjectedFault):
        cli._build_loaders(args, seed=0, axis=None)


def test_cli_download_flag_trains_on_the_fetched_files(tmp_path, mirror,
                                                       monkeypatch, capsys):
    from pytorch_distributed_mnist_tpu_torch import cli

    monkeypatch.setitem(dl.MIRRORS, "mnist", (mirror["url"],))
    monkeypatch.setitem(dl.CHECKSUMS, "mnist", mirror["checksums"])
    summary = cli.run(cli.build_parser().parse_args([
        "--download", "--root", str(tmp_path / "data"), "--model", "linear",
        "--batch-size", "16", "--epochs", "1", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ck")]))
    assert not summary["dataset_synthesized"]
    assert summary["epochs_run"] == 1
    out = capsys.readouterr().out
    assert "Epoch: 0/1" in out and "dataset: synthetic" not in out
