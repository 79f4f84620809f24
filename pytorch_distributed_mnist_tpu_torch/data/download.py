"""Dataset acquisition: fetch + verify the four IDX files.

Counterpart of ``pytorch_distributed_mnist_tpu/data/download.py`` (host
code only, so a copy with the port's imports). The reference gets this
from torchvision's ``datasets.MNIST(root, download=True)``; this is the
first-party equivalent: stdlib-only HTTP(S) fetch of the gzipped IDX
files into ``root/<name>/``, checksum verification, atomic writes
(tmp + ``os.replace``), and skip-if-present idempotence.

Design notes:

- ``urllib`` also serves ``file://`` URLs, so the whole path is testable
  offline with a local mirror directory (tests/test_torch_download.py) — the
  no-egress analog of torchvision's mirror list.
- Checksums are MD5 (the values every MNIST mirror publishes and
  torchvision pins); callers can pass their own ``checksums`` for private
  mirrors. Verification failure deletes the file and raises — a truncated
  or tampered download never becomes load-bearing.
- Only process 0 of a multi-host job should download (the reference gets
  the same property with a world-size-1 pre-download run);
  ``download_dataset`` takes ``process_index`` for that gate.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import urllib.error
import urllib.request
from typing import Dict, Iterable, Optional, Sequence

_GZ_FILES = (
    "train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte.gz",
)

# Public mirror lists; first reachable wins.
MIRRORS: Dict[str, Sequence[str]] = {
    "mnist": (
        "https://ossci-datasets.s3.amazonaws.com/mnist/",
        "http://yann.lecun.com/exdb/mnist/",
    ),
    "fashion_mnist": (
        "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/",
    ),
}

# MD5 of each .gz as published by the mirrors (and pinned by torchvision).
CHECKSUMS: Dict[str, Dict[str, str]] = {
    "mnist": {
        "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
        "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
        "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
        "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
    },
    "fashion_mnist": {
        "train-images-idx3-ubyte.gz": "8d4fb7e6c68d591d4c3dfef9ec88bf0d",
        "train-labels-idx1-ubyte.gz": "25c81989df183df01b3e8a0aad5dffbe",
        "t10k-images-idx3-ubyte.gz": "bef4ecab320f06d8554ea6380940ec79",
        "t10k-labels-idx1-ubyte.gz": "bb300cfdad3c16e7a12a480ee83cd310",
    },
}


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _looks_like_idx_gz(path: str) -> bool:
    """Cheap sanity check used when no checksum is pinned: gunzips and has
    an IDX magic (0x0000 08xx)."""
    try:
        with gzip.open(path, "rb") as f:
            head = f.read(4)
    except Exception:
        # Broad on purpose: this predicate answers
        # "is the published file usable?" — truncated-after-header
        # (EOFError), unreadable (OSError), AND corrupt mid-stream
        # (zlib.error, not an OSError subclass) must all answer False so
        # the fetch loop deletes and retries, never crashes.
        return False
    return len(head) == 4 and head[0] == 0 and head[1] == 0 and head[2] == 8


class _PermanentFetchError(Exception):
    """A per-URL failure retrying cannot fix (HTTP 4xx: the mirror is up
    and definitively does not serve this file) — fail over to the next
    mirror immediately instead of burning backoff attempts."""


def _fetch(url: str, dest: str, timeout: float) -> None:
    from pytorch_distributed_mnist_tpu_torch.runtime.supervision import (
        maybe_fault,
    )

    maybe_fault("download_fetch")
    # pid-unique tmp: concurrent downloaders (multiple hosts sharing a
    # filesystem) each publish atomically instead of interleaving writes.
    tmp = f"{dest}.tmp{os.getpid()}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
            # getattr: test doubles (and file:// responses on some
            # platforms) expose a bare file object without headers.
            headers = getattr(r, "headers", None)
            expected = headers.get("Content-Length") if headers else None
            received = 0
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                received += len(chunk)
                f.write(chunk)
            # A connection torn mid-body ends the chunk loop exactly like
            # a complete one (read() reports EOF either way); only the
            # byte count knows. OSError feeds _fetch_verified's
            # delete-and-retry path instead of publishing a truncated
            # file the gzip gate must then catch.
            if expected is not None and received != int(expected):
                raise OSError(f"short read from {url}: got {received} "
                              f"of {expected} bytes")
        os.replace(tmp, dest)  # atomic publish, like checkpoint writes
    finally:
        if os.path.exists(tmp):  # mid-stream failure: no orphan partials
            os.remove(tmp)


def _fetch_verified(url: str, dest: str, timeout: float,
                    want_md5: Optional[str], attempts: int = 3) -> None:
    """Fetch ``url`` and verify it, retrying with exponential backoff.

    One mirror used to get exactly one shot: a transient reset (or a
    proxy serving one truncated body) failed the file over to the next
    mirror — or, for the single-mirror datasets, failed the download
    outright. Each attempt now re-verifies the published file (pinned
    md5, else the gunzip+IDX-magic sanity gate — a truncated-but-
    well-formed gzip prefix passes a naive existence check but not this)
    and a verification failure deletes the file and retries like any
    network error, with backoff + jitter so multiple hosts hammering a
    shared mirror de-synchronize. Raises the last error when ``attempts``
    are exhausted; the caller's mirror loop then moves on.
    """
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        failure_events,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.watchdog import (
        retry_with_backoff,
    )

    def attempt() -> None:
        try:
            _fetch(url, dest, timeout)
        except urllib.error.HTTPError as exc:
            if exc.code < 500:
                # Deterministic refusal (404 on a dead mirror layout,
                # 403): identical on every retry — move on now.
                raise _PermanentFetchError(f"{exc}") from exc
            raise
        if want_md5:
            got = _md5(dest)
            if got != want_md5:
                os.remove(dest)
                raise ValueError(
                    f"checksum mismatch (got {got}, want {want_md5})")
        elif not _looks_like_idx_gz(dest):
            os.remove(dest)
            raise ValueError("not a gzipped IDX file")

    retry_with_backoff(
        attempt, attempts=attempts,
        retry_on=(urllib.error.URLError, OSError, ValueError),
        on_retry=lambda n, exc, delay: failure_events.record(
            "download_retry",
            f"{url} attempt {n} failed ({exc!r}); retrying in "
            f"{delay:.2f}s"),
    )


def dataset_present(directory: str, files: Iterable[str] = _GZ_FILES) -> bool:
    """True when every IDX file exists (gzipped or already decompressed)."""
    for name in files:
        raw = name[: -len(".gz")]
        if not (
            os.path.isfile(os.path.join(directory, name))
            or os.path.isfile(os.path.join(directory, raw))
        ):
            return False
    return True


def download_dataset(
    root: str,
    name: str = "mnist",
    mirrors: Optional[Sequence[str]] = None,
    checksums: Optional[Dict[str, str]] = None,
    timeout: float = 60.0,
    process_index: int = 0,
    attempts: int = 3,
) -> str:
    """Fetch ``name``'s four IDX .gz files into ``root/<name>/``.

    Returns the directory holding the files. Idempotent: files already
    present (and passing verification when a checksum is pinned) are kept.
    Non-zero ``process_index`` returns immediately — one downloader per
    filesystem, the multi-host analog of the reference's world-size-1
    pre-download run.

    Each mirror gets ``attempts`` tries with exponential backoff + jitter,
    and every attempt re-verifies what landed (``_fetch_verified``).
    Raises ``OSError`` when no mirror can serve a file after all retries.
    """
    directory = os.path.join(root, name)
    if process_index != 0:
        return directory
    if mirrors is None:
        mirrors = MIRRORS.get(name, ())
    if checksums is None:
        checksums = CHECKSUMS.get(name, {})
    os.makedirs(directory, exist_ok=True)

    for filename in _GZ_FILES:
        dest = os.path.join(directory, filename)
        want = checksums.get(filename)
        if os.path.isfile(dest) and (
            (want and _md5(dest) == want) or (not want and _looks_like_idx_gz(dest))
        ):
            continue
        if os.path.isfile(os.path.join(directory, filename[: -len(".gz")])):
            continue  # already decompressed (e.g. hand-placed raw IDX)
        errors = []
        for mirror in mirrors:
            url = mirror.rstrip("/") + "/" + filename
            try:
                _fetch_verified(url, dest, timeout, want, attempts=attempts)
            except (urllib.error.URLError, OSError, ValueError,
                    _PermanentFetchError) as exc:
                errors.append(f"{url}: {exc}")
                continue
            break
        else:
            raise OSError(
                f"could not download {filename} for {name!r}: "
                + ("; ".join(errors) if errors else "no mirrors configured")
            )
    return directory
