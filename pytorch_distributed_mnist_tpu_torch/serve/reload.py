"""Checkpoint hot-reload: a serve process tracking a live training run.

Counterpart of ``pytorch_distributed_mnist_tpu/serve/reload.py``. Writers
publish ``checkpoint_{e}.npz`` files, ``checkpoint_{e}.ckpt`` directories
and ``checkpoint_{e}.manifest`` files atomically (tmp + rename), so a
watcher that resolves ``latest_checkpoint()`` only ever sees whole
checkpoints, and a trainer and a serve process can share one directory
with no channel but the filesystem. The server's loader is the delta
fetcher (``distrib/fetch.py``): a torn manifest and a manifest whose
chunk is found nowhere are both skipped for good, and the next clean
publish is installed.

The watcher polls on its own daemon thread, loads the newest file through
``load_params_for_serving`` (name and shape validation included: a
checkpoint of another model aborts the reload, not the server), and hands
the params to ``on_params`` — the engine's ``swap_params``, an atomic
reference swap, so the in-flight batch finishes on the old params and the
next one sees the new. The callback owns the fan-out: per replica or
mesh group on a pool, per STAGE inside a pipeline chain (all stages under
one lock, so no batch spans two epochs), to both planes of a canary.
Failures are contained: a corrupt or vanished checkpoint is recorded
(``serve_reload_failed`` in the stats/JSONL stream) and the server keeps
answering on the params it has.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from pytorch_distributed_mnist_tpu_torch.train.checkpoint import latest_checkpoint


class CheckpointWatcher:
    """Polls ``directory`` and hands newly published params to ``on_params``.

    ``template`` is what the loader restores onto, per serve mode
    (``serve/programs.py::make_serve_template``): the model name (the
    model's own params), or the pipeline plane's ``ServeTemplate`` of the
    stage-stacked split tree, which its engines split by stage
    themselves.

    ``on_params(params, epoch, path)`` runs on the watcher thread and must
    be cheap + thread-safe (the engine's ``swap_params`` is both). A
    falsy non-None return means the swap was refused as stale — every
    engine behind the callback already serves a newer epoch — and is not
    recorded as a reload.
    ``current_path`` marks the checkpoint already loaded at boot so the
    first poll doesn't redundantly reload it. ``poll_once`` is public and
    thread-free so tests drive the state machine deterministically.
    """

    def __init__(
        self,
        directory: str,
        template,
        on_params: Callable,
        poll_interval_s: float = 2.0,
        serve_log=None,
        current_path: Optional[str] = None,
        validate_fn: Optional[Callable] = None,
        loader: Optional[Callable] = None,
    ) -> None:
        self.directory = directory
        self.poll_interval_s = float(poll_interval_s)
        self.serve_log = serve_log
        self._template = template
        self._on_params = on_params
        # Pre-load gate (``validate_fn(path)`` raising rejects the
        # file): the server passes the serve-mode/parallel-layout check
        # here, so a checkpoint published with a mismatched training
        # layout is SKIPPED — permanently for that file, a ValueError —
        # instead of being installed under the wrong serving mode.
        self._validate = validate_fn
        # The loader seam: ``loader(path, template) -> (params, epoch)``.
        # Default is the whole-file ``load_params_for_serving``.
        self._loader = loader
        self._current = current_path
        # Last path that failed to load: retried only once the listing
        # moves past it, so one corrupt file can't hot-loop the log.
        self._failed: Optional[str] = None
        # Serializes polls: the background loop and a concurrent caller
        # (tests drive poll_once directly; /healthz handlers could too)
        # must not both pass the path==current check and double-install
        # the same publish — the params swap is epoch-idempotent, but
        # the second install is a wasted host load + device_put and a
        # phantom +1 in the reload stats.
        self._poll_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def current_path(self) -> Optional[str]:
        return self._current

    def poll_once(self) -> bool:
        """One resolution + (maybe) reload; returns True when new params
        were installed. Serialized against the watcher thread's own
        polls: a concurrent caller either performs the reload itself or
        finds ``_current`` already advanced and returns False."""
        with self._poll_lock:
            return self._poll_once()

    def _poll_once(self) -> bool:
        path = latest_checkpoint(self.directory)
        if not path or path == self._current or path == self._failed:
            return False
        from pytorch_distributed_mnist_tpu_torch.serve.engine import (
            load_params_for_serving,
        )

        loader = self._loader or load_params_for_serving
        try:
            if self._validate is not None:
                self._validate(path)  # ValueError routes to "permanent"
            params, epoch = loader(path, self._template)
        except Exception as exc:  # noqa: BLE001 - serving must survive
            # Serving always survives a failed reload — but retry policy
            # follows the damage taxonomy
            # (``is_corrupt_checkpoint_error``): content-level corruption
            # and template mismatches (shape/leaf-count ValueErrors — the
            # CALLER's model is wrong for this directory) are permanent
            # for this file, so the path is remembered and only a NEWER
            # publish is tried. Anything else (EIO off a flaky NFS
            # export, a momentary device OOM) is transient: the next
            # poll retries the same path, because after training's final
            # publish no newer path will ever appear to clear a
            # wrongly-pinned blacklist.
            from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
                is_corrupt_checkpoint_error,
            )

            # The sharded loader's missing-shards ValueError is
            # absence-level (a stale NFS readdir view of a directory whose
            # atomic publish means it WAS complete), the same reasoning
            # is_corrupt_checkpoint_error gives for leaving it out of
            # quarantine: it stays retryable here too.
            stale_view = (isinstance(exc, ValueError)
                          and "missing shards" in str(exc))
            permanent = not stale_view and (
                is_corrupt_checkpoint_error(exc)
                or isinstance(exc, ValueError))
            if permanent:
                self._failed = path
            if self.serve_log is not None:
                self.serve_log.record_reload_failure(path, repr(exc))
            policy = ("skipping until a newer checkpoint appears"
                      if permanent else "will retry next poll")
            print(f"serve reload: failed to load {path!r} ({policy}; "
                  f"still serving current params): {exc!r}", flush=True)
            return False
        installed = self._on_params(params, epoch, path)
        self._current = path
        self._failed = None
        if installed is not None and not installed:
            # The engine applied its swap-ordering rule and refused:
            # every replica already serves a NEWER epoch than this file
            # (e.g. a slow load raced a faster one). The file itself was
            # fine — mark it current so it isn't re-loaded, but it never
            # served, so no reload is recorded.
            print(f"serve reload: {path!r} (epoch {epoch}) is staler than "
                  f"the serving params; skipped", flush=True)
            return False
        if self.serve_log is not None:
            self.serve_log.record_reload(path, epoch)
        print(f"serve reload: now serving {path!r} (epoch {epoch})",
              flush=True)
        return True

    def start(self) -> "CheckpointWatcher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serve-reload")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as exc:  # noqa: BLE001 - watcher never dies
                # poll_once already contains load errors; this catches
                # listing-level surprises (directory deleted, EIO). The
                # watcher thread must outlive them all.
                print(f"serve reload: poll failed: {exc!r}", flush=True)
