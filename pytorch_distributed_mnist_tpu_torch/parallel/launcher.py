"""Local N-process spawner: the reference's ``mp.spawn`` launch mode as a
flag (``--spawn N``).

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/launcher.py``.
The spawner starts N processes of ``python -m
pytorch_distributed_mnist_tpu_torch`` with the caller's flags, each
joining a TCP rendezvous on a free loopback port as rank r (spawn order,
the reference's ``run_spawn(proc_id)``). One process drives one device:

- on the card, rank r takes ``cuda:r`` and the world talks NCCL, so the
  machine needs N cards (the CLI checks before it spawns, and never puts
  two ranks on one card);
- with ``--device cpu`` every rank runs on the CPU and the world talks
  gloo.

Rank 0's output streams live; the other ranks write to temp files that
are replayed when a rank fails. When a rank fails, the others get
``settle`` seconds to exit on their own (under the run supervision,
``runtime/supervision.py``, a survivor unwinds with ``PeerFailure`` and
exits 75), then are stopped, so no rank waits in a collective for a peer
that is gone. The CLI gives them the agreement deadline plus the poison
pill's bound when ``--agreement-timeout`` is set, else none. The return
code is the first non-zero one, a signal's as the shell's 128+N;
:func:`run_local` returns every rank's.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

PACKAGE = "pytorch_distributed_mnist_tpu_torch"
POLL_S = 0.1


def free_port() -> int:
    """A free loopback port for the rendezvous (bound, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def strip_flags(argv: Sequence[str], flags: dict) -> List[str]:
    """Remove launcher-consumed flags from an argv copy. ``flags`` maps a
    flag's name to the number of value tokens dropped with it
    (``=``-joined forms are always one token)."""
    out: List[str] = []
    skip = 0
    for a in argv:
        if skip:
            skip -= 1
            continue
        if a in flags:
            skip = flags[a]
            continue
        if any(a.startswith(flag + "=") for flag in flags):
            continue
        out.append(a)
    return out


def strip_spawn_flag(argv: Sequence[str]) -> List[str]:
    """Remove ``--spawn N`` / ``--spawn=N`` from an argv copy."""
    return strip_flags(argv, {"--spawn": 1})


def _child_env() -> dict:
    """Environment of one spawned process: unbuffered output, and the
    checkout that holds this package first on the import path."""
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


def child_device(device: str, rank: int) -> str:
    """Rank ``rank``'s device: ``cuda:rank`` for any CUDA device, else
    ``device`` (the CPU)."""
    return f"cuda:{rank}" if device.startswith("cuda") else device


def _exit_code(rc: int) -> int:
    # A signal-killed child has a negative returncode: the shell's 128+N.
    return rc if rc > 0 else 128 - rc


def spawn_local(nprocs: int, argv: Sequence[str], device: str = "cuda", *,
                timeout: Optional[float] = None, settle: float = 0.0) -> int:
    """Run ``nprocs`` local processes of the CLI with ``argv`` (``--spawn``
    and ``--device`` removed; each rank gets its own device and the
    rendezvous flags); return 0, or the first failed rank's exit code."""
    first_bad = run_local(nprocs, argv, device, timeout=timeout,
                          settle=settle)["first_bad"]
    return 0 if first_bad is None else _exit_code(first_bad)


def run_local(nprocs: int, argv: Sequence[str], device: str = "cuda", *,
              timeout: Optional[float] = None, settle: float = 0.0) -> dict:
    """:func:`spawn_local`'s world; returns ``{"returncodes": [each
    rank's, negative for a signal], "first_bad": the first failure's or
    None, "stopped": [ranks stopped after the settle period]}``. Raises
    ``subprocess.TimeoutExpired`` past ``timeout``."""
    if nprocs < 2:
        raise ValueError(f"--spawn needs >= 2 processes, got {nprocs}")
    child_argv = strip_flags(argv, {"--spawn": 1, "--device": 1})
    port = free_port()
    env = _child_env()
    procs, logs = [], []
    try:
        for rank in range(nprocs):
            cmd = [sys.executable, "-m", PACKAGE, *child_argv,
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(nprocs),
                   "--process-id", str(rank),
                   "--device", child_device(device, rank)]
            if rank == 0:
                log = None
                procs.append(subprocess.Popen(cmd, env=env))
            else:
                # Temp files, not pipes: a full pipe would block a chatty
                # child against a parent that reads only at the end.
                log = tempfile.TemporaryFile(mode="w+")
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=log, stderr=subprocess.STDOUT))
            logs.append(log)
        deadline = None if timeout is None else time.monotonic() + timeout
        first_bad, settle_end = None, None
        while None in [p.poll() for p in procs]:  # polls every rank
            bad = [p.returncode for p in procs
                   if p.returncode not in (None, 0)]
            if bad and first_bad is None:
                first_bad = bad[0]
                settle_end = time.monotonic() + settle
            if settle_end is not None and time.monotonic() >= settle_end:
                break  # its peers would wait for it: stop them
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(cmd, timeout)
            time.sleep(POLL_S)
        if first_bad is None:
            first_bad = next((p.returncode for p in procs
                              if p.returncode != 0), None)
    finally:
        stopped = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                tail = ""
                if log is not None:
                    log.seek(0)
                    tail = log.read()[-4000:]
                print(f"--- spawned process {rank} failed "
                      f"(rc={p.returncode}"
                      f"{', stopped' if rank in stopped else ''}) ---\n"
                      f"{tail}", file=sys.stderr)
            if log is not None:
                log.close()
    return {"returncodes": [p.returncode for p in procs],
            "first_bad": first_bad, "stopped": stopped}
