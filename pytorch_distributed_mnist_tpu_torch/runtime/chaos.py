"""Fault-injection (chaos) harness of the training world.

Counterpart of ``tools/chaos.py``. Its training modes run the same local
world as ``--spawn N`` (or, with ``--elastic``, the elastic supervisor of
``runtime/elastic.py``) with one process sabotaged at a named fault point
(``TPUMNIST_FAULT=point:host:kind[:arg]``, ``runtime/supervision.py``),
then the same world with no fault, as the twin to compare with. The
world's device is the ``--device`` of the CLI args after ``--``, ``cuda``
when they name none, as the CLI's default: ``--device cpu`` gives a gloo
world on the CPU, and without a card the ranks fail as the CLI does::

    # what can be injected, and where each point fires
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos --list

    # SIGKILL rank 1 at the checkpoint publish agreement: rank 0 must
    # exit 75 with PeerFailure naming host 1, not wait
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \\
        --fault ckpt_publish:1:kill --nprocs 2 --agreement-timeout 8 -- \\
        --device cpu --model linear --dataset synthetic --epochs 2 \\
        --synthetic-train-size 2048 --synthetic-test-size 512 \\
        --batch-size 64 --checkpoint-dir /tmp/chaos/ck

    # ELASTIC: kill rank 2 at epoch 1's entry; the world shrinks to 2
    # ranks, resumed from checkpoint_0, and trains to the end
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \\
        --elastic --min-world 2 --fault train_epoch:2:kill:1 --nprocs 3 \\
        -- --device cpu --model linear --dataset synthetic --epochs 2 \\
        --synthetic-train-size 2048 --synthetic-test-size 512 \\
        --batch-size 96 --checkpoint-dir /tmp/chaos/el

    # GROW (2 -> 1 -> 2): rank 1 dies at epoch 1's entry, the world
    # shrinks to host 0; --rejoin 1@1 writes host 1's join record while
    # generation 1 runs, the epoch-boundary grow rendezvous admits it,
    # and the job finishes at a world of 2
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \\
        --elastic --elastic-grow --rejoin 1@1 --fault train_epoch:1:kill:1 \\
        --nprocs 2 -- --device cpu --model linear --dataset synthetic \\
        --epochs 3 --batch-size 64 --checkpoint-dir /tmp/chaos/grow

The last line of its output is one JSON object: the fault, each run's
exit codes (per rank; the supervisor's under ``--elastic``), the ranks
stopped after the settle period and the seconds. The exit code is 0 when
no rank of the faulted world had to be stopped (every rank exited on its
own) and the twin with no fault exited 0. The twin writes into its own
``--checkpoint-dir`` (the given one with ``_twin`` appended).

The serving modes boot the port's server as a process (``python -m
pytorch_distributed_mnist_tpu_torch serve``, on ``--device``), drive it
with ``tools/loadgen.py`` and run each scenario beside its no-fault twin
(the same boot and load with nothing injected)::

    # replica 0 dies after 5 batches under live traffic: every request
    # answered, the pool quarantines and regroups it
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos --serve \
        --device cpu --serve-devices 2 --serve-fault 0:5 --expect-groups 2

    # roll /resize through 3 and 2 replicas under traffic, zero drops
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos --serve \
        --device cpu --serve-devices 2 --resize 3,2 --expect-groups 2

    # every shadow comparison disagrees: the canary rolls back and the
    # f32 baseline answers every request
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos --serve \
        --device cpu --canary-rollback

    # a load spike against a 1-replica pool: the dry run records a
    # scale-up and moves nothing; the real run resizes up and back down
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \
        --autoscale-spike --device cpu --slo-p95-ms 5

    # one hot client at 10x --quota-rps is clipped with 429 +
    # Retry-After while a well-behaved client keeps >= 90% goodput
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \
        --quota-abuse --device cpu --quota-rps 20

    # Zipf-duplicate traffic through a hot reload: zero drops, and every
    # reply after the swap carries the new epoch (no stale cache hit)
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \
        --cache-storm --device cpu

    # torn publishes: a half-written manifest, then one with a missing
    # chunk, then a clean one: skipped, skipped, recovered; serving
    # never stops
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \
        --torn-manifest --device cpu

The fleet modes boot the port's router (``python -m
pytorch_distributed_mnist_tpu_torch route``, which imports no torch:
its log holds ``-X importtime``'s record, and the chaos line says
whether torch, numpy or JAX was among its imports) over ``--fleet N``
port serve processes on ``--device``, each serving ``--serve-model`` on
the ``--serve-precision`` plane (int8 unless another is named: on the
card every backend's Dense layers run the int8 kernel)::

    # SIGKILL backend 1 under open-loop traffic: zero dropped requests
    # (router failover + loadgen's bounded retry), quarantine, then
    # probation back to healthy after a restart on the same port
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \
        --fleet 2 --kill-backend 1 --device cpu

    # a fleet-wide rolling deploy under traffic: every backend on the
    # new epoch, zero drops
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \
        --fleet 2 --rolling-reload --device cpu

    # a publish behind a fleet canary with TPUMNIST_FLEET_FAULT=
    # canary_disagree in the router: rolled back, baseline republished
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \
        --fleet 2 --fleet-canary-rollback --device cpu

    # every backend watches one shared directory; 3 adjacent delta
    # publishes under traffic: zero drops, the fleet converges, each
    # publish adds a small fraction of the cold publish's chunk bytes
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \
        --fleet 2 --delta-publish 3 --device cpu

Each serving and fleet mode runs its scenario, then its no-fault twin
(the same boot and load with nothing injected), prints one JSON
``chaos`` line last and exits 0 only when both held.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
    run_local,
    strip_flags,
)
from pytorch_distributed_mnist_tpu_torch.runtime.elastic import supervise
from pytorch_distributed_mnist_tpu_torch.runtime.supervision import (
    FAULT_ENV,
    FAULT_POINTS,
    TIMEOUT_ENV,
    parse_fault_specs,
)


# The injection variables of the serve plane and the fleet, spelled as
# ``serve/pool.py``, ``serve/canary.py`` and ``serve/router.py`` define
# them (and as ``tools/chaos.py`` spells them).
SERVE_FAULT_ENV = "TPUMNIST_SERVE_FAULT"
CANARY_FAULT_ENV = "TPUMNIST_CANARY_FAULT"
FLEET_FAULT_ENV = "TPUMNIST_FLEET_FAULT"
PACKAGE = "pytorch_distributed_mnist_tpu_torch"
# Open-loop seconds of the fleet modes' and the cache storm's traffic.
LOAD_SECONDS = 4.0
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LOADGEN = os.path.join(_REPO, "tools", "loadgen.py")


def list_fault_points(file=sys.stdout) -> None:
    """One line per injectable point: ``name<TAB>description``."""
    for name in sorted(FAULT_POINTS):
        print(f"{name}\t{FAULT_POINTS[name]}", file=file)


def twin_argv(cli_args: List[str]) -> List[str]:
    """``cli_args`` with ``--checkpoint-dir D`` moved to ``D_twin``."""
    out = strip_flags(cli_args, {"--checkpoint-dir": 1})
    for i, arg in enumerate(cli_args):
        if arg == "--checkpoint-dir" and i + 1 < len(cli_args):
            return out + ["--checkpoint-dir", cli_args[i + 1] + "_twin"]
        if arg.startswith("--checkpoint-dir="):
            return out + ["--checkpoint-dir",
                          arg.split("=", 1)[1] + "_twin"]
    return out


def cli_device(cli_args: List[str]) -> str:
    """The ``--device`` that ``cli_args`` name (the last one, as argparse
    takes it), else the CLI's default, ``cuda``."""
    device = "cuda"
    for i, arg in enumerate(cli_args):
        if arg == "--device" and i + 1 < len(cli_args):
            device = cli_args[i + 1]
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
    return device


def parse_rejoin(spec: str) -> List[Tuple[int, int]]:
    """``HOST@GEN[,HOST@GEN...]`` -> ``[(host, generation), ...]``."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            host_s, gen_s = part.split("@")
            out.append((int(host_s), int(gen_s)))
        except ValueError:
            raise SystemExit(
                f"bad --rejoin spec {part!r}: expected HOST@GENERATION "
                f"(e.g. 1@1: host 1 announces a join while generation 1 "
                f"runs)") from None
    return out


def _world(args, cli_args: List[str], fault: Optional[str], device: str,
           rejoin=()) -> dict:
    """One run of the world on ``device`` with ``fault`` set (or none)
    and the ``rejoin`` join records (elastic only)."""
    if fault:
        os.environ[FAULT_ENV] = fault
    else:
        os.environ.pop(FAULT_ENV, None)
    t0 = time.perf_counter()
    if args.elastic:
        rc = supervise(args.nprocs, cli_args, min_world=args.min_world,
                       max_world=args.max_world, grow=args.elastic_grow,
                       rejoin=rejoin, settle_timeout=args.settle_timeout,
                       generation_timeout=args.timeout, device=device)
        out = {"returncodes": [rc], "stopped": []}
    else:
        got = run_local(args.nprocs, cli_args, device, timeout=args.timeout,
                        settle=2 * args.agreement_timeout + 15.0)
        out = {"returncodes": got["returncodes"], "stopped": got["stopped"]}
    out["seconds"] = time.perf_counter() - t0
    return out


def _say(msg: str) -> None:
    print(f"chaos: {msg}", file=sys.stderr, flush=True)


def _get_json(url: str, path: str, timeout: float = 10.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return json.loads(r.read())


def _post_json(url: str, path: str, payload: dict,
               timeout: float = 120.0) -> dict:
    import urllib.request

    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class _Proc:
    """One process of the package (``argv`` after ``-m``), its output in
    a temporary file; :meth:`wait_url` reads the URL its ``pattern``
    line announces (None when it never came up). ``close`` kills it and
    removes the log."""

    def __init__(self, argv: List[str], env: dict, what: str,
                 python_flags: Tuple[str, ...] = ()) -> None:
        self.what = what
        self.log = tempfile.NamedTemporaryFile(mode="w+", suffix=".log",
                                               delete=False)
        cmd = [sys.executable, *python_flags, "-m", PACKAGE] + argv
        _say(f"booting {what}: {' '.join(cmd)}")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT)
        self.url = None
        self.boot_s = None

    def text(self) -> str:
        with open(self.log.name) as f:
            return f.read()

    def wait_url(self, timeout: float, pattern: str) -> Optional[str]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and self.url is None:
            if self.proc.poll() is not None:
                break
            m = re.search(pattern, self.text())
            if m:
                self.url = m.group(1).rstrip("/")
                self.boot_s = time.perf_counter() - self.t0
            else:
                time.sleep(0.1)
        if self.url is None:
            print(self.text()[-4000:], file=sys.stderr)
            _say(f"{self.what} never came up")
        return self.url

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait()

    def close(self) -> None:
        self.kill()
        self.log.close()
        os.unlink(self.log.name)


class _Served(_Proc):
    """One port server process on ``--device``, on ``ckpt`` (a fresh
    directory, seeded fresh params, when None) and ``port``; ``close``
    kills it and removes its log and the directory it made."""

    def __init__(self, args, flags: List[str], env: dict,
                 ckpt: Optional[str] = None, port: int = 0,
                 wait: bool = True) -> None:
        self.own_ckpt = ckpt is None
        self.ckpt = ckpt or tempfile.mkdtemp(prefix="tpumnist-serve-chaos-")
        super().__init__(["serve", "--device", args.device,
                          "--checkpoint-dir", self.ckpt, "--host",
                          "127.0.0.1", "--port", str(port)] + flags, env,
                         "serve twin")
        self.timeout = args.timeout
        if wait:
            self.wait()

    def wait(self) -> Optional[str]:
        return self.wait_url(self.timeout, r"serving on (http://\S+)")

    @property
    def name(self) -> str:
        return (self.url or "").split("//")[-1]

    def close(self) -> None:
        super().close()
        if self.own_ckpt:
            shutil.rmtree(self.ckpt, ignore_errors=True)


def _serve_env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in (SERVE_FAULT_ENV, CANARY_FAULT_ENV, FLEET_FAULT_ENV)}
    env.update(extra)
    env["PYTHONUNBUFFERED"] = "1"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start_loadgen(argv: List[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, _LOADGEN] + argv,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_loadgen(proc: subprocess.Popen, timeout: float) -> tuple:
    """A started ``tools/loadgen.py`` (pure stdlib) run to its end:
    ``(exit code, its last-line report)``; killed and reaped at
    ``timeout``."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    line = out.strip().splitlines()[-1] if out.strip() else "{}"
    try:
        return proc.returncode, json.loads(line)
    except json.JSONDecodeError:
        return proc.returncode, {"output": out[-2000:]}


def _loadgen(argv: List[str], timeout: float) -> tuple:
    return _finish_loadgen(_start_loadgen(argv), timeout)


def _serve_once(args, injected: bool) -> dict:
    """One boot of the serve scenario: with ``injected`` the fault
    (``--serve-fault``, ``--canary-rollback``'s disagreement) and the
    ``--resize`` roll, else the no-fault twin. Returns its verdict."""
    env = {}
    if injected and args.serve_fault:
        env[SERVE_FAULT_ENV] = args.serve_fault
    if injected and args.canary_rollback:
        env[CANARY_FAULT_ENV] = "disagree"
    flags = ["--model", args.serve_model, "--buckets", "1,8,32",
             "--serve-devices", str(args.serve_devices),
             "--quarantine-after", str(args.quarantine_after),
             "--max-wait-ms", "2", "--poll-interval", "1"]
    precision = args.serve_precision
    if args.canary_rollback and not precision:
        precision = "bf16"  # the canary needs a quantized plane
    if precision:
        flags += ["--serve-precision", precision]
    if args.canary_rollback:
        # Every batch shadowed; a huge promotion window and a zero budget
        # leave the injected disagreement the only possible transition.
        flags += ["--canary-fraction", "1.0", "--canary-promote-after",
                  "100000", "--canary-budget", "0.0"]
    served = _Served(args, flags, _serve_env(env))
    out = {"injected": injected, "ok": False}
    try:
        if served.url is None:
            return out
        load = _start_loadgen(["--smoke", "--url", served.url,
                               "--requests", str(args.requests),
                               "--concurrency", "8"])
        try:
            resized = []
            # Roll the topology while the load runs: each /resize must
            # complete under traffic with zero dropped requests.
            for target in (args.resize_targets if injected else []):
                time.sleep(0.5)
                reply = _post_json(served.url, "/resize",
                                   {"serve_devices": target})
                resized.append(reply["new"]["groups"])
        except BaseException:
            load.kill()
            load.wait()
            raise
        rc, report = _finish_loadgen(load, args.timeout)
        out.update(answered=report.get("ok"), requests=args.requests,
                   transport_errors=report.get("transport_errors"),
                   resized=resized)
        ok = rc == 0 and report.get("ok") == args.requests
        if injected and args.canary_rollback:
            canary = _get_json(served.url, "/stats").get("canary") or {}
            out["canary"] = {k: canary.get(k) for k in (
                "state", "compared_rows", "disagreed_rows", "rollbacks")}
            ok = ok and canary.get("state") == "rolled_back"
        # The pool heals (quarantine -> regroup) before the final gate.
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            stats = _get_json(served.url, "/stats")
            if not stats.get("quarantined_groups"):
                break
            time.sleep(0.5)
        final = ["--smoke", "--url", served.url, "--requests", "50",
                 "--concurrency", "4"]
        if args.expect_groups:
            final += ["--expect-groups", str(args.expect_groups)]
        rc, _ = _loadgen(final, args.timeout)
        stats = _get_json(served.url, "/stats")
        out["topology"] = {k: stats.get(k) for k in (
            "topology_generation", "groups", "active_groups", "regroups",
            "failovers")}
        ok = ok and rc == 0
        if injected and args.serve_fault:
            ok = ok and bool(stats.get("regroups"))
        out["ok"] = bool(ok)
        return out
    finally:
        served.close()


def run_serve_chaos(args) -> int:
    """The serve-plane scenario (a replica's death, a rolling resize or
    a canary rollback under live loadgen traffic) and its no-fault twin;
    both must answer every request and pass the final topology gate."""
    t0 = time.perf_counter()
    faulted = _serve_once(args, injected=True)
    twin = None if args.no_twin else _serve_once(args, injected=False)
    ok = faulted["ok"] and (twin is None or twin["ok"])
    print(json.dumps({"chaos": {
        "serve": {"fault": args.serve_fault, "resize": args.resize_targets,
                  "canary_rollback": args.canary_rollback,
                  "device": args.device},
        "faulted": faulted, "twin": twin, "ok": ok,
        "seconds": time.perf_counter() - t0}}), flush=True)
    return 0 if ok else 1


def _spike(args, url: str) -> tuple:
    return _loadgen(["--url", url, "--mode", "open", "--shape", "spike",
                     "--rate", str(args.spike_rate), "--spike-mult", "8",
                     "--duration", str(args.spike_duration),
                     "--mix", "interactive=0.6,batch=0.3,best_effort=0.1",
                     "--timeout", "30"], args.timeout)


def run_autoscale_spike(args) -> int:
    """The autoscaler twin: a load spike must trigger a scale-up, first
    in a dry run (decisions recorded, the topology untouched), then for
    real on a fresh boot (the pool resizes up during the spike and back
    down after it, with zero dropped in-flight requests)."""
    # cnn unless another model is named: linear answers too fast on one
    # device for a spike to back its queue up. Buckets capped at 4, so
    # micro-batching cannot absorb the spike whole.
    model = args.serve_model if args.serve_model != "linear" else "cnn"
    base = ["--model", model, "--buckets", "1,4",
            "--serve-devices", "1", "--max-inflight", "2",
            "--max-wait-ms", "2", "--max-queue", "64",
            "--poll-interval", "5", "--stats-window-s", "5",
            "--autoscale", "--slo-p95-ms", str(args.slo_p95_ms),
            "--autoscale-interval-s", "0.3", "--autoscale-cooldown-s", "1.5",
            "--autoscale-down-after", "3", "--autoscale-max-devices", "2"]
    t0 = time.perf_counter()
    result = {"dry_run": {}, "real": {}, "ok": False}

    def _done(ok: bool) -> int:
        result["ok"] = ok
        result["seconds"] = time.perf_counter() - t0
        print(json.dumps({"chaos": {"autoscale_spike": result}}), flush=True)
        return 0 if ok else 1

    served = _Served(args, base + ["--autoscale-dry-run"], _serve_env({}))
    try:
        if served.url is None:
            return _done(False)
        _spike(args, served.url)
        stats = _get_json(served.url, "/stats")
        ups = [d for d in (stats.get("autoscaler") or {}).get(
            "decisions", []) if d.get("action") == "scale_up"]
        result["dry_run"] = {"scale_ups": len(ups),
                             "serve_devices": stats.get("serve_devices")}
        if not ups or not all(d.get("dry_run") for d in ups) \
                or stats.get("serve_devices") != 1:
            _say(f"dry run: {result['dry_run']}")
            return _done(False)
    finally:
        served.close()

    served = _Served(args, base, _serve_env({}))
    try:
        if served.url is None:
            return _done(False)
        rc, report = _spike(args, served.url)
        stats = _get_json(served.url, "/stats")
        scaler = stats.get("autoscaler") or {}
        answered = (report.get("ok", 0) + report.get("rejected", 0)
                    + report.get("quota_rejected", 0))
        sends = (sum(report.get("status_counts", {}).values())
                 + report.get("transport_errors", 0))
        result["real"] = {"scale_ups": scaler.get("scale_ups"),
                          "decisions": scaler.get("decisions"),
                          "answered": answered, "sends": sends,
                          "transport_errors": report.get("transport_errors")}
        if not scaler.get("scale_ups") or report.get("transport_errors") \
                or answered != sends:
            _say(f"the spike: {result['real']}")
            return _done(False)
        # The calm after the spike must bring the pool back down.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            stats = _get_json(served.url, "/stats")
            if stats.get("serve_devices") == 1 and \
                    stats.get("autoscaler", {}).get("scale_downs", 0):
                result["real"]["scale_downs"] = \
                    stats["autoscaler"]["scale_downs"]
                return _done(True)
            time.sleep(0.5)
        _say("the pool never scaled back down after the spike")
        return _done(False)
    finally:
        served.close()


# -- the fleet modes: the port's router over N port serve processes ----------

def _sends(report: dict) -> int:
    """Requests a loadgen run launched: every status code plus transport
    errors (nothing it could not send is skipped silently)."""
    return (sum(report.get("status_counts", {}).values())
            + report.get("transport_errors", 0))


def _dropped(report: dict) -> int:
    return report.get("transport_errors", 0) + report.get("conn_refused", 0)


def _answered_all(rc: int, report: dict, least: int = 1) -> bool:
    """Every request a loadgen run sent was answered 200: none dropped
    (after its bounded retries), none refused."""
    answered = sum(report.get("status_counts", {}).values())
    return (rc == 0 and not _dropped(report) and answered >= least
            and report.get("ok") == answered)


def _seed_checkpoint(directory: str, epoch: int, model: str) -> str:
    """``checkpoint_{epoch}.npz`` of seeded ``model`` params (seed 7 +
    epoch, so adjacent epochs carry other weights) in ``directory``."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
        params_to_jax,
    )
    from pytorch_distributed_mnist_tpu_torch.train.checkpoint import (
        save_params_checkpoint,
    )

    return save_params_checkpoint(
        params_to_jax(init_params(model, 7 + epoch)), epoch=epoch,
        directory=directory, best_acc=0.5)


def _delta_publish(directory: str, model: str, e0: int, n: int,
                   drop_new: bool = False, sleep_s: float = 0.0) -> None:
    """Delta-publish epochs ``e0 .. e0 + n - 1`` of ``model``'s seed-7
    params into ``directory``, epoch e with the smallest leaf moved by
    e * 1e-3 (adjacent epochs differ in one leaf; an epoch's bytes are
    the same on every run). ``drop_new`` deletes every chunk a publish
    added after its manifest landed: the missing-chunk torn publish."""
    from pytorch_distributed_mnist_tpu_torch.distrib.cas import ChunkStore
    from pytorch_distributed_mnist_tpu_torch.distrib.publish import (
        publish_arrays,
    )
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        init_params,
        key_path,
        params_to_jax,
    )

    base = params_to_jax(init_params(model, 7))
    names = sorted(base, key=key_path)
    small = min(names, key=lambda k: base[k].size)
    store = ChunkStore(directory)
    for e in range(e0, e0 + n):
        named = [(k, base[k] + e * 1e-3 if k == small else base[k])
                 for k in names]
        before = store.digests()
        publish_arrays(named, epoch=e, best_acc=0.5, directory=directory)
        if drop_new:
            for digest in store.digests() - before:
                os.remove(store.path(digest))
        if sleep_s and e + 1 < e0 + n:
            time.sleep(sleep_s)


def _chunk_bytes(directory: str) -> int:
    chunks = os.path.join(directory, "chunks")
    if not os.path.isdir(chunks):
        return 0
    return sum(os.path.getsize(os.path.join(chunks, name))
               for name in os.listdir(chunks))


def _imports_of(log: str) -> dict:
    """Which of torch, numpy and JAX a process imported, from the
    ``-X importtime`` lines of its log."""
    tops = set()
    for line in log.splitlines():
        if line.startswith("import time:") and "|" in line:
            tops.add(line.rsplit("|", 1)[1].strip().split(".")[0])
    return {name: name in tops for name in ("torch", "numpy", "jax")}


def _backend_flags(args) -> List[str]:
    return ["--model", args.serve_model, "--serve-precision",
            args.serve_precision or "int8", "--buckets", "1,8",
            "--max-wait-ms", "2", "--max-queue", "256",
            "--poll-interval", "0.2"]


def _k3_launches(url: str) -> int:
    return int(_get_json(url, "/stats").get("kernel_launches", {})
               .get("matmul_i8", 0))


def _wait_for(check, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if check():
            return True
        time.sleep(0.2)
    return False


def _fleet_once(args, injected: bool) -> dict:
    """One boot of the fleet scenario: ``--fleet`` backends (one shared
    watch directory under ``--delta-publish``), the router over them,
    open-loop traffic through the router, and with ``injected`` the
    mode's event under it (a SIGKILL, a rolling reload, a canary with
    ``canary_disagree``, delta publishes); without it the no-fault twin,
    the same boot and load with nothing injected. Returns its verdict."""
    out = {"injected": injected, "ok": False}
    env = _serve_env({})
    router_env = _serve_env({FLEET_FAULT_ENV: "canary_disagree"}
                            if injected and args.fleet_canary_rollback
                            else {})
    flags = _backend_flags(args)
    staging = tempfile.mkdtemp(prefix="tpumnist-fleet-staging-")
    shared = None
    backends: List[_Served] = []
    router = None
    try:
        if args.delta_publish:
            # One directory for the whole fleet (a shared filesystem),
            # seeded with a cold publish: every backend boots on epoch 1
            # off the manifest, and the store holds the whole state's
            # bytes to hold each adjacent publish against.
            shared = tempfile.mkdtemp(prefix="tpumnist-fleet-delta-")
            _delta_publish(shared, args.serve_model, 1, 1)
        backends = [_Served(args, flags, env, ckpt=shared, wait=False)
                    for _ in range(args.fleet)]
        if not all(b.wait() for b in backends):
            return out
        router = _Proc(["route", "--backends",
                        ",".join(b.name for b in backends),
                        "--host", "127.0.0.1", "--port", "0",
                        "--health-interval", "0.2", "--quarantine-after",
                        "2", "--probation-successes", "2",
                        "--connect-timeout", "2.0"], router_env, "router",
                       python_flags=("-X", "importtime"))
        url = router.wait_url(args.timeout, r"routing on (http://\S+)")
        if url is None:
            return out
        out["router"] = {"boot_s": router.boot_s,
                         "imports": _imports_of(router.text())}
        if not _wait_for(lambda: _get_json(url, "/healthz").get(
                "routable") == args.fleet, args.timeout):
            _say("the router never saw every backend healthy")
            return out
        dirs = {b.name: b.ckpt for b in backends}
        load = ["--url", url, "--mode", "open", "--duration",
                str(LOAD_SECONDS), "--retry-transport", "2",
                "--timeout", "30"]
        if args.kill_backend is not None:
            ok = _fleet_kill(args, injected, url, backends, flags, env,
                             load, out)
        elif args.rolling_reload:
            ok = _fleet_rolling(args, injected, url, backends, staging,
                                dirs, load, out)
        elif args.fleet_canary_rollback:
            ok = _fleet_canary(args, injected, url, backends, staging, dirs,
                               out)
        else:
            ok = _fleet_delta(args, injected, backends, shared, load, out)
        stats = _get_json(url, "/stats")
        out["fleet"] = {k: stats["fleet"][k] for k in (
            "routable", "total", "failovers", "retries", "fleet_503s")}
        out["fleet"]["window"] = stats["fleet"]["window"]
        out["backends"] = {r["name"]: {k: r[k] for k in (
            "state", "epoch", "requests", "quarantines", "readmissions")}
            for r in stats["backends"]}
        # The router shares no fate with its data plane: no torch, no
        # numpy, no JAX in its process.
        out["ok"] = bool(ok) and not any(out["router"]["imports"].values())
        return out
    finally:
        if router is not None:
            router.close()
        for b in backends:
            b.close()
        shutil.rmtree(staging, ignore_errors=True)
        if shared is not None:
            shutil.rmtree(shared, ignore_errors=True)


def _fleet_kill(args, injected, url, backends, flags, env, load,
                out) -> bool:
    """``--kill-backend K``: SIGKILL backend K a third into the traffic;
    every request answered, K quarantined, and after a restart on its
    port K walks probation back to healthy. Each backend's
    ``kernel_launches.matmul_i8`` is read from its own ``/stats`` before
    the kill."""
    victim = backends[args.kill_backend]
    lg = _start_loadgen(load + ["--rate", "80"])
    time.sleep(LOAD_SECONDS * 0.35)
    out["k3_launches_before_kill"] = {b.name: _k3_launches(b.url)
                                      for b in backends}
    if injected:
        _say(f"SIGKILL backend {args.kill_backend} ({victim.url})")
        victim.kill()
    rc, report = _finish_loadgen(lg, args.timeout)
    out["load"] = {k: report.get(k) for k in (
        "ok", "status_counts", "transport_errors", "conn_refused",
        "transport_retries", "throughput_rps", "latency_ms")}
    ok = _answered_all(rc, report, least=10)
    if args.device == "cuda" and (args.serve_precision or "int8") == "int8":
        # On the card every backend's int8 plane runs the kernel, never
        # its plain version.
        ok = ok and all(out["k3_launches_before_kill"].values())
    if not injected:
        stats = _get_json(url, "/stats")
        return ok and all(r["state"] == "healthy" and not r["quarantines"]
                          for r in stats["backends"])
    row = {}

    def victim_is(state):
        nonlocal row
        row = {r["name"]: r for r in _get_json(url, "/stats")["backends"]
               }[victim.name]
        return row["state"] == state

    quarantined = _wait_for(lambda: victim_is("quarantined"), args.timeout)
    stats = _get_json(url, "/stats")
    out["victim_quarantined"] = quarantined
    port = int(victim.url.rsplit(":", 1)[1])
    victim.close()
    revived = _Served(args, flags, env, ckpt=victim.ckpt, port=port)
    backends[args.kill_backend] = revived
    if revived.url is None:
        return False
    healed = _wait_for(lambda: victim_is("healthy"), args.timeout)
    out["victim_readmissions"] = row.get("readmissions")
    out["failovers"] = stats["fleet"]["failovers"]
    return (ok and quarantined and stats["fleet"]["failovers"] >= 1
            and healed and bool(row.get("readmissions")))


def _fleet_rolling(args, injected, url, backends, staging, dirs, load,
                   out) -> bool:
    """``--rolling-reload``: ``POST /rollout`` of epoch 1 a second into
    the traffic; every request answered, every backend on epoch 1 and
    undrained after it."""
    source = _seed_checkpoint(staging, 1, args.serve_model)
    lg = _start_loadgen(load + ["--rate", "60"])
    reply = None
    if injected:
        time.sleep(1.0)
        reply = _post_json(url, "/rollout", {"source": source,
                                             "dirs": dirs})
        out["rollout"] = reply
    rc, report = _finish_loadgen(lg, args.timeout)
    out["load"] = {k: report.get(k) for k in (
        "ok", "status_counts", "transport_errors", "transport_retries")}
    ok = _answered_all(rc, report, least=10)
    health = [_get_json(b.url, "/healthz") for b in backends]
    out["epochs"] = [h.get("model_epoch") for h in health]
    if injected:
        ok = ok and reply.get("ok") and len(reply.get("updated", [])) \
            == args.fleet and out["epochs"] == [1] * args.fleet
    return ok and not any(h.get("draining") for h in health)


def _fleet_canary(args, injected, url, backends, staging, dirs,
                  out) -> bool:
    """``--fleet-canary-rollback``: the fleet on epoch 1 (a rollout),
    then epoch 2 behind a fleet canary on backend 0 with every request
    in its cohort. Under ``canary_disagree`` the canary rolls back and
    the baseline's weights are republished on backend 0 as epoch 3; the
    twin's canary stays in shadow with no disagreement. Every request
    answered either way."""
    reply = _post_json(url, "/rollout", {
        "source": _seed_checkpoint(staging, 1, args.serve_model),
        "dirs": dirs})
    if not reply.get("ok"):
        _say(f"baseline publish failed: {reply}")
        return False
    canary = backends[0]
    reply = _post_json(url, "/rollout", {
        "source": _seed_checkpoint(staging, 2, args.serve_model),
        "dirs": dirs,
        "canary": {"fraction": 1.0, "budget": 0.0,
                   "promote_after": 100000, "backends": [canary.name]}})
    if not reply.get("ok"):
        _say(f"canary publish failed: {reply}")
        return False
    rc, report = _loadgen(["--url", url, "--requests", str(args.requests),
                           "--concurrency", "4", "--retry-transport", "2",
                           "--client-id", "canary-probe"], args.timeout)
    out["load"] = {k: report.get(k) for k in (
        "ok", "status_counts", "transport_errors", "transport_retries")}
    ok = _answered_all(rc, report)
    want = "rolled_back" if injected else "shadow"
    state = {}

    def canary_is():
        state.update(_get_json(url, "/stats").get("fleet_canary") or {})
        return state.get("state") == want

    ok = ok and _wait_for(canary_is, args.timeout if injected else 1.0)
    out["fleet_canary"] = {k: state.get(k) for k in (
        "state", "compared_rows", "disagreed_rows", "rollbacks")}
    if not injected:
        return ok and state.get("disagreed_rows") == 0
    # The rollback republishes the baseline's weights as the next epoch
    # (epochs only move forward); the canary backend swaps onto them.
    restored = _wait_for(lambda: _get_json(canary.url, "/healthz").get(
        "model_epoch") == 3, args.timeout)
    out["canary_backend_epoch"] = _get_json(canary.url,
                                            "/healthz").get("model_epoch")
    return ok and restored


def _fleet_delta(args, injected, backends, shared, load, out) -> bool:
    """``--delta-publish E``: E adjacent delta publishes into the shared
    directory under traffic; every request answered, every backend on
    the last epoch, and each publish's new chunk bytes under 30% of the
    cold publish's. The twin's fleet stays on epoch 1."""
    n = args.delta_publish
    cold = _chunk_bytes(shared)
    last = 1 + n if injected else 1
    lg = _start_loadgen(load + ["--rate", "60"])
    t0 = time.monotonic()
    if injected:
        time.sleep(1.0)
        _delta_publish(shared, args.serve_model, 2, n, sleep_s=0.5)
    converged = _wait_for(lambda: all(
        _get_json(b.url, "/healthz").get("model_epoch") == last
        for b in backends), args.timeout)
    out["consistent_s"] = time.monotonic() - t0
    rc, report = _finish_loadgen(lg, args.timeout)
    out["load"] = {k: report.get(k) for k in (
        "ok", "status_counts", "transport_errors", "transport_retries")}
    per_publish = (_chunk_bytes(shared) - cold) / n
    out["chunk_bytes"] = {"cold": cold, "per_publish": per_publish}
    ok = _answered_all(rc, report, least=10) and converged
    if injected:
        ok = ok and per_publish < 0.30 * cold
    return ok


def run_fleet_chaos(args) -> int:
    """The fleet scenario (``--kill-backend``, ``--rolling-reload``,
    ``--fleet-canary-rollback`` or ``--delta-publish``) and its no-fault
    twin; both must hold."""
    modes = [args.kill_backend is not None, args.rolling_reload,
             args.fleet_canary_rollback, bool(args.delta_publish)]
    if sum(modes) != 1:
        raise SystemExit("--fleet N needs one of --kill-backend K / "
                         "--rolling-reload / --fleet-canary-rollback / "
                         "--delta-publish E")
    if args.kill_backend is not None \
            and not 0 <= args.kill_backend < args.fleet:
        raise SystemExit(f"--kill-backend {args.kill_backend} is not one "
                         f"of the {args.fleet} backends")
    t0 = time.perf_counter()
    faulted = _fleet_once(args, injected=True)
    twin = None if args.no_twin else _fleet_once(args, injected=False)
    ok = faulted["ok"] and (twin is None or twin["ok"])
    print(json.dumps({"chaos": {
        "fleet": {"backends": args.fleet, "kill_backend": args.kill_backend,
                  "rolling_reload": args.rolling_reload,
                  "fleet_canary_rollback": args.fleet_canary_rollback,
                  "delta_publish": args.delta_publish,
                  "device": args.device, "model": args.serve_model,
                  "precision": args.serve_precision or "int8"},
        "faulted": faulted, "twin": twin, "ok": ok,
        "seconds": time.perf_counter() - t0}}), flush=True)
    return 0 if ok else 1


# -- one serve process: torn publishes, quota abuse, a cache storm ----------

def _smoke(url: str, timeout: float, n: int = 50) -> bool:
    rc, report = _loadgen(["--smoke", "--url", url, "--requests", str(n),
                           "--concurrency", "4"], timeout)
    return rc == 0 and report.get("ok") == n


def _torn_once(args, injected: bool) -> dict:
    """One server on a delta-published directory (epoch 1). Injected: a
    torn epoch-2 manifest, then an epoch-3 manifest whose new chunks are
    gone, each skipped (a reload failure recorded, still epoch 1, zero
    drops), then a clean epoch 4 the watcher recovers onto. The twin
    publishes epochs 2-4 cleanly: epoch 4, no reload failure."""
    out = {"injected": injected, "ok": False}
    ckpt = tempfile.mkdtemp(prefix="tpumnist-torn-")
    model = args.serve_model
    served = None
    try:
        _delta_publish(ckpt, model, 1, 1)
        served = _Served(args, _backend_flags(args), _serve_env({}),
                         ckpt=ckpt)
        url = served.url
        if url is None or _get_json(url, "/healthz").get(
                "model_epoch") != 1:
            return out
        steps = []

        def failures():
            return _get_json(url, "/stats").get("reload_failures", 0)

        if injected:
            with open(os.path.join(ckpt, "checkpoint_1.manifest"),
                      "rb") as f:
                data = f.read()
            with open(os.path.join(ckpt, "checkpoint_2.manifest"),
                      "wb") as f:
                f.write(data[:len(data) // 2])
            steps.append(_wait_for(lambda: failures() >= 1, args.timeout)
                         and _get_json(url, "/healthz")["model_epoch"] == 1
                         and _smoke(url, args.timeout))
            _delta_publish(ckpt, model, 3, 1, drop_new=True)
            steps.append(_wait_for(lambda: failures() >= 2, args.timeout)
                         and _get_json(url, "/healthz")["model_epoch"] == 1
                         and _smoke(url, args.timeout))
            _delta_publish(ckpt, model, 4, 1)
        else:
            _delta_publish(ckpt, model, 2, 3)
        steps.append(_wait_for(lambda: _get_json(url, "/healthz").get(
            "model_epoch") == 4, args.timeout) and _smoke(url, args.timeout))
        stats = _get_json(url, "/stats")
        out.update(steps=steps, reloads=stats.get("reloads"),
                   reload_failures=stats.get("reload_failures"))
        out["ok"] = all(steps) and stats.get("reload_failures") == (
            2 if injected else 0)
        return out
    finally:
        if served is not None:
            served.close()
        shutil.rmtree(ckpt, ignore_errors=True)


def _quota_once(args, injected: bool) -> dict:
    """One server at ``--quota-rps``. Injected: a hot client at 10x the
    quota beside a well-behaved one; the hot one is clipped with 429 and
    Retry-After, the well-behaved one keeps >= 90% goodput. The twin
    runs the well-behaved client alone: every request answered."""
    out = {"injected": injected, "ok": False}
    served = _Served(args, ["--model", args.serve_model, "--buckets",
                            "1,8,32", "--max-wait-ms", "2", "--max-queue",
                            "64", "--poll-interval", "5", "--quota-rps",
                            str(args.quota_rps)], _serve_env({}))
    try:
        if served.url is None:
            return out
        base = ["--url", served.url, "--mode", "open", "--duration",
                str(args.quota_duration), "--timeout", "20"]
        hog = _start_loadgen(base + ["--rate", str(args.quota_rps * 10),
                                     "--client-id", "hog"]) \
            if injected else None
        good = _start_loadgen(base + ["--rate",
                                      str(max(2.0, args.quota_rps / 4.0)),
                                      "--client-id", "good"])
        _, good_report = _finish_loadgen(good, args.timeout)
        sends, answered = _sends(good_report), good_report.get("ok", 0)
        out["good"] = {"sends": sends, "ok": answered,
                       "quota_rejected": good_report.get("quota_rejected")}
        ok = sends > 0 and answered >= 0.9 * sends
        if injected:
            _, hog_report = _finish_loadgen(hog, args.timeout)
            out["hog"] = {"sends": _sends(hog_report),
                          "quota_rejected": hog_report.get("quota_rejected"),
                          "retry_after_seen":
                              hog_report.get("retry_after_seen")}
            ok = ok and bool(hog_report.get("quota_rejected")) \
                and bool(hog_report.get("retry_after_seen"))
        else:
            ok = ok and answered == sends
        out["ok"] = bool(ok)
        return out
    finally:
        served.close()


def _post_predict(url: str, body: bytes, timeout: float = 30.0):
    """One ``/predict`` of a serialized body: ``(reply, X-Cache)``."""
    import urllib.request

    req = urllib.request.Request(
        url + "/predict", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read()), r.headers.get("X-Cache")


def _cache_once(args, injected: bool) -> dict:
    """One server with the response cache on. A fixed probe body warms
    the cache (a hit among three), then Zipf-duplicate open-loop traffic
    runs; injected, a newer checkpoint lands a moment in and the server
    hot-reloads under the storm. Zero drops, client-seen hits, and every
    probe after it carries the serving epoch (injected: the new one; a
    cache hit from the old params would be a stale reply)."""
    out = {"injected": injected, "ok": False}
    served = _Served(args, ["--model", args.serve_model, "--buckets", "1,8",
                            "--max-wait-ms", "2", "--poll-interval", "0.2"],
                     _serve_env({}))
    try:
        url = served.url
        if url is None:
            return out
        rng = random.Random(3)
        probe = json.dumps({"images": [[[rng.randrange(256)
                                         for _ in range(28)]
                                        for _ in range(28)]]}).encode()
        pre = [_post_predict(url, probe) for _ in range(3)]
        old = pre[0][0].get("model_epoch")
        if {r.get("model_epoch") for r, _ in pre} != {old} \
                or "hit" not in [v for _, v in pre]:
            _say(f"the probe never hit a warm cache: {pre}")
            return out
        storm = _start_loadgen(["--url", url, "--mode", "open", "--rate",
                                str(max(20.0, args.requests /
                                        LOAD_SECONDS)),
                                "--duration", str(LOAD_SECONDS),
                                "--shape", "zipf:1.1", "--timeout", "20"])
        new = old
        if injected:
            time.sleep(0.5)
            new = (old or 0) + 7
            _seed_checkpoint(served.ckpt, new, args.serve_model)
        swapped = _wait_for(lambda: _get_json(url, "/healthz").get(
            "model_epoch") == new, args.timeout)
        rc, report = _finish_loadgen(storm, args.timeout)
        hits = report.get("cache_client", {}).get("hits", 0)
        post = [_post_predict(url, probe) for _ in range(8)]
        stale = [i for i, (r, _) in enumerate(post)
                 if r.get("model_epoch") != new]
        stats = _get_json(url, "/stats").get("cache", {})
        out.update(epochs=[old, new], storm_ok=report.get("ok"),
                   sends=_sends(report), dropped=_dropped(report),
                   client_hits=hits, stale_replies=len(stale),
                   post_cache=[v for _, v in post],
                   generation=stats.get("generation"),
                   stale_drops=stats.get("stale_drops"))
        out["ok"] = bool(swapped and not _dropped(report)
                         and report.get("ok") == _sends(report) and hits
                         and not stale and "hit" in out["post_cache"])
        return out
    finally:
        served.close()


def run_serve_twins(args, name: str, once) -> int:
    """``once(args, injected)`` for the scenario, then for its no-fault
    twin; one ``chaos`` line, exit 0 only when both held."""
    t0 = time.perf_counter()
    faulted = once(args, True)
    twin = None if args.no_twin else once(args, False)
    ok = faulted["ok"] and (twin is None or twin["ok"])
    print(json.dumps({"chaos": {
        name: {"device": args.device, "model": args.serve_model},
        "faulted": faulted, "twin": twin, "ok": ok,
        "seconds": time.perf_counter() - t0}}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos",
        description="run a local training world with one process "
                    "sabotaged at a named fault point, a serve process "
                    "or a fleet under a fault, then its twin with no "
                    "fault")
    p.add_argument("--list", action="store_true",
                   help="print the fault points and exit")
    p.add_argument("--fault", type=str, default=None,
                   help="point:host:kind[:arg][,...] (kill, raise, stall)")
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--agreement-timeout", type=float, default=15.0,
                   help="every rank's agreement deadline; a failed "
                        "world's survivors get twice this plus 15 s to "
                        "exit on their own before they are stopped")
    p.add_argument("--elastic", action="store_true",
                   help="run the world under the elastic supervisor")
    p.add_argument("--min-world", type=int, default=1, metavar="W",
                   help="--elastic: the smallest world to shrink to")
    p.add_argument("--elastic-grow", action="store_true",
                   help="--elastic: run the epoch-boundary grow "
                        "rendezvous too, so join records (--rejoin) are "
                        "admitted between epochs")
    p.add_argument("--max-world", type=int, default=0, metavar="W",
                   help="--elastic: the largest world to grow to (0: no "
                        "bound)")
    p.add_argument("--rejoin", type=str, default=None,
                   metavar="HOST@GEN[,...]",
                   help="--elastic: write HOST's join record while "
                        "generation GEN runs (a returning host announcing "
                        "itself; e.g. 1@1 for the 2 -> 1 -> 2 twin)")
    p.add_argument("--settle-timeout", type=float, default=60.0,
                   help="--elastic: seconds the supervisor waits for the "
                        "other ranks once one failed, before it stops "
                        "them and rebuilds without them")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds one world (one generation) may take")
    p.add_argument("--no-twin", action="store_true",
                   help="skip the run with no fault")
    serve = p.add_argument_group("serving modes")
    serve.add_argument("--serve", action="store_true",
                       help="boot the port's server, drive it with "
                            "loadgen, and require every request answered "
                            "through a replica's death (--serve-fault), a "
                            "rolling --resize or a canary rollback "
                            "(--canary-rollback), then the final topology "
                            "(--expect-groups); then the no-fault twin")
    serve.add_argument("--autoscale-spike", action="store_true",
                       help="spike loadgen against a 1-replica pool "
                            "under --autoscale: the dry run must record a "
                            "scale-up and move nothing, the real run "
                            "resize up and back down with zero drops "
                            "(needs 2 devices: --device cpu gives them)")
    serve.add_argument("--quota-abuse", action="store_true",
                       help="one hot client at 10x --quota-rps must be "
                            "clipped with 429 + Retry-After while a "
                            "well-behaved client keeps >= 90%% goodput")
    serve.add_argument("--cache-storm", action="store_true",
                       help="Zipf-duplicate loadgen over a live hot "
                            "reload: zero drops through the swap and no "
                            "stale reply after it")
    serve.add_argument("--torn-manifest", action="store_true",
                       help="a torn manifest, then one with a missing "
                            "chunk, then a clean publish: both damaged "
                            "ones skipped, serving never stops, the clean "
                            "one recovered with no restart")
    serve.add_argument("--device", type=str, default="cuda",
                       choices=["cuda", "cpu"],
                       help="the served device (serving and fleet modes)")
    serve.add_argument("--serve-devices", type=int, default=2)
    serve.add_argument("--serve-model", type=str, default="linear")
    serve.add_argument("--serve-precision", type=str, default=None,
                       help="the served plane (the fleet modes: int8 "
                            "unless named)")
    serve.add_argument("--serve-fault", type=str, default=None,
                       metavar="GROUP[:AFTER]",
                       help=f"{SERVE_FAULT_ENV}: replica GROUP's dispatch "
                            f"fails after AFTER successful batches")
    serve.add_argument("--resize", type=str, default=None,
                       metavar="N1[,N2...]",
                       help="POST /resize through these serve_devices "
                            "targets while loadgen runs")
    serve.add_argument("--canary-rollback", action="store_true",
                       help=f"boot with --canary-fraction 1.0 and "
                            f"{CANARY_FAULT_ENV}=disagree (bf16 unless "
                            f"--serve-precision)")
    serve.add_argument("--quarantine-after", type=int, default=3)
    serve.add_argument("--expect-groups", type=int, default=0,
                       help="active replicas the final /stats must show "
                            "(0 skips)")
    serve.add_argument("--requests", type=int, default=200)
    serve.add_argument("--slo-p95-ms", type=float, default=150.0)
    serve.add_argument("--spike-rate", type=float, default=60.0)
    serve.add_argument("--spike-duration", type=float, default=8.0)
    serve.add_argument("--quota-rps", type=float, default=20.0,
                       help="--quota-abuse: the server's per-client "
                            "requests/s")
    serve.add_argument("--quota-duration", type=float, default=6.0,
                       help="--quota-abuse: loadgen seconds")
    fleet = p.add_argument_group("fleet modes")
    fleet.add_argument("--fleet", type=int, default=0, metavar="N",
                       help="boot the port's router over N port serve "
                            "processes; with one of --kill-backend, "
                            "--rolling-reload, --fleet-canary-rollback, "
                            "--delta-publish")
    fleet.add_argument("--kill-backend", type=int, default=None,
                       metavar="K",
                       help="SIGKILL backend K under traffic: zero "
                            "dropped requests, quarantine, then probation "
                            "back to healthy after a restart on its port")
    fleet.add_argument("--rolling-reload", action="store_true",
                       help="POST /rollout a new epoch across the fleet "
                            "under traffic: zero drops, every backend on "
                            "the new epoch")
    fleet.add_argument("--fleet-canary-rollback", action="store_true",
                       help=f"a publish behind a fleet canary with "
                            f"{FLEET_FAULT_ENV}=canary_disagree in the "
                            f"router: rolled back, the baseline's weights "
                            f"republished, every request answered")
    fleet.add_argument("--delta-publish", type=int, default=0,
                       metavar="E",
                       help="every backend watches one shared directory; "
                            "E adjacent delta publishes under traffic: "
                            "zero drops, the fleet converges, each "
                            "publish adds < 30%% of the cold publish's "
                            "chunk bytes")
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="arguments after -- go to the CLI verbatim")
    args = p.parse_args(argv)
    if args.list:
        list_fault_points()
        return 0
    if args.fleet:
        if args.fleet < 2:
            raise SystemExit("--fleet N needs N >= 2 (a fleet of one has "
                             "no failure domain to survive)")
        return run_fleet_chaos(args)
    if args.kill_backend is not None or args.rolling_reload \
            or args.fleet_canary_rollback or args.delta_publish:
        raise SystemExit("--kill-backend/--rolling-reload/"
                         "--fleet-canary-rollback/--delta-publish are "
                         "fleet modes; add --fleet N")
    if args.torn_manifest:
        return run_serve_twins(args, "torn_manifest", _torn_once)
    if args.quota_abuse:
        return run_serve_twins(args, "quota_abuse", _quota_once)
    if args.cache_storm:
        return run_serve_twins(args, "cache_storm", _cache_once)
    if args.serve or args.autoscale_spike:
        args.resize_targets = [int(t) for t in (args.resize or "").split(",")
                               if t.strip()]
        return run_autoscale_spike(args) if args.autoscale_spike \
            else run_serve_chaos(args)
    if (args.elastic_grow or args.rejoin or args.max_world) \
            and not args.elastic:
        raise SystemExit("--elastic-grow/--rejoin/--max-world require "
                         "--elastic")
    rejoin = parse_rejoin(args.rejoin) if args.rejoin else []
    if args.fault:
        parse_fault_specs(args.fault)  # fail fast with the spec's message
    cli_args = list(args.cli_args)
    if cli_args and cli_args[0] == "--":
        cli_args = cli_args[1:]
    device = cli_device(cli_args)
    cli_args = strip_flags(cli_args, {"--device": 1})
    os.environ[TIMEOUT_ENV] = str(args.agreement_timeout)
    print(f"chaos: {args.nprocs} ranks on {device}"
          + (" under the elastic supervisor" if args.elastic else "")
          + (f", fault {args.fault}" if args.fault else " (no fault)")
          + (f", rejoin {args.rejoin}" if rejoin else "")
          + f", agreement timeout {args.agreement_timeout:g}s",
          file=sys.stderr, flush=True)
    faulted = _world(args, cli_args, args.fault, device, rejoin)
    twin = None if args.no_twin else _world(args, twin_argv(cli_args),
                                            None, device)
    ok = not faulted["stopped"] and (
        twin is None or all(rc == 0 for rc in twin["returncodes"]))
    print(json.dumps({"chaos": {"fault": args.fault, "nprocs": args.nprocs,
                                "elastic": args.elastic,
                                "rejoin": args.rejoin, "device": device,
                                "faulted": faulted, "twin": twin,
                                "ok": ok}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
