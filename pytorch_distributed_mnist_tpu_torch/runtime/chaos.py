"""Fault-injection (chaos) harness of the training world.

Counterpart of the training-world part of ``tools/chaos.py``: it runs the
same local world as ``--spawn N --device cpu`` (gloo; or, with
``--elastic``, the elastic supervisor of ``runtime/elastic.py``) with one
process sabotaged at a named fault point
(``TPUMNIST_FAULT=point:host:kind[:arg]``, ``runtime/supervision.py``),
then the same world with no fault, as the twin to compare with::

    # what can be injected, and where each point fires
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos --list

    # SIGKILL rank 1 at the checkpoint publish agreement: rank 0 must
    # exit 75 with PeerFailure naming host 1, not wait
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \\
        --fault ckpt_publish:1:kill --nprocs 2 --agreement-timeout 8 -- \\
        --model linear --dataset synthetic --epochs 2 \\
        --synthetic-train-size 2048 --synthetic-test-size 512 \\
        --batch-size 64 --checkpoint-dir /tmp/chaos/ck

    # ELASTIC: kill rank 2 at epoch 1's entry; the world shrinks to 2
    # ranks, resumed from checkpoint_0, and trains to the end
    python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos \\
        --elastic --min-world 2 --fault train_epoch:2:kill:1 --nprocs 3 \\
        -- --model linear --dataset synthetic --epochs 2 \\
        --synthetic-train-size 2048 --synthetic-test-size 512 \\
        --batch-size 96 --checkpoint-dir /tmp/chaos/el

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

Each prints one JSON ``chaos`` line last and exits 0 when the scenario
and its twin both held. The fleet modes (``--fleet``, ``--torn-manifest``,
``--delta-publish``), the quota and cache twins, and the grow drive
(``--rejoin``) wait for the port's router (ROADMAP Queue 1 item 13) and a
joining host.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

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


# The injection variables of the serve plane, spelled as
# ``serve/pool.py`` and ``serve/canary.py`` define them (and as
# ``tools/chaos.py`` spells them).
SERVE_FAULT_ENV = "TPUMNIST_SERVE_FAULT"
CANARY_FAULT_ENV = "TPUMNIST_CANARY_FAULT"
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


def _world(args, cli_args: List[str], fault: Optional[str]) -> dict:
    """One run of the world with ``fault`` set (or none)."""
    if fault:
        os.environ[FAULT_ENV] = fault
    else:
        os.environ.pop(FAULT_ENV, None)
    t0 = time.perf_counter()
    if args.elastic:
        rc = supervise(args.nprocs, cli_args, min_world=args.min_world,
                       generation_timeout=args.timeout, device="cpu")
        out = {"returncodes": [rc], "stopped": []}
    else:
        got = run_local(args.nprocs, cli_args, "cpu", timeout=args.timeout,
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


class _Served:
    """One port server process on a fresh checkpoint directory (seeded
    fresh params), its log in a temporary file; ``url`` is None when it
    never came up. ``close`` kills it and removes both."""

    def __init__(self, args, flags: List[str], env: dict) -> None:
        self.ckpt = tempfile.mkdtemp(prefix="tpumnist-serve-chaos-")
        self.log = tempfile.NamedTemporaryFile(mode="w+", suffix=".log",
                                               delete=False)
        cmd = [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
               "serve", "--device", args.device, "--checkpoint-dir",
               self.ckpt, "--host", "127.0.0.1", "--port", "0"] + flags
        _say(f"booting serve twin: {' '.join(cmd)}")
        self.proc = subprocess.Popen(cmd, env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT)
        self.url = None
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline and self.url is None:
            if self.proc.poll() is not None:
                break
            with open(self.log.name) as f:
                m = re.search(r"serving on (http://\S+)", f.read())
            if m:
                self.url = m.group(1).rstrip("/")
            else:
                time.sleep(0.2)
        if self.url is None:
            with open(self.log.name) as f:
                print(f.read()[-4000:], file=sys.stderr)
            _say("server never came up")

    def close(self) -> None:
        self.proc.kill()
        self.proc.wait()
        self.log.close()
        os.unlink(self.log.name)
        shutil.rmtree(self.ckpt, ignore_errors=True)


def _serve_env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in (SERVE_FAULT_ENV, CANARY_FAULT_ENV)}
    env.update(extra)
    env["PYTHONUNBUFFERED"] = "1"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _loadgen(argv: List[str], timeout: float) -> tuple:
    """``tools/loadgen.py`` (pure stdlib) run to its end: ``(exit code,
    its last-line report)``; killed and reaped at ``timeout``."""
    proc = subprocess.Popen([sys.executable, _LOADGEN] + argv,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
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
        load = subprocess.Popen(
            [sys.executable, _LOADGEN, "--smoke", "--url", served.url,
             "--requests", str(args.requests), "--concurrency", "8"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            resized = []
            # Roll the topology while the load runs: each /resize must
            # complete under traffic with zero dropped requests.
            for target in (args.resize_targets if injected else []):
                time.sleep(0.5)
                reply = _post_json(served.url, "/resize",
                                   {"serve_devices": target})
                resized.append(reply["new"]["groups"])
            text, _ = load.communicate(timeout=args.timeout)
        except BaseException:
            load.kill()
            load.wait()
            raise
        report = json.loads(text.strip().splitlines()[-1]
                            if text.strip() else "{}")
        out.update(answered=report.get("ok"), requests=args.requests,
                   transport_errors=report.get("transport_errors"),
                   resized=resized)
        ok = load.returncode == 0 and report.get("ok") == args.requests
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_mnist_tpu_torch.runtime.chaos",
        description="run a local training world with one process "
                    "sabotaged at a named fault point, then its twin "
                    "with no fault")
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
    serve.add_argument("--device", type=str, default="cuda",
                       choices=["cuda", "cpu"],
                       help="the served device (serving modes)")
    serve.add_argument("--serve-devices", type=int, default=2)
    serve.add_argument("--serve-model", type=str, default="linear")
    serve.add_argument("--serve-precision", type=str, default=None)
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
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="arguments after -- go to the CLI verbatim")
    args = p.parse_args(argv)
    if args.list:
        list_fault_points()
        return 0
    if args.serve or args.autoscale_spike:
        args.resize_targets = [int(t) for t in (args.resize or "").split(",")
                               if t.strip()]
        return run_autoscale_spike(args) if args.autoscale_spike \
            else run_serve_chaos(args)
    if args.fault:
        parse_fault_specs(args.fault)  # fail fast with the spec's message
    cli_args = list(args.cli_args)
    if cli_args and cli_args[0] == "--":
        cli_args = cli_args[1:]
    cli_args = strip_flags(cli_args, {"--device": 1})
    os.environ[TIMEOUT_ENV] = str(args.agreement_timeout)
    print(f"chaos: {args.nprocs} ranks on the CPU"
          + (" under the elastic supervisor" if args.elastic else "")
          + (f", fault {args.fault}" if args.fault else " (no fault)")
          + f", agreement timeout {args.agreement_timeout:g}s",
          file=sys.stderr, flush=True)
    faulted = _world(args, cli_args, args.fault)
    twin = None if args.no_twin else _world(args, twin_argv(cli_args), None)
    ok = not faulted["stopped"] and (
        twin is None or all(rc == 0 for rc in twin["returncodes"]))
    print(json.dumps({"chaos": {"fault": args.fault, "nprocs": args.nprocs,
                                "elastic": args.elastic,
                                "faulted": faulted, "twin": twin,
                                "ok": ok}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
