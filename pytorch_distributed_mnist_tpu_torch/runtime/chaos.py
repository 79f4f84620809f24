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
``--checkpoint-dir`` (the given one with ``_twin`` appended). The serving
chaos modes of ``tools/chaos.py`` (pool faults, autoscaling, quotas,
fleets) and its grow drive (``--rejoin``) wait for the port's serving
fleet and a joining host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
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
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="arguments after -- go to the CLI verbatim")
    args = p.parse_args(argv)
    if args.list:
        list_fault_points()
        return 0
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
