"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port. The cell's
configuration, traffic and limits are found by the names in
``BENCHMARK.json``. A run uses one card and one process: a cell that asks
for more cards is refused.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decided ``correct``
beside its limit, which the last lines of standard error repeat.

Without a card, with a cell of more than one card, without the port, or
with a module of JAX loaded once the window has closed, the run exits
non-zero and prints no result.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Python's bytecode cache, at a fixed directory inside the checkout: where
# the interpreter's own tree is not writable, every process would compile
# torch's sources again.
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")

from portbench.core import check, guard, session, spec  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit(index: int) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def result_line(cell, res: dict, traced: bool, device: dict) -> dict:
    """The result's fields, in the contract's order, ``checks`` last."""
    numbers = res["numbers"]
    checks = {k: {"value": numbers.get(k), "limit": lim}
              for k, lim in cell.limits.items()}
    failed = len(check.failing(numbers, cell.limits))
    line = {"correct": failed == 0, "attempted": len(checks),
            "failed": failed}
    if traced:
        line["metrics"] = {m["name"]: {"value": res["layers"][m["name"]],
                                       "unit": m["unit"]}
                           for m in cell.per_layer
                           if m["name"] in res["layers"]}
        line["device"] = dict(device, busy_s=res["busy_s"],
                              window_s=res["span_s"])
        line["breakdown"] = res["breakdown"]
    else:
        values = {"train_images_per_s": res["images"] / res["window_s"],
                  "setup_s": res["setup_s"]}
        line["metrics"] = {m["name"]: {"value": values[m["name"]],
                                       "unit": m["unit"]}
                           for m in cell.end_to_end}
        line["device"] = device
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    session.cuda_env(ROOT)
    cell = spec.load_cell(args.workload)
    import torch

    clock = session.Clock(_START)
    clock.mark("import_torch")
    if not torch.cuda.is_available() or cell.chips != 1:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"portbench: {cell.name} asks for {cell.chips} CUDA card(s), "
            f"{found} visible; this harness runs cells on one card")
        return 2
    res = session.run(cell, args.seed, args.seconds, bool(args.trace),
                      clock, log=log)
    found = guard.loaded_forbidden()
    if found:
        log(f"portbench: modules of JAX or of the JAX package are loaded: "
            f"{found}")
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res["peak"],
              "power_limit": power_limit(0)}
    line = result_line(cell, res, bool(args.trace), device)
    log(f"portbench: {cell.name} seed {args.seed}: {res['epochs']} epochs, "
        f"{res['images']} images in {res['window_s']:.6f} s "
        f"({res['images'] / res['window_s']:.1f} images/s), set-up "
        f"{res['setup_s']:.6f} s, split {json.dumps(res['split'])}, "
        f"power limit {device['power_limit']}")
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
