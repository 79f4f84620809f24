"""The readings that set a cell's limits, on the card, in one process:
for each seed, the program's probe against the reference (the lower
readings), the control (the reference in scaled float8 put in the
program's place) and each fault planted in the program (the upper ones).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults half_batch,eval_altered] \
        [--out chiprun_out/readings-<cell>.jsonl]

No window runs: the set-up of a run (``session.Rank`` and
``session.set_up``: the warm-up epoch that captures the graphs, then the
probe through their replays) runs once per seed, and once per planted
fault on the control's seeds. One JSON line per reading goes to
``--out`` and to standard output. Faults, planted before the warm-up so
that the graphs capture them:

- ``half_batch``: the train step takes the first half of its batch and
  the mean over it;
- ``state_unchanged``: the optimizer's step does nothing (it reads 1 on
  the change by the measure, so it needs no chip run);
- ``eval_altered``: every eval step's loss sum is 5% high.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")

from portbench.core import check, session, spec  # noqa: E402


@contextlib.contextmanager
def planted(fault):
    """The port with ``fault`` planted for the block (``None``: as it is)."""
    from pytorch_distributed_mnist_tpu_torch.train import steps

    saved = {}

    def swap(name, value):
        saved[name] = getattr(steps, name)
        setattr(steps, name, value)

    if fault == "half_batch":
        step = steps.train_step

        def half(state, batch, *args, **kwargs):
            rows = batch["label"].shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()},
                        *args, **kwargs)

        swap("train_step", half)
    elif fault == "eval_altered":
        evaluate = steps.eval_step

        def altered(state, batch):
            ms = evaluate(state, batch)
            return type(ms)(ms.loss_sum * 1.05, ms.correct, ms.count)

        swap("eval_step", altered)
    elif fault not in (None, "state_unchanged"):
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(steps, name, value)


def probe(cell, seed, device, ref, fault=None):
    """The program's readings for ``seed`` with ``fault`` planted, and its
    rank object (for the reference's inputs)."""
    rank = session.Rank(cell, seed, device, ref)
    if fault == "state_unchanged":
        rank.state.optimizer.step = lambda closure=None: None
    with planted(fault):
        prog = session.set_up(rank)
    rank.close()
    return prog, rank


def free(rank, torch, on_card):
    del rank.trainer, rank.state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def readings(cell, seeds, control_seeds, faults, device_name=None,
             emit=print):
    """Every reading, each emitted as it comes."""
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
    from pytorch_distributed_mnist_tpu_torch.utils import compile_cache

    on_card = device_name is None
    device = (torch.device("cuda", 0) if on_card
              else torch.device(device_name))
    if on_card:
        torch.cuda.set_device(device)
        compile_cache.configure()
        cuda_build.build(session.kernel_libraries(cell))
    ref = spec.load_module("reference", cell.model)
    out = []
    for seed in seeds:
        for fault in [None] + (list(faults) if seed in control_seeds
                               else []):
            t0 = time.perf_counter()
            prog, rank = probe(cell, seed, device, ref, fault)
            free(rank, torch, on_card)
            numbers, against = session.reference_numbers(cell, rank, prog,
                                                         device)
            rows = [("program" if fault is None else fault, numbers, prog)]
            if fault is None and seed in control_seeds:
                fp8 = check.reference_readings(
                    ref, cell.config, cell.traffic,
                    {k: w.to(device) for k, w in rank.weights.items()},
                    rank.probe_batches(device),
                    torch.from_numpy(rank.host["test_image"]).to(device),
                    torch.from_numpy(rank.host["test_label"]).to(device),
                    "fp8")
                rows.append(("control_fp8", check.gaps(fp8, against), fp8))
            for kind, nums, side in rows:
                rec = {"cell": cell.name, "seed": seed, "kind": kind,
                       "numbers": nums, "losses": side["losses"],
                       "leaves": check.leaf_gaps(side, against),
                       "seconds": time.perf_counter() - t0}
                emit(json.dumps(rec))
                out.append(rec)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    session.cuda_env(ROOT)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]
    import torch

    if not torch.cuda.is_available() or cell.chips != 1:
        print(f"control: {cell.name} needs one CUDA card, and this script "
              f"runs cells on one", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    try:
        readings(cell, seeds, control, faults, emit=emit)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
