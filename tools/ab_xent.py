"""A/B of two builds of the port's cross-entropy kernels
(``csrc/xent.cu``) on one card.

Builds two sources (A and B, B by default the checkout's own) as
libraries of their own, prints each build's ptxas registers and spills
per kernel, and

1. holds both against the plain versions (``ops/xent.py``) at
   ``chip_smoke.py``'s check shapes (``XENT_CHECK_BATCHES`` x
   ``XENT_CHECK_CLASSES``), the same bits on a second call;
2. times each kernel alone (device ms from the profiler's trace,
   ``chip_smoke.device_ms``) at (256, 10) (the cnn's, ViT's and MoE's
   train and eval batch), (128, 10) (``--grad-accum 2``), (300, 10) and
   (256, 128), in turns A, B, B, A, beside the smallest kernel PyTorch
   launches (an add on one float: the floor of a kernel's device time);
3. runs the replayed scan step of the cnn and of ``moe_mlp`` (bf16, fused
   loss and Adam; ``chip_smoke._scan_setup``) with each source, one
   process per source and turn, in the same turns: device kernels and
   device ms per replayed step, each cross-entropy kernel's device ms per
   call, the gap between the end of the kernel before it and its start,
   and the launches the wrappers credit per epoch.

Prints one JSON line per result, then the card's name and power limit.

    python3 tools/ab_xent.py --a PARENT/csrc/xent.cu
    python3 tools/ab_xent.py --a X.cu --b Y.cu --no-steps

A source must keep the C entries of ``ops/cuda_build.py``'s
``KERNELS["xent"]``. Needs a CUDA card and ``nvcc``; the builds go under
the checkout's ``build/torch_kernels/``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.ab_builds import in_turns, register  # noqa: E402

# (B, C): the train and eval batch, --grad-accum 2's micro-batch, a
# ragged batch, and the widest tile.
TIMING_SHAPES = [(256, 10), (128, 10), (300, 10), (256, 128)]
STEP_MODELS = ("cnn", "moe_mlp")
STEP_EPOCHS = 2  # replayed epochs a step trace holds (32 steps each)


def _stream(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def fwd(lib, logits, labels):
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

    b, c = logits.shape
    loss = torch.empty(b, device=logits.device)
    lse = torch.empty(b, device=logits.device)
    err = cuda_build.load(lib).xent_fwd_launch(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        b, c, logits.stride(0), logits.device.index, _stream(logits))
    if err:
        raise RuntimeError(f"{lib} forward: CUDA error {err}")
    return loss, lse


def bwd(lib, logits, labels, lse, g):
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

    b, c = logits.shape
    out = torch.empty((b, c), device=logits.device)
    err = cuda_build.load(lib).xent_bwd_launch(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        out.data_ptr(), b, c, logits.stride(0), out.stride(0),
        logits.device.index, _stream(logits))
    if err:
        raise RuntimeError(f"{lib} backward: CUDA error {err}")
    return out


def check(libs, device) -> dict:
    """Each library's largest error against the plain versions over the
    check shapes; raises, after every shape, on an error outside rtol =
    atol = 1e-6 or other bits on a second call."""
    import torch

    import chip_smoke as smoke
    from pytorch_distributed_mnist_tpu_torch.ops import xent

    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 2)
    worst = {lib: 0.0 for lib in libs}
    faults = []
    for b in smoke.XENT_CHECK_BATCHES:
        for c in smoke.XENT_CHECK_CLASSES:
            logits, labels, g = smoke.xent_inputs(b, c, gen, device)
            want_loss, want_lse = xent.xent_fwd_plain(logits, labels)
            for lib in libs:
                loss, lse = fwd(lib, logits, labels)
                again = fwd(lib, logits, labels)
                dl = bwd(lib, logits, labels, lse, g)
                dl2 = bwd(lib, logits, labels, lse, g)
                want_dl = xent.xent_bwd_plain(logits, labels, lse, g)
                torch.cuda.synchronize()
                if not (torch.equal(loss, again[0])
                        and torch.equal(lse, again[1])
                        and torch.equal(dl, dl2)):
                    faults.append(f"{lib} {b}x{c}: other bits on a second "
                                  f"call")
                for got, want in ((loss, want_loss), (lse, want_lse),
                                  (dl, want_dl)):
                    try:
                        torch.testing.assert_close(got, want, rtol=1e-6,
                                                   atol=1e-6)
                    except AssertionError as e:
                        faults.append(f"{lib} {b}x{c}: {e}")
                    worst[lib] = max(worst[lib],
                                     float((got - want).abs().max()))
    if faults:
        raise AssertionError("\n".join(faults))
    return worst


def timings(libs, device, peaks) -> list:
    """Device ms per call of each library's kernels at ``TIMING_SHAPES``,
    in turns A, B, B, A, beside the floor (an add on one float)."""
    import torch

    import chip_smoke as smoke
    from pytorch_distributed_mnist_tpu_torch.ops import xent

    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 3)
    one = torch.zeros(1, device=device)
    rows = []
    for b, c in TIMING_SHAPES:
        logits, labels, g = smoke.xent_inputs(b, c, gen, device)
        _, lse = xent.xent_fwd_plain(logits, labels)
        for kind, moved in (("fwd", 4 * b * c + 16 * b),
                            ("bwd", 8 * b * c + 16 * b)):
            calls = {"floor": lambda: one.add_(1.0)}
            for lib in libs:
                calls[lib] = (lambda lib=lib: fwd(lib, logits, labels)) \
                    if kind == "fwd" else \
                    (lambda lib=lib: bwd(lib, logits, labels, lse, g))
            times = in_turns(list(calls), lambda n: sum(
                smoke.device_ms(calls[n]).values()))
            row = {"shape": [b, c], "kind": kind,
                   "bound_ms": moved / peaks[0] * 1e3, **times}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def step_run(source: str) -> dict:
    """The package's ``xent`` built from ``source`` inside the replayed
    scan step of each of ``STEP_MODELS``: device kernels and ms per step,
    each cross-entropy kernel's ms per call and the gap before it
    (median over the trace), launches credited per epoch."""
    import torch

    import chip_smoke as smoke
    from pytorch_distributed_mnist_tpu_torch.ops import xent

    register({"xent": source}, "xent")
    device = torch.device("cuda", 0)
    out = {"source": source}
    for model in STEP_MODELS:
        make_state, _, staged = smoke._scan_setup(device, model, 4)
        scan = smoke._epoch_program(device, make_state, staged)
        before = (xent.xent_fwd.launches, xent.xent_bwd.launches)
        steps = STEP_EPOCHS * smoke.SCAN_STEPS
        with smoke.device_trace() as prof:
            for _ in range(STEP_EPOCHS):
                scan["run"]()
            torch.cuda.synchronize()
        credited = [(xent.xent_fwd.launches - before[0]) / STEP_EPOCHS,
                    (xent.xent_bwd.launches - before[1]) / STEP_EPOCHS]
        events = sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and smoke.LEAD_KERNEL not in e.name),
            key=lambda e: e.time_range.start)
        row = {"kernels_per_step": len(events) / steps,
               "device_ms_per_step": sum(e.time_range.elapsed_us()
                                         for e in events) / 1e3 / steps,
               "launches_per_epoch": credited}
        for kernel in ("xent_fwd_kernel", "xent_bwd_kernel"):
            at = [i for i, e in enumerate(events) if kernel in e.name and i]
            gaps = [events[i].time_range.start - events[i - 1].time_range.end
                    for i in at]
            row[kernel] = {
                "calls": len(at),
                "ms": sum(events[i].time_range.elapsed_us()
                          for i in at) / 1e3 / max(len(at), 1),
                "gap_us_median": statistics.median(gaps) if gaps else None}
        out[model] = row
    return out


def steps(sources: dict) -> dict:
    """``step_run`` of each {library: source} in turns A, B, B, A, each in
    a process of its own."""
    def one(lib):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--step",
             sources[lib]], capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        row = ({"error": proc.stderr[-3000:]}
               if proc.returncode != 0 or not lines
               else json.loads(lines[-1]))
        print(json.dumps({"lib": lib, **row}), flush=True)
        return row

    return in_turns(list(sources), one)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--a", help="source A (a .cu path)")
    parser.add_argument("--b", default=None,
                        help="source B (default: the checkout's own)")
    parser.add_argument("--no-steps", action="store_true",
                        help="kernels alone only")
    parser.add_argument("--step", help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_xent.py: no CUDA card is visible", file=sys.stderr)
        return 1
    if args.step:
        print(json.dumps(step_run(args.step)), flush=True)
        return 0
    if not args.a:
        parser.error("--a is required")
    import chip_smoke as smoke
    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

    sources = {"xent_a": args.a}
    if args.b is not None:
        sources["xent_b"] = args.b
    register(sources, "xent")
    libs = ["xent_a", "xent_b" if args.b else "xent"]
    info = cuda_build.build(libs)  # one nvcc each, in parallel
    for lib in libs:
        print(json.dumps({"build": lib, "seconds": info[lib]["seconds"],
                          "ptxas": smoke.ptxas_counts(info[lib]["log"])}),
              flush=True)
    device = torch.device("cuda", 0)
    _, peaks = smoke.peaks_for(torch.cuda.get_device_name(0))
    print(json.dumps({"check": check(libs, device)}), flush=True)
    timings(libs, device, peaks)
    if not args.no_steps:
        steps({"xent_a": args.a,
               libs[1]: args.b or cuda_build.source_path("xent")})
    print(smoke.smi_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
