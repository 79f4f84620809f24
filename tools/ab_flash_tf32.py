"""A/B of two builds of the port's float32 flash kernels on one card.

Builds two sources of ``csrc/flash_tf32.cu`` (A and B, each with the
``csrc/`` headers it includes beside it) as libraries of their own,
prints each build's ptxas registers and spills per kernel, holds both
against the plain versions (``ops/flash.py``) at ``chip_smoke.py``'s
float32 check shapes (``FLASH_CHECK_SHAPES`` and ``TILED_CHECK_SHAPES``),
causal and not, twice for the same bits, and times the forward and the
backward pair of each at the ViT's shapes (D = 16 and 12, T = 49 and
196) and the per-rank and per-microbatch shapes of ``chip_smoke.py``, in
turns A, B, B, A, with ``chip_smoke.device_ms`` (device time from the
profiler's trace). Prints one JSON line per row, then the card's name
and power limit.

    python3 tools/ab_flash_tf32.py --a PARENT/csrc/flash_tf32.cu
    python3 tools/ab_flash_tf32.py --a X.cu --b Y.cu --no-check

B defaults to the checkout's own source. A source must keep the C
entries of ``ops/cuda_build.py``'s ``KERNELS["flash_tf32"]``. Needs a
CUDA card and ``nvcc``; the builds go under the checkout's
``build/torch_kernels/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.ab_builds import in_turns, register  # noqa: E402


def fwd(lib, q, k, v, causal=False):
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    q, k, v = flash._views(q, k, v)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    flash._launch("flash_fwd_tf32_launch", q,
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr()], flash._scale(q, None), causal, lib)
    return o, lse


def bwd(lib, q, k, v, o, lse, do, causal=False):
    import torch

    from pytorch_distributed_mnist_tpu_torch.ops import flash

    q, k, v = flash._views(q, k, v)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    b, t, h, d = q.shape
    dq, dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    flash._launch("flash_bwd_tf32_launch", q,
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr()],
                  flash._scale(q, None), causal, lib)
    return dq, dk, dv


def check(libs, device) -> dict:
    """Each library's largest share of ``flash_tolerance(float32)`` used,
    forward and backward, over every float32 check shape, causal and not;
    raises, after every shape, on a share above 1 or other bits on a
    second call, naming each."""
    import torch

    import chip_smoke as smoke
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    tol = smoke.flash_tolerance(torch.float32)
    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 4)
    worst = {lib: {"fwd": 0.0, "bwd": 0.0} for lib in libs}
    faults = []
    for shape in smoke.FLASH_CHECK_SHAPES + smoke.TILED_CHECK_SHAPES:
        for causal in (False, True):
            q, k, v, do = smoke.flash_inputs(shape, torch.float32, gen,
                                             device)
            want_o, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
            want = flash.flash_bwd_plain(q, k, v, want_o, want_lse, do,
                                         causal=causal)
            for lib in libs:
                got = fwd(lib, q, k, v, causal)
                again = fwd(lib, q, k, v, causal)
                grads = bwd(lib, q, k, v, want_o, want_lse, do, causal)
                grads2 = bwd(lib, q, k, v, want_o, want_lse, do, causal)
                torch.cuda.synchronize()
                where = f"{lib} {shape} causal={causal}"
                if not all(torch.equal(a, b) for a, b in
                           zip(got + grads, again + grads2)):
                    faults.append(f"other bits on a second call: {where}")
                share = max(smoke.tolerance_used(got[0], want_o, tol),
                            smoke.tolerance_used(got[1], want_lse, tol))
                worst[lib]["fwd"] = max(worst[lib]["fwd"], share)
                bshare = max(smoke.tolerance_used(a, w, tol)
                             for a, w in zip(grads, want))
                worst[lib]["bwd"] = max(worst[lib]["bwd"], bshare)
                if not share <= 1 or not bshare <= 1:
                    faults.append(f"outside flash_tolerance: {where} fwd "
                                  f"{share:.3g} bwd {bshare:.3g}")
    if faults:
        raise AssertionError("\n".join(faults))
    return worst


def timings(libs, device, peaks) -> list:
    """Rows of device ms per call at the ViT's shapes (D = 16 and 12) and
    the per-rank and per-microbatch shapes, each library timed in turns A,
    B, B, A."""
    import torch

    import chip_smoke as smoke
    from pytorch_distributed_mnist_tpu_torch.ops import flash

    shapes = ([("vit", smoke.VIT_SHAPE), ("p2", smoke.P2_SHAPE),
               ("d12", smoke.D12_SHAPE), ("d12_p2", smoke.D12_P2_SHAPE)]
              + list(smoke.RANK_SHAPES) + list(smoke.PIPELINE_SHAPES))
    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 5)
    rows = []
    for tag, shape in shapes:
        q, k, v, do = smoke.flash_inputs(shape, torch.float32, gen, device)
        o, lse = flash.flash_fwd_plain(q, k, v)
        row = {"shape": tag, "at": list(shape)}
        for what, bound in (
                ("fwd", smoke.flash_bound_ms("flash_fwd_tf32", shape, 4,
                                             peaks)[0]),
                ("bwd", smoke.pair_bound_ms(smoke.TF32_PAIR, shape, 4,
                                            peaks)[0])):
            calls = {lib: (lambda lib=lib: fwd(lib, q, k, v)) if what == "fwd"
                     else (lambda lib=lib: bwd(lib, q, k, v, o, lse, do))
                     for lib in libs}
            times = in_turns(libs, lambda lib: sum(
                smoke.device_ms(calls[lib]).values()))
            row[what] = {"bound_ms": bound, **times}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--a", required=True, help="source A (a .cu path)")
    parser.add_argument("--b", default=None,
                        help="source B (default: the checkout's own)")
    parser.add_argument("--no-check", action="store_true",
                        help="time only")
    args = parser.parse_args()
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("ab_flash_tf32.py: no CUDA card is visible", file=sys.stderr)
        return 1
    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

    sources = {"flash_tf32_a": args.a}
    if args.b is not None:
        sources["flash_tf32_b"] = args.b
    register(sources, "flash_tf32")
    libs = ["flash_tf32_a", "flash_tf32_b" if args.b else "flash_tf32"]
    info = cuda_build.build(libs)  # one nvcc each, in parallel
    for lib in libs:
        print(json.dumps({"build": lib, "seconds": info[lib]["seconds"],
                          "ptxas": smoke.ptxas_counts(info[lib]["log"])}),
              flush=True)
        warnings = [line for line in info[lib]["log"].splitlines()
                    if "warning" in line.lower() or "(C7" in line]
        if warnings:
            print(json.dumps({"build": lib, "warnings": warnings[:20]}),
                  flush=True)
    device = torch.device("cuda", 0)
    smoke.require_full_float32()
    _, peaks = smoke.peaks_for(torch.cuda.get_device_name(0))
    if not args.no_check:
        print(json.dumps({"check": check(libs, device)}), flush=True)
    timings(libs, device, peaks)
    print(smoke.smi_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
