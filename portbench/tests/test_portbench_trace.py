"""Each trace-reading metric on a small canned trace, the trace's
completeness check and its breakdown."""

import types

import pytest
import torch

from portbench.core import session, spec, trace

MS = 1_000_000  # ns


def _canned(copies=3):
    """Two epochs of two train steps and one eval step on one clock:
    train pass [0, 10) ms, eval pass [10, 14) ms, then [20, 30) and
    [30, 34). Each train pass: a staged copy of 2 ms (in ``copies``
    parts), per step a conv of 1 ms, an elementwise kernel of 0.5 ms,
    K1a and K1b of 0.01 ms each, Adam 0.1 ms, the flash forward 0.2 ms
    and the tiled backward's two kernels 0.3 ms each; each eval pass
    one conv of 1 ms."""
    t = trace.Trace()
    for base in (0, 20 * MS):
        t.spans += [("portbench.train_pass", base, base + 10 * MS),
                    ("portbench.eval_pass", base + 10 * MS, base + 14 * MS)]
        at = base
        for i in range(copies):
            t.device.append(("Memcpy HtoD (Pinned -> Device)", at,
                             at + 2 * MS // copies, "gpu_memcpy"))
            at += 2 * MS // copies
        for _step in range(2):
            for name, ms in (("sm90_xmma_fprop_implicit_gemm_cudnn", 1.0),
                             ("vectorized_elementwise_kernel", 0.5),
                             ("xent_fwd_kernel<10>", 0.01),
                             ("xent_bwd_kernel<10>", 0.01),
                             ("adam_leaves_kernel", 0.1),
                             ("flash_fwd_mma_kernel<16>", 0.2),
                             ("flash_dq_tiled_kernel<16>", 0.3),
                             ("flash_dkv_tiled_kernel<16>", 0.3)):
                t.device.append((name, at, at + int(ms * MS), "kernel"))
                at += int(ms * MS)
        t.device.append(("cudnn_conv_eval", base + 11 * MS, base + 12 * MS,
                         "kernel"))
        t.host.append(("cudaStreamSynchronize", base + 9 * MS,
                       base + 10 * MS))
    t.device.sort(key=lambda r: r[1])
    return t


def _ctx(tr, model="vit", complete=True, eval_ms=(4.0, 6.0),
         waits=(1.0, 3.0)):
    cell = spec.load_cell("vit-t196-b256" if model == "vit" else "cnn-b256")
    params = [torch.zeros(1000)]
    rank = types.SimpleNamespace(
        train_loader=types.SimpleNamespace(steps_per_epoch=2,
                                           local_batch_size=256),
        state=types.SimpleNamespace(
            model=types.SimpleNamespace(parameters=lambda: params)))
    rec = {"trace": tr, "epochs": 2, "complete": complete}
    return session.Context(cell, rank, rec, list(eval_ms), list(waits))


def _read(name, ctx):
    return spec.load_module("metrics", name).read(ctx)


def test_host_metrics():
    ctx = _ctx(_canned())
    assert _read("epoch.eval_ms", ctx) == 5.0
    assert _read("staging.wait_ms", ctx) == 2.0


def test_device_metrics_per_train_step():
    ctx = _ctx(_canned())
    assert ctx.train_steps == 4
    assert _read("model.conv_ms", ctx) == pytest.approx(1.0)
    assert _read("model.elementwise_ms", ctx) == pytest.approx(0.5)
    assert _read("staging.h2d_ms", ctx) == pytest.approx(2.0, abs=1e-5)


def test_idle_share():
    ctx = _ctx(_canned())
    # per epoch 2 ms copy + 2 x 2.42 ms of kernels + 1 ms eval conv = 7.84
    # ms busy of a 14 ms pass pair, and the 6 ms between the epochs
    # ([14, 20) ms) is inside the span: 15.68 of 34 ms busy.
    assert ctx.span_s == pytest.approx(0.034)
    assert _read("device.idle_pct", ctx) == pytest.approx(
        100 * (1 - 15.68 / 34), rel=1e-6)


def test_rooflines():
    ctx = _ctx(_canned())
    peak = spec.peaks()
    xent = spec.load_module("counts", "xent")
    bound = (xent.fwd_bytes(256, 10) + xent.bwd_bytes(256, 10)) \
        / peak["hbm_bytes_per_s"] * 1e3
    assert _read("xent.roofline_pct", ctx) == pytest.approx(
        100 * bound / 0.02)
    assert _read("adam.roofline_pct", ctx) == pytest.approx(
        100 * 28 * 1000 / peak["hbm_bytes_per_s"] * 1e3 / 0.1)
    flash = spec.load_module("counts", "flash")
    shape = (256, 196, 4, 16)
    fwd = max(flash.fwd_flops(*shape) / peak["bf16_flops"],
              flash.fwd_bytes(*shape) / peak["hbm_bytes_per_s"]) * 1e3
    bwd = max(flash.bwd_flops(*shape) / peak["bf16_flops"],
              flash.bwd_bytes(*shape) / peak["hbm_bytes_per_s"]) * 1e3
    # depth 2 calls a step against 0.2 and 0.6 ms a step
    assert _read("flash.fwd_roofline_pct", ctx) == pytest.approx(
        100 * 2 * fwd / 0.2)
    assert _read("flash.bwd_roofline_pct", ctx) == pytest.approx(
        100 * 2 * bwd / 0.6)


def test_mfu():
    ctx = _ctx(_canned())
    counts = spec.load_module("counts", "vit")
    fwd = counts.forward_flops(ctx.config, ctx.traffic)
    flops = 3 * fwd * 4 * 256 + fwd * 10000 * 2
    assert _read("step.mfu_pct", ctx) == pytest.approx(
        100 * flops / (0.034 * 989e12))


def test_an_incomplete_trace_gives_no_trace_metric():
    ctx = _ctx(_canned(), complete=False)
    for name in ("staging.h2d_ms", "model.conv_ms", "model.elementwise_ms",
                 "xent.roofline_pct", "adam.roofline_pct",
                 "flash.fwd_roofline_pct", "flash.bwd_roofline_pct",
                 "device.idle_pct"):
        assert _read(name, ctx) is None, name


def test_a_reader_that_finds_nothing_returns_nothing():
    tr = _canned()
    tr.device = [r for r in tr.device if "flash" not in r[0]]
    ctx = _ctx(tr)
    assert _read("flash.fwd_roofline_pct", ctx) is None
    assert _read("flash.bwd_roofline_pct", ctx) is None


def test_completeness_against_the_counters():
    tr = _canned()
    delta = {("ops.xent", "xent_fwd", "launches"): 4,
             ("ops.xent", "xent_bwd", "launches"): 4,
             ("ops.adam", "adam_leaves", "launches"): 4,
             ("ops.flash", "flash_fwd", "tensor"): 4,
             ("ops.flash", "flash_bwd", "tiled"): 4}
    assert session._complete(tr, delta, copies=3) is None
    lost = _canned()
    lost.device = [r for r in lost.device
                   if not (r[0].startswith("adam") and r[1] < 5 * MS)]
    assert "adam_leaves_kernel" in session._complete(lost, delta, copies=3)
    assert "copies" in session._complete(_canned(copies=2), delta, copies=3)


def test_breakdown():
    b = trace.breakdown(_canned())
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][0] == "sm90_xmma_fprop_implicit_gemm_cudnn"
    assert b["device_ops"][0][1] == pytest.approx(4 * 1e-3)
    # the longest gap: from the end of the eval conv to the next epoch's
    # copy, which began while the eval pass was open on the host
    assert b["idle_gaps"][0][0] == "eval_pass:no_host_op"
    assert b["idle_gaps"][0][1] == pytest.approx(6e-3 + 2e-3)


def test_step_part_rules():
    assert trace.step_part("ncclDevKernel_AllReduce_Sum_f32") == "collective"
    assert trace.step_part("xent_fwd_kernel<10>") == "xent_fwd"
    assert trace.step_part("Memcpy HtoD") == "copy"
    assert trace.step_part("sm90_xmma_dgrad_cudnn") == "conv"
    assert trace.step_part("nvjet_tst_128x64") == "fc_gemm"
    assert trace.step_part("vectorized_elementwise_kernel") == \
        "other_elementwise"
