"""Fused softmax cross-entropy: the hand-written CUDA kernels (forward and
backward), their plain PyTorch versions, and the autograd function built
on them.

Counterpart of ``pytorch_distributed_mnist_tpu/ops/pallas/xent.py``,
selected by ``--loss fused`` (``ops/loss.py::set_loss_impl``). The forward
computes each row's loss and saves its log-sum-exp, so the backward never
reduces the row again: ``dlogits = (exp(l - lse) - onehot) * g * live``,
where ``live`` is the reference's gate on the forward's ``max(x, 0)``
clamp (1, 0.5 or 0 as ``lse - picked`` is > 0, == 0 or < 0).

:func:`xent_fwd` and :func:`xent_bwd` launch ``csrc/xent.cu`` for CUDA
tensors (built at first use, ``ops/cuda_build.py``) and take
:func:`xent_fwd_plain` / :func:`xent_bwd_plain` only for tensors on the
CPU. There is no fallback from one to the other: a CUDA tensor launches
the kernel or raises. Up to 32 classes a group of lanes owns a row (the
forward: the next power of two >= C lanes, one class each; the
backward: half as many, two classes each); above, a warp does. The
layout is chosen from C alone.

The wrappers launch on the current stream and keep no state between
calls but their launch counts, so a CUDA graph can capture them
(``train/steps.py::EpochProgram``); ``ops/launches.py`` keeps the counts
exact across the graph's replays.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
from pytorch_distributed_mnist_tpu_torch.utils import debug_nans

__all__ = ["fused_cross_entropy", "fused_cross_entropy_per_example",
           "xent_bwd", "xent_bwd_plain", "xent_fwd", "xent_fwd_plain"]

# The TPU kernel's one 128-lane tile: a warp holds a row of up to 128
# classes, four per lane.
MAX_CLASSES = 128

_count_lock = threading.Lock()


def _check_classes(c: int) -> None:
    if c > MAX_CLASSES:
        raise ValueError(
            f"fused cross-entropy handles up to {MAX_CLASSES} classes per "
            f"128-lane tile; got C={c} — use ops.loss.cross_entropy")


def _check(logits: torch.Tensor, labels: torch.Tensor, *rows) -> None:
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"fused cross-entropy takes (B, C) float32 logits, "
                         f"got {tuple(logits.shape)} {logits.dtype}")
    _check_classes(logits.shape[1])
    if logits.shape[1] > 1 and logits.stride(1) != 1:
        raise ValueError("fused cross-entropy needs unit stride along C; "
                         "call .contiguous() first")
    b = logits.shape[0]
    if labels.dtype != torch.int64 or labels.shape != (b,):
        raise ValueError(f"fused cross-entropy takes ({b},) int64 labels, "
                         f"got {tuple(labels.shape)} {labels.dtype}")
    for t in (labels, *rows):
        if t.device != logits.device:
            raise ValueError(f"operands on different devices: "
                             f"{logits.device} / {t.device}")
        if b > 1 and t.stride(0) != 1:
            raise ValueError("fused cross-entropy needs contiguous per-row "
                             "operands")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != (b,):
            raise ValueError(f"fused cross-entropy takes ({b},) float32 "
                             f"per-row operands, got {tuple(t.shape)} "
                             f"{t.dtype}")


def _picked(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``sum_c where(c == label, logits, 0)``: the label's logit, 0 for a
    label outside ``[0, C)`` (the TPU kernel's one-hot sum)."""
    cols = torch.arange(logits.shape[1], device=logits.device)
    hit = cols[None, :] == labels[:, None]
    return torch.where(hit, logits, torch.zeros((), device=logits.device)
                       ).sum(dim=1)


def xent_fwd_plain(logits: torch.Tensor, labels: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``, each ``(B,)`` float32: the forward kernel's
    function in a few torch ops. Runs on any device; the CPU path of
    :func:`xent_fwd` and the yardstick the kernel is held against on the
    card."""
    _check(logits, labels)
    m = logits.max(dim=1).values
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=1))
    picked = _picked(logits, labels)
    # A label in [C, 128) picks a class the TPU kernel masked to -inf.
    padded = (labels >= logits.shape[1]) & (labels < MAX_CLASSES)
    picked = torch.where(padded, torch.full((), float("-inf"),
                                            device=logits.device), picked)
    loss = torch.maximum(lse - picked, torch.zeros((), device=logits.device))
    return loss, lse


def xent_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                   lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dlogits`` ``(B, C)`` float32: the backward kernel's function in a
    few torch ops (see the module docstring for ``live``)."""
    _check(logits, labels, lse, g)
    p = torch.exp(logits - lse[:, None])
    cols = torch.arange(logits.shape[1], device=logits.device)
    onehot = (cols[None, :] == labels[:, None]).float()
    diff = lse - _picked(logits, labels)
    live = torch.where(diff > 0, 1.0, torch.where(diff == 0, 0.5, 0.0))
    return (p - onehot) * g[:, None] * live[:, None]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    return True


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)`` of ``(B, C)`` float32 logits and ``(B,)`` int64
    labels. CUDA tensors launch the kernel (counted in
    ``xent_fwd.launches``); CPU tensors take :func:`xent_fwd_plain`."""
    _check(logits, labels)
    if not _on_card(logits, "xent_fwd"):
        return xent_fwd_plain(logits, labels)
    b, c = logits.shape
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    lse = torch.empty(b, dtype=torch.float32, device=logits.device)
    if b == 0:
        return loss, lse
    lib = cuda_build.load("xent")
    err = lib.xent_fwd_launch(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        b, c, logits.stride(0), logits.device.index, _stream(logits))
    if err != 0:
        raise RuntimeError(f"xent_fwd kernel launch failed: CUDA error {err} "
                           f"at {b}x{c}")
    with _count_lock:
        xent_fwd.launches += 1
    debug_nans.check_outputs("xent_fwd", loss, lse)
    return loss, lse


def xent_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """``dlogits`` ``(B, C)`` float32 from the forward's inputs, its saved
    ``lse`` and the upstream per-row gradient ``g``. CUDA tensors launch
    the kernel (counted in ``xent_bwd.launches``); CPU tensors take
    :func:`xent_bwd_plain`."""
    _check(logits, labels, lse, g)
    if not _on_card(logits, "xent_bwd"):
        return xent_bwd_plain(logits, labels, lse, g)
    b, c = logits.shape
    out = torch.empty((b, c), dtype=torch.float32, device=logits.device)
    if b == 0:
        return out
    lib = cuda_build.load("xent")
    err = lib.xent_bwd_launch(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        out.data_ptr(), b, c, logits.stride(0), out.stride(0),
        logits.device.index, _stream(logits))
    if err != 0:
        raise RuntimeError(f"xent_bwd kernel launch failed: CUDA error {err} "
                           f"at {b}x{c}")
    with _count_lock:
        xent_bwd.launches += 1
    debug_nans.check_outputs("xent_bwd", out)
    return out


xent_fwd.launches = 0
xent_bwd.launches = 0


class _FusedXent(torch.autograd.Function):
    """Per-example loss with the backward kernel as its gradient; saves
    the float32 logits, the labels and ``lse`` (the TPU path's custom_vjp
    residuals)."""

    @staticmethod
    def forward(ctx, logits, labels):
        # The float32 boundary outside the kernel, as the reference casts
        # before its pallas_call: the reduction must not run in bfloat16.
        l32 = logits.float()
        if l32.shape[1] > 1 and l32.stride(1) != 1:
            l32 = l32.contiguous()
        lab = labels.long().contiguous()
        loss, lse = xent_fwd(l32, lab)
        ctx.save_for_backward(l32, lab, lse)
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        l32, lab, lse = ctx.saved_tensors
        dl = xent_bwd(l32, lab, lse, g.float().contiguous())
        return dl.to(ctx.logits_dtype), None


def fused_cross_entropy_per_example(logits: torch.Tensor,
                                    labels: torch.Tensor) -> torch.Tensor:
    """Per-example loss ``(B,)`` float32, differentiable with respect to
    ``logits`` through the backward kernel; the drop-in for
    ``ops.loss.cross_entropy_per_example``."""
    _check_classes(logits.shape[-1])
    return _FusedXent.apply(logits, labels)


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean (or masked mean) fused loss, with ``ops.loss.masked_mean`` as
    the one owner of the mean's semantics for both loss impls."""
    from pytorch_distributed_mnist_tpu_torch.ops.loss import masked_mean

    return masked_mean(fused_cross_entropy_per_example(logits, labels), mask)
