"""Bytes of the cross-entropy kernels per call: each input read once and
each output written once. K1a reads float32 logits ``(B, C)`` and int64
labels and writes the float32 loss and log-sum-exp ``(B,)``; K1b reads the
logits, labels, log-sum-exp and the float32 cotangent and writes float32
``dlogits``. Their operations (a few per logit) are far under the bytes'
time."""

from __future__ import annotations


def fwd_bytes(batch: int, classes: int) -> int:
    return batch * classes * 4 + batch * 8 + 2 * batch * 4


def bwd_bytes(batch: int, classes: int) -> int:
    return 2 * batch * classes * 4 + batch * 8 + 2 * batch * 4
