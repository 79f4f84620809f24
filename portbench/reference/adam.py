"""Plain Adam (Kingma and Ba, with bias correction), in float32 torch
operations, for the reference's steps: ``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g^2``, ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

from __future__ import annotations

import torch


@torch.no_grad()
def adam_step(params: dict, grads: dict, moments: dict, t: int, lr: float,
              b1: float, b2: float, eps: float) -> None:
    """One step ``t`` (from 1) on every leaf, in place."""
    for name, p in params.items():
        g = grads[name]
        m, v = moments.setdefault(name, (torch.zeros_like(p),
                                         torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        m_hat = m / (1.0 - b1 ** t)
        v_hat = v / (1.0 - b2 ** t)
        p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
