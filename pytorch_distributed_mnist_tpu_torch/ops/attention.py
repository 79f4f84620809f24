"""Attention ops: the dense reference and the blockwise online-softmax
building block.

Counterpart of ``pytorch_distributed_mnist_tpu/ops/attention.py``. Layout
throughout: ``(B, T, H, D)`` — batch, tokens, heads, head dim. Scores are
computed in float32 whatever the inputs' dtype (softmax is the delicate
reduction), and the output comes back in q's dtype.

:func:`full_attention` is the ViT's default ``attention_fn`` and the dense
oracle the flash kernels (``ops/flash.py``) are held against. The
``OnlineSoftmaxState`` helpers are the recurrence a sequence-parallel ring
folds block by block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30  # softmax mask value; avoids -inf NaN propagation in exp


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention, ``(B, T, H, D)`` in and out. The causal
    mask is end-aligned (``tril(k=Tk-Tq)``); a fully masked row (possible
    when Tq > Tk) gives zeros, not the mean of V."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf = q.float(), k.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale  # (B, H, Tq, Tk)
    mask = None
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=s.device).tril(diagonal=tk - tq)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=s.device))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


class OnlineSoftmaxState(NamedTuple):
    """Carry of the blockwise (flash-style) attention recurrence.

    ``o``: unnormalized output accumulator, (B, Tq, H, D) float32;
    ``m``: running row max of scores, (B, H, Tq) float32;
    ``l``: running softmax normalizer, (B, H, Tq) float32.
    """

    o: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def online_softmax_init(q: torch.Tensor) -> OnlineSoftmaxState:
    b, tq, h, d = q.shape
    return OnlineSoftmaxState(
        o=torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device),
        m=torch.full((b, h, tq), NEG_INF, dtype=torch.float32,
                     device=q.device),
        l=torch.zeros((b, h, tq), dtype=torch.float32, device=q.device))


def online_softmax_block(state: OnlineSoftmaxState, q: torch.Tensor,
                         k_blk: torch.Tensor, v_blk: torch.Tensor, *,
                         scale: Optional[float] = None,
                         mask: Optional[torch.Tensor] = None) \
        -> OnlineSoftmaxState:
    """Fold one K/V block into the running attention state.

    ``mask``: optional (Tq, Tk_blk) or (B, H, Tq, Tk_blk) boolean, True =
    attend. The old accumulator is rescaled by ``exp(m_old - m_new)`` and
    the new block's contribution added."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m_new = torch.maximum(state.m, s.amax(dim=-1))
    # exp(NEG_INF - NEG_INF) must be 0, not 1: a row masked so far has
    # m == NEG_INF, so the correction is guarded.
    corr = torch.where(state.m <= NEG_INF / 2,
                       torch.zeros((), device=s.device),
                       torch.exp(state.m - m_new))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=s.device))
    l_new = state.l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    # corr is (B, H, Tq); o is (B, Tq, H, D).
    o_new = state.o * corr.permute(0, 2, 1)[..., None] + pv
    return OnlineSoftmaxState(o=o_new, m=m_new, l=l_new)


def online_softmax_finish(state: OnlineSoftmaxState,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalize the accumulator: ``o / l`` (safe where l == 0)."""
    l = state.l.permute(0, 2, 1)[..., None]  # (B, Tq, H, 1)
    return (state.o / torch.clamp(l, min=1e-30)).to(dtype)
