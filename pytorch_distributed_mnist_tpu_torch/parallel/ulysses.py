"""Ulysses sequence parallelism: all-to-all head resharding.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/ulysses.py``.
Activations arrive sequence-sharded ``(B, T/n, H, D)``. One all-to-all
over the ``seq`` axis re-shards heads instead of tokens ->
``(B, T, H/n, D)``; each rank runs attention over the FULL sequence for
its own heads (attention is independent per head), and a second
all-to-all restores the token sharding. Both are
``parallel/regions.py::all_to_all``, whose gradient is the all-to-all
back. Against the ring (``parallel/ring.py``): O(T^2) scores per rank,
but two larger collectives in place of n - 1 hops.

The local attention is ``full_attention``, or the flash kernels
(``ops/flash.py::flash_attention``) under ``--attention flash``: each
rank hands them its ``(B, T, H/n, D)`` block, so on the card the CUDA
kernels run at full T with ``H/n`` heads.

Requires ``num_heads % n == 0``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pytorch_distributed_mnist_tpu_torch.ops.attention import full_attention
from pytorch_distributed_mnist_tpu_torch.parallel.regions import all_to_all


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, axis, causal: bool = False,
                            scale: Optional[float] = None,
                            local_attention: Optional[Callable] = None) \
        -> torch.Tensor:
    """This rank's ``(B, T/n, H, D)`` blocks, tokens sharded over
    ``axis`` -> its O block. ``local_attention`` is the per-rank
    attention over the full sequence and this rank's heads (default
    dense ``full_attention``)."""
    n = 1 if axis is None else axis.size
    if q.shape[2] % n:
        raise ValueError(
            f"num_heads {q.shape[2]} not divisible by axis size {n}")
    attn = local_attention if local_attention is not None else full_attention
    if n == 1 or axis.group is None:
        return attn(q, k, v, causal=causal, scale=scale)

    def to_heads(x):  # (B, T/n, H, D) -> (B, T, H/n, D)
        b, tl, h, d = x.shape
        parts = x.reshape(b, tl, n, h // n, d).permute(2, 0, 1, 3, 4)
        got = all_to_all(parts, axis)  # got[j]: rank j's tokens
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * tl, h // n, d)

    def to_tokens(x):  # (B, T, H/n, D) -> (B, T/n, H, D)
        b, t, hn, d = x.shape
        parts = x.reshape(b, n, t // n, hn, d).permute(1, 0, 2, 3, 4)
        got = all_to_all(parts, axis)  # got[j]: rank j's heads
        return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hn, d)

    o = attn(to_heads(q), to_heads(k), to_heads(v), causal=causal,
             scale=scale)
    return to_tokens(o)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh, axis: str = "seq",
                      batch_axis: Optional[str] = None, causal: bool = False,
                      scale: Optional[float] = None,
                      local_attention: Optional[Callable] = None) \
        -> torch.Tensor:
    """Ulysses attention on this rank's ``(B/dp, T/sp, H, D)`` blocks of
    the global arrays, the tokens sharded over mesh axis ``axis``;
    ``batch_axis`` names where the batch is split. The heads cannot also
    be split over the mesh: Ulysses re-shards them itself."""
    if batch_axis is not None:
        mesh.axis(batch_axis)  # a KeyError names an axis the mesh lacks
    return ulysses_attention_local(q, k, v, axis=mesh.axis(axis),
                                   causal=causal, scale=scale,
                                   local_attention=local_attention)
