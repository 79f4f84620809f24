"""Ring attention: sequence parallelism over a mesh axis.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/ring.py``. The
token axis T is sharded across the ``seq`` axis: each rank holds
``(B, T/n, H, D)`` of Q, K and V. The ring runs n steps; at step j every
rank folds one (local Q block) x (visiting K/V block) update into its
online softmax (``ops/attention.py``, plain torch: the reference's ring
is ``jnp``, not a Pallas kernel) while the K/V blocks rotate one hop
around the ring (``parallel/regions.py::ppermute``: rank i sends to
i + 1, and the gradients travel back i + 1 -> i). The last step's blocks
are not rotated on, so a ring of n makes n - 1 hops. No rank ever holds
a (T, T) score matrix.

Causal masking: after j hops the rank at ring position i holds the K/V
block that started at position ``(i - j) mod n``; the block's global
offsets give the exact (Tq, Tk) triangle, so causal ring attention
equals dense causal attention.

Here every process already holds its own shard, so :func:`ring_attention`
is :func:`ring_attention_local` on the mesh's axis; ``batch_axis`` and
``head_axis`` name the axes the batch and the heads are split over (data
parallelism, and tensor parallelism's local heads), which only make each
rank's block smaller: the ring talks along ``axis`` alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_mnist_tpu_torch.ops.attention import (
    online_softmax_block,
    online_softmax_finish,
    online_softmax_init,
)
from pytorch_distributed_mnist_tpu_torch.parallel.regions import ppermute


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, axis, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """This rank's Q/K/V blocks ``(B, T_local, H, D)`` -> its O block,
    the token axis sharded over ``axis`` (a ``parallel/mesh.py::DataAxis``;
    one rank: plain blockwise attention)."""
    n = 1 if axis is None else axis.size
    me = 0 if axis is None else axis.rank
    t_local = q.shape[1]

    def block_mask(kv_owner: int) -> torch.Tensor:
        """(Tq_local, Tk_local) causal mask between this rank's Q block
        and the block that started on ``kv_owner``."""
        qi = me * t_local + torch.arange(t_local, device=q.device)[:, None]
        ki = kv_owner * t_local + torch.arange(t_local,
                                               device=q.device)[None, :]
        return qi >= ki

    state = online_softmax_init(q)
    kv = (k, v)
    for j in range(n):
        mask = block_mask((me - j) % n) if causal else None
        state = online_softmax_block(state, q, kv[0], kv[1], scale=scale,
                                     mask=mask)
        if j + 1 < n:
            # Rotate K/V one hop: the next step holds the block of
            # (me - j - 1) mod n.
            kv = ppermute(kv, axis, 1)
    return online_softmax_finish(state, dtype=q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = "seq", batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention on this rank's ``(B/dp, T/sp, H/tp, D)`` blocks of
    the global ``(B, T, H, D)`` arrays, the tokens sharded over mesh
    axis ``axis``; ``batch_axis`` and ``head_axis`` name where the batch
    and the heads are split (each rank holds its own already)."""
    for name in (batch_axis, head_axis):
        if name is not None:
            mesh.axis(name)  # a KeyError names an axis the mesh lacks
    return ring_attention_local(q, k, v, axis=mesh.axis(axis),
                                causal=causal, scale=scale)
