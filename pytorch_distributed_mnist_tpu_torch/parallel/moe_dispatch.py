"""Capacity-factor MoE dispatch, the load-balance loss and the autograd
collectives of expert parallelism.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/moe_dispatch.py``.
Each token is physically dispatched to ONE expert's buffer, bounded by a
capacity factor; over the ``expert`` mesh axis the buffers cross to their
experts' owners as one all-to-all each way (``lax.all_to_all`` there,
``torch.distributed.nn.functional.all_to_all_single`` here, which has a
gradient).

Shape walk (per rank, its token group of ``Bg`` rows):

    x_loc (Bg, M) --dispatch one-hot--> (E, Cap, M)        local einsum
      --all_to_all(expert)-->           (G, E_loc, Cap, M) tokens to owners
      --expert MLP (local weights)-->   (G, E_loc, Cap, M)
      --all_to_all back-->              (E, Cap, M)
      --combine one-hot * gate-->       (Bg, M)

Tokens past an expert's capacity ``ceil(Bg * cf / E)`` drop (their
combine weight is zero; the classifier's residual carries them). With no
oversubscription the result equals dense dispatch.

Where JAX runs a ``shard_map`` over the token groups ``(data, expert)``,
each rank of the port takes its ``1/ep`` slice of its data rank's batch
(``split``) and all-gathers the output over the expert subgroup
(``gather``), so a rank's group holds the rows JAX's
``P(('data', 'expert'))`` gives that device. Without an expert axis
(``ep = 1``) JAX hands the model no mesh: the capacity and the arrival
positions are over the GLOBAL batch, so on a data axis that reduces the
port offsets each rank's positions by the earlier ranks' counts.

The collectives of a region every rank of the expert subgroup computes
alike come in Megatron pairs, so that the replicated leaves' gradients
are counted once: ``copy_to_region`` (identity forward, all-reduce
backward) and ``reduce_from_region`` (all-reduce forward, identity
backward); ``split`` (slice forward, all-gather backward) and
``gather`` (all-gather forward, slice backward). They live in
``parallel/regions.py``, shared with tensor and sequence parallelism.

Routing and dispatch tensors are float32: top-1 is a discrete decision,
and bf16 logit noise would make the routing layout-dependent.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
    all_to_all,
    copy_to_region,
    gather,
    reduce_from_region,
    split,
)

__all__ = [
    "top1_mask_gate",
    "build_dispatch",
    "moe_capacity_forward",
    "load_balance_loss",
]


# -- routing ----------------------------------------------------------------

def top1_mask_gate(probs: torch.Tensor):
    """(B, E) router probs -> (one-hot mask (B, E), routed prob gate (B,)).

    THE routing decision, shared by dense dispatch (``models/moe.py``),
    capacity dispatch and the aux loss. ``argmax`` takes the first
    maximum, as ``jnp.argmax`` does."""
    e = probs.shape[-1]
    mask = F.one_hot(torch.argmax(probs, dim=-1), e).to(probs.dtype)
    gate = torch.sum(probs * mask, dim=-1)
    return mask, gate


def build_dispatch(probs: torch.Tensor, capacity: int,
                   offset: Optional[torch.Tensor] = None):
    """(B, E) router probs -> one-hot dispatch/combine (B, E, Cap).

    Top-1 routing with in-order capacity assignment: the k-th token routed
    to expert e takes slot k; tokens with k >= capacity are dropped (both
    tensors zero for them). ``offset`` (E,) adds the tokens routed to each
    expert before these rows (earlier ranks of a data axis)."""
    mask, gate = top1_mask_gate(probs)
    # 0-indexed arrival position of each token within its expert's queue.
    pos = torch.cumsum(mask, dim=0) * mask - mask
    if offset is not None:
        pos = pos + offset.to(pos.dtype)[None, :] * mask
    keep = mask * (pos < capacity).to(mask.dtype)
    slot = F.one_hot(pos.clamp(0, capacity - 1).to(torch.int64),
                     capacity).to(probs.dtype)
    dispatch = keep[..., None] * slot  # (B, E, Cap)
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def load_balance_loss(probs: torch.Tensor, axis=None) -> torch.Tensor:
    """Switch-transformer auxiliary loss: ``E * sum_e f_e * p_e``.

    ``f_e`` = fraction of tokens top-1-routed to expert e, ``p_e`` = mean
    router probability of e, both over the GLOBAL batch: on a data
    ``axis`` that reduces, the sums are all-reduced over it (``p``'s with
    an identity backward, so each rank backpropagates through its own
    rows and the gradient sum over the axis is the global one). Equals
    1.0 under uniform routing; differentiable through ``p_e``."""
    e = probs.shape[-1]
    mask, _ = top1_mask_gate(probs)
    if axis is None or axis.group is None:
        f = torch.mean(mask, dim=0)
        p = torch.mean(probs, dim=0)
        return e * torch.sum(f * p)
    with torch.no_grad():
        counts = torch.cat([mask.sum(0), mask.new_tensor([probs.shape[0]])])
        dist.all_reduce(counts, group=axis.group)
    n = counts[-1]
    f = counts[:-1] / n
    # Identity backward: each rank backpropagates through its own rows.
    p = reduce_from_region(probs.sum(0), axis) / n
    return e * torch.sum(f * p)


def _expert_mlp(ei, w1, b1, w2, b2, compute_dtype):
    """(..., E, Cap, M) tokens through per-expert two-layer MLPs."""
    ei = ei.to(compute_dtype)
    h = F.relu(
        torch.einsum("...ecm,emh->...ech", ei, w1.to(compute_dtype))
        + b1.to(compute_dtype)[..., :, None, :])
    return (torch.einsum("...ech,ehm->...ecm", h, w2.to(compute_dtype))
            + b2.to(compute_dtype)[..., :, None, :])


def moe_capacity_forward(
    x: torch.Tensor,
    probs: torch.Tensor,
    w1: torch.Tensor,  # (E_loc, M, H)
    b1: torch.Tensor,  # (E_loc, H)
    w2: torch.Tensor,  # (E_loc, H, M)
    b2: torch.Tensor,  # (E_loc, M)
    *,
    capacity_factor: float = 1.25,
    compute_dtype=torch.float32,
    mesh=None,
    expert_axis: str = "expert",
    data_axis: Optional[str] = "data",
) -> torch.Tensor:
    """Capacity-dispatched switch layer: (B, M) -> (B, M), ``x`` and
    ``probs`` this rank's data shard, the weights its local experts.

    Without a mesh (or on one rank) this is the pure local program, the
    oracle of the distributed paths. With an expert axis of ``ep > 1``
    tokens group over ``(data, expert)`` and the two all-to-alls
    exchange buffers with the experts' owners; with ``ep = 1`` over a
    data axis that reduces, capacity and positions are the global
    batch's."""
    e = probs.shape[-1]
    ep_axis = None if mesh is None else mesh.expert
    ep = 1 if ep_axis is None else ep_axis.size
    data = None
    if mesh is not None and data_axis:
        data = mesh.axis(data_axis) if data_axis in mesh.shape else None
    n_data = 1 if data is None else data.size

    def local_forward(x_loc, probs_loc, n_groups, capacity=None,
                      offset=None):
        bg = x_loc.shape[0]
        if capacity is None:
            capacity = max(1, math.ceil(bg * capacity_factor / e))
        dispatch, combine = build_dispatch(probs_loc.to(torch.float32),
                                           capacity, offset)
        ei = torch.einsum("bec,bm->ecm", dispatch.to(x_loc.dtype), x_loc)
        if n_groups == 1:
            y = _expert_mlp(ei, w1, b1, w2, b2, compute_dtype)
        else:
            e_loc = e // n_groups
            ei = ei.reshape((n_groups, e_loc) + tuple(ei.shape[1:]))
            # (G, E_loc, Cap, M): dim 0 becomes the sender-group index.
            ei = all_to_all(ei, ep_axis)
            y = _expert_mlp(ei, w1, b1, w2, b2, compute_dtype)
            y = all_to_all(y, ep_axis)
            y = y.reshape((e,) + tuple(y.shape[2:]))
        return torch.einsum("ecm,bec->bm", y.to(torch.float32),
                            combine).to(x_loc.dtype)

    if ep == 1:
        if data is None or data.group is None:
            return local_forward(x, probs, 1)
        # JAX's program is over the global batch: its capacity, and each
        # token's arrival position after every earlier rank's tokens.
        with torch.no_grad():
            mask, _ = top1_mask_gate(probs.to(torch.float32))
            counts = mask.sum(0)
            every = torch.empty(data.size * counts.numel(),
                                dtype=counts.dtype, device=counts.device)
            dist.all_gather_into_tensor(every, counts, group=data.group)
            offset = every.view(data.size, -1)[:data.rank].sum(0)
        capacity = max(1, math.ceil(x.shape[0] * data.size
                                    * capacity_factor / e))
        return local_forward(x, probs, 1, capacity, offset)

    if e % ep:
        raise ValueError(f"{e} experts not divisible by {expert_axis}={ep}")
    token_axes = ((data_axis, expert_axis) if n_data > 1
                  else (expert_axis,))
    n_groups = n_data * ep
    batch = x.shape[0] * n_data
    if batch % n_groups:
        raise ValueError(
            f"batch {batch} not divisible by the {n_groups} token "
            f"groups of mesh axes {token_axes} (capacity dispatch shards "
            f"tokens over them)")
    x_g = split(x, ep_axis)
    probs_g = split(probs, ep_axis)
    out = local_forward(x_g, probs_g, ep)
    return gather(out, ep_axis)
