"""Pipeline parallelism: GPipe-style microbatched stages over a mesh axis.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/pipeline.py``.
There the pipeline is one ``shard_map`` program: every device holds its
stage's weights, and a ``lax.scan`` runs ``m + S - 1`` ticks in lockstep;
each tick every device applies its stage to the activation it holds and
passes the result one hop to the next stage with ``lax.ppermute``. The
first ``S - 1`` ticks are the fill bubble, the last ``S - 1`` the drain
bubble: utilization ``m / (m + S - 1)``.

Here every rank is a process, and :func:`pipeline_apply` is that tick
loop written out: stage 0 injects microbatch ``t``, the last stage
retires microbatch ``t - (S - 1)`` into its outputs, each tick ends with
the open chain's hop from stage ``s`` to ``s + 1``
(``parallel/regions.py::ppermute`` with ``wrap=False``, differentiable),
and the last stage's outputs are summed over the axis
(``reduce_from_region``: all-reduce forward, identity backward), so every
stage rank holds them.

The backward needs no schedule of its own, but it must run every hop on
every rank, in the same order: a rank whose graph lacks a hop's backward
leaves its partner waiting on a receive. So the body keeps the JAX
formulation: the stage index is a tensor, stage 0's input is chosen with
``torch.where`` and the last stage's outputs are a masked write, never a
Python ``if`` on the stage. Every rank then builds the same graph, the
hops chained tick after tick, and autograd runs the reverse hops in
reverse tick order on every rank.

Restrictions, as in JAX: every stage has the same params structure and
the same activation shape in and out; the number of stages is the size
of the axis; the microbatch count divides each data slice's batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
    ppermute,
    reduce_from_region,
)

__all__ = ["stack_stage_params", "pipeline_apply", "sequential_apply"]


def stack_stage_params(per_stage_params: Sequence[Dict[str, torch.Tensor]]) \
        -> Dict[str, torch.Tensor]:
    """Stack a list of per-stage ``{name: tensor}`` trees into one tree
    whose leaves have a leading S dim."""
    return {name: torch.stack([p[name] for p in per_stage_params])
            for name in per_stage_params[0]}


def _stage_row(stage_params: Dict[str, torch.Tensor], n_stages: int,
               stage: int) -> Dict[str, torch.Tensor]:
    """This rank's stage params from leaves with a leading dim of S (the
    whole stack: its row) or 1 (its row already, as a placed state holds
    it)."""
    out = {}
    for name, a in stage_params.items():
        if a.shape[0] == n_stages:
            out[name] = a[stage]
        elif a.shape[0] == 1:
            out[name] = a[0]
        else:
            raise ValueError(
                f"stage param {name!r} has leading dim {a.shape[0]}; "
                f"expected the {n_stages} stages' stack or this stage's "
                f"row (1)")
    return out


def pipeline_apply(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                   x: torch.Tensor, *, mesh, axis: str = "stage",
                   num_microbatches: Optional[int] = None,
                   data_axis: Optional[str] = None) -> torch.Tensor:
    """Run ``x`` through the S pipelined stages: ``y = f_S(... f_1(x))``.

    ``stage_fn(params, h) -> h`` with identical in/out shape;
    ``stage_params`` leaves have a leading dim of S (use
    :func:`stack_stage_params`; this rank takes its row) or 1 (this
    rank's row). ``x`` is this rank's batch: the rows of its data
    coordinate (``data_axis``), the same on every stage rank; it is cut
    into ``num_microbatches`` (default S) microbatches on dim 0. Returns
    the outputs of the whole batch, the same on every stage rank.

    The JAX signature's ``param_specs`` (PP x TP splits block weights
    over ``model`` too, ``parallel/pipeline_tp.py``) has no counterpart:
    each rank's params arrive placed, and the tick loop and its hops are
    the same for any layout."""
    st = mesh.axis(axis)
    n_stages = st.size
    m = num_microbatches or n_stages
    if data_axis is not None:
        mesh.axis(data_axis)
    batch = x.shape[0]
    if batch % m:
        raise ValueError(
            f"per-dataslice batch {batch} not divisible by microbatches {m}")
    p = _stage_row(stage_params, n_stages, st.rank)
    # The stage index as a device tensor (a fill kernel: capturable in
    # the scan mode's CUDA graph), so every branch below is a select.
    s = torch.full((), st.rank, dtype=torch.int64, device=x.device)
    xm = x.reshape((m, batch // m) + tuple(x.shape[1:]))
    mb_shape = tuple(xm.shape[1:])
    buf = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
    outs = torch.zeros((m,) + mb_shape, dtype=x.dtype, device=x.device)
    last = n_stages - 1
    for t in range(m + n_stages - 1):
        # Stage 0 injects microbatch t (clamped; late ticks are bubble).
        inj = xm[min(t, m - 1)]
        h = stage_fn(p, torch.where(s == 0, inj, buf))
        # The last stage retires microbatch t - (S - 1).
        widx = t - last
        updated = outs.index_copy(
            0, torch.full((1,), min(max(widx, 0), m - 1), dtype=torch.int64,
                          device=x.device), h.to(outs.dtype).unsqueeze(0))
        outs = torch.where((s == last) & (widx >= 0), updated, outs)
        # The hop to the next stage (no wraparound: the last stage's
        # output leaves the pipe through ``outs``).
        (buf,) = ppermute((h,), st, 1, wrap=False)
    # Only the last stage holds real outputs; the sum over the axis gives
    # them to every stage rank.
    outs = reduce_from_region(torch.where(s == last, outs,
                                          torch.zeros_like(outs)), st)
    return outs.reshape((batch,) + tuple(x.shape[1:]))


def sequential_apply(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """Reference semantics: the same stages applied one after another."""
    n = next(iter(stage_params.values())).shape[0]
    for i in range(n):
        x = stage_fn({k: a[i] for k, a in stage_params.items()}, x)
    return x
