"""Mixture-of-experts model family (the expert parallelism vehicle).

Counterpart of ``pytorch_distributed_mnist_tpu/models/moe.py``: a
switch-style (top-1) MoE layer inside a small MNIST classifier. The
expert weights carry a leading ``num_experts`` dim that
``parallel/expert.py::moe_ep_rules`` splits over the ``expert`` mesh
axis; a rank then holds ``E / ep`` experts and computes only their FLOPs.

Two dispatch modes behind one interface:

- ``dispatch='dense'`` (default): every local expert's MLP runs on every
  token algebraically and the one-hot combine zeroes all but the routed
  expert. Under expert parallelism each rank combines its local experts'
  share and the shares sum over the expert subgroup
  (``parallel/regions.py``'s Megatron pair: the input's gradient is
  all-reduced, the output all-reduced with an identity backward).
- ``dispatch='capacity'``: physical dispatch into per-expert buffers
  bounded by ``capacity_factor``, crossing the expert axis by all-to-all
  (``parallel/moe_dispatch.py::moe_capacity_forward``); over-capacity
  tokens drop (the residual carries them). Equal to dense dispatch when
  nothing drops.

Both compute the switch load-balance loss (``E * sum_e f_e p_e``; 1.0 =
uniform) when asked: ``MoEClassifier(x, intermediates=True)`` returns
``(logits, {('moe', 'aux_loss'): aux})``, the port of flax's
``sow('intermediates', 'aux_loss', ...)``; ``train/steps.py`` adds
``aux_weight * aux`` to the objective. Nothing is kept in module state.

Param names and shapes are flax's: ``moe.router.kernel``/``bias`` (a
Dense, float32 whatever the compute dtype: routing is a discrete
decision), and the raw ``moe.w1`` ``(E, C, H)``, ``b1`` ``(E, H)``,
``w2`` ``(E, H, C)``, ``b2`` ``(E, C)``. The einsums stay
``torch.einsum``: the JAX package computes them in XLA, outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_mnist_tpu_torch.models.linear import Dense
from pytorch_distributed_mnist_tpu_torch.models.registry import register_model
from pytorch_distributed_mnist_tpu_torch.parallel.moe_dispatch import (
    load_balance_loss,
    moe_capacity_forward,
    top1_mask_gate,
)
from pytorch_distributed_mnist_tpu_torch.parallel.regions import (
    copy_to_region,
    reduce_from_region,
)


class SwitchMoE(nn.Module):
    """Top-1-routed mixture of expert MLPs: (B, C) -> (B, C). ``mesh`` (a
    ``parallel/mesh.py`` mesh) names the expert axis the expert weights
    split over and the data axis the aux loss sums over; None is one
    process."""

    def __init__(self, features: int, num_experts: int = 8,
                 hidden: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 dispatch: str = "dense", capacity_factor: float = 1.25,
                 mesh=None, expert_axis: str = "expert",
                 data_axis: Optional[str] = "data") -> None:
        super().__init__()
        if dispatch not in ("dense", "capacity"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        e, h, c = num_experts, hidden, features
        self.num_experts = num_experts
        self.compute_dtype = compute_dtype
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        self.mesh = mesh
        self.expert_axis = expert_axis
        self.data_axis = data_axis
        self.router = Dense(c, e, torch.float32)
        self.w1 = nn.Parameter(torch.zeros(e, c, h))
        self.b1 = nn.Parameter(torch.zeros(e, h))
        self.w2 = nn.Parameter(torch.zeros(e, h, c))
        self.b2 = nn.Parameter(torch.zeros(e, c))

    def _axis(self, name: Optional[str]):
        """The mesh's axis ``name`` (``'data'`` is the composed pair on a
        two-tier mesh), or None."""
        if self.mesh is None or not name:
            return None
        try:
            return self.mesh.axis(name)
        except KeyError:
            return None

    def forward(self, x: torch.Tensor, want_aux: bool = False):
        """``(out, aux)``: aux is the load-balance loss, or None unless
        ``want_aux``."""
        cd = self.compute_dtype
        # Router math in f32: top-1 selection is a discrete decision.
        probs = torch.softmax(self.router(x.to(torch.float32)), dim=-1)
        aux = (load_balance_loss(probs, self._axis(self.data_axis))
               if want_aux else None)
        if self.dispatch == "capacity":
            out = moe_capacity_forward(
                x.to(cd), probs, self.w1, self.b1, self.w2, self.b2,
                capacity_factor=self.capacity_factor, compute_dtype=cd,
                mesh=self.mesh, expert_axis=self.expert_axis,
                data_axis=self.data_axis)
            return out.to(x.dtype), aux

        mask, gate = top1_mask_gate(probs)  # (B, E) one-hot, (B,) prob
        e_loc = self.w1.shape[0]
        ep_axis = self._axis(self.expert_axis)
        xc = x.to(cd)
        if e_loc != self.num_experts:
            # This rank's experts: their columns of the combine; the
            # input's (and the gate's) gradient sums over the subgroup.
            lo = ep_axis.rank * e_loc
            mask = mask[:, lo:lo + e_loc]
            xc = copy_to_region(xc, ep_axis)
            gate = copy_to_region(gate, ep_axis)
        gate = gate[:, None]
        # (B, E_loc, H): per-expert hidden.
        hdn = F.relu(torch.einsum("bc,ech->beh", xc, self.w1.to(cd))
                     + self.b1.to(cd))
        y = (torch.einsum("beh,ehc->bec", hdn, self.w2.to(cd))
             + self.b2.to(cd))  # (B, E_loc, C)
        # One-hot combine: under EP the sum over E is the all-reduce.
        out = torch.einsum("bec,be->bc", y.to(torch.float32), mask) * gate
        if e_loc != self.num_experts:
            out = reduce_from_region(out, ep_axis)
        return out.to(x.dtype), aux


@register_model("moe_mlp")
class MoEClassifier(nn.Module):
    """flatten -> embed -> residual SwitchMoE -> head (MNIST classifier)."""

    def __init__(self, num_classes: int = 10, num_experts: int = 8,
                 embed_dim: int = 64, hidden: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 dispatch: str = "dense", capacity_factor: float = 1.25,
                 mesh=None, expert_axis: str = "expert",
                 data_axis: Optional[str] = "data") -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed = Dense(784, embed_dim, compute_dtype)
        self.moe = SwitchMoE(embed_dim, num_experts, hidden, compute_dtype,
                             dispatch=dispatch,
                             capacity_factor=capacity_factor, mesh=mesh,
                             expert_axis=expert_axis, data_axis=data_axis)
        self.head = Dense(embed_dim, num_classes, compute_dtype)

    def forward(self, x: torch.Tensor, intermediates: bool = False):
        """Logits; with ``intermediates``, ``(logits, {('moe',
        'aux_loss'): aux})``."""
        x = x.reshape(x.shape[0], -1).to(self.compute_dtype)  # (B, 784)
        x = F.relu(self.embed(x))
        y, aux = self.moe(x, want_aux=intermediates)
        x = x + y
        logits = self.head(x).float()
        if intermediates:
            return logits, {("moe", "aux_loss"): aux}
        return logits
