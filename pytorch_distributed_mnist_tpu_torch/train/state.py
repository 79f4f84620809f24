"""Train state and optimizers.

Counterpart of ``pytorch_distributed_mnist_tpu/train/state.py``. A
:class:`TrainState` holds the model (its float32 params on the device),
the optimizer and the global step. Every optimizer keeps the state of the
reference's ``optax.inject_hyperparams(...)`` wrapper: an int32 ``count``,
float32 ``hyperparams`` on the device (the per-epoch learning rate is
written there, ``with_learning_rate``), and its inner state, so
``models/convert.py`` maps it one to one onto the JAX checkpoint leaves.

- ``adam``: optax's formula ``m_hat / (sqrt(v_hat + eps_root) + eps)`` in
  plain torch ops (not ``torch.optim.Adam``, which rounds elsewhere);
- ``adam_pallas``: the fused CUDA kernel (``ops/adam.py::FusedAdam``);
- ``sgd``: ``add_decayed_weights``, then momentum, as optax chains them.

Unlike the reference's immutable pytree, the port updates in place.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from pytorch_distributed_mnist_tpu_torch.models.convert import (
    jax_param_order,
)
from pytorch_distributed_mnist_tpu_torch.models.registry import (
    lecun_normal_init,
)
from pytorch_distributed_mnist_tpu_torch.ops.adam import (
    FusedAdam,
    bias_corrections,
)

OPTIMIZERS = ("adam", "adam_pallas", "sgd")


class OptaxAdam(FusedAdam):
    """``inject_hyperparams(optax.adam)``: the same state as
    :class:`FusedAdam`, updated with optax's own operations and rounding
    (``scale_by_adam`` then ``scale_by_learning_rate``) in plain torch
    ops. Its bias corrections ``1 - b ** t`` come from ``torch.pow``
    (``ops/adam.py::bias_corrections``), optax's from XLA's ``pow``: they
    round ``b ** t`` one ulp apart at some steps (first at t = 31 for b1,
    t = 168 for b2), so a resume across the packages agrees within
    allclose, not bit for bit."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam.step takes no closure")
        self.count.add_(1)
        self.inner_count.add_(1)
        h = self.hyperparams
        b1, b2 = h["b1"], h["b2"]
        bc1, bc2 = bias_corrections(h, self.inner_count.float())
        for p in self.params:
            g = p.grad
            mu, nu = self.state[p]["mu"], self.state[p]["nu"]
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2 + h["eps_root"]) + h["eps"])
            p.add_(u * -h["learning_rate"])
        return None


class OptaxSGD(torch.optim.Optimizer):
    """``inject_hyperparams(chain(add_decayed_weights(wd), sgd(lr,
    momentum)))``: ``u = g + wd * p``; ``trace = u + momentum * trace``;
    ``p += trace * -lr``. Only the learning rate is injected (the
    reference closes over ``momentum`` and ``wd``)."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.9,
                 weight_decay: float = 1e-4) -> None:
        super().__init__(params, {})
        dev = self.params[0].device
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.hyperparams = {"learning_rate": torch.tensor(
            lr, dtype=torch.float32, device=dev)}
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        for p in self.params:
            self.state[p]["trace"] = torch.zeros_like(p, dtype=torch.float32)

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def set_learning_rate(self, lr: float) -> None:
        self.hyperparams["learning_rate"].fill_(lr)

    def inner_leaves(self) -> List[Tuple[str, object]]:
        # chain(add_decayed_weights, chain(trace, scale)): only the trace
        # has leaves.
        return [("['opt_state'].inner_state[1][0].trace",
                 [self.state[p]["trace"] for p in self.params])]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxSGD.step takes no closure")
        self.count.add_(1)
        neg_lr = -self.hyperparams["learning_rate"]
        for p in self.params:
            trace = self.state[p]["trace"]
            u = p.grad + self.weight_decay * p
            trace.copy_(u + self.momentum * trace)
            p.add_(trace * neg_lr)
        return None


def make_optimizer(params, lr: float = 1e-3, optimizer: str = "adam",
                   momentum: float = 0.9, weight_decay: float = 1e-4):
    """The optimizer named by ``--optimizer`` over ``params`` (which must
    be in the JAX flatten order, ``models/convert.py::jax_param_order``)."""
    if optimizer == "adam":
        return OptaxAdam(params, lr=lr)
    if optimizer == "adam_pallas":
        return FusedAdam(params, lr=lr)
    if optimizer == "sgd":
        return OptaxSGD(params, lr=lr, momentum=momentum,
                        weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer!r}")


class TrainState:
    """The model, its optimizer and the global step (an int32 device
    scalar), updated in place by ``train/steps.py::train_step``."""

    def __init__(self, model: torch.nn.Module, optimizer, step: torch.Tensor):
        self.model = model
        self.optimizer = optimizer
        self.step = step
        # The flat gradient buffer of a data-parallel step
        # (``parallel/collectives.py::grad_buffer``), made at its first
        # use; None for a single process.
        self.grad_buffer = None
        # Leaves that live split over a mesh axis, by JAX leaf name
        # (``parallel/tensor.py::Placement``): the expert weights under
        # expert parallelism, ZeRO's shards. Empty: every leaf is whole.
        self.placements = {}
        # The ZeRO data plane (``parallel/zero.py::ZeroPlane``), or None.
        self.zero = None

    def param_leaves(self):
        """``{port param name: live tensor}`` of the params the state
        holds: the model's, except that under ZeRO-3 a split leaf is this
        rank's shard (the model's whole param is a gathered workspace)."""
        params = dict(self.model.named_parameters())
        zero = self.zero
        if zero is not None and zero.level == 3:
            for i, name in enumerate(zero.names):
                if i in zero.shards:
                    params[name] = zero.shards[i]
        return params

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.hyperparams["learning_rate"])

    def with_learning_rate(self, lr: float) -> "TrainState":
        """Write ``lr`` (as float32) into the injected hyperparameters, on
        the device and with no host sync."""
        self.optimizer.set_learning_rate(lr)
        return self


def create_train_state(model: torch.nn.Module, seed: int, device,
                       lr: float = 1e-3, optimizer: str = "adam",
                       momentum: float = 0.9,
                       weight_decay: float = 1e-4,
                       init: bool = True) -> TrainState:
    """Initialise ``model``'s params (``lecun_normal_init`` from ``seed``;
    ``init=False`` keeps the values it holds), move it to ``device`` and
    build the optimizer over its params in the JAX flatten order."""
    order = jax_param_order(name for name, _ in model.named_parameters())
    if init:
        lecun_normal_init(model, seed, order)
    model.to(device)
    params = dict(model.named_parameters())
    tx = make_optimizer([params[n] for n in order], lr=lr,
                        optimizer=optimizer, momentum=momentum,
                        weight_decay=weight_decay)
    return TrainState(model, tx,
                      torch.zeros((), dtype=torch.int32, device=device))
