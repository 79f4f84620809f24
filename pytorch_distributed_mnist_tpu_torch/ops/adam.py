"""Fused Adam: the hand-written CUDA kernel for one parameter leaf, its
plain PyTorch version, and the optimizer built on them.

Counterpart of ``pytorch_distributed_mnist_tpu/ops/pallas/adam.py`` under
``optax.inject_hyperparams`` (``train/state.py::make_optimizer``), selected
by ``--optimizer adam_pallas``. One kernel launch per parameter leaf updates
the moments and the parameter in place (the TPU kernel plus
``optax.apply_updates``), from a float32[9] hypers vector on the device:
``[lr, b1, b2, eps, 1/bc1, 1/bc2, 1-b1, 1-b2, eps_root]``.

:func:`adam_leaf` launches ``csrc/adam.cu`` for CUDA tensors (built at
first use, ``ops/cuda_build.py``) and takes :func:`adam_leaf_plain` only
for tensors on the CPU. There is no fallback from one to the other.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch

from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

__all__ = ["FusedAdam", "adam_hypers", "adam_leaf", "adam_leaf_plain"]

_count_lock = threading.Lock()

# The injected hyperparameters of optax.adam, in the order JAX flattens
# them (sorted keys), with their defaults.
ADAM_DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def adam_hypers(hyper: Dict[str, torch.Tensor], t: torch.Tensor) \
        -> torch.Tensor:
    """The float32[9] hypers vector from the injected float32 scalars and
    the float32 step ``t`` (the incremented count), with the float32
    operations of the reference's ``inject_hyperparams(pallas_adam)``
    path (``adam.py:147-159``). There ``b1`` and ``b2`` arrive as float32
    arrays, so the complements ``1 - b`` are float32 subtractions:
    ``1 - f32(0.999)``, not ``f32(0.001)``. All on the device: no host
    sync."""
    b1, b2 = hyper["b1"], hyper["b2"]
    return torch.stack([
        hyper["learning_rate"], b1, b2, hyper["eps"],
        1.0 / (1.0 - torch.pow(b1, t)),
        1.0 / (1.0 - torch.pow(b2, t)),
        1.0 - b1, 1.0 - b2, hyper["eps_root"],
    ])


def _check(p, g, m, v, hypers) -> None:
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"adam_leaf takes float32 leaves; {name} is "
                             f"{t.dtype}")
        if t.shape != p.shape:
            raise ValueError(f"adam_leaf: {name} has shape {tuple(t.shape)}"
                             f", the param {tuple(p.shape)}")
        if t.device != p.device:
            raise ValueError(f"operands on different devices: {p.device} / "
                             f"{t.device}")
    if hypers.dtype != torch.float32 or hypers.shape != (9,) \
            or hypers.device != p.device:
        raise ValueError(f"adam_leaf takes float32[9] hypers on {p.device}, "
                         f"got {tuple(hypers.shape)} {hypers.dtype} on "
                         f"{hypers.device}")


def adam_leaf_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, hypers: torch.Tensor) -> None:
    """The kernel's update in torch ops, one rounding per operation in
    the TPU kernel's order; updates ``p``, ``m`` and ``v`` in place. Runs
    on any device; the CPU path of :func:`adam_leaf` and the yardstick the
    kernel is held against on the card."""
    _check(p, g, m, v, hypers)
    lr, b1, b2, eps, inv_bc1, inv_bc2, c1, c2, eps_root = hypers.unbind()
    m_new = b1 * m + c1 * g
    v_new = b2 * v + c2 * g * g
    m_hat = m_new * inv_bc1
    v_hat = v_new * inv_bc2
    delta = -lr * m_hat / (torch.sqrt(v_hat + eps_root) + eps)
    p.add_(delta)
    m.copy_(m_new)
    v.copy_(v_new)


def adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, hypers: torch.Tensor) -> None:
    """Update one float32 leaf in place: ``p``, ``m`` and ``v`` from the
    gradient ``g`` and the device ``hypers`` vector. CUDA tensors launch
    the kernel (counted in ``adam_leaf.launches``); CPU tensors take
    :func:`adam_leaf_plain`. ``p``, ``m`` and ``v`` must be contiguous (the
    kernel writes them in place); a strided ``g`` is copied."""
    _check(p, g, m, v, hypers)
    if p.device.type == "cpu":
        adam_leaf_plain(p, g, m, v, hypers)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_leaf runs on cuda or cpu, not {p.device}")
    for name, t in (("p", p), ("m", m), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"adam_leaf updates {name} in place and needs it "
                             f"contiguous")
    g = g.contiguous()
    hypers = hypers.contiguous()
    lib = cuda_build.load("adam")
    err = lib.adam_launch(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                          v.data_ptr(), hypers.data_ptr(), p.numel(),
                          p.device.index,
                          torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err} at "
                           f"{p.numel()} elements")
    with _count_lock:
        adam_leaf.launches += 1


adam_leaf.launches = 0


class FusedAdam(torch.optim.Optimizer):
    """Adam with one fused kernel launch per parameter leaf.

    Its state maps one to one onto the reference's
    ``inject_hyperparams(pallas_adam)`` state: ``count`` (the injection
    wrapper's step count, ``['opt_state'].count``), ``hyperparams``
    (float32 device scalars ``b1``, ``b2``, ``eps``, ``eps_root``,
    ``learning_rate``), and the ``ScaleByAdamState`` of
    ``['opt_state'].inner_state[0]``: ``inner_count`` and ``mu``/``nu``
    per parameter (``self.state[p]``). Counts are int32 device scalars.
    ``step()`` reads each parameter's ``.grad`` and runs no host sync."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0) -> None:
        super().__init__(params, {})
        first = self.param_groups[0]["params"][0]
        dev = first.device

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        self.hyperparams = {"b1": f32(b1), "b2": f32(b2), "eps": f32(eps),
                            "eps_root": f32(eps_root),
                            "learning_rate": f32(lr)}
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.inner_count = torch.zeros((), dtype=torch.int32, device=dev)
        for p in self.params:
            self.state[p]["mu"] = torch.zeros_like(p, dtype=torch.float32)
            self.state[p]["nu"] = torch.zeros_like(p, dtype=torch.float32)

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def set_learning_rate(self, lr: float) -> None:
        """Write the float32 ``lr`` into the injected hyperparameters (the
        reference's ``with_learning_rate``)."""
        self.hyperparams["learning_rate"].fill_(lr)

    def inner_leaves(self) -> List[Tuple[str, object]]:
        """The inner state's leaves in the reference's flatten order:
        ``(path, scalar tensor)`` or ``(path, [tensor per param])``."""
        return [("['opt_state'].inner_state[0].count", self.inner_count),
                ("['opt_state'].inner_state[0].mu",
                 [self.state[p]["mu"] for p in self.params]),
                ("['opt_state'].inner_state[0].nu",
                 [self.state[p]["nu"] for p in self.params])]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedAdam.step takes no closure")
        self.count.add_(1)
        self.inner_count.add_(1)
        hypers = adam_hypers(self.hyperparams, self.inner_count.float())
        for p in self.params:
            if p.grad is None:
                raise RuntimeError("FusedAdam.step: a parameter has no "
                                   "gradient (call backward first)")
            adam_leaf(p, p.grad, self.state[p]["mu"], self.state[p]["nu"],
                      hypers)
        return None
