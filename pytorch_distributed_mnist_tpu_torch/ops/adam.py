"""Fused Adam: the hand-written CUDA kernel that updates every parameter
leaf of a step in one launch, its plain PyTorch version, and the optimizer
built on them.

Counterpart of ``pytorch_distributed_mnist_tpu/ops/pallas/adam.py`` under
``optax.inject_hyperparams`` (``train/state.py::make_optimizer``), selected
by ``--optimizer adam_pallas``. The reference makes one ``pallas_call`` per
leaf; here one launch of ``csrc/adam.cu`` updates the moments and the
parameter of up to :data:`MAX_LEAVES` leaves in place (the TPU kernel plus
``optax.apply_updates``), with the hypers
``[lr, b1, b2, eps, 1/bc1, 1/bc2, 1-b1, 1-b2, eps_root]`` formed on the
device.

:func:`adam_leaves` and :func:`adam_leaf` launch the kernel for CUDA
tensors (built at first use, ``ops/cuda_build.py``) and take
:func:`adam_leaves_plain` / :func:`adam_leaf_plain` only for tensors on
the CPU. There is no fallback from one to the other.

The wrappers launch on the current stream and keep no state between
calls but their launch counts and :class:`FusedAdam`'s table of the
params' and moments' pointers, which are updated in place and stay
where they are, so a CUDA graph can capture them
(``train/steps.py::EpochProgram``); ``ops/launches.py`` keeps the counts
exact across the graph's replays.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
from pytorch_distributed_mnist_tpu_torch.utils import debug_nans

__all__ = ["CHUNK", "FusedAdam", "LeafTable", "MAX_LEAVES", "adam_hypers",
           "adam_leaf", "adam_leaf_plain", "adam_leaves", "adam_leaves_plain",
           "bias_corrections", "launch_plan"]

_count_lock = threading.Lock()

# The injected hyperparameters of optax.adam, in the order JAX flattens
# them (sorted keys), with their defaults.
ADAM_DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}
HYPER_KEYS = ("learning_rate", "b1", "b2", "eps", "eps_root")

CHUNK = 1024      # elements per block: csrc/adam.cu's kThreads * kVec
MAX_LEAVES = 64   # leaves per launch: csrc/adam.cu's kMaxLeaves


def adam_hypers(hyper: Dict[str, torch.Tensor], t: torch.Tensor) \
        -> torch.Tensor:
    """The float32[9] hypers vector from the injected float32 scalars and
    the float32 step ``t`` (the incremented count), with the float32
    operations of the reference's ``inject_hyperparams(pallas_adam)``
    path (``adam.py:147-159``). There ``b1`` and ``b2`` arrive as float32
    arrays, so the complements ``1 - b`` are float32 subtractions:
    ``1 - f32(0.999)``, not ``f32(0.001)``. All on the device: no host
    sync.

    ``b ** t`` has three implementations: ``torch.pow`` here, XLA's
    ``pow`` in the reference (its optax bias correction and ``pallas_adam``),
    and CUDA's ``powf`` in ``csrc/adam.cu``, which forms this vector on the
    card. torch and XLA:CPU round ``b1 ** t`` one ulp apart at 180 of
    t = 1..3000 (first at t = 31) and ``b2 ** t`` at 56 (first at t = 168),
    so a resume across the two packages agrees within allclose after step
    31, not bit for bit (``tests/test_torch_adam.py`` pins the bound). On
    the card ``torch.pow`` is CUDA's ``powf`` too, and the kernel's vector
    equals this one bit for bit (``chip_smoke.py`` checks t = 1..3000)."""
    b1, b2 = hyper["b1"], hyper["b2"]
    bc1, bc2 = bias_corrections(hyper, t)
    return torch.stack([
        hyper["learning_rate"], b1, b2, hyper["eps"], 1.0 / bc1, 1.0 / bc2,
        1.0 - b1, 1.0 - b2, hyper["eps_root"],
    ])


def bias_corrections(hyper: Dict[str, torch.Tensor], t: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(1 - b1 ** t, 1 - b2 ** t)`` in float32 from the injected ``b1``,
    ``b2`` and the float32 step ``t``, with ``torch.pow``: the bias
    corrections of :func:`adam_hypers` and of
    ``train/state.py::OptaxAdam``."""
    return 1.0 - torch.pow(hyper["b1"], t), 1.0 - torch.pow(hyper["b2"], t)


def _check(p, g, m, v) -> None:
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"adam takes float32 leaves; {name} is "
                             f"{t.dtype}")
        if t.shape != p.shape:
            raise ValueError(f"adam: {name} has shape {tuple(t.shape)}, the "
                             f"param {tuple(p.shape)}")
        if t.device != p.device:
            raise ValueError(f"operands on different devices: {p.device} / "
                             f"{t.device}")


def _check_hypers(hypers: torch.Tensor, device) -> None:
    if hypers.dtype != torch.float32 or hypers.shape != (9,) \
            or hypers.device != device:
        raise ValueError(f"adam_leaf takes float32[9] hypers on {device}, "
                         f"got {tuple(hypers.shape)} {hypers.dtype} on "
                         f"{hypers.device}")


def _check_scalars(hyper: Dict[str, torch.Tensor],
                   inner_count: torch.Tensor, device) -> None:
    for key in HYPER_KEYS:
        t = hyper[key]
        if t.dtype != torch.float32 or t.dim() != 0 or t.device != device:
            raise ValueError(f"adam_leaves takes a float32 scalar {key} on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if inner_count.dtype != torch.int32 or inner_count.dim() != 0 \
            or inner_count.device != device:
        raise ValueError(f"adam_leaves takes an int32 scalar step count on "
                         f"{device}")


def adam_leaf_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, hypers: torch.Tensor) -> None:
    """The kernel's update in torch ops, one rounding per operation in
    the TPU kernel's order; updates ``p``, ``m`` and ``v`` in place. Runs
    on any device; the CPU path of :func:`adam_leaf` and the yardstick the
    kernel is held against on the card."""
    _check(p, g, m, v)
    _check_hypers(hypers, p.device)
    lr, b1, b2, eps, inv_bc1, inv_bc2, c1, c2, eps_root = hypers.unbind()
    m_new = b1 * m + c1 * g
    v_new = b2 * v + c2 * g * g
    m_hat = m_new * inv_bc1
    v_hat = v_new * inv_bc2
    delta = -lr * m_hat / (torch.sqrt(v_hat + eps_root) + eps)
    p.add_(delta)
    m.copy_(m_new)
    v.copy_(v_new)


def adam_leaves_plain(params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor],
                      ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                      hyper: Dict[str, torch.Tensor],
                      inner_count: torch.Tensor) -> None:
    """:func:`adam_leaves` in torch ops: the hypers vector from
    :func:`adam_hypers` at ``t = float(inner_count)``, then
    :func:`adam_leaf_plain` on each leaf in turn."""
    hypers = adam_hypers(hyper, inner_count.float())
    for p, g, m, v in zip(params, grads, ms, vs, strict=True):
        adam_leaf_plain(p, g, m, v, hypers)


def launch_plan(numels: Sequence[int]) -> List[Tuple[List[int], List[int]]]:
    """The launches that update leaves of these lengths: per launch, the
    indices of its leaves (at most :data:`MAX_LEAVES`; empty leaves are in
    none) and ``first``, the first chunk of each of them, then the grid's
    size. Block ``b`` of a launch updates elements ``[(b - first[i]) *
    CHUNK, (b - first[i] + 1) * CHUNK)`` of its leaf ``i``, the last with
    ``first[i] <= b`` (cut at the leaf's length)."""
    live = [i for i, n in enumerate(numels) if n > 0]
    plan = []
    for s in range(0, len(live), MAX_LEAVES):
        group = live[s:s + MAX_LEAVES]
        first = [0]
        for i in group:
            first.append(first[-1] + -(-int(numels[i]) // CHUNK))
        if first[-1] > 2 ** 31 - 1:
            raise ValueError(f"adam: {first[-1]} blocks exceed one launch")
        plan.append((group, first))
    return plan


def _refuse_overlaps(rows: np.ndarray) -> None:
    """Raises when any two of the table's p, g, m and v share a byte: the
    kernel reads and writes them as distinct buffers. (Sorted by start, an
    overlap anywhere shows between two neighbours.)"""
    starts = rows[:, :4].ravel()
    sizes = np.repeat(rows[:, 4] * 4, 4)
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], starts[order] + sizes[order]
    if np.any(starts[1:] < ends[:-1]):
        raise ValueError("adam: two leaves (or a leaf's p, g, m and v) "
                         "share storage")


class LeafTable:
    """The host side of one multi-leaf update: a row per non-empty leaf
    (the device pointers of p, g, m and v, and its length) and the launch
    plan. p, m and v are checked once here (float32, contiguous, on one
    CUDA device); :meth:`launch` fills only the gradients' column, so an
    optimizer that keeps its table (:class:`FusedAdam`) refreshes the
    pointers that change every step and no others. p, m and v must stay
    where they are: updated in place, as the optimizer and the checkpoint
    loader (``models/convert.py::load_state_from_jax``) do."""

    def __init__(self, params: Sequence[torch.Tensor],
                 ms: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor]) -> None:
        if not len(params) == len(ms) == len(vs):
            raise ValueError(f"adam: {len(params)} params, {len(ms)} first "
                             f"and {len(vs)} second moments")
        if not params:
            raise ValueError("adam: no leaves")
        self.device = params[0].device
        if self.device.type != "cuda":
            raise ValueError(f"adam's kernel runs on cuda, not "
                             f"{self.device}")
        for p, m, v in zip(params, ms, vs):
            _check(p, p, m, v)
            if p.device != self.device:
                raise ValueError(f"operands on different devices: "
                                 f"{self.device} / {p.device}")
            for name, t in (("p", p), ("m", m), ("v", v)):
                if not t.is_contiguous():
                    raise ValueError(f"adam updates {name} in place and "
                                     f"needs it contiguous")
        self.params = list(params)
        self.live = [i for i, p in enumerate(params) if p.numel() > 0]
        self.rows = np.zeros((len(self.live), 5), dtype=np.int64)
        for r, i in enumerate(self.live):
            self.rows[r] = (params[i].data_ptr(), 0, ms[i].data_ptr(),
                            vs[i].data_ptr(), params[i].numel())
        # Rows are the live leaves in order, so the plan's indices are rows.
        self.plan = [(rows, np.asarray(first, dtype=np.int32))
                     for rows, first in launch_plan(self.rows[:, 4])]

    def launch(self, grads: Sequence[torch.Tensor], hypers=None,
               hyper: Optional[Dict[str, torch.Tensor]] = None,
               inner_count: Optional[torch.Tensor] = None,
               hypers_out: Optional[torch.Tensor] = None) -> int:
        """Launch the kernel over every leaf with these gradients, on the
        current stream; the hypers from the float32[9] ``hypers``, or from
        the injected scalars ``hyper`` and the int32 ``inner_count``.
        Returns the number of launches (one per :data:`MAX_LEAVES`
        leaves)."""
        if len(grads) != len(self.params):
            raise ValueError(f"adam: {len(grads)} gradients for "
                             f"{len(self.params)} params")
        held = []  # contiguous copies of strided gradients, kept alive
        for r, i in enumerate(self.live):
            p, g = self.params[i], grads[i]
            if g.dtype != torch.float32 or g.shape != p.shape \
                    or g.device != self.device:
                raise ValueError(f"adam: gradient {i} is {tuple(g.shape)} "
                                 f"{g.dtype} on {g.device}, its param "
                                 f"{tuple(p.shape)} float32 on {self.device}")
            if not g.is_contiguous():
                g = g.contiguous()
                held.append(g)
            self.rows[r, 1] = g.data_ptr()
        _refuse_overlaps(self.rows)
        if hypers is not None:
            pointers = [hypers.data_ptr()] + [None] * 6
        else:
            pointers = [None] + [hyper[k].data_ptr() for k in HYPER_KEYS] \
                + [inner_count.data_ptr()]
        out = None if hypers_out is None else hypers_out.data_ptr()
        lib = cuda_build.load("adam")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for leaves, first in self.plan:
            rows = np.ascontiguousarray(self.rows[leaves])
            err = lib.adam_leaves_launch(
                rows.ctypes.data, len(leaves), first.ctypes.data, *pointers,
                out, self.device.index, stream)
            if err != 0:
                raise RuntimeError(f"adam kernel launch failed: CUDA error "
                                   f"{err} over {len(leaves)} leaves")
        return len(self.plan)


def adam_leaves(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], hyper: Dict[str, torch.Tensor],
                inner_count: torch.Tensor, *,
                table: Optional[LeafTable] = None,
                hypers_out: Optional[torch.Tensor] = None) -> None:
    """Update every float32 leaf in place: ``params``, ``ms`` and ``vs``
    from ``grads``, with the hypers formed from the injected float32
    scalars ``hyper`` (``learning_rate``, ``b1``, ``b2``, ``eps``,
    ``eps_root``) and the int32 step count ``inner_count`` (already
    incremented). CUDA tensors launch the kernel once per
    :data:`MAX_LEAVES` leaves (counted in ``adam_leaves.launches``), from
    ``table`` when the caller keeps one for these params and moments;
    ``hypers_out`` (float32[9] on the card), when given, receives the
    hypers the kernel formed. CPU tensors take :func:`adam_leaves_plain`.
    Leaves must not share storage; p, m and v must be contiguous, a
    strided gradient is copied."""
    if not params:
        return
    device = params[0].device
    _check_scalars(hyper, inner_count, device)
    if device.type == "cpu":
        for p, g, m, v in zip(params, grads, ms, vs, strict=True):
            _check(p, g, m, v)
        _refuse_overlaps(np.array(
            [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
              p.numel()) for p, g, m, v in zip(params, grads, ms, vs)
             if p.numel() > 0], dtype=np.int64).reshape(-1, 5))
        adam_leaves_plain(params, grads, ms, vs, hyper, inner_count)
        return
    if device.type != "cuda":
        raise ValueError(f"adam_leaves runs on cuda or cpu, not {device}")
    if table is None:
        table = LeafTable(params, ms, vs)
    launched = table.launch(grads, hyper=hyper, inner_count=inner_count,
                            hypers_out=hypers_out)
    with _count_lock:
        adam_leaves.launches += launched
    debug_nans.check_outputs("adam", *params, *ms, *vs)


def adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, hypers: torch.Tensor) -> None:
    """Update one float32 leaf in place: ``p``, ``m`` and ``v`` from the
    gradient ``g`` and the device ``hypers`` vector. The one-leaf case of
    :func:`adam_leaves`' launch: CUDA tensors launch the same kernel
    (counted in ``adam_leaves.launches``); CPU tensors take
    :func:`adam_leaf_plain`. ``p``, ``m`` and ``v`` must be contiguous
    (the kernel writes them in place); a strided ``g`` is copied."""
    _check(p, g, m, v)
    _check_hypers(hypers, p.device)
    if p.device.type == "cpu":
        adam_leaf_plain(p, g, m, v, hypers)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_leaf runs on cuda or cpu, not {p.device}")
    launched = LeafTable([p], [m], [v]).launch([g],
                                               hypers=hypers.contiguous())
    with _count_lock:
        adam_leaves.launches += launched
    debug_nans.check_outputs("adam", p, m, v)


adam_leaves.launches = 0


class FusedAdam(torch.optim.Optimizer):
    """Adam with one fused kernel launch per step (per :data:`MAX_LEAVES`
    leaves).

    Its state maps one to one onto the reference's
    ``inject_hyperparams(pallas_adam)`` state: ``count`` (the injection
    wrapper's step count, ``['opt_state'].count``), ``hyperparams``
    (float32 device scalars ``b1``, ``b2``, ``eps``, ``eps_root``,
    ``learning_rate``), and the ``ScaleByAdamState`` of
    ``['opt_state'].inner_state[0]``: ``inner_count`` and ``mu``/``nu``
    per parameter (``self.state[p]``). Counts are int32 device scalars.
    ``step()`` reads each parameter's ``.grad``, runs no host sync, and on
    the card keeps one :class:`LeafTable` of its params and moments."""

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
        self._table: Optional[LeafTable] = None

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
        params = self.params
        grads = [p.grad for p in params]
        if any(g is None for g in grads):
            raise RuntimeError("FusedAdam.step: a parameter has no "
                               "gradient (call backward first)")
        self.count.add_(1)
        self.inner_count.add_(1)
        ms = [self.state[p]["mu"] for p in params]
        vs = [self.state[p]["nu"] for p in params]
        if self._table is None and self.count.device.type == "cuda":
            self._table = LeafTable(params, ms, vs)
        adam_leaves(params, grads, ms, vs, self.hyperparams,
                    self.inner_count, table=self._table)
        return None
