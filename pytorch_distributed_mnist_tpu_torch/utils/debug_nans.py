"""``--debug-nans``: stop at the op that made the first NaN.

The reference turns on ``jax_debug_nans``: a jitted step that yields a
NaN is re-run un-jitted and raises ``FloatingPointError`` at the
primitive that produced it (an Inf is ``jax_debug_infs``' business, which
the reference does not turn on: the cross-entropy pads its classes with
-inf on purpose). Here the counterpart is :class:`NanCheckMode`, a
``TorchDispatchMode`` that checks the output of every floating aten op it
sees and raises ``FloatingPointError`` naming the op. The autograd
engine carries the mode into the backward pass (on its own threads too),
so backward ops are checked alike. The hand-written kernels are invisible
to a dispatch mode (they launch through ctypes), so their wrappers
(``ops/xent.py``, ``ops/adam.py``) check their own outputs with
:func:`check_outputs` while the mode is on.

- ``stepwise`` and ``explicit`` run every train and eval step under the
  mode (``train/trainer.py``).
- ``scan`` replays a captured CUDA graph, inside which nothing may read
  the card from the host. The trainer instead keeps a copy of the train
  state from each pass's start, checks the pass's loss sum where the pass
  reads its metrics anyway, and on a NaN sum restores the copy and
  re-runs the pass eagerly under the mode, so the error names the op as
  the reference's does.

:func:`enabled_for` turns the switch on for one run: a later run in the
same process without the flag does not inherit it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves

_enabled = False


def enabled() -> bool:
    """True while a ``--debug-nans`` run is on."""
    return _enabled


@contextlib.contextmanager
def enabled_for(on: bool):
    """Turn the switch on for the block when ``on`` (and off after)."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    try:
        yield
    finally:
        _enabled = prev


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and bool(torch.isnan(t).any()))


def _unwritten(func) -> bool:
    """Ops whose output holds no computed value: allocations (their bytes
    are whatever was there) and views of another op's output."""
    name = func.overloadpacket.__name__
    return func.is_view or name.startswith(("empty", "new_empty", "resize"))


class NanCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the first aten op whose
    floating output holds a NaN. One host read per op: a debugging mode,
    not a fast one."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _unwritten(func) and any(_has_nan(t)
                                        for t in tree_leaves(out)):
            raise FloatingPointError(f"--debug-nans: {func} produced a NaN")
        return out


def checking():
    """The mode for one block when the switch is on, else nothing."""
    return NanCheckMode() if _enabled else contextlib.nullcontext()


def check_outputs(kernel: str, *outputs: torch.Tensor) -> None:
    """A hand-written kernel's check of its outputs: raises
    ``FloatingPointError`` naming ``kernel`` when one holds a NaN and
    :class:`NanCheckMode` is on in this thread (never inside a captured
    graph, which runs without it)."""
    if not _enabled or not any(isinstance(m, NanCheckMode)
                               for m in _get_current_dispatch_mode_stack()):
        return
    if any(_has_nan(t) for t in outputs):
        raise FloatingPointError(
            f"--debug-nans: the {kernel} kernel produced a NaN")
