"""Device selection: every entry point of the port runs on the card unless
the caller asks for the CPU, and asking for the card without one raises —
nothing silently carries on on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"`` -> ``torch.device``.
    Raises ``RuntimeError`` for a CUDA device when no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA card is visible; "
                f"pass device='cpu' (--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev


def device_name(device: torch.device) -> str:
    """The card's name, or ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


#: Replica slots of the CPU: ``--device cpu`` places up to this many serve
#: replicas on the host, the host-device count the JAX package's CPU test
#: suite runs its pools with (``tests/conftest.py``). The CPU replicas
#: share the host's cores: they are there to drive the pool's logic, not
#: to add throughput.
CPU_SLOTS = 8


def local_devices(kind: str = "cuda") -> list:
    """The devices a serve pool may place replicas on: every visible card
    (``cuda:0`` ... ``cuda:{device_count() - 1}``), or :data:`CPU_SLOTS`
    slots of the host for ``"cpu"``. Asking for the card without one
    raises, as :func:`resolve_device` does."""
    if kind == "cpu":
        return [torch.device("cpu")] * CPU_SLOTS
    if kind != "cuda":
        raise ValueError(f"unsupported device kind {kind!r}: use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("cuda devices requested but no CUDA card is "
                           "visible; pass device='cpu' (--device cpu) to "
                           "run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
