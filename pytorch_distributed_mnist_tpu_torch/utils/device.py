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
