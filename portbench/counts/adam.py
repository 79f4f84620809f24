"""Bytes of the fused Adam kernel per step: every float32 parameter,
gradient and both moments read once, and the parameter and both moments
written once (28 bytes a parameter)."""

from __future__ import annotations


def step_bytes(parameters: int) -> int:
    return 28 * parameters
