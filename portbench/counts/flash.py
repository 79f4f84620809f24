"""Operations and bytes of the flash attention kernels per call on
``(B, T, H, D)`` in a ``elem``-byte type (bf16: 2).

Forward: ``q k^T`` and ``p v``, ``4 B H T^2 D`` operations; reads q, k, v
and writes o and the float32 log-sum-exp ``(B, H, T)``. Backward: the
recomputed ``q k^T``, ``dO v^T``, ``dV``, ``dQ`` and ``dK`` products,
``10 B H T^2 D``; reads q, k, v, o, dO and the log-sum-exp, writes dq, dk
and dv. A workspace the kernel writes and reads itself (the backward's
row sums) is neither input nor output and is not counted."""

from __future__ import annotations


def fwd_flops(b: int, t: int, h: int, d: int) -> int:
    return 4 * b * h * t * t * d


def fwd_bytes(b: int, t: int, h: int, d: int, elem: int = 2) -> int:
    return 4 * b * t * h * d * elem + b * h * t * 4


def bwd_flops(b: int, t: int, h: int, d: int) -> int:
    return 10 * b * h * t * t * d


def bwd_bytes(b: int, t: int, h: int, d: int, elem: int = 2) -> int:
    return 8 * b * t * h * d * elem + b * h * t * 4
