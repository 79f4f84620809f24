"""int8 x int8 -> int32 matrix product: the hand-written CUDA kernel, its
plain PyTorch version, and the int8 Dense contraction built on them.

Counterpart of ``pytorch_distributed_mnist_tpu/ops/pallas/matmul_i8.py``.
The ``int8`` serving plane injects :func:`int8_linear` into a model's
``matmul`` field (``models/registry.py::model_accepts`` gates it), which
reaches ``cnn``'s ``fc1``/``fc2`` and ``linear``'s ``fc``: both operands
are quantized per tensor, dynamically, contracted in int8 with exact
int32 sums, and the sums are rescaled by the product of the two scales.

:func:`matmul_i8` launches ``csrc/matmul_i8.cu`` for CUDA tensors (built
at first use, see ``ops/cuda_build.py``) and takes
:func:`matmul_i8_plain` only for tensors on the CPU. There is no fallback
from one to the other: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Tuple

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

__all__ = ["abs_peak", "int8_linear", "matmul_i8", "matmul_i8_plain",
           "quantize_dynamic_i8", "quantize_i8", "rescale_i8", "split_k"]

# The reference writes the scale as ``max|x| / 127.0``; XLA's algebraic
# simplifier rewrites a divide by a constant into a multiply by the f32
# reciprocal, so that is what the reference computes. Written out here so
# the scales agree bitwise.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))
# The reference's rescale ``acc * (sa * sb)`` is ``acc * ((ma / 127) *
# (mb / 127))``; XLA folds the two constants into one, so what it computes
# is ``acc * ((ma * mb) * _INV_127_SQ)``, with this float32 constant.
_INV_127_SQ = float(np.float32(np.float32(_INV_127) * np.float32(_INV_127)))

# Output tile of the CUDA kernel (kBlockM x kBlockN) and its K step.
_BLOCK_M, _BLOCK_N, _BLOCK_K = 32, 32, 128
# Most blocks of one thread-block cluster (portable on Hopper), which sum
# their slices of K on chip before C sees them.
_MAX_CLUSTER = 8
# Most int32 atomic adds into C a split may cost: beyond one cluster each
# further one adds M * N.
_ATOMIC_BUDGET = 1 << 14
# CUDA's limit on gridDim.y, which walks the row blocks.
_MAX_GRID_Y = 65535

_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def matmul_i8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) int8 x (K, N) int8 -> (M, N) int32`` in float64: exact,
    since every partial sum is an integer far below 2**53. Runs on any
    device; the CPU path of :func:`matmul_i8` and the yardstick the
    kernel is held against on the card."""
    _check(a, b)
    return (a.double() @ b.double()).to(torch.int32)


def split_k(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """``(splits, cluster)``: how many slices of K the kernel's grid takes,
    and how many of them share a thread-block cluster (a power of two, at
    most 8, dividing ``splits``). When the output tiles alone cannot fill
    the card, K is cut for about two blocks per SM; clusters beyond the
    first add into C atomically, so their number is held to
    ``_ATOMIC_BUDGET / (M * N)``. Slices hold whole 128-byte steps of K,
    as few per slice as the count allows; rounding the count up to whole
    clusters may leave the last slices empty (they add zeros)."""
    tiles = math.ceil(n / _BLOCK_N) * math.ceil(m / _BLOCK_M)
    k_steps = math.ceil(k / _BLOCK_K)
    if tiles >= sms or k_steps < 2:
        return 1, 1
    splits = min(k_steps, math.ceil(2 * sms / tiles))
    cluster = min(_MAX_CLUSTER, 1 << (splits.bit_length() - 1))
    groups = max(1, min(math.ceil(splits / cluster),
                        _ATOMIC_BUDGET // max(1, m * n)))
    steps = math.ceil(k_steps / (groups * cluster))
    splits = math.ceil(math.ceil(k_steps / steps) / cluster) * cluster
    return splits, cluster


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(
            f"matmul_i8 takes int8 operands, got {a.dtype}/{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul_i8 takes (M, K) x (K, N), got {tuple(a.shape)} x "
            f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(
            f"operands on different devices: {a.device} / {b.device}")


def matmul_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) int8 x (K, N) int8 -> (M, N) int32``, exact.

    CUDA tensors launch the hand-written kernel (and count the launch in
    ``matmul_i8.launches``); CPU tensors take :func:`matmul_i8_plain`.
    Rows must be contiguous (unit stride along K for A, along N for B);
    anything else the kernel does not take raises."""
    _check(a, b)
    if a.device.type == "cpu":
        return matmul_i8_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_i8 runs on cuda or cpu, not {a.device}")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("matmul_i8 needs row-contiguous operands; call "
                         ".contiguous() first")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k, a.stride(0), b.stride(0)) >= 2**31:
        raise ValueError(f"matmul_i8: dims {m}x{k}x{n} exceed int32")
    if math.ceil(m / _BLOCK_M) > _MAX_GRID_Y:
        raise ValueError(f"matmul_i8: M={m} needs more than {_MAX_GRID_Y} "
                         f"row blocks of {_BLOCK_M}")
    lib = cuda_build.load("matmul_i8")
    splits, cluster = split_k(m, n, k, _sm_count(a.device.index))
    # More slices than one cluster holds: the clusters add their sums
    # atomically into C, which must start at zero. Otherwise every element
    # is stored once.
    alloc = torch.zeros if splits > cluster else torch.empty
    c = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return c
    err = lib.matmul_i8_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        a.stride(0), b.stride(0), c.stride(0), splits, cluster,
        a.device.index, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_i8 kernel launch failed: CUDA error "
                           f"{err} at {m}x{k}x{n}")
    with _count_lock:
        matmul_i8.launches += 1
    return c


matmul_i8.launches = 0


def abs_peak(x: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-12)`` in float32, a 0-d tensor on ``x``'s device:
    what a per-tensor scale is taken from. The peak of a tensor split in
    pieces is the max of the pieces' peaks, bit for bit."""
    return torch.clamp(x.float().abs().amax(), min=1e-12)


def quantize_i8(x: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """``x`` quantized with the scale of ``peak``: ``clip(round_half_even(
    x / (peak / 127)), +-127)`` as int8."""
    scale = peak * _INV_127
    q = torch.round(x.float() / scale)
    return q.clamp(-127.0, 127.0).to(torch.int8)


def rescale_i8(acc: torch.Tensor, peak_a: torch.Tensor,
               peak_b: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums back to float32: ``acc * ((peak_a * peak_b) *
    _INV_127_SQ)``."""
    return acc.float() * ((peak_a * peak_b) * _INV_127_SQ)


def _quantize(x: torch.Tensor):
    """``(q_int8, scale, max)`` with ``max = max(max|x|, 1e-12)``."""
    peak = abs_peak(x)
    return quantize_i8(x, peak), peak * _INV_127, peak


def quantize_dynamic_i8(x: torch.Tensor):
    """Symmetric per-tensor dynamic quantization: ``(q_int8, scale)``,
    ``scale = max(max|x|, 1e-12) / 127`` (see ``_INV_127``), ``q =
    clip(round_half_even(x / scale), +-127)``. ``scale`` is a 0-d tensor
    on ``x``'s device, so the division is an IEEE divide on the card too
    (dividing by a Python number there becomes a multiply by its
    reciprocal)."""
    q, scale, _ = _quantize(x)
    return q, scale


def int8_linear(x: torch.Tensor, w_kn: torch.Tensor, out_dtype=None,
                matmul=matmul_i8, *, peaks=None,
                raw: bool = False) -> torch.Tensor:
    """``(..., K) x (K, N)`` as quantize + int8 product + rescale — the
    counterpart of ``int8_dot_general``'s Dense branch. ``out_dtype``
    defaults to the promoted input dtype (the reference's
    ``result_type(lhs, rhs)``). ``matmul`` picks the int8 product:
    the kernel by default, :func:`matmul_i8_plain` for a reference run on
    the same device.

    A sharded serving engine (``serve/sharded.py``) runs one product per
    shard of a split Dense: ``peaks=(peak_a, peak_b)`` then gives the
    peaks of the WHOLE input and weight (:func:`abs_peak` of each piece,
    maxed), so every shard quantizes with the unsharded scales, and
    ``raw=True`` returns the exact int32 sums, shaped ``(..., N)``, for
    the caller to add over the shards and :func:`rescale_i8` once."""
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, w_kn.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    peak_a, peak_b = peaks if peaks is not None \
        else (abs_peak(x2), abs_peak(w_kn))
    acc = matmul(quantize_i8(x2, peak_a),
                 quantize_i8(w_kn, peak_b).contiguous())
    if raw:
        return acc.reshape(*lead, w_kn.shape[-1])
    out = rescale_i8(acc, peak_a, peak_b)
    return out.reshape(*lead, w_kn.shape[-1]).to(out_dtype)
