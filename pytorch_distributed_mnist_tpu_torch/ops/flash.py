"""Flash attention: the hand-written CUDA kernels (forward; the backward
fused in one kernel, or split into a dQ and a dK/dV kernel), their plain
PyTorch versions, and the autograd function built on them.

Counterpart of ``pytorch_distributed_mnist_tpu/ops/pallas/flash.py``,
selected by ``--attention flash`` for the ViT. Layout ``(B, T, H, D)``,
self-attention only (Tq == Tk). The forward saves ``lse = m + log l`` per
row, ``(B, H, T)`` float32, and the backward recomputes every probability
from it:

    delta_i = rowsum(dO_i * O_i)
    P_ij    = exp(scale * q_i.k_j - lse_i)       (0 where masked)
    dQ_i    = scale * sum_j P_ij (dO_i.V_j - delta_i) K_j
    dV_j    = sum_i P_ij dO_i
    dK_j    = scale * sum_i P_ij (dO_i.V_j - delta_i) Q_i

The causal mask is start-aligned (``qi >= kj``), as the reference's
kernels have it. A row with nothing to attend gives O = 0 and
``lse = NEG_INF``. Scores and sums are float32; O, dQ, dK and dV come back
in the inputs' dtype (float32 or bfloat16).

:func:`flash_fwd`, :func:`flash_bwd`, :func:`flash_dq` and
:func:`flash_dkv` launch ``csrc/flash_fwd.cu``, ``csrc/flash_tf32.cu``,
``csrc/flash.cu``, ``csrc/flash_bwd.cu`` and ``csrc/flash_bwd_tiled.cu``
for CUDA tensors (built at first use, ``ops/cuda_build.py``) and take the
plain versions only for tensors on the CPU. There is no fallback from one
to the other: a CUDA tensor launches a kernel or raises.

The wrappers launch on the current stream and keep no state between
calls but their launch counts, so a CUDA graph can capture them
(``train/steps.py::EpochProgram``); ``ops/launches.py`` keeps the counts
exact across the graph's replays.

Every default route runs on the tensor cores, at any 1 <= D <= 128 and
any T; :func:`_fwd_route` and :func:`_bwd_route` pick it from the dtype
and T alone:

- ``"tensor"`` (forward, bfloat16): ``csrc/flash_fwd.cu``, both products
  as bf16 ``mma.sync`` with float32 sums, P rounded once to bf16 for P V.
- ``"fused"`` (backward, bfloat16, T <= 128): ``csrc/flash_bwd.cu``, one
  kernel per call computes delta, dQ, dK and dV for a whole (batch, head).
- ``"tiled"`` (backward, bfloat16, T > 128, such as the ViT at
  ``--patch-size 2``): ``csrc/flash_bwd_tiled.cu``, a dQ kernel (which
  also writes delta) and then a dK/dV kernel, each tiling T by 64 rows.
- ``"tf32x3"`` (forward and backward, float32, such as the ViT under
  ``--dtype f32``): ``csrc/flash_tf32.cu``, the forward and a dQ then a
  dK/dV kernel as in the tiled pair, every product as three TF32
  ``wgmma`` (each operand split once, as it is staged, into a high and a
  low TF32 part) with float32 sums, which keeps the float32 route's 1e-4
  tolerance (:func:`_tf32_tiles`, :func:`_tf32_plane_words`).

The tensor-core kernels pad the head dims to DP in {16, 32, 64, 128} (8
too in float32) with zeros in shared memory. With D a multiple of 8 and
16-byte aligned views they copy 16 bytes a thread; any other view (an odd
D, the ViT's D = 12 slices of its qkv product, a view that starts off a
16-byte boundary) takes their narrow instantiation, which copies and
stores in the widest of 16, 8, 4 and 2 bytes that the view allows
(``csrc/stage_common.cuh``, :func:`_copy_width`). No operand is copied
for its alignment.

A caller may also name the CUDA-core kernels of ``csrc/flash.cu``, float32
FMAs, for any problem: ``route="cuda_core"`` for the forward and
``route="split"`` for the backward (:func:`flash_dq`, which also computes
delta, then :func:`flash_dkv`). No problem takes them by default; they
stay so that the smoke can time the tensor-core routes beside them.
``"tiled"`` may also be named for a bf16 problem of T <= 128.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
from pytorch_distributed_mnist_tpu_torch.ops.attention import NEG_INF

__all__ = ["flash_attention", "flash_bwd", "flash_bwd_plain", "flash_dkv",
           "flash_dkv_plain", "flash_dq", "flash_dq_plain", "flash_fwd",
           "flash_fwd_plain", "sharded_flash_attention"]

MAX_HEAD_DIM = 128  # the kernels hold 16 head dims per thread, 8 threads
# The fused backward keeps a whole (batch, head) in one block: one warp per
# 16-row tile, at most 8, and the (T, T) dS in shared memory.
FUSED_MAX_T = 128
_TYPES = (torch.float32, torch.bfloat16)

_count_lock = threading.Lock()


def _check(q: torch.Tensor, *same: torch.Tensor) -> None:
    """q, and every tensor of ``same``, is a (B, T, H, D) float32 or
    bfloat16 tensor of q's shape and type, D <= 128, on q's device."""
    if q.dim() != 4:
        raise ValueError(f"flash attention takes (B, T, H, D) operands, got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _TYPES:
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes head dims up to "
                         f"{MAX_HEAD_DIM}, got D={q.shape[-1]}")
    for t in same:
        if t.device != q.device:
            raise ValueError(f"operands on different devices: {q.device} / "
                             f"{t.device}")
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash attention operands must match q's "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _check_rows(q: torch.Tensor, *rows: torch.Tensor) -> None:
    b, t, h, _ = q.shape
    for r in rows:
        if r.device != q.device:
            raise ValueError(f"operands on different devices: {q.device} / "
                             f"{r.device}")
        if r.dtype != torch.float32 or r.shape != (b, h, t):
            raise ValueError(f"flash attention takes ({b}, {h}, {t}) float32 "
                             f"row statistics, got {tuple(r.shape)} "
                             f"{r.dtype}")


def _on_card(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    return True


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


# ---------------------------------------------------------------- plain


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B, H, T, D) float32."""
    return x.float().permute(0, 2, 1, 3)


def _keep(t: int, causal: bool, device) -> torch.Tensor:
    """(T, T) boolean, True = attend: all, or the start-aligned triangle."""
    keep = torch.ones((t, t), dtype=torch.bool, device=device)
    return keep.tril() if causal else keep


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)``: O ``(B, T, H, D)`` in q's dtype, lse ``(B, H, T)``
    float32. The forward kernel's function in torch ops, with the (T, T)
    scores materialized. Runs on any device; the CPU path of
    :func:`flash_fwd` and the yardstick the kernel is held against on the
    card."""
    _check(q, k, v)
    scale = _scale(q, scale)
    keep = _keep(q.shape[1], causal, q.device)
    s = (_heads(q) * scale) @ _heads(k).transpose(-1, -2)  # (B, H, T, T)
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ _heads(v)) / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full((), NEG_INF, device=q.device))
    return (o.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            lse[..., 0].contiguous())


def _delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in float32, ``(B, H, T)``."""
    return (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def _ds_plain(q, k, v, lse, delta, do, causal: bool, scale: float):
    """``(P, dS)``, (B, H, T, T) float32: the probabilities recomputed from
    ``lse`` and ``dS = P * (dO.V - delta)``."""
    keep = _keep(q.shape[1], causal, q.device)
    s = scale * (_heads(q) @ _heads(k).transpose(-1, -2))
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    return p, p * (_heads(do) @ _heads(v).transpose(-1, -2)
                   - delta[..., None])


def _out(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) float32 -> (B, T, H, D) contiguous in ``like``'s dtype."""
    return x.permute(0, 2, 1, 3).to(like.dtype).contiguous()


def flash_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   causal: bool = False, scale: Optional[float] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dQ, delta)`` as :func:`flash_dq` gives them, in torch ops."""
    _check(q, k, v, o, do)
    _check_rows(q, lse)
    scale = _scale(q, scale)
    delta = _delta_plain(o, do)
    _, ds = _ds_plain(q, k, v, lse, delta, do, causal, scale)
    return _out(scale * (ds @ _heads(k)), q), delta


def flash_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lse: torch.Tensor, delta: torch.Tensor, do: torch.Tensor,
                    *, causal: bool = False, scale: Optional[float] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` as :func:`flash_dkv` gives them, in torch ops."""
    _check(q, k, v, do)
    _check_rows(q, lse, delta)
    scale = _scale(q, scale)
    p, ds = _ds_plain(q, k, v, lse, delta, do, causal, scale)
    return (_out(scale * (ds.transpose(-1, -2) @ _heads(q)), k),
            _out(p.transpose(-1, -2) @ _heads(do), v))


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dQ, dK, dV)`` in q's, k's and v's dtype from the forward's O and
    lse and the upstream gradient dO: the backward's function in torch ops
    (the CPU path of :func:`flash_bwd`, and the yardstick both of its
    routes are held against on the card)."""
    dq, delta = flash_dq_plain(q, k, v, o, lse, do, causal=causal,
                               scale=scale)
    dk, dv = flash_dkv_plain(q, k, v, lse, delta, do, causal=causal,
                             scale=scale)
    return dq, dk, dv


# ---------------------------------------------------------------- kernels


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k and v as the kernels take them: one set of strides with a unit
    stride along D. The ViT's slices of its qkv product already are;
    anything else is copied to contiguous tensors."""
    if (q.stride() == k.stride() == v.stride()
            and (q.shape[-1] == 1 or q.stride(-1) == 1)):
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


def _shape_args(q: torch.Tensor) -> tuple:
    b, t, h, d = q.shape
    return (b, h, t, d, q.stride(0), q.stride(1), q.stride(2))


def _copy_width(*tensors: torch.Tensor) -> int:
    """The copy width in bytes that the tensor-core kernels' C entries
    pick for a call on these tensors (``copy_width`` in
    ``csrc/stage_common.cuh``): the widest of 16, 8, 4 and 2 that divides
    every pointer and the bytes of every stride and of D. 16 with D a
    multiple of 8 is their 16-byte path; anything else their narrow one."""
    bits = 0
    for t in tensors:
        size = t.element_size()
        bits |= t.data_ptr() | t.shape[-1] * size
        for st in t.stride()[:-1]:
            bits |= st * size
    width = 16
    while width > 1 and bits % width:
        width //= 2
    return width


def _tf32_tiles(dp: int) -> Tuple[int, int, int]:
    """The rows of a streamed tile of the 3xTF32 kernels at head-dim
    capacity ``dp`` (``fwd_tile``, ``dq_tile`` and ``dkv_tile`` in
    ``csrc/flash_tf32.cu``): the forward's and the dQ kernel's keys, the
    dK/dV kernel's queries. Each block owns 64 rows."""
    return (32 if dp == 128 else 64, 16 if dp == 128 else 64,
            64 if dp <= 16 else 16 if dp == 128 else 32)


def _tf32_plane_words(rows: int, dp: int, transposed: bool = False) \
        -> torch.Tensor:
    """Where the 3xTF32 kernels' split pass (``split_tile`` in
    ``csrc/flash_tf32.cu``) writes each element of a ``rows x dp`` raw
    tile: a ``(rows, dp)`` tensor of 32-bit word offsets into its plane.
    Chunk ``c`` of the pass is 4 columns of one row, ``(c & 7) + 8 ((c >>
    3) // (dp / 4))``, from column ``4 ((c >> 3) % (dp / 4))``, and lands at
    words ``4c`` of the plane. ``transposed``: the tile's transposed plane
    (``dp`` rows of ``rows`` columns), row ``r`` at column ``(r & ~7) +
    ((r & 7) >> 1) + 4 (r & 1)`` (each group of 8 rows reordered: row 2i at
    column i, row 2i + 1 at i + 4), in cores of 8 rows by 4 columns, 32
    words each, ``rows / 4`` cores a row of cores."""
    cpr = dp // 4
    words = torch.empty((rows, dp), dtype=torch.int64)
    for c in range(rows * cpr):
        r, x = (c & 7) + 8 * ((c >> 3) // cpr), (c >> 3) % cpr
        for i in range(4):
            if not transposed:
                words[r, 4 * x + i] = 4 * c + i
                continue
            d, p = 4 * x + i, (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1)
            words[r, d] = (((d >> 3) * (rows // 4) + (p >> 2)) * 32
                           + (d & 7) * 4 + (p & 3))
    return words


def _fwd_route(shape, dtype) -> str:
    """:func:`flash_fwd`'s route for a ``(B, T, H, D)`` problem of this
    dtype, at any D: ``"tensor"`` (bfloat16) or ``"tf32x3"`` (float32)."""
    return "tensor" if dtype == torch.bfloat16 else "tf32x3"


def _bwd_route(shape, dtype) -> str:
    """:func:`flash_bwd`'s route for a ``(B, T, H, D)`` problem of this
    dtype, at any D: ``"fused"`` (bfloat16, T <= 128), ``"tiled"``
    (bfloat16, T > 128) or ``"tf32x3"`` (float32, any T)."""
    if dtype == torch.bfloat16:
        return "fused" if shape[1] <= FUSED_MAX_T else "tiled"
    return "tf32x3"


def _bwd_routes(shape, dtype) -> tuple:
    """The routes a caller may name for this problem: the default first,
    ``"tiled"`` for any bf16 problem, and ``"split"`` for any."""
    return {"fused": ("fused", "tiled", "split"), "tiled": ("tiled", "split"),
            "tf32x3": ("tf32x3", "split")}[_bwd_route(shape, dtype)]


def _launch(symbol: str, q: torch.Tensor, pointers: list, scale: float,
            causal: bool, lib_name: str = "flash") -> None:
    lib = cuda_build.load(lib_name)
    err = getattr(lib, symbol)(
        *pointers, *_shape_args(q), scale, int(causal),
        int(q.dtype == torch.bfloat16), q.device.index, _stream(q))
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err} at "
                           f"{tuple(q.shape)} {q.dtype}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, scale: Optional[float] = None,
              route: Optional[str] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)`` as :func:`flash_fwd_plain` gives them. CPU tensors take
    :func:`flash_fwd_plain`. CUDA tensors launch the kernel of ``route``
    (default :func:`_fwd_route`'s; ``"cuda_core"`` may be named for any
    problem, ``"tensor"`` and ``"tf32x3"`` only where the route function
    gives them), counted in ``flash_fwd.launches`` and
    ``flash_fwd.route_launches[route]``. The kernels take q, k and v as
    strided views at any alignment (:func:`_copy_width`)."""
    _check(q, k, v)
    best = _fwd_route(q.shape, q.dtype)
    route = best if route is None else route
    if route not in (best, "cuda_core"):
        raise ValueError(f"flash_fwd has no route {route!r} for "
                         f"{tuple(q.shape)} {q.dtype}")
    if not _on_card(q, "flash_fwd"):
        return flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    q, k, v = _views(q, k, v)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    pointers = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr()]
    if route == "tensor":
        _launch("flash_fwd_mma_launch", q, pointers, _scale(q, scale),
                causal, "flash_fwd")
    elif route == "tf32x3":
        _launch("flash_fwd_tf32_launch", q, pointers, _scale(q, scale),
                causal, "flash_tf32")
    else:
        _launch("flash_fwd_launch", q, pointers, _scale(q, scale), causal)
    with _count_lock:
        flash_fwd.launches += 1
        flash_fwd.route_launches[route] += 1
    return o, lse


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
             causal: bool = False, scale: Optional[float] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dQ, delta)``: dQ ``(B, T, H, D)`` in q's dtype and ``delta =
    rowsum(dO * O)`` ``(B, H, T)`` float32, which :func:`flash_dkv` takes.
    CUDA tensors launch the dQ kernel (counted in ``flash_dq.launches``);
    CPU tensors take :func:`flash_dq_plain`."""
    _check(q, k, v, o, do)
    _check_rows(q, lse)
    if not _on_card(q, "flash_dq"):
        return flash_dq_plain(q, k, v, o, lse, do, causal=causal,
                              scale=scale)
    q, k, v = _views(q, k, v)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    b, t, h, d = q.shape
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    _launch("flash_dq_launch", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr()],
            _scale(q, scale), causal)
    with _count_lock:
        flash_dq.launches += 1
    return dq, delta


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor, do: torch.Tensor, *,
              causal: bool = False, scale: Optional[float] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` in k's and v's dtype from the forward's lse and
    :func:`flash_dq`'s delta. CUDA tensors launch the dK/dV kernel (counted
    in ``flash_dkv.launches``); CPU tensors take :func:`flash_dkv_plain`."""
    _check(q, k, v, do)
    _check_rows(q, lse, delta)
    if not _on_card(q, "flash_dkv"):
        return flash_dkv_plain(q, k, v, lse, delta, do, causal=causal,
                               scale=scale)
    q, k, v = _views(q, k, v)
    do, lse, delta = do.contiguous(), lse.contiguous(), delta.contiguous()
    b, t, h, d = q.shape
    dk = torch.empty((b, t, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, t, h, d), dtype=v.dtype, device=q.device)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_dkv_launch", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()],
            _scale(q, scale), causal)
    with _count_lock:
        flash_dkv.launches += 1
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = False, scale: Optional[float] = None,
              route: Optional[str] = None) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dQ, dK, dV)`` as :func:`flash_bwd_plain` gives them, from the
    forward's O and lse and the upstream gradient dO. CPU tensors take
    :func:`flash_bwd_plain`. CUDA tensors take ``route`` (default
    :func:`_bwd_route`'s; :func:`_bwd_routes` says which may be named),
    counted in ``flash_bwd.route_launches[route]``: ``"fused"`` launches
    the one-kernel backward (also counted in ``flash_bwd.launches``),
    ``"tiled"`` the tiled dQ and dK/dV kernels and ``"tf32x3"`` the float32
    ones, q, k and v as strided views at any alignment and O and dO made
    contiguous (the kernels index them densely); ``"split"`` calls
    :func:`flash_dq` and then :func:`flash_dkv` (counted in theirs)."""
    _check(q, k, v, o, do)
    _check_rows(q, lse)
    allowed = _bwd_routes(q.shape, q.dtype)
    route = allowed[0] if route is None else route
    if route not in allowed:
        raise ValueError(f"flash_bwd has no route {route!r} for "
                         f"{tuple(q.shape)} {q.dtype}")
    if not _on_card(q, "flash_bwd"):
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal,
                               scale=scale)
    if route == "split":
        dq, delta = flash_dq(q, k, v, o, lse, do, causal=causal, scale=scale)
        dk, dv = flash_dkv(q, k, v, lse, delta, do, causal=causal,
                           scale=scale)
        with _count_lock:
            flash_bwd.route_launches["split"] += 1
        return dq, dk, dv
    q, k, v = _views(q, k, v)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    b, t, h, d = q.shape
    dq, dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    if route == "fused":
        _launch("flash_bwd_launch", q,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr()], _scale(q, scale), causal, "flash_bwd")
    else:
        delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        symbol, lib = {"tiled": ("flash_bwd_tiled_launch", "flash_bwd_tiled"),
                       "tf32x3": ("flash_bwd_tf32_launch", "flash_tf32")}[
                           route]
        _launch(symbol, q,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr()],
                _scale(q, scale), causal, lib)
    with _count_lock:
        if route == "fused":
            flash_bwd.launches += 1
        flash_bwd.route_launches[route] += 1
    return dq, dk, dv


flash_fwd.launches = 0
flash_fwd.route_launches = {"tensor": 0, "tf32x3": 0, "cuda_core": 0}
flash_bwd.launches = 0
flash_bwd.route_launches = {"fused": 0, "tiled": 0, "tf32x3": 0, "split": 0}
flash_dq.launches = 0
flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """O from :func:`flash_fwd` (the bf16 or the 3xTF32 tensor-core
    forward); the backward is :func:`flash_bwd` (the fused kernel, the
    tiled pair or the 3xTF32 pair), each on its default route. Saves q, k,
    v, O and lse (the reference's custom_vjp residuals, here unpadded)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block: Optional[int] = None) -> torch.Tensor:
    """Flash attention on ``(B, T, H, D)``; drop-in for
    ``ops.attention.full_attention`` and differentiable through the
    backward kernels. Self-attention shapes only: Tq must equal Tk (the
    start-aligned causal mask and the dense oracle's end-aligned one agree
    exactly there).

    ``block`` is checked as the reference checks it (a multiple of 8, at
    most 512) and then ignored: the CUDA kernels tile by 64 rows (the
    fused backward by 16) whatever it says."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"flash_attention requires Tq == Tk (self-attention); got "
            f"Tq={q.shape[1]}, Tk={k.shape[1]} — use full_attention for "
            f"cross-attention shapes")
    if block is not None and (block < 8 or block % 8):
        raise ValueError(f"block must be a multiple of 8, got {block}")
    if block is not None and block > 512:
        raise ValueError(
            f"block must be <= 512 (block^2 f32 scratch exceeds VMEM "
            f"beyond that), got {block}")
    return _FlashAttention.apply(q, k, v, causal, _scale(q, scale))


def sharded_flash_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, mesh,
                            batch_axis: Optional[str] = None,
                            head_axis: Optional[str] = None,
                            causal: bool = False,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on this rank's ``(B/dp, T, H/tp, D)`` block of the
    global ``(B, T, H, D)`` arrays: the reference's nested ``shard_map``
    over the batch and head axes. Attention is independent per batch row
    and per head, so each rank runs :func:`flash_attention` (the CUDA
    kernels on a card tensor) on the block it holds, with no collective
    and no gather. This is how ``--attention flash`` composes with
    ``--tensor-parallel``: the Megatron rules give each rank whole heads
    (``parallel/tensor.py::vit_tp_rules``). ``batch_axis`` and
    ``head_axis`` name the mesh axes the block is split over."""
    for name in (batch_axis, head_axis):
        if name is not None:
            mesh.axis(name)  # a KeyError names an axis the mesh lacks
    return flash_attention(q, k, v, causal=causal, scale=scale)
