"""The serving precision plane: how params quantize at install time, how the
forward transforms, and what dtype the staged activations ride.

Counterpart of the precision plane of ``pytorch_distributed_mnist_tpu/
serve/programs.py``. The serve-mode registry keeps ``replicated`` only:
the port serves one whole model on one card.

Precisions (``--serve-precision``): ``f32`` (identity), ``bf16`` (weights
stored bfloat16; compute follows the model's own dtype), ``int8w``
(weight-only int8: per-leaf symmetric scales, dequantized on the device,
f32 activations) and ``int8`` (``int8w`` plus int8 activations with the
fixed normalize-range scale :data:`ACT_SCALE`; the model built for this
plane also runs its Dense layers through the int8 matmul kernel).

The fused plane (the default) takes the raw staged uint8 bytes:
:func:`fused_normalize` and, on ``int8``, :func:`quant_i8_traced` run on
the device and are bitwise equal to their host twins
(``data/mnist.py::normalize_images`` and :func:`_quant_i8_host`, both
run by the native C++ library over the server's ``-j`` threads and equal
to their NumPy expressions bit for bit, ``data/native.py``). Every
divide that must match the host's IEEE divide divides by a tensor on the
same device: on the card, dividing by a Python number becomes a multiply
by its reciprocal, which can differ in the last bit.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.data.mnist import MNIST_MEAN, MNIST_STD

REPLICATED = "replicated"
F32 = "f32"


def serve_modes() -> List[str]:
    """The serve modes of the port: one whole model per card."""
    return [REPLICATED]


def check_checkpoint_layout(layout: Optional[dict], mode: str,
                            model_name: str) -> None:
    """Boot/reload gate: a checkpoint trained tensor-, expert- or
    pipeline-parallel is refused by name (the port has no sharded serving
    mode yet). ``None`` (no stamp) passes."""
    if not layout:
        return
    for key in ("tensor", "expert", "pipeline"):
        if int(layout.get(key, 1)) > 1 and mode != key:
            raise ValueError(
                f"checkpoint was trained with {key}-parallel {layout[key]}; "
                f"--model {model_name} serves only --serve-mode "
                f"{serve_modes()} here")


class QuantLeaf(NamedTuple):
    """One int8-quantized param leaf: the int8 values (original shape) and
    the float32 symmetric scale, installed together so a hot reload stays
    one reference swap."""

    q: object  # int8 values, the original leaf's shape
    s: object  # float32 scale (dequant: q.float() * s)


def _act_scale() -> np.float32:
    """The FIXED int8 activation scale: normalized MNIST pixels live in
    ``[(0-mean)/std, (1-mean)/std]`` (max |x| at pixel 255), so one
    symmetric scale covers every request. float32 ops, as the reference
    computes it."""
    max_abs = ((np.float32(1.0) - np.float32(MNIST_MEAN))
               / np.float32(MNIST_STD))
    return np.float32(max_abs / np.float32(127.0))


ACT_SCALE = _act_scale()
_INV_ACT_SCALE = float(np.float32(1.0) / ACT_SCALE)


def _quant_i8_host(x: np.ndarray, scale: np.float32,
                   workers: int = 4) -> np.ndarray:
    """The host-side float32 -> int8 quantizer (weight leaves and the split
    plane's activation staging): multiply by the float32 reciprocal (never
    a division: the two round differently), round half to even, NaN -> 0,
    clip to +-127. The native kernel over ``workers`` threads, else (under
    ``TPUMNIST_NATIVE=0``) the same NumPy expression."""
    from pytorch_distributed_mnist_tpu_torch.data import native

    x = np.ascontiguousarray(x, np.float32)
    q = native.quant_i8(x, float(scale), workers=workers)
    if q is not None:
        return q
    inv = np.float32(1.0) / scale
    scaled = np.rint(x * inv)
    scaled = np.where(np.isnan(scaled), np.float32(0.0), scaled)
    return np.clip(scaled, -127, 127).astype(np.int8)


def quantize_leaf_i8(leaf) -> QuantLeaf:
    """Symmetric per-leaf int8 quantization (host-side, install time):
    ``scale = max|leaf| / 127``, ``q = clip(rne(leaf * (1/scale)), +-127)``.
    An all-zero leaf gets scale 1.0."""
    x = np.ascontiguousarray(np.asarray(leaf), np.float32)
    max_abs = float(np.max(np.abs(x))) if x.size else 0.0
    scale = np.float32(max_abs) / np.float32(127.0) \
        if max_abs > 0.0 else np.float32(1.0)
    return QuantLeaf(q=_quant_i8_host(x, scale), s=scale)


def dequantize_params(tree: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Every :class:`QuantLeaf` becomes its float32 leaf (``q.float() *
    s``); everything else passes through. Runs on the device, per forward:
    the weights rest in int8."""
    return {name: leaf.q.float() * leaf.s if isinstance(leaf, QuantLeaf)
            else leaf for name, leaf in tree.items()}


@functools.lru_cache(maxsize=None)
def _normalize_consts(device: torch.device):
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (255.0, MNIST_MEAN, MNIST_STD))


def fused_normalize(raw: torch.Tensor) -> torch.Tensor:
    """On-device MNIST normalize, bitwise equal to ``normalize_images``:
    raw uint8 ``(N, 28, 28)`` -> float32 ``(N, 28, 28, 1)``. The constants
    are 0-d tensors on ``raw``'s device so each divide is an IEEE divide
    (the reference hides them behind an optimization barrier for the same
    reason)."""
    c255, mean, std = _normalize_consts(raw.device)
    y = raw.to(torch.float32) / c255
    y = (y - mean) / std
    return y[..., None]


def quant_i8_traced(x: torch.Tensor) -> torch.Tensor:
    """On-device int8 activation quantization, bitwise equal to
    :func:`_quant_i8_host` on finite input: multiply by the same float32
    reciprocal of :data:`ACT_SCALE`, round half to even, clip to +-127."""
    return torch.round(x * _INV_ACT_SCALE).clamp(-127.0, 127.0).to(torch.int8)


def _floating_leaf(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


class ServePrecision:
    """One registered serving precision. The hooks the engine calls:

    - ``quantize(params)`` — host-side, once per param install (boot, hot
      reload), outside the engine lock. Idempotent: ``QuantLeaf`` leaves
      pass through.
    - ``wrap_forward(forward)`` — the split plane's transform (int8
      activations dequantized, weights dequantized, logits cast to f32).
    - ``wrap_fused_forward(forward)`` — raw uint8 -> logits: normalize
      (and quantize activations on ``int8``) on the device, then the SAME
      ``wrap_forward`` transform.
    - ``stage_host(images, workers)`` — the split plane's host-side activation
      transform before staging (``int8``: quantize with :data:`ACT_SCALE`).

    ``f32`` is the identity on every hook."""

    def __init__(self, name: str, *, weight_cast=None, int8_weights=False,
                 int8_activations=False, act_cast=None) -> None:
        self.name = name
        self.weight_cast = weight_cast  # host-side dtype cast (bf16)
        self.int8_weights = int8_weights
        self.int8_activations = int8_activations
        self.act_cast = act_cast  # on-device activation dtype
        self.input_dtype = torch.int8 if int8_activations else torch.float32

    @property
    def identity(self) -> bool:
        return not (self.weight_cast is not None or self.int8_weights
                    or self.int8_activations or self.act_cast is not None)

    def _quantize_leaf(self, leaf):
        """One leaf's install form; a leaf already in it passes through."""
        if isinstance(leaf, QuantLeaf) or not _floating_leaf(leaf):
            return leaf
        if self.int8_weights:
            return quantize_leaf_i8(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == self.weight_cast:
            return leaf
        return torch.as_tensor(np.asarray(leaf)).to(self.weight_cast)

    def quantize(self, params: Dict[str, object],
                 workers: int = 1) -> Dict[str, object]:
        """Every leaf in its install form, over ``workers`` threads."""
        if not (self.int8_weights or self.weight_cast is not None):
            return params
        names = list(params)
        if workers > 1 and len(names) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(workers, len(names))) as pool:
                leaves = list(pool.map(self._quantize_leaf,
                                       (params[n] for n in names)))
        else:
            leaves = [self._quantize_leaf(params[n]) for n in names]
        return dict(zip(names, leaves))

    def wrap_forward(self, forward):
        if self.identity:
            return forward
        spec = self

        def precision_forward(params, images):
            x = images
            if spec.int8_activations:
                x = x.float() * float(ACT_SCALE)
            if spec.act_cast is not None:
                x = x.to(spec.act_cast)
            p = dequantize_params(params) if spec.int8_weights else params
            return forward(p, x).float()

        return precision_forward

    def wrap_fused_forward(self, forward):
        spec = self
        split = self.wrap_forward(forward)

        def fused_forward(params, raw):
            x = fused_normalize(raw)
            if spec.int8_activations:
                x = quant_i8_traced(x)
            return split(params, x)

        return fused_forward

    def stage_host(self, images: np.ndarray,
                   workers: int = 4) -> np.ndarray:
        if not self.int8_activations:
            return images
        return _quant_i8_host(images, ACT_SCALE, workers)


_PRECISIONS: Dict[str, ServePrecision] = {}


def register_precision(spec: ServePrecision) -> ServePrecision:
    if spec.name in _PRECISIONS:
        raise ValueError(f"serve precision {spec.name!r} already registered")
    _PRECISIONS[spec.name] = spec
    return spec


register_precision(ServePrecision(F32))
register_precision(ServePrecision("bf16", weight_cast=torch.bfloat16))
register_precision(ServePrecision("int8w", int8_weights=True))
register_precision(ServePrecision("int8", int8_weights=True,
                                  int8_activations=True))


def serve_precisions() -> List[str]:
    """Every registered precision, ``f32`` first (the default)."""
    return [F32] + sorted(n for n in _PRECISIONS if n != F32)


def get_precision(name: Optional[str]) -> ServePrecision:
    try:
        return _PRECISIONS[name or F32]
    except KeyError:
        raise ValueError(
            f"unknown serve precision {name!r}; registered: "
            f"{serve_precisions()}"
        ) from None


def precision_engine_name(name: Optional[str],
                          precision: Optional[str]) -> Optional[str]:
    """An engine name with its precision suffix (``{name}.{prec}``); f32
    keeps the bare name."""
    if not precision or precision == F32:
        return name
    return f"{name}.{precision}" if name else precision
