"""Carry params between the JAX package's layout and the port's.

A JAX checkpoint names each param leaf by its path in the train state,
e.g. ``['params']['params']['conv1']['kernel']``. The port's models name
them as PyTorch does (``conv1.weight``, ``fc1.kernel``). Convolution
kernels go from HWIO to OIHW; Dense kernels keep ``(in, out)``, the
``(K, N)`` operand the int8 matmul takes; biases are unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from pytorch_distributed_mnist_tpu_torch.models.registry import get_model

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def param_shapes(model_name: str) -> Dict[str, tuple]:
    """The port's param names and shapes for ``model_name``."""
    return {name: tuple(p.shape)
            for name, p in get_model(model_name).named_parameters()}


def jax_leaf_name(port_name: str) -> str:
    """``conv1.weight`` -> ``['params']['params']['conv1']['kernel']``."""
    layer, leaf = port_name.rsplit(".", 1)
    leaf = "bias" if leaf == "bias" else "kernel"
    return f"['params']['params']['{layer}']['{leaf}']"


def params_from_jax(model_name: str, flat: Dict[str, np.ndarray]) \
        -> Dict[str, np.ndarray]:
    """JAX-named leaves (extra leaves such as ``opt_state`` are ignored)
    -> the port's float32 params, validated name by name and shape by
    shape. Raises ``ValueError`` when a leaf is missing or misshapen: a
    checkpoint of another model is refused, never half-loaded."""
    out = {}
    for name, shape in param_shapes(model_name).items():
        key = jax_leaf_name(name)
        if key not in flat:
            raise ValueError(f"model {model_name!r}: checkpoint has no leaf "
                             f"{key}")
        arr = np.asarray(flat[key], dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(_HWIO_TO_OIHW)
        if arr.shape != shape:
            raise ValueError(f"model {model_name!r}: leaf {key} has shape "
                             f"{arr.shape} in the port's layout, expected "
                             f"{shape}")
        out[name] = np.array(arr, dtype=np.float32, order="C")
    return out


def params_to_jax(params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: port params -> JAX-named
    leaves in the JAX layouts (what the checkpoint writer stores)."""
    out = {}
    for name, value in params.items():
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(_OIHW_TO_HWIO)
        out[jax_leaf_name(name)] = np.ascontiguousarray(arr)
    return out


def init_params(model_name: str, seed: int) -> Dict[str, np.ndarray]:
    """Seeded random params in the port's layout, made with numpy: each
    kernel drawn normal with variance 1/fan_in, each bias normal with
    scale 0.01 (so the bias path is exercised too)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(model_name).items():
        if name.endswith(".bias"):
            arr = rng.normal(0.0, 0.01, size=shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), size=shape)
        out[name] = arr.astype(np.float32)
    return out
