"""Carry params and train states between the JAX package's layout and the
port's.

A JAX checkpoint names each leaf by its path in the train state, e.g.
``['params']['params']['conv1']['kernel']``. The port's models name
params as PyTorch does (``conv1.weight``, ``fc1.kernel``). Convolution
kernels, and their Adam moments, go from HWIO to OIHW; Dense kernels keep
``(in, out)``, the ``(K, N)`` operand the int8 matmul takes; biases are
unchanged.

A full train state is carried leaf by leaf in the order JAX flattens it
(:func:`state_leaves`), because the JAX loader restores by position: the
sorted keys ``opt_state``, ``params``, ``step``; inside ``opt_state`` the
injection wrapper's ``count``, its ``hyperparams`` (sorted) and its inner
state; every per-param tree in :func:`jax_param_order`.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.models.registry import (
    get_model,
    param_kind,
)

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def param_shapes(model_name: str, **model_kwargs) -> Dict[str, tuple]:
    """The port's param names and shapes for ``model_name`` built with
    ``model_kwargs`` (the ViT's shapes follow its ``patch_size``)."""
    return {name: tuple(p.shape) for name, p in
            get_model(model_name, **model_kwargs).named_parameters()}


def jax_param_path(port_name: str, root: str = "['params']") -> str:
    """A port param name -> its path inside the flax variables (and inside
    each moment tree): every module level is one key, and the leaf is
    named as flax names it (:func:`registry.param_kind`).
    ``conv1.weight`` -> ``['params']['conv1']['kernel']``;
    ``block0.attn.qkv.kernel`` -> ``['params']['block0']['attn']['qkv']
    ['kernel']``; ``block0.ln1.weight`` -> ``...['ln1']['scale']``;
    ``pos_embed`` -> ``['params']['pos_embed']``; the MoE's raw
    ``moe.w1`` -> ``['params']['moe']['w1']``. ``root`` is the flax
    variables' ``params`` level: a tree that is not a flax variables dict
    (the split tree of ``parallel/pipeline_tp.py``, which the JAX state
    holds as its params directly) has none, ``root=""``."""
    *layers, leaf = port_name.split(".")
    kind = param_kind(port_name)
    named = kind in ("pos_embed", "raw_kernel", "raw_bias")
    keys = layers + ([leaf] if named else [kind])
    return root + "".join(f"['{k}']" for k in keys)


def jax_leaf_name(port_name: str, root: str = "['params']") -> str:
    """``conv1.weight`` -> ``['params']['params']['conv1']['kernel']``."""
    return "['params']" + jax_param_path(port_name, root)


def key_path(jax_name: str) -> Tuple[str, ...]:
    """The dict keys of a JAX leaf name, outermost first."""
    return tuple(re.findall(r"\['([^']*)'\]", jax_name))


def jax_param_order(port_names: Iterable[str]) -> List[str]:
    """Port param names in the order JAX flattens the params tree: nested
    dicts flatten by sorted keys at each level (layer, then ``bias`` before
    ``kernel``), which is the lexicographic order of the key paths."""
    return sorted(port_names, key=lambda n: key_path(jax_leaf_name(n)))


def _to_jax_layout(arr: np.ndarray) -> np.ndarray:
    """A C-ordered copy, HWIO for a 4-D leaf (0-d leaves stay 0-d)."""
    return np.array(arr.transpose(_OIHW_TO_HWIO) if arr.ndim == 4 else arr,
                    order="C")


def _to_port_layout(arr: np.ndarray) -> np.ndarray:
    """A C-ordered copy, OIHW for a 4-D leaf (0-d leaves stay 0-d)."""
    return np.array(arr.transpose(_HWIO_TO_OIHW) if arr.ndim == 4 else arr,
                    order="C")


def params_from_jax(model_name: str, flat: Dict[str, np.ndarray],
                    **model_kwargs) -> Dict[str, np.ndarray]:
    """JAX-named leaves (extra leaves such as ``opt_state`` are ignored)
    -> the port's float32 params, validated name by name and shape by
    shape (of the model built with ``model_kwargs``). Raises
    ``ValueError`` when a leaf is missing or misshapen: a checkpoint of
    another model is refused, never half-loaded."""
    return params_from_flat(flat, param_shapes(model_name, **model_kwargs),
                            model_name)


def params_from_flat(flat: Dict[str, np.ndarray], shapes: Dict[str, tuple],
                     model_name: str,
                     root: str = "['params']") -> Dict[str, np.ndarray]:
    """:func:`params_from_jax` over given port names and shapes: each
    leaf read from ``flat`` at its JAX name under ``root`` (``""`` for a
    tree the JAX state holds as its params directly, the pipeline's split
    tree), validated by shape."""
    out = {}
    for name, shape in shapes.items():
        key = jax_leaf_name(name, root)
        if key not in flat:
            raise ValueError(f"model {model_name!r}: checkpoint has no leaf "
                             f"{key}")
        arr = _to_port_layout(np.asarray(flat[key], dtype=np.float32))
        if arr.shape != tuple(shape):
            raise ValueError(f"model {model_name!r}: leaf {key} has shape "
                             f"{arr.shape} in the port's layout, expected "
                             f"{tuple(shape)}")
        out[name] = arr
    return out


def params_to_jax(params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: port params -> JAX-named
    leaves in the JAX layouts (what the checkpoint writer stores)."""
    return {jax_leaf_name(name): _to_jax_layout(
                np.asarray(value, dtype=np.float32))
            for name, value in params.items()}


def init_params(model_name: str, seed: int) -> Dict[str, np.ndarray]:
    """Seeded random params in the port's layout, made with numpy: each
    kernel drawn normal with variance 1/fan_in, each bias normal with
    scale 0.01 (so the bias path is exercised too), each LayerNorm scale
    1 plus normal noise of scale 0.01, ``pos_embed`` normal with scale
    0.02."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(model_name).items():
        kind = param_kind(name)
        if kind in ("bias", "raw_bias"):
            arr = rng.normal(0.0, 0.01, size=shape)
        elif kind == "scale":
            arr = 1.0 + rng.normal(0.0, 0.01, size=shape)
        elif kind == "pos_embed":
            arr = rng.normal(0.0, 0.02, size=shape)
        else:
            if kind == "raw_kernel":
                fan_in = int(np.prod(shape[:-1]))
            else:
                fan_in = (int(np.prod(shape[1:])) if len(shape) == 4
                          else shape[0])
            arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), size=shape)
        out[name] = arr.astype(np.float32)
    return out


def state_leaves(state) -> List[Tuple[str, torch.Tensor]]:
    """``(JAX leaf name, tensor)`` of every leaf of a port train state
    (``train/state.py::TrainState``), in the JAX package's flatten order.
    The tensors are the live ones (device, port layout)."""
    params = state.param_leaves()
    names = jax_param_order(params)
    root = getattr(state.model, "param_root", "['params']")
    opt = state.optimizer
    if getattr(state, "zero", None) is None and \
            [id(p) for p in opt.params] != [id(params[n]) for n in names]:
        raise ValueError("the optimizer's params are not the model's in "
                         "the JAX flatten order")
    out = [("['opt_state'].count", opt.count)]
    out += [(f"['opt_state'].hyperparams['{k}']", opt.hyperparams[k])
            for k in sorted(opt.hyperparams)]
    for prefix, value in opt.inner_leaves():
        if isinstance(value, list):
            out += [(prefix + jax_param_path(n, root), t)
                    for n, t in zip(names, value)]
        else:
            out.append((prefix, value))
    out += [(jax_leaf_name(n, root), params[n]) for n in names]
    out.append(("['step']", state.step))
    return out


def state_to_jax(state) -> List[Tuple[str, np.ndarray]]:
    """The train state as ``(JAX name, host array in the JAX layout)`` in
    flatten order: what the checkpoint writer stores, every leaf whole.
    One device-to-host copy per leaf. A state with placed leaves
    (``state.placements``) gathers each over its mesh axis first: a
    collective, so every rank of the world calls this."""
    placements = getattr(state, "placements", None) or {}
    out = []
    for name, t in state_leaves(state):
        if name in placements:
            t = placements[name].gather(t)
        out.append((name, _to_jax_layout(t.detach().cpu().numpy())))
    return out


def load_state_from_jax(state, names: Sequence[str],
                        arrays: Sequence[np.ndarray], path: str = "") -> None:
    """Restore a train state in place from a checkpoint's leaves, by
    position as the JAX loader does, checking the count, each name and
    each shape; dtypes follow the live state (int32 counts, float32
    rest). Raises ``ValueError`` on any mismatch, before anything is
    written."""
    leaves = state_leaves(state)
    placements = getattr(state, "placements", None) or {}
    if len(leaves) != len(arrays):
        raise ValueError(f"{path}: checkpoint has {len(arrays)} leaves, "
                         f"current state has {len(leaves)} — "
                         f"model/optimizer mismatch")
    staged = []
    for (name, t), saved, arr in zip(leaves, names, arrays):
        if name != saved:
            raise ValueError(f"{path}: leaf {saved} where the state has "
                             f"{name} — model/optimizer mismatch")
        arr = _to_port_layout(np.asarray(arr))
        if name in placements:
            if arr.shape != placements[name].shape:
                raise ValueError(f"{path}: leaf {name} shape {arr.shape} != "
                                 f"expected {placements[name].shape}")
            arr = placements[name].local(arr)  # this rank's slice
        if arr.shape != tuple(t.shape):
            raise ValueError(f"{path}: leaf {name} shape {arr.shape} != "
                             f"expected {tuple(t.shape)}")
        staged.append((t, torch.from_numpy(arr)))
    with torch.no_grad():
        for t, value in staged:
            t.copy_(value.to(t.dtype))
    if getattr(state, "zero", None) is not None:
        state.zero.stale = True  # the ZeRO-3 workspace is re-gathered
