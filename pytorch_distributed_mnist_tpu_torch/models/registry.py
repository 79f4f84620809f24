"""Model registry: name -> constructor.

Counterpart of ``pytorch_distributed_mnist_tpu/models/registry.py``: the
CLI (``--model``) and the tests select an architecture by name.
"""

import inspect
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str) -> Callable:
    """Class decorator registering a model constructor under ``name``."""

    def wrap(cls):
        if name in _REGISTRY:
            raise ValueError(f"model {name!r} already registered")
        _REGISTRY[name] = cls
        return cls

    return wrap


def _lookup(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def get_model(name: str, **kwargs):
    """Instantiate a registered model by name."""
    return _lookup(name)(**kwargs)


def list_models():
    return sorted(_REGISTRY)


def model_accepts(name: str, field: str) -> bool:
    """True if the registered model's constructor takes ``field`` — the
    explicit capability probe the int8 serving plane uses before it
    injects its matmul, so a genuine TypeError from a constructor is
    never mistaken for a missing capability."""
    try:
        return field in inspect.signature(_lookup(name)).parameters
    except (TypeError, ValueError):
        return False
