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


def lecun_normal_init(model, seed: int, order=None) -> None:
    """Training init in flax's default scheme, in place: every kernel
    drawn from ``lecun_normal`` (a normal truncated to +-2 standard
    deviations, scaled to std ``sqrt(1/fan_in) / 0.8796...``), every bias
    zero. Draws come from a ``torch.Generator`` seeded with ``seed``, on
    the CPU, in ``order`` (param names; default the model's own), so a
    seed gives the same values on every device. They are not JAX's
    values: parity tests start both packages from one npz.

    The truncated normal is written out as an inverse CDF of uniform
    draws (``u`` in ``[Phi(-2), Phi(2))``, ``sqrt(2) * erfinv(2u - 1)``):
    ``torch.nn.init.trunc_normal_`` draws other values from the same
    generator in other torch releases (2.11 and 2.13 differ), the uniform
    stream does not."""
    import math

    import torch

    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    gen = torch.Generator().manual_seed(seed)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name in (order or list(params)):
            p = params[name]
            if name.endswith(".bias"):
                p.zero_()
                continue
            # Conv weights are OIHW (fan_in = I*H*W), Dense kernels (in, out).
            fan_in = (p.shape[1] * p.shape[2] * p.shape[3] if p.dim() == 4
                      else p.shape[0])
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            draw = torch.empty(p.shape, dtype=torch.float32)
            draw.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
            draw.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
            p.copy_(draw * std)


def model_accepts(name: str, field: str) -> bool:
    """True if the registered model's constructor takes ``field`` — the
    explicit capability probe the int8 serving plane uses before it
    injects its matmul, so a genuine TypeError from a constructor is
    never mistaken for a missing capability."""
    try:
        return field in inspect.signature(_lookup(name)).parameters
    except (TypeError, ValueError):
        return False
