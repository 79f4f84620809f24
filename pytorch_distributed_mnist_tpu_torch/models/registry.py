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


# Raw params of the MoE layer (``models/moe.py``): flax ``self.param``
# leaves named as they are, not a Dense's ``kernel``/``bias``.
_RAW_MOE = {"w1": "raw_kernel", "w2": "raw_kernel",
            "b1": "raw_bias", "b2": "raw_bias"}


def param_kind(name: str) -> str:
    """What a param is, by its port name, for init and conversion:
    ``"bias"``; ``"scale"`` (a LayerNorm's ``weight``: its layer's name
    starts with ``ln``); ``"pos_embed"``; ``"raw_kernel"`` and
    ``"raw_bias"`` (the MoE layer's ``w1``/``w2`` and ``b1``/``b2``,
    leaves that keep their own names); else ``"kernel"`` (a Dense
    kernel, or a conv weight)."""
    *layers, leaf = name.split(".")
    if layers and layers[-1] == "moe" and leaf in _RAW_MOE:
        return _RAW_MOE[leaf]
    if leaf == "bias":
        return "bias"
    if leaf == "pos_embed":
        return "pos_embed"
    if leaf == "weight" and layers and layers[-1].startswith("ln"):
        return "scale"
    return "kernel"


def _normal_draw(shape, gen, cut: float):
    """Standard normal draws cut at +-``cut``, written out as an inverse
    CDF of uniform draws (``u`` in ``[Phi(-cut), Phi(cut))``,
    ``sqrt(2) * erfinv(2u - 1)``): ``torch.nn.init.trunc_normal_`` and
    ``normal_`` draw other values from the same generator in other torch
    releases (2.11 and 2.13 differ), the uniform stream does not."""
    import math

    import torch

    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-cut, cut))
    draw = torch.empty(shape, dtype=torch.float32)
    draw.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    return draw.erfinv_().mul_(math.sqrt(2.0)).clamp_(-cut, cut)


def lecun_normal_init(model, seed: int, order=None) -> None:
    """Training init in flax's default scheme, in place: every kernel
    drawn from ``lecun_normal`` (a normal truncated to +-2 standard
    deviations, scaled to std ``sqrt(1/fan_in) / 0.8796...``), every bias
    zero (raw MoE biases too), every LayerNorm scale one, raw MoE kernels
    from ``lecun_normal`` with flax's fan-in of a stacked kernel (every
    dim but the last: ``(E, C, H)`` has fan-in ``E * C``), and
    ``pos_embed`` drawn from
    ``normal(stddev=0.02)`` (cut at 4 standard deviations, where flax's is
    not cut: 6 draws in 100,000 lie beyond). Draws come from a
    ``torch.Generator`` seeded with ``seed``, on the CPU, in ``order``
    (param names; default the model's own), so a seed gives the same
    values on every device. They are not JAX's values: parity tests start
    both packages from one npz."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name in (order or list(params)):
            p = params[name]
            kind = param_kind(name)
            if kind in ("bias", "raw_bias"):
                p.zero_()
            elif kind == "scale":
                p.fill_(1.0)
            elif kind == "pos_embed":
                p.copy_(_normal_draw(p.shape, gen, 4.0) * 0.02)
            else:
                # Conv weights are OIHW (fan_in = I*H*W), Dense kernels
                # (in, out).
                if kind == "raw_kernel":
                    fan_in = p[..., 0].numel()
                else:
                    fan_in = (p.shape[1] * p.shape[2] * p.shape[3]
                              if p.dim() == 4 else p.shape[0])
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                p.copy_(_normal_draw(p.shape, gen, 2.0) * std)


def model_field_default(name: str, field: str):
    """A registered model's constructor default for ``field`` (the one
    source for flag-level checks such as head counts). Raises
    ``ValueError`` for an unknown model or a field with no default, so a
    typo fails loudly instead of reading as "no default"."""
    try:
        param = inspect.signature(_lookup(name)).parameters[field]
    except (KeyError, TypeError):
        param = None
    if param is None or param.default is inspect.Parameter.empty:
        raise ValueError(f"model {name!r} has no field {field!r} with a "
                         f"default")
    return param.default


def model_accepts(name: str, field: str) -> bool:
    """True if the registered model's constructor takes ``field`` — the
    explicit capability probe the int8 serving plane uses before it
    injects its matmul, so a genuine TypeError from a constructor is
    never mistaken for a missing capability."""
    try:
        return field in inspect.signature(_lookup(name)).parameters
    except (TypeError, ValueError):
        return False
