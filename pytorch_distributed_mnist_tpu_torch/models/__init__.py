"""Model zoo of the port: ``linear``, ``cnn``, ``vit`` and ``moe_mlp``,
registered by name."""

from pytorch_distributed_mnist_tpu_torch.models import (  # registers
    attention,
    cnn,
    linear,
    moe,
)
from pytorch_distributed_mnist_tpu_torch.models.registry import (
    get_model,
    list_models,
    model_accepts,
    model_field_default,
    register_model,
)

__all__ = ["attention", "cnn", "get_model", "linear", "list_models",
           "model_accepts", "model_field_default", "moe", "register_model"]
