"""Model zoo of the port: ``linear`` and ``cnn``, registered by name."""

from pytorch_distributed_mnist_tpu_torch.models import cnn, linear  # registers
from pytorch_distributed_mnist_tpu_torch.models.registry import (
    get_model,
    list_models,
    model_accepts,
    register_model,
)

__all__ = ["cnn", "get_model", "linear", "list_models", "model_accepts",
           "register_model"]
