"""The guard of every run: the process that prints a result holds no
module of JAX or of the port's JAX original. Names are compared by their
top-level part (before the first dot), whole: the port's own name begins
with the JAX package's and passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_distributed_mnist_tpu")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The names whose top-level part is one of :data:`FORBIDDEN`."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    return forbidden_modules(list(sys.modules))
