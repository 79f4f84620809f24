"""Expert parallelism: the rule table of the MoE expert weights.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/expert.py``. The
expert weights carry a leading ``num_experts`` dim, the rules split it
over the ``expert`` mesh axis (``parallel/tensor.py::shard_state``), and
each rank computes only its local experts (``models/moe.py``); the sum of
the combine over experts becomes an all-reduce over the expert subgroup.
"""

from __future__ import annotations

from typing import Dict, Tuple

from pytorch_distributed_mnist_tpu_torch.parallel.tensor import P


def moe_ep_rules(axis: str = "expert") -> Dict[Tuple[str, str], P]:
    """Path-suffix rules (``parallel/tensor.py::leaf_spec``) for
    ``SwitchMoE``. The router, ``embed`` and ``head`` stay replicated:
    every rank must route identically for the one-hot combine to agree."""
    return {
        ("moe", "w1"): P(axis, None, None),
        ("moe", "b1"): P(axis, None),
        ("moe", "w2"): P(axis, None, None),
        ("moe", "b2"): P(axis, None),
    }
