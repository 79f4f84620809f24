"""Rank-aware logging.

Counterpart of ``pytorch_distributed_mnist_tpu/utils/logging.py``'s
``log0``. The reference prints its epoch metrics from every rank; here
only process 0 prints (the rank from ``parallel/distributed.py``), unless
``all_ranks`` asks for every one.
"""

from __future__ import annotations

import sys

from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    process_index,
)


def log0(*args, all_ranks: bool = False, **kwargs) -> None:
    """``print`` from process 0 only (or from every rank), flushed."""
    if all_ranks or process_index() == 0:
        print(*args, **kwargs)
        sys.stdout.flush()
