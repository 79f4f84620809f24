"""Logging helpers.

Counterpart of ``pytorch_distributed_mnist_tpu/utils/logging.py``'s
``log0``. The port runs one process, which is process 0.
"""

from __future__ import annotations

import sys


def log0(*args, **kwargs) -> None:
    """``print`` from process 0, flushed."""
    print(*args, **kwargs)
    sys.stdout.flush()
