"""What the A/B tools (``ab_flash_tf32.py``, ``ab_xent.py``) share: builds
of one kernel's source declared as libraries of their own, and a timer
that runs every build in turns.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence


def register(sources: Dict[str, str], kernel: str) -> None:
    """Declares each {library name: source path} to ``cuda_build`` as a
    library with ``KERNELS[kernel]``'s C entries; a name that is already
    a kernel's (``kernel`` itself) is built from the path given."""
    from pytorch_distributed_mnist_tpu_torch.ops import cuda_build

    own = cuda_build.source_path
    paths = {name: os.path.abspath(path) for name, path in sources.items()}
    cuda_build.source_path = lambda name: paths.get(name) or own(name)
    for name in paths:
        cuda_build.KERNELS[name] = cuda_build.KERNELS[kernel]


def in_turns(names: Sequence[str], run: Callable[[str], object]) \
        -> Dict[str, List[object]]:
    """``{name: [run(name), run(name)]}``, each name run in the order
    given, then in reverse (A, B, B, A), so a drift of the card's clock
    over the run falls on both alike."""
    out: Dict[str, List[object]] = {name: [] for name in names}
    for name in list(names) + list(names)[::-1]:
        out[name].append(run(name))
    return out
