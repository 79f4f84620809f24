"""The kernels' and the collectives' launch counts across captured CUDA
graphs.

Each kernel wrapper counts its launches in plain integers on itself
(``xent_fwd.launches``, ``flash_fwd.route_launches[route]``, ...), added
where it launches its kernel; each collective wrapper of
``parallel/collectives.py`` counts its calls alike. A captured graph runs
the wrappers once, while it is captured, and launches nothing then; each
replay launches the kernels and the collectives again without running a
wrapper. :class:`CapturedLaunches` keeps every count exact: it takes back
what a capture added and adds it once per replay
(:meth:`CapturedLaunches.credit`).
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, Tuple

# The wrappers that count launches: (module in the package, name). Each
# is looked up when counted, so a wrapper swapped in for a test counts
# too.
WRAPPERS = (("ops.xent", "xent_fwd"), ("ops.xent", "xent_bwd"),
            ("ops.adam", "adam_leaves"), ("ops.flash", "flash_fwd"),
            ("ops.flash", "flash_bwd"), ("ops.flash", "flash_dq"),
            ("ops.flash", "flash_dkv"), ("ops.matmul_i8", "matmul_i8"),
            ("parallel.collectives", "count_all_reduce"),
            ("parallel.collectives", "grad_all_reduce"),
            ("parallel.collectives", "metric_all_reduce"),
            ("parallel.collectives", "shard_collective"),
            ("parallel.collectives", "dcn_all_reduce"))

Key = Tuple[str, str, str]  # (module, wrapper, "launches" or a route)


def _module(name: str):
    return importlib.import_module(
        f"pytorch_distributed_mnist_tpu_torch.{name}")


def read_counts() -> Dict[Key, int]:
    """Every counter's value now."""
    counts = {}
    for mod, name in WRAPPERS:
        wrapper = getattr(_module(mod), name)
        counts[(mod, name, "launches")] = wrapper.launches
        for route, n in getattr(wrapper, "route_launches", {}).items():
            counts[(mod, name, route)] = n
    return counts


def add_counts(delta: Dict[Key, int], times: int) -> None:
    """Add ``delta`` ``times`` times to the counters, under each wrapper
    module's lock."""
    for (mod, name, key), n in delta.items():
        module = _module(mod)
        wrapper = getattr(module, name)
        with module._count_lock:
            if key == "launches":
                wrapper.launches += n * times
            else:
                wrapper.route_launches[key] += n * times


class CapturedLaunches:
    """The launches of one captured graph: what its capture counted
    (``per_replay``), taken back when the capture ends and added back
    once per replay."""

    def __init__(self) -> None:
        self.per_replay: Dict[Key, int] = {}

    @contextlib.contextmanager
    def capturing(self):
        """Wrap the capture: the counters leave it as they entered it."""
        before = read_counts()
        try:
            yield
        finally:
            after = read_counts()
            self.per_replay = {k: after[k] - before[k] for k in after
                               if after[k] != before[k]}
            add_counts(self.per_replay, -1)

    def credit(self, replays: int) -> None:
        """Count ``replays`` replays of the captured graph."""
        add_counts(self.per_replay, replays)
