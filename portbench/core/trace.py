"""The device trace of a ``--trace 1`` run: taken with ``torch.profiler``
over whole epochs, read into plain records, checked for completeness, and
what the per-layer readers take from it.

Frozen copies, so a later change to the program cannot move the
yardstick: the port's kernels by the names the profiler gives them
(:data:`OWN_KERNELS`), which of the port's launch counters each answers
to (:data:`COUNTED`), and the rules that give a kernel its part of a
step (:func:`step_part`, from ``utils/profiling.py``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# The port's kernels by name, and the part of a train step each is.
OWN_KERNELS = (("xent_fwd_kernel", "xent_fwd"),
               ("xent_bwd_kernel", "xent_bwd"),
               ("adam_leaves_kernel", "adam"),
               ("flash_fwd_mma_kernel", "flash_fwd"),
               ("flash_fwd_kernel", "flash_fwd"),
               ("flash_bwd_kernel", "flash_bwd"),
               ("flash_dq_tiled_kernel", "flash_bwd"),
               ("flash_dkv_tiled_kernel", "flash_bwd"),
               ("flash_fwd_tf32_kernel", "flash_fwd"),
               ("flash_dq_tf32_kernel", "flash_bwd"),
               ("flash_dkv_tf32_kernel", "flash_bwd"),
               ("flash_dq_kernel", "flash_bwd"),
               ("flash_dkv_kernel", "flash_bwd"))

# The port's launch counters (ops/launches.py's keys: module, wrapper,
# "launches" or a route) and the kernels each launch runs once.
COUNTED = {("ops.xent", "xent_fwd", "launches"): ("xent_fwd_kernel",),
           ("ops.xent", "xent_bwd", "launches"): ("xent_bwd_kernel",),
           ("ops.adam", "adam_leaves", "launches"): ("adam_leaves_kernel",),
           ("ops.flash", "flash_fwd", "tensor"): ("flash_fwd_mma_kernel",),
           ("ops.flash", "flash_bwd", "fused"): ("flash_bwd_kernel",),
           ("ops.flash", "flash_bwd", "tiled"): ("flash_dq_tiled_kernel",
                                                 "flash_dkv_tiled_kernel")}

COLLECTIVE_KERNELS = ("nccl",)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
LEAD_SPINS = 32  # spin kernels that open a trace (see lead_in)


def own_kernel(name: str) -> Optional[str]:
    """The first of :data:`OWN_KERNELS` whose name ``name`` holds."""
    for own, _ in OWN_KERNELS:
        if own in name:
            return own
    return None


def step_part(kernel: str) -> str:
    """A device kernel's part of a train step by its name: ``collective``
    (NCCL), the port's own kernels' parts, else ``copy``, ``conv``,
    ``fc_gemm`` or ``other_elementwise``."""
    name = kernel.lower()
    if any(s in name for s in COLLECTIVE_KERNELS):
        return "collective"
    for own, part in OWN_KERNELS:
        if own in name:
            return part
    if "memcpy" in name or "memset" in name:
        return "copy"
    if any(s in name for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                               "implicit", "winograd")):
        return "conv"
    if any(s in name for s in ("gemm", "gemv", "nvjet", "cutlass", "cublas")):
        return "fc_gemm"
    return "other_elementwise"


@dataclass
class Trace:
    """One traced span: device work, the harness's spans and the host's
    ops, as ``(name, start_ns, end_ns)`` on the profiler's one clock."""

    device: List[Tuple[str, int, int, str]] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    def span_times(self, name: str) -> List[Tuple[int, int]]:
        return [(s, e) for n, s, e in self.spans if n == SPAN_PREFIX + name]

    @property
    def bounds(self) -> Tuple[int, int]:
        """From the first train pass's start to the last eval pass's end."""
        starts = [s for s, _ in self.span_times("train_pass")]
        ends = [e for _, e in self.span_times("eval_pass")]
        return min(starts), max(ends)

    def within(self, windows) -> List[Tuple[str, int, int, str]]:
        """Device records that start inside one of ``windows``."""
        return [r for r in self.device
                if any(lo <= r[1] < hi for lo, hi in windows)]

    def own_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for name, _s, _e, kind in self.within([self.bounds]):
            own = own_kernel(name) if kind == "kernel" else None
            if own is not None:
                counts[own] = counts.get(own, 0) + 1
        return counts


def lead_in(torch) -> None:
    """Open a trace with spin kernels: late in a process the profiler has
    been seen to drop the first device records of a trace; the spins take
    that loss. They start before the first span and are never read."""
    for _ in range(LEAD_SPINS):
        torch.cuda._sleep(100)


@contextlib.contextmanager
def tracing(torch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        yield prof


def _device_kind(ev) -> Optional[str]:
    """``kernel``, ``gpu_memcpy`` or ``gpu_memset`` for a device record
    of work, None for an annotation mirrored onto the device's timeline
    (a ``record_function`` span, ``Optimizer.step``)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = kind()
        return kind if kind in DEVICE_WORK else None
    user = getattr(ev, "is_user_annotation", None)
    name = ev.name()
    if (user is not None and user()) or name.startswith(SPAN_PREFIX) \
            or name.startswith("Optimizer."):
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def read(prof, torch) -> Trace:
    """The profiler's records as a :class:`Trace`."""
    trace = Trace()
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        rec = (ev.name(), ev.start_ns(), ev.end_ns())
        if ev.device_type() == cuda:
            kind = _device_kind(ev)
            if kind is not None:
                trace.device.append(rec + (kind,))
        elif rec[0].startswith(SPAN_PREFIX):
            trace.spans.append(rec)
        else:
            trace.host.append(rec)
    trace.device.sort(key=lambda r: r[1])
    return trace


def expected_counts(delta: Dict[tuple, int]) -> Dict[str, int]:
    """The kernels a span should hold, from the port's counters' change
    over it."""
    want: Dict[str, int] = {}
    for key, kernels in COUNTED.items():
        for kernel in kernels:
            if delta.get(key):
                want[kernel] = want.get(kernel, 0) + delta[key]
    return want


def copies_per_pass(trace: Trace) -> List[int]:
    """The host-to-device copies in each traced train pass."""
    return [sum(1 for name, _s, _e, kind in trace.within([w])
                if kind == "gpu_memcpy" and "HtoD" in name)
            for w in trace.span_times("train_pass")]


def merged(records, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the records' intervals, clipped to ``[lo, hi]``."""
    out: List[Tuple[int, int]] = []
    for _name, s, e, _kind in sorted(records, key=lambda r: r[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_ns(trace: Trace) -> int:
    lo, hi = trace.bounds
    return sum(e - s for s, e in merged(trace.device, lo, hi))


def _open_at(records, t: int) -> Optional[str]:
    """The innermost of ``records`` open at ``t`` (the latest start)."""
    best = None
    for name, s, e in records:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return None if best is None else best[0]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the span, and its
    longest idle gaps by what the host was doing: the harness's span and
    the innermost host op open when the gap began."""
    lo, hi = trace.bounds
    total: Dict[str, float] = {}
    for name, s, e, _kind in trace.device:
        if lo <= s < hi:
            total[name] = total.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    gaps, at = [], lo
    for s, e in merged(trace.device, lo, hi) + [(hi, hi)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        span = _open_at(trace.spans, s) or "between_spans"
        op = _open_at(trace.host, s) or "no_host_op"
        named.append([f"{span[len(SPAN_PREFIX):] if span.startswith(SPAN_PREFIX) else span}:{op}",
                      (e - s) / 1e9])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
