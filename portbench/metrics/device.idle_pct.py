"""``device.idle_pct``: the share of the traced span (from the first
traced train pass to the last traced eval pass) in which the card runs no
kernel and no copy, in percent; the result line gives the mean over the
cell's cards. Layer: the device."""

from portbench.core import trace


def read(ctx):
    if not ctx.complete:
        return None
    busy_s = trace.busy_ns(ctx.trace) / 1e9
    return 100.0 * (1.0 - busy_s / ctx.span_s)
