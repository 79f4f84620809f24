"""``adam.roofline_pct``: the bound of the fused Adam kernel of a train
step (K2 over every parameter, bytes at the card's HBM rate) over its
device time per train step, in percent. Layer: the optimizer."""

from portbench.core import spec


def read(ctx):
    ms = ctx.per_train_step_ms(lambda n: "adam_leaves_kernel" in n)
    if ms is None:
        return None
    counts = spec.load_module("counts", "adam")
    bound_ms = counts.step_bytes(ctx.parameters) \
        / spec.peaks()["hbm_bytes_per_s"] * 1e3
    return 100.0 * bound_ms / ms
