"""``xent.roofline_pct``: the bound of the cross-entropy kernels of a
train step (K1a and K1b at the step's local batch and classes, bytes at
the card's HBM rate) over their device time per train step, in percent.
Layer: the loss."""

from portbench.core import spec


def read(ctx):
    ms = ctx.per_train_step_ms(
        lambda n: "xent_fwd_kernel" in n or "xent_bwd_kernel" in n)
    if ms is None:
        return None
    xent = spec.load_module("counts", "xent")
    b, c = ctx.local_batch, ctx.config["num_classes"]
    bound_ms = (xent.fwd_bytes(b, c) + xent.bwd_bytes(b, c)) \
        / spec.peaks()["hbm_bytes_per_s"] * 1e3
    return 100.0 * bound_ms / ms
