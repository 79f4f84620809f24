"""``step.mfu_pct``: the model FLOPs of the traced passes (train: three
forwards an image; eval: one; nothing recomputed), from the benchmark's
own counts, over the traced span's wall times the card's bf16 peak, in
percent. Layer: the epoch program and step."""

from portbench.core import spec


def read(ctx):
    counts = spec.load_module("counts", ctx.config["model"])
    fwd = counts.forward_flops(ctx.config, ctx.traffic)
    images = ctx.train_steps * ctx.local_batch
    flops = 3 * fwd * images + fwd * ctx.eval_images * ctx.epochs
    return 100.0 * flops / (ctx.span_s * spec.peaks()["bf16_flops"])
