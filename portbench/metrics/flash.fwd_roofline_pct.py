"""``flash.fwd_roofline_pct``: the bound of the flash forward kernels of a
train step (K4a once per block at the step's (B, T, H, D), the larger of
operations at the bf16 peak and bytes at the HBM rate) over their device
time per train step, in percent. Layer: attention."""

from portbench.core import spec


def read(ctx):
    ms = ctx.per_train_step_ms(lambda n: "flash_fwd" in n)
    if ms is None:
        return None
    flash = spec.load_module("counts", "flash")
    vit = spec.load_module("counts", "vit")
    shape = (ctx.local_batch, vit.tokens(ctx.config, ctx.traffic),
             ctx.config["num_heads"], ctx.config["head_dim"])
    peak = spec.peaks()
    bound_s = max(flash.fwd_flops(*shape) / peak["bf16_flops"],
                  flash.fwd_bytes(*shape) / peak["hbm_bytes_per_s"])
    return 100.0 * bound_s * 1e3 * ctx.config["depth"] / ms
