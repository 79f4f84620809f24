"""``flash.bwd_roofline_pct``: the bound of the flash backward kernels of
a train step (K4b once per block: the fused kernel at T <= 128, the tiled
dQ and dK/dV pair above) over their device time per train step, in
percent. Layer: attention."""

from portbench.core import spec

BACKWARD = ("flash_bwd_kernel", "flash_dq", "flash_dkv")


def read(ctx):
    ms = ctx.per_train_step_ms(lambda n: any(k in n for k in BACKWARD))
    if ms is None:
        return None
    flash = spec.load_module("counts", "flash")
    vit = spec.load_module("counts", "vit")
    shape = (ctx.local_batch, vit.tokens(ctx.config, ctx.traffic),
             ctx.config["num_heads"], ctx.config["head_dim"])
    peak = spec.peaks()
    bound_s = max(flash.bwd_flops(*shape) / peak["bf16_flops"],
                  flash.bwd_bytes(*shape) / peak["hbm_bytes_per_s"])
    return 100.0 * bound_s * 1e3 * ctx.config["depth"] / ms
