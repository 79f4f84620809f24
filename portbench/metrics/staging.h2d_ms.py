"""``staging.h2d_ms``: device ms of the host-to-device copies inside the
traced train passes, per epoch: the staged epoch's copy, queued on the
stream the epoch program runs on. Layer: trainer staging."""


def read(ctx):
    if not ctx.complete:
        return None
    ns = sum(e - s for name, s, e, kind in ctx.train_records()
             if kind == "gpu_memcpy" and "HtoD" in name)
    return ns / 1e6 / ctx.epochs if ns else None
