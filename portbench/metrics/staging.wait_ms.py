"""``staging.wait_ms``: the trainer's blocked time per staged epoch (its
``StagingLog.record_wait``: the join of the prefetch thread, or the whole
gather, and the copy's queueing), the mean over the window's epochs.
Layer: trainer staging."""


def read(ctx):
    if not ctx.waits:
        return None
    return sum(ctx.waits) / len(ctx.waits)
