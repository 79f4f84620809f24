"""``epoch.eval_ms``: the harness's host clock around ``Trainer.evaluate()``
(which reads its metrics back), the mean over the window's untraced
epochs. Layer: the epoch loop."""


def read(ctx):
    if not ctx.eval_ms:
        return None
    return sum(ctx.eval_ms) / len(ctx.eval_ms)
