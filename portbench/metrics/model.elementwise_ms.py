"""``model.elementwise_ms``: device ms of the elementwise kernels per
train step (every kernel the frozen ``step_part`` rules call
``other_elementwise``: activations, casts, LayerNorm, residuals, the
metric updates). Layer: the model."""

from portbench.core import trace


def read(ctx):
    return ctx.per_train_step_ms(
        lambda n: trace.step_part(n) == "other_elementwise")
