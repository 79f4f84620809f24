"""``model.conv_ms``: device ms of the convolution kernels (cuDNN's) per
train step, by the frozen ``step_part`` rules. Layer: the model."""

from portbench.core import trace


def read(ctx):
    return ctx.per_train_step_ms(lambda n: trace.step_part(n) == "conv")
