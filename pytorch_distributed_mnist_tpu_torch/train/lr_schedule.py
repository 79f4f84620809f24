"""Learning-rate schedules.

A copy of ``pytorch_distributed_mnist_tpu/train/lr_schedule.py``: the
reference's step decay ``lr = base_lr * 0.1 ** (epoch // 10)``, applied
once per epoch by writing it into the optimizer's injected
hyperparameters.
"""

from __future__ import annotations


def step_decay_schedule(base_lr: float, decay_factor: float = 0.1,
                        decay_every: int = 10):
    """Return ``lr(epoch)`` implementing the reference's step decay."""

    def lr(epoch: int) -> float:
        return base_lr * decay_factor ** (epoch // decay_every)

    return lr
