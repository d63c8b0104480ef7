"""LR schedule (port of dskd_tpu/train/schedule.py ``step_lr_schedule``):
mmcv's step policy with linear warmup.

Flagship recipe: linear warmup over 1500 iterations from ratio 0.01, decay
x0.1 at epochs 8 and 11. The schedule is read at the optimizer's update
count, starting from 0, as optax reads it.
"""
from __future__ import annotations

from typing import Callable, Sequence


def step_lr_schedule(base_lr: float, warmup_iters: int = 1500,
                     warmup_ratio: float = 0.01,
                     step_epochs: Sequence[int] = (8, 11),
                     iters_per_epoch: int = 1000,
                     gamma: float = 0.1) -> Callable[[int], float]:
    """Returns f(update count) -> learning rate."""
    steps = [e * iters_per_epoch for e in step_epochs]

    def schedule(step: int) -> float:
        lr = base_lr * gamma ** sum(step >= s for s in steps)
        if step >= warmup_iters:
            return lr
        k = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        return lr * (warmup_ratio + (1.0 - warmup_ratio) * k)

    return schedule
