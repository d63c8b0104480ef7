"""LR schedules (port of dskd_tpu/train/schedule.py ``step_lr_schedule``
and ``yolox_cosine_schedule``).

Flagship recipe: mmcv's step policy, linear warmup over 1500 iterations
from ratio 0.01, decay x0.1 at epochs 8 and 11. YOLOX's: a quadratic
warmup, a cosine anneal to ``min_lr_ratio`` of the base rate, then that
floor for the no-aug epochs. A schedule is read at the optimizer's update
count, starting from 0, as optax reads it; the port computes in Python
floats, where JAX computes in f32.
"""
from __future__ import annotations

import math
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


def yolox_cosine_schedule(base_lr: float, warmup_iters: int,
                          total_iters: int, last_iters: int = 0,
                          min_lr_ratio: float = 0.05
                          ) -> Callable[[int], float]:
    """YOLOXLrUpdaterHook: ``base_lr * (step / warmup)**2`` during the
    warmup, then a cosine from ``base_lr`` at the warmup's end to
    ``min_lr_ratio * base_lr`` at ``total_iters - last_iters``, which
    holds after it."""
    min_lr = base_lr * min_lr_ratio
    anneal = max(total_iters - last_iters - warmup_iters, 1)

    def schedule(step: int) -> float:
        if step < warmup_iters:
            w = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
            return base_lr * w * w
        k = min(max((step - warmup_iters) / anneal, 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * k))

    return schedule
