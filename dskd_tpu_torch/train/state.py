"""Train state (port of dskd_tpu/train/state.py ``TrainState``): the
student model with its f32 master parameters, the optimizer, the update
count and the ``torch.Generator`` that draws the dropout masks.

The frozen teacher is a separate copy of the model (``frozen_copy``), in
eval mode with no parameter that requires a gradient: promoting the student
to teacher at a task boundary is one copy, as the JAX package's pytree copy
is.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.nn as nn

from .optim import Optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer,
               seed: int) -> "TrainState":
        device = next(model.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        return cls(model=model.train(), optimizer=optimizer, generator=gen)


def frozen_copy(model: nn.Module) -> nn.Module:
    """An eval-mode copy of ``model`` whose parameters take no gradient."""
    return copy.deepcopy(model).eval().requires_grad_(False)
