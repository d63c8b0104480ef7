"""Per-family train-step construction (port of dskd_tpu/train/family.py
``make_family_train_step``): a thin lookup in the port's family registry
(``dskd_tpu_torch/registry.py``).

A family that builds its own full step (the flagship) registers
``train_step``; any other registers ``losses`` and trains through the
generic step, ``train.step.make_generic_step`` (JAX's
``_jit_family_step``). An arch the port does not build raises. The port's
model has one off switch for dropout, p = 0, so ``use_dropout=False`` needs
a model built with dropout 0, as ``train.incremental.build_model`` builds
it.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..registry import get_family
from ..utils.config import ExperimentConfig
from .step import make_generic_step


def model_dropout(model: nn.Module) -> float:
    """The largest dropout rate among ``model``'s modules."""
    return max([float(m.dropout) for m in model.modules()
                if isinstance(getattr(m, "dropout", None), (int, float))],
               default=0.0)


def make_family_train_step(arch: str, model: nn.Module,
                           cfg: ExperimentConfig, num_prev: int,
                           has_teacher: bool, use_dropout: bool = True,
                           compute_dtype: torch.dtype = torch.float32,
                           use_l1: bool = False):
    """Returns ``train_step(state, batch, teacher=None) -> (state, losses)``
    for ``model``. ``use_l1`` is YOLOX's no-aug extra (its L1 branch); the
    other families take none."""
    try:
        spec = get_family(arch)
    except ValueError:
        raise ValueError(f"no train step for arch: {arch}") from None
    if not use_dropout and model_dropout(model) > 0:
        raise ValueError("use_dropout=False needs a model built with "
                         "dropout 0")
    if spec["train_step"] is not None:
        return spec["train_step"](
            model, cfg, num_prev=num_prev, has_teacher=has_teacher,
            use_dropout=use_dropout, compute_dtype=compute_dtype)
    if compute_dtype != torch.float32:
        raise ValueError(f"the {arch} family trains in f32 only (its generic "
                         f"step has no {compute_dtype} path)")
    extra = {"use_l1": True} if use_l1 else {}
    return make_generic_step(spec["losses"](
        model, cfg, num_prev=num_prev, has_teacher=has_teacher,
        use_dropout=use_dropout, **extra))
