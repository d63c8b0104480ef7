"""Per-family train-step construction (port of dskd_tpu/train/family.py
``make_family_train_step`` with the flagship registry entry of
dskd_tpu/models/detector.py).

The port has the flagship archs, ``gfl_deformable_detr`` and
``deformable_detr_il``; any other arch raises. The loss configs are built
from the experiment config exactly as the JAX registry's ``train_step``
builds them. The port's model has one off switch for dropout, p = 0, so
``use_dropout=False`` needs a model built with dropout 0, as
``train.incremental.build_model`` builds it.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..distill.losses import DistillConfig
from ..models.detector import ARCHS
from ..models.gfl_detr_loss import DetLossConfig
from ..utils.config import ExperimentConfig
from .step import make_train_step

def model_dropout(model: nn.Module) -> float:
    """The largest dropout rate among ``model``'s modules."""
    return max([float(m.dropout) for m in model.modules()
                if isinstance(getattr(m, "dropout", None), (int, float))],
               default=0.0)


def make_family_train_step(arch: str, model: nn.Module,
                           cfg: ExperimentConfig, num_prev: int,
                           has_teacher: bool, use_dropout: bool = True,
                           compute_dtype: torch.dtype = torch.float32):
    """Returns ``train_step(state, batch, teacher=None) -> (state, losses)``
    for ``model``."""
    if arch not in ARCHS:
        raise ValueError(f"no train step for arch: {arch}")
    if not use_dropout and model_dropout(model) > 0:
        raise ValueError("use_dropout=False needs a model built with "
                         "dropout 0")
    det_cfg = DetLossConfig(num_classes=cfg.model.num_classes,
                            reg_max=cfg.model.reg_max)
    distill_cfg = None
    if has_teacher:
        distill_cfg = DistillConfig.from_flags(
            cates_distill=cfg.distill.cates_distill,
            locat_distill=cfg.distill.locat_distill,
            feats_distill=cfg.distill.feats_distill,
            memory_distill=cfg.distill.memory_distill,
            num_prev=max(num_prev, 1), reg_max=cfg.model.reg_max,
            fix_fg_grad_direction=cfg.distill.fix_fg_grad_direction)
    return make_train_step(
        det_cfg, distill_cfg,
        teacher_score_thr=cfg.distill.teacher_score_thr,
        teacher_max_per_img=cfg.distill.teacher_max_per_img,
        compute_dtype=compute_dtype)
