"""LD, localization distillation for GFL (port of dskd_tpu/models/ld.py
``LDLossConfig``, ``ld_loss`` and its registry entry ``ld``).

A GFL student (ResNet-18 in ``configs/ld_r18_gflv1_r101_1x.py``) trains on
GFL's losses plus a KL term that carries a frozen GFL teacher's (ResNet-101)
corner distributions: at the student's ATSS positives, KL(T = 10) of the
4 x (reg_max + 1) bin logits, each side weighted by the detached max class
probability of the student, over an avg_factor of 4 (not over the weights'
sum, as DFL is), times 0.25. The teacher runs in every step, outside
autograd. The eval step is GFL's (``models/gfl.py gfl_eval_step``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core import losses as L
from ..core.atss import atss_assign
from .gfl import build_gfl, gfl_eval_step, init_gfl
from .gfl_head import (GFLHeadOutputs, GFLLossConfig, cat_levels,
                       gfl_anchors, gfl_detection_loss)


class LDLossConfig(NamedTuple):
    gfl: GFLLossConfig = GFLLossConfig()
    ld_T: float = 10.0
    ld_weight: float = 0.25


def ld_loss(student_out: GFLHeadOutputs, teacher_out: GFLHeadOutputs,
            gt_bboxes, gt_labels, gt_valid,
            cfg: LDLossConfig) -> Dict[str, torch.Tensor]:
    """GFL's detection losses and ``loss_ld``, the KL of the teacher's
    corner distributions at the student's positives."""
    losses = gfl_detection_loss(student_out, gt_bboxes, gt_labels, gt_valid,
                                cfg.gfl)
    g = cfg.gfl
    C = g.num_classes
    n_bins = g.reg_max + 1
    device = student_out.cls_scores[0].device
    per_level = gfl_anchors([c.shape[1:3] for c in student_out.cls_scores],
                            device, g.strides)
    assign = atss_assign(torch.cat(per_level),
                         [a.shape[0] for a in per_level], gt_bboxes,
                         gt_labels, gt_valid, C, g.atss_topk)
    cls_flat = cat_levels(student_out.cls_scores, C)
    s_reg = cat_levels(student_out.bbox_preds, 4 * n_bins)
    t_reg = cat_levels(teacher_out.bbox_preds, 4 * n_bins).detach()
    w = (torch.sigmoid(cls_flat).amax(-1).detach()
         * assign.pos_mask.to(cls_flat.dtype))
    kl = L.kd_kl_div_loss(s_reg.reshape(-1, n_bins),
                          t_reg.reshape(-1, n_bins), T=cfg.ld_T,
                          weight=w.reshape(-1).repeat_interleave(4),
                          avg_factor=4.0)
    losses["loss_ld"] = cfg.ld_weight * kl
    return losses


def _register():
    from ..registry import register_family
    from ..utils.weights import gfl_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = LDLossConfig(gfl=GFLLossConfig(
            num_classes=cfg.model.num_classes, reg_max=cfg.model.reg_max))

        def losses_fn(model, batch, teacher, generator):
            if teacher is None:
                raise ValueError("arch 'ld' needs a frozen teacher (an "
                                 "external teacher_ckpt for its first task)")
            out = model(batch.images, batch.img_hw)
            with torch.no_grad():
                t_out = teacher(batch.images, batch.img_hw)
            return ld_loss(out.head, t_out.head, batch.gt_bboxes,
                           batch.gt_labels, batch.gt_valid, det_cfg)
        return losses_fn

    register_family("ld", build=build_gfl, init_weights=init_gfl,
                    from_jax=gfl_state_dict_from_jax, losses=losses,
                    eval_step=gfl_eval_step)


_register()
