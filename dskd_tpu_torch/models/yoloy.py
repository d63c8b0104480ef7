"""YOLOY, the YOLOX-style incremental detector, and its distillation (port
of dskd_tpu/models/yoloy.py ``YOLOY``, ``YOLOYDistillConfig``,
``yoloy_compute_losses`` and its registry entry ``yoloy``).

Pytorch-style ResNet (C3-C5, frozen BatchNorm) -> PAFPN -> decoupled head
at strides 8, 16 and 32. ``model.train()`` puts the neck's and head's
BatchNorms on batch statistics, which update their running statistics;
the frozen teacher and the eval loop read the running statistics. Images
enter NHWC; ``neck_feats`` stay NCHW.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..core import losses as L
from ..distill.losses import _kd_kl_axis, _kept_query_weight
from ..distill.teacher import merge_teacher_gt
from .dilated_encoder import init_conv_bn
from .resnet import ResNet
from .yolof_head import Detections
from .yoloy_head import (PRIOR_BIAS, YOLOYHead, YOLOYHeadOutputs,
                         YOLOYLossConfig, yoloy_detection_loss,
                         yoloy_get_bboxes)
from .yoloy_pafpn import YOLOYPAFPN


class YOLOYOutputs(NamedTuple):
    head: YOLOYHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]    # per level (B, C, H, W)


class YOLOY(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 18,
                 frozen_stages: int = 1, neck_channels: int = 128):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = YOLOYPAFPN(self.backbone.out_channels[1:], device,
                               out_channels=neck_channels)
        self.bbox_head = YOLOYHead(device, num_classes, neck_channels,
                                   neck_channels)

    def forward(self, images, img_hw) -> YOLOYOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw (B, 2) is unused by
        the forward (the decode clips to it)."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return YOLOYOutputs(self.bbox_head(neck), neck)


class YOLOYDistillConfig(NamedTuple):
    hard: bool = True
    soft: bool = False
    feats_kldv: bool = False
    kd_weight: float = 1.0
    kd_T: float = 2.0
    fd_weight: float = 1.0
    fd_T: float = 2.0

    @classmethod
    def from_flags(cls, cates_distill="", locat_distill="",
                   feats_distill="", **kw):
        return cls(hard="hard" in cates_distill,
                   soft="soft" in cates_distill,
                   feats_kldv="kldv" in feats_distill, **kw)


def _detached(out: YOLOYOutputs) -> YOLOYOutputs:
    return YOLOYOutputs(
        YOLOYHeadOutputs(*(tuple(t.detach() for t in ts) for ts in out.head)),
        tuple(t.detach() for t in out.neck_feats))


def yoloy_compute_losses(out: YOLOYOutputs, batch,
                         det_cfg: YOLOYLossConfig,
                         teacher_out: Optional[YOLOYOutputs] = None,
                         distill_cfg: Optional[YOLOYDistillConfig] = None,
                         teacher_score_thr: float = 0.3,
                         teacher_max_per_img: int = 100
                         ) -> Dict[str, torch.Tensor]:
    """Detection losses and the YOLOY-IL distills for one batch: hard (the
    teacher's detections ahead of the GT), soft (the class logits' KL over
    every prior at JAX's (N, 1) weight of the teacher's kept priors, in its
    closed form (Σw)(ΣKL)/num_keep) and kldv (``_kd_kl_axis`` over each
    neck level's channels, summed over the levels and divided by B)."""
    gt_bboxes, gt_labels, gt_valid = (batch.gt_bboxes, batch.gt_labels,
                                      batch.gt_valid)
    tdet = None
    if teacher_out is not None:
        teacher_out = _detached(teacher_out)
        tdet = yoloy_get_bboxes(teacher_out.head, batch.img_hw,
                                strides=det_cfg.strides,
                                score_thr=teacher_score_thr,
                                max_per_img=teacher_max_per_img)
        if distill_cfg.hard:
            gt_bboxes, gt_labels, gt_valid = merge_teacher_gt(
                tdet, gt_bboxes, gt_labels, gt_valid)

    losses = yoloy_detection_loss(out.head, gt_bboxes, gt_labels, gt_valid,
                                  det_cfg)
    if tdet is None:
        return losses
    B = out.head.cls_scores[0].shape[0]
    C = det_cfg.num_classes
    num_keep = tdet.valid.sum().float().clamp(min=1.0)
    if distill_cfg.soft:
        cls_s, cls_t = (torch.cat([c.reshape(B, -1, C) for c in o.head
                                   .cls_scores], 1)
                        for o in (out, teacher_out))
        keep_w = _kept_query_weight(tdet, B, cls_s.shape[1]).to(cls_s.dtype)
        losses["loss_kd"] = distill_cfg.kd_weight * L.kd_kl_div_loss_outer(
            cls_s.reshape(-1, C), cls_t.reshape(-1, C), keep_w.reshape(-1),
            num_keep, T=distill_cfg.kd_T)
    if distill_cfg.feats_kldv:
        total = sum(_kd_kl_axis(sf, tf, distill_cfg.fd_T, axis=1).sum()
                    for sf, tf in zip(out.neck_feats, teacher_out.neck_feats))
        losses["loss_fd"] = distill_cfg.fd_weight * total / B
    return losses


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_yoloy(model_cfg, device="cuda") -> YOLOY:
    m = model_cfg
    return YOLOY(device, num_classes=m.num_classes, depth=m.depth,
                 frozen_stages=m.frozen_stages)


@torch.no_grad()
def init_yoloy(model: YOLOY, seed: int = 0) -> None:
    """Seeded random weights at the scales of JAX's initializers, drawn on
    the CPU: lecun-normal for every conv, zero biases but the class and
    objectness convs', -4.595; identity BatchNorms."""
    init_conv_bn(model, torch.Generator().manual_seed(seed),
                 lambda name: "lecun")
    head = model.bbox_head
    for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
        conv.bias.fill_(PRIOR_BIAS)


def _register():
    from ..registry import register_family
    from ..utils.weights import yoloy_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = YOLOYLossConfig(num_classes=cfg.model.num_classes)
        distill_cfg = YOLOYDistillConfig.from_flags(
            cates_distill=cfg.distill.cates_distill,
            feats_distill=cfg.distill.feats_distill) if has_teacher else None

        def losses_fn(model, batch, teacher, generator):
            # a training-mode student normalises by the batch statistics
            # and updates its running ones; the frozen teacher (eval mode)
            # reads its own
            out = model(batch.images, batch.img_hw)
            t_out = None
            if teacher is not None:
                with torch.no_grad():
                    t_out = teacher(batch.images, batch.img_hw)
            return yoloy_compute_losses(
                out, batch, det_cfg, teacher_out=t_out,
                distill_cfg=distill_cfg,
                teacher_score_thr=cfg.distill.teacher_score_thr,
                teacher_max_per_img=cfg.distill.teacher_max_per_img)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors) -> Detections:
            return yoloy_get_bboxes(
                model(images, img_hw).head, img_hw,
                scale_factor=scale_factors, score_thr=max(score_thr, 0.01),
                max_per_img=max_per_img, rescale=True)
        return step

    register_family("yoloy", build=build_yoloy, init_weights=init_yoloy,
                    from_jax=yoloy_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
