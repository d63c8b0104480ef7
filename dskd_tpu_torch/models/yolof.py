"""YOLOF and its incremental distillation (port of dskd_tpu/models/yolof.py
``YOLOF``, ``YOLOFDistillConfig``, ``yolof_teacher_out``,
``yolof_compute_losses`` and its registry entry ``yolof``).

Caffe-style ResNet C5 -> DilatedEncoder -> YOLOF head (stride 32, five
anchors per position). ``model.train()`` puts the neck's and head's
BatchNorms on batch statistics, which update their running statistics;
the backbone's BatchNorm stays frozen. The frozen teacher (an eval-mode
copy) and the eval loop read the running statistics. Images enter NHWC;
``neck_feat`` stays NCHW.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from ..core import losses as L
from ..core.anchors import delta2bbox
from ..distill.losses import _kd_kl_axis, _kept_query_weight
from ..distill.teacher import merge_teacher_gt
from .dilated_encoder import DilatedEncoder, init_conv_bn
from .resnet import ResNet
from .yolof_head import (Detections, YOLOFHead, YOLOFHeadOutputs,
                         YOLOFLossConfig, yolof_anchors, yolof_detection_loss,
                         yolof_get_bboxes)


class YOLOFOutputs(NamedTuple):
    head: YOLOFHeadOutputs
    neck_feat: torch.Tensor     # (B, 512, H, W)


class YOLOF(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1, num_anchors: int = 5):
        super().__init__()
        # the YOLOF recipe ships a detectron caffe-style R50
        self.backbone = ResNet(depth, device, out_indices=(3,),
                               frozen_stages=frozen_stages, style="caffe")
        self.neck = DilatedEncoder(self.backbone.out_channels[3], device)
        self.bbox_head = YOLOFHead(device, num_classes,
                                   num_anchors=num_anchors)

    def forward(self, images, img_hw) -> YOLOFOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw (B, 2) is unused by
        the forward (the decode clips to it)."""
        feat = self.neck(self.backbone(images.permute(0, 3, 1, 2)))[0]
        return YOLOFOutputs(self.bbox_head(feat), feat)


class YOLOFDistillConfig(NamedTuple):
    hard: bool = True
    soft: bool = False
    ld_bbox: bool = False
    feats_kldv: bool = False
    kd_weight: float = 10.0
    kd_T: float = 2.0
    ld_bbox_weight: float = 10.0
    fd_weight: float = 10.0
    fd_T: float = 2.0

    @classmethod
    def from_flags(cls, cates_distill="", locat_distill="",
                   feats_distill="", **kw):
        return cls(hard="hard" in cates_distill,
                   soft="soft" in cates_distill,
                   ld_bbox="bbox" in locat_distill,
                   feats_kldv="kldv" in feats_distill, **kw)


def yolof_teacher_out(outputs: YOLOFOutputs, anchors, img_hw,
                      score_thr: float = 0.3, max_per_img: int = 100):
    """The frozen teacher's detections and outputs, detached."""
    det = yolof_get_bboxes(outputs.head, anchors, img_hw,
                           score_thr=score_thr, max_per_img=max_per_img)
    head = outputs.head
    return (Detections(*(t.detach() for t in det)),
            YOLOFOutputs(YOLOFHeadOutputs(head.cls_scores.detach(),
                                          head.bbox_preds.detach(),
                                          head.feat_hw),
                         outputs.neck_feat.detach()))


def yolof_compute_losses(out: YOLOFOutputs, anchors, batch,
                         det_cfg: YOLOFLossConfig,
                         teacher_out: Optional[YOLOFOutputs] = None,
                         distill_cfg: Optional[YOLOFDistillConfig] = None,
                         teacher_score_thr: float = 0.3,
                         teacher_max_per_img: int = 100,
                         ctr_clamp: float = 32.0) -> Dict[str, torch.Tensor]:
    """Detection losses and the YOLOF-IL distills for one batch.

    hard: the teacher's detections ahead of the GT; soft: the KL of the
    class logits over every anchor at JAX's (N, 1) weight of the teacher's
    kept anchors (a scatter-max, so an anchor kept twice counts once)
    against the (N,) per-row KL, in its closed form (Σw)(ΣKL)/num_keep;
    ld_bbox: smooth L1 between the decoded boxes at the kept anchors; kldv:
    ``_kd_kl_axis`` over the neck map's channels, summed and divided by
    B."""
    gt_bboxes, gt_labels, gt_valid = (batch.gt_bboxes, batch.gt_labels,
                                      batch.gt_valid)
    tdet = None
    if teacher_out is not None:
        tdet, teacher_out = yolof_teacher_out(
            teacher_out, anchors, batch.img_hw, teacher_score_thr,
            teacher_max_per_img)
        if distill_cfg.hard:
            gt_bboxes, gt_labels, gt_valid = merge_teacher_gt(
                tdet, gt_bboxes, gt_labels, gt_valid)

    losses, _ = yolof_detection_loss(out.head, anchors, gt_bboxes,
                                     gt_labels, gt_valid, det_cfg)
    if tdet is None:
        return losses
    head, t_head = out.head, teacher_out.head
    B = head.cls_scores.shape[0]
    C = det_cfg.num_classes
    num_keep = tdet.valid.sum().float().clamp(min=1.0)
    keep_w = _kept_query_weight(tdet, B, anchors.shape[0]).to(
        head.cls_scores.dtype)
    if distill_cfg.soft:
        losses["loss_kd"] = distill_cfg.kd_weight * L.kd_kl_div_loss_outer(
            head.cls_scores.reshape(-1, C), t_head.cls_scores.reshape(-1, C),
            keep_w.reshape(-1), num_keep, T=distill_cfg.kd_T)
    if distill_cfg.ld_bbox:
        s_boxes, t_boxes = (
            delta2bbox(anchors[None], h.bbox_preds.reshape(B, -1, 4),
                       add_ctr_clamp=True, ctr_clamp=ctr_clamp)
            for h in (head, t_head))
        losses["loss_ld_bbox"] = distill_cfg.ld_bbox_weight * \
            L.smooth_l1_loss(s_boxes.reshape(-1, 4), t_boxes.reshape(-1, 4),
                             weight=keep_w.reshape(-1, 1),
                             avg_factor=num_keep)
    if distill_cfg.feats_kldv:
        kl = _kd_kl_axis(out.neck_feat, teacher_out.neck_feat,
                         distill_cfg.fd_T, axis=1)
        losses["loss_fd"] = distill_cfg.fd_weight * kl.sum() / B
    return losses


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_yolof(model_cfg, device="cuda") -> YOLOF:
    m = model_cfg
    return YOLOF(device, num_classes=m.num_classes, depth=m.depth,
                 frozen_stages=m.frozen_stages)


@torch.no_grad()
def init_yolof(model: YOLOF, seed: int = 0) -> None:
    """Seeded random weights at the scales of JAX's initializers, drawn on
    the CPU: normal(0.01) for the dilated blocks' and the head's convs,
    caffe2-Xavier (uniform +-sqrt(3 / fan_in)) for the lateral and fpn
    convs, lecun-normal for the backbone; zero biases but the cls score's,
    -log(99) (prior 0.01); identity BatchNorms."""
    def init_of(name):
        if name in ("neck.lateral_conv", "neck.fpn_conv"):
            return "caffe2_xavier"
        if name.startswith(("neck.dilated_encoder_blocks", "bbox_head.")):
            return "normal_001"
        return "lecun"

    init_conv_bn(model, torch.Generator().manual_seed(seed), init_of)
    model.bbox_head.cls_score.bias.fill_(-math.log((1 - 0.01) / 0.01))


def _register():
    from ..registry import register_family
    from ..utils.weights import yolof_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = YOLOFLossConfig(num_classes=cfg.model.num_classes)
        distill_cfg = YOLOFDistillConfig.from_flags(
            cates_distill=cfg.distill.cates_distill,
            locat_distill=cfg.distill.locat_distill,
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
            return yolof_compute_losses(
                out, yolof_anchors(out.head.feat_hw, out.neck_feat.device),
                batch, det_cfg, teacher_out=t_out, distill_cfg=distill_cfg,
                teacher_score_thr=cfg.distill.teacher_score_thr,
                teacher_max_per_img=cfg.distill.teacher_max_per_img)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            return yolof_get_bboxes(
                out.head, yolof_anchors(out.head.feat_hw, images.device),
                img_hw, scale_factor=scale_factors,
                score_thr=max(score_thr, 0.05), max_per_img=max_per_img,
                rescale=True)
        return step

    register_family("yolof", build=build_yolof, init_weights=init_yolof,
                    from_jax=yolof_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
