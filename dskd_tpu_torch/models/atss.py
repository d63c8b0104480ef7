"""ATSS (port of dskd_tpu/models/atss.py ``ATSSHead``, ``ATSS``,
``atss_anchors``, ``ATSSLossConfig``, ``_centerness_target``,
``atss_detection_loss``, ``atss_get_bboxes`` and its registry entry
``atss``).

ResNet -> FPN (C3-C5, P3-P7, extra convs on the output with a ReLU
between them) -> two towers of 4 x (conv, GroupNorm(32), ReLU) shared
across the levels; ``atss_cls`` on the cls tower, ``atss_reg`` (deltas,
times a per-level ``Scale``) and ``atss_centerness`` on the reg tower. One
square anchor of 8 strides per position. Loss: ATSS assignment, focal
loss, GIoU of the decoded boxes weighted by the centerness target, BCE on
the centerness. Decoding: sigmoid(cls) x sigmoid(centerness), per-level
threshold and top-k, deltas decoded at stds (0.1, 0.1, 0.2, 0.2), clipped,
class-aware NMS at IoU 0.6. With ``dyhead_blocks`` (ATSS-DyHead) the
DyHead blocks (``models/dyhead.py``) sit between the FPN and a head
without towers, and their outputs are the ``neck_feats``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.anchors import base_anchors, delta2bbox, grid_anchors
from ..core.atss import atss_assign
from ..core.postprocess import filter_scores_and_topk_mlvl
from .dyhead import DyHead, init_dyhead
from .fpn import FPN
from .gfl import init_dense
from .gfl_head import (ConvGN, Scale, cat_levels, centres, level_sizes, nhwc,
                       tower)
from .resnet import ResNet
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
ANCHOR_SCALE = 8
DELTA_STDS = (0.1, 0.1, 0.2, 0.2)
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)     # bias_init_with_prob(0.01)


class ATSSHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]    # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]    # per level (B, H, W, 4) deltas
    centernesses: Tuple[torch.Tensor, ...]  # per level (B, H, W, 1)


class ATSSOutputs(NamedTuple):
    head: ATSSHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


class ATSSHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 4,
                 feat_channels: int = 256, num_levels: int = 5):
        super().__init__()
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvGN(feat_channels, feat_channels, device)
                for _ in range(stacked_convs)))

        def conv(cout):
            return nn.Conv2d(feat_channels, cout, 3, padding=1,
                             device=device)

        self.atss_cls = conv(num_classes)
        self.atss_reg = conv(4)
        self.atss_centerness = conv(1)
        self.scales = nn.ModuleList(Scale(device) for _ in range(num_levels))

    def forward(self, feats) -> ATSSHeadOutputs:
        cls, reg, ctr = [], [], []
        for lvl, f in enumerate(feats):
            c, r = tower(self.cls_convs, f), tower(self.reg_convs, f)
            cls.append(nhwc(self.atss_cls(c)))
            reg.append(nhwc(self.scales[lvl](self.atss_reg(r))))
            # the centerness reads the reg tower
            ctr.append(nhwc(self.atss_centerness(r)))
        return ATSSHeadOutputs(tuple(cls), tuple(reg), tuple(ctr))


class ATSS(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1, dyhead_blocks: int = 0,
                 head_stacked_convs: int = 4):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_output",
                        relu_before_extra_convs=True)
        self.dyhead = (DyHead(device, num_blocks=dyhead_blocks)
                       if dyhead_blocks else None)
        self.bbox_head = ATSSHead(device, num_classes,
                                  stacked_convs=head_stacked_convs)

    def forward(self, images, img_hw) -> ATSSOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        if self.dyhead is not None:
            neck = self.dyhead(neck)
        return ATSSOutputs(self.bbox_head(neck), neck)


def atss_anchors(featmap_sizes, device):
    """One square anchor of 8 strides per position: (anchors (N, 4),
    per-level counts)."""
    per_level = [grid_anchors((h, w), s, base_anchors(s, (ANCHOR_SCALE,),
                                                      (1.0,)), device)
                 for (h, w), s in zip(featmap_sizes, STRIDES)]
    return torch.cat(per_level), tuple(a.shape[0] for a in per_level)


class ATSSLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 2.0
    loss_ctr_weight: float = 1.0
    topk: int = 9


def _centerness_target(anchors, gts):
    """sqrt of the min/max ratios of the left/right and top/bottom
    distances from each anchor's centre to its GT's sides."""
    c = centres(anchors)
    lr = torch.stack([c[..., 0] - gts[..., 0], gts[..., 2] - c[..., 0]], -1)
    tb = torch.stack([c[..., 1] - gts[..., 1], gts[..., 3] - c[..., 1]], -1)
    val = ((lr.amin(-1) / lr.amax(-1).clamp(min=1e-6))
           * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6)))
    return val.clamp(min=0).sqrt()


def atss_detection_loss(out: ATSSHeadOutputs, anchors, level_counts,
                        gt_bboxes, gt_labels, gt_valid, cfg: ATSSLossConfig):
    C = cfg.num_classes
    cls_flat = cat_levels(out.cls_scores, C)
    deltas = cat_levels(out.bbox_preds, 4)
    ctr_flat = cat_levels(out.centernesses, 1)[..., 0]
    assign = atss_assign(anchors, level_counts, gt_bboxes, gt_labels,
                         gt_valid, C, topk=cfg.topk)
    pos = assign.pos_mask
    num_pos = pos.sum().float().clamp(min=1.0)
    onehot = F.one_hot(assign.labels, C + 1)[..., :C].to(cls_flat.dtype)
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot.reshape(-1, C), avg_factor=num_pos,
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)

    G = gt_bboxes.shape[1]
    tgt = torch.gather(gt_bboxes, 1, assign.assigned_gt.clamp(0, G - 1)[
        ..., None].expand(-1, -1, 4))
    ctr_t = _centerness_target(anchors[None], tgt)
    ctr_t = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))
    decoded = delta2bbox(anchors[None], deltas, stds=DELTA_STDS)
    posf = pos.to(ctr_t.dtype)
    loss_bbox = cfg.loss_bbox_weight * L.giou_loss(
        decoded.reshape(-1, 4), tgt.reshape(-1, 4),
        weight=(posf * ctr_t).reshape(-1),
        avg_factor=ctr_t.sum().clamp(min=1e-6))
    loss_ctr = cfg.loss_ctr_weight * L.bce_loss(
        ctr_flat.reshape(-1), ctr_t.reshape(-1), weight=posf.reshape(-1),
        avg_factor=num_pos)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                loss_centerness=loss_ctr)


def atss_get_bboxes(out: ATSSHeadOutputs, anchors, img_hw,
                    scale_factor=None, score_thr: float = 0.05,
                    nms_iou: float = 0.6, nms_pre: int = 1000,
                    max_per_img: int = 100, rescale: bool = False
                    ) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    anchor)."""
    C = out.cls_scores[0].shape[-1]
    probs = (torch.sigmoid(cat_levels(out.cls_scores, C))
             * torch.sigmoid(cat_levels(out.centernesses, 1)))
    top = filter_scores_and_topk_mlvl(probs, score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    deltas = torch.gather(cat_levels(out.bbox_preds, 4), 1,
                          idx[..., None].expand(-1, -1, 4))
    boxes = delta2bbox(anchors[idx], deltas, stds=DELTA_STDS)
    return nms_detections(boxes, top, img_hw, scale_factor, rescale,
                          nms_iou, max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_atss(model_cfg, device="cuda") -> ATSS:
    m = model_cfg
    return ATSS(device, num_classes=m.num_classes, depth=m.depth,
                frozen_stages=m.frozen_stages,
                dyhead_blocks=m.dyhead_blocks,
                head_stacked_convs=0 if m.dyhead_blocks else 4)


def init_atss(model: ATSS, seed: int = 0) -> None:
    init_dense(model, seed, "atss_cls", PRIOR_BIAS)
    if model.dyhead is not None:
        init_dyhead(model.dyhead, torch.Generator().manual_seed(seed + 1))


def _register():
    from ..registry import register_family
    from ..utils.weights import atss_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = ATSSLossConfig(num_classes=cfg.model.num_classes)

        # JAX's ATSS losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            anchors, counts = atss_anchors(
                [c.shape[1:3] for c in out.head.cls_scores],
                batch.images.device)
            return atss_detection_loss(out.head, anchors, counts,
                                       batch.gt_bboxes, batch.gt_labels,
                                       batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            anchors, _ = atss_anchors(
                [c.shape[1:3] for c in out.head.cls_scores], images.device)
            return atss_get_bboxes(out.head, anchors, img_hw,
                                   scale_factor=scale_factors,
                                   score_thr=max(score_thr, 0.05),
                                   max_per_img=max_per_img, rescale=True)
        return step

    register_family("atss", build=build_atss, init_weights=init_atss,
                    from_jax=atss_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
