"""YOLOY's decoupled head, priors, loss and decoding (port of
dskd_tpu/models/yoloy_head.py ``YOLOYHead``, ``yoloy_priors``,
``yoloy_decode``, ``YOLOYLossConfig``, ``yoloy_detection_loss`` and
``yoloy_get_bboxes``).

Per level: two conv + BN + swish stacks for classes and for boxes -> C
class logits, 4 box terms (xy offset in strides, log wh) and 1
objectness logit; outputs are NHWC per level, as JAX's. Loss: SimOTA on
the detached sigmoid(cls) x sigmoid(obj) and decoded boxes, IoU-aware
one-hot class targets at the positives, objectness BCE over every prior,
DIoU on the positives (the fork's config), optional L1, each divided by
the positives' count. Module names follow mmdet's YOLOXHead
(``multi_level_cls_convs.l.i``, ``multi_level_conv_cls.l``, ...).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.postprocess import filter_scores_and_topk
from ..core.sim_ota import sim_ota_assign
from .yolof_head import Detections, nms_detections
from .yoloy_pafpn import conv_bn_swish

PRIOR_BIAS = -4.595     # the class and objectness bias prior


class YOLOYHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]    # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]    # per level (B, H, W, 4)
    objectnesses: Tuple[torch.Tensor, ...]  # per level (B, H, W, 1)


class YOLOYHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, in_channels: int = 128,
                 feat_channels: int = 128, stacked_convs: int = 2,
                 num_levels: int = 3):
        super().__init__()

        def tower():
            return nn.Sequential(*(conv_bn_swish(
                in_channels if i == 0 else feat_channels, feat_channels, 3,
                device) for i in range(stacked_convs)))

        def head(cout):
            return nn.ModuleList(nn.Conv2d(feat_channels, cout, 1,
                                           device=device)
                                 for _ in range(num_levels))

        self.multi_level_cls_convs = nn.ModuleList(
            tower() for _ in range(num_levels))
        self.multi_level_reg_convs = nn.ModuleList(
            tower() for _ in range(num_levels))
        self.multi_level_conv_cls = head(num_classes)
        self.multi_level_conv_reg = head(4)
        self.multi_level_conv_obj = head(1)

    def forward(self, feats: Sequence[torch.Tensor]) -> YOLOYHeadOutputs:
        cls_scores, bbox_preds, objectnesses = [], [], []
        for lvl, x in enumerate(feats):
            c = self.multi_level_cls_convs[lvl](x)
            r = self.multi_level_reg_convs[lvl](x)
            cls_scores.append(self.multi_level_conv_cls[lvl](c))
            bbox_preds.append(self.multi_level_conv_reg[lvl](r))
            objectnesses.append(self.multi_level_conv_obj[lvl](r))
        return YOLOYHeadOutputs(*(tuple(t.permute(0, 2, 3, 1) for t in ts)
                                  for ts in (cls_scores, bbox_preds,
                                             objectnesses)))


def yoloy_priors(featmap_sizes, device, strides=(8, 16, 32)) -> torch.Tensor:
    """(N, 4) [x, y, stride, stride] over the levels, row-major per level,
    no centre offset (MlvlPointGenerator)."""
    out = []
    for (h, w), s in zip(featmap_sizes, strides):
        xs = torch.arange(w, dtype=torch.float32, device=device) * s
        ys = torch.arange(h, dtype=torch.float32, device=device) * s
        gx = xs[None, :].expand(h, w).reshape(-1)
        gy = ys[:, None].expand(h, w).reshape(-1)
        out.append(torch.stack([gx, gy, torch.full_like(gx, s),
                                torch.full_like(gx, s)], -1))
    return torch.cat(out, 0)


def yoloy_decode(priors, bbox_preds):
    """(N, 4) priors and (..., N, 4) predictions -> xyxy boxes."""
    xys = bbox_preds[..., :2] * priors[..., 2:] + priors[..., :2]
    whs = torch.exp(bbox_preds[..., 2:]) * priors[..., 2:]
    return torch.cat([xys - whs / 2, xys + whs / 2], -1)


def flatten_levels(out: YOLOYHeadOutputs):
    """(cls (B, N, C), reg (B, N, 4), obj (B, N)) over the levels."""
    B = out.cls_scores[0].shape[0]
    return (torch.cat([c.reshape(B, -1, c.shape[-1])
                       for c in out.cls_scores], 1),
            torch.cat([r.reshape(B, -1, 4) for r in out.bbox_preds], 1),
            torch.cat([o.reshape(B, -1) for o in out.objectnesses], 1))


def featmap_sizes(out: YOLOYHeadOutputs):
    return [tuple(c.shape[1:3]) for c in out.cls_scores]


class YOLOYLossConfig(NamedTuple):
    num_classes: int = 80
    strides: Tuple[int, ...] = (8, 16, 32)
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 5.0
    loss_obj_weight: float = 1.0
    loss_l1_weight: float = 1.0
    use_l1: bool = False
    bbox_loss: str = "diou"     # the fork's config uses DIoULoss


def yoloy_detection_loss(out: YOLOYHeadOutputs, gt_bboxes, gt_labels,
                         gt_valid, cfg: YOLOYLossConfig
                         ) -> Dict[str, torch.Tensor]:
    C = cfg.num_classes
    cls_flat, reg_flat, obj_flat = flatten_levels(out)
    priors = yoloy_priors(featmap_sizes(out), cls_flat.device, cfg.strides)
    decoded = yoloy_decode(priors[None], reg_flat)          # (B, N, 4)

    # the assignment's priors carry the half-stride centre offset
    offset_priors = torch.cat([priors[:, :2] + priors[:, 2:] * 0.5,
                               priors[:, 2:]], -1)
    with torch.no_grad():
        scores = torch.sigmoid(cls_flat) * torch.sigmoid(obj_flat)[..., None]
        assign = sim_ota_assign(scores, offset_priors, decoded, gt_bboxes,
                                gt_labels, gt_valid, C)
    num_total = assign.num_pos.sum().float().clamp(min=1.0)

    G = gt_bboxes.shape[1]
    safe = assign.assigned_gt.clamp(0, G - 1)
    tgt_boxes = torch.gather(gt_bboxes, 1, safe[..., None].expand(-1, -1, 4))
    posf = assign.pos_mask.to(cls_flat.dtype)
    bbox_fn = {"diou": L.diou_loss, "ciou": L.ciou_loss,
               "square_iou": L.square_iou_loss}.get(cfg.bbox_loss,
                                                    L.iou_loss)
    loss_bbox = cfg.loss_bbox_weight * bbox_fn(
        decoded.reshape(-1, 4), tgt_boxes.reshape(-1, 4),
        weight=posf.reshape(-1), reduction="none").sum() / num_total
    loss_obj = cfg.loss_obj_weight * L.binary_cross_entropy_with_logits(
        obj_flat, posf).sum() / num_total
    onehot = F.one_hot(assign.labels.clamp(0, C), C + 1)[..., :C].to(
        cls_flat.dtype)
    cls_tgt = onehot * assign.max_ious[..., None]
    cls_bce = L.binary_cross_entropy_with_logits(cls_flat, cls_tgt)
    loss_cls = cfg.loss_cls_weight * (cls_bce * posf[..., None]).sum() \
        / num_total
    losses = dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_obj=loss_obj)
    if cfg.use_l1:
        gt_xy = (tgt_boxes[..., :2] + tgt_boxes[..., 2:]) / 2
        gt_wh = tgt_boxes[..., 2:] - tgt_boxes[..., :2]
        l1_tgt = torch.cat([
            (gt_xy - priors[None, :, :2]) / priors[None, :, 2:],
            torch.log(gt_wh.clamp(min=1e-8) / priors[None, :, 2:] + 1e-8)],
            -1)
        losses["loss_l1"] = cfg.loss_l1_weight * (
            (reg_flat - l1_tgt).abs() * posf[..., None]).sum() / num_total
    return losses


def yoloy_get_bboxes(out: YOLOYHeadOutputs, img_hw, scale_factor=None,
                     strides=(8, 16, 32), score_thr: float = 0.01,
                     nms_iou: float = 0.65, nms_pre: int = 2000,
                     max_per_img: int = 100,
                     rescale: bool = False) -> Detections:
    """Fixed-size detections per image: scores sigmoid(cls) x
    sigmoid(obj), the ``nms_pre`` best (prior, class) pairs above
    ``score_thr``, boxes clipped to the image, class-aware NMS;
    ``keep_qid`` is each survivor's prior position."""
    cls_flat, reg_flat, obj_flat = flatten_levels(out)
    priors = yoloy_priors(featmap_sizes(out), cls_flat.device, strides)
    scores = torch.sigmoid(cls_flat) * torch.sigmoid(obj_flat)[..., None]
    boxes = yoloy_decode(priors[None], reg_flat)
    top = filter_scores_and_topk(scores, score_thr, nms_pre)
    sel = torch.gather(boxes, 1,
                       top.keep_idxs.long()[..., None].expand(-1, -1, 4))
    return nms_detections(sel, top, img_hw, scale_factor, rescale, nms_iou,
                          max_per_img)
