"""Detection loss of the GFL-Deformable-DETR head (port of
dskd_tpu/models/gfl_detr_loss.py ``DetLossConfig``, ``LayerTargets``,
``assign_all_layers``, ``single_layer_losses`` and ``detection_loss``).

Per decoder layer: one-to-one Hungarian assignment on the QFL + L1 + GIoU
cost (all nl * B solves in one batched auction), then QFL against the IoU
score (not detached, as in the reference), L1 on normalized cxcywh, GIoU on
image-scaled xyxy and DFL on the sigmoided bins against (w, w, h, h) / 2,
each averaged over the global count of valid GT (clamped at 1). Padded GT
carry zero weight.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core import losses as L
from ..core.boxes import (bbox_cxcywh_to_xyxy, bbox_overlaps,
                          bbox_xyxy_to_cxcywh)
from ..core.matching import gfl_match_cost, hungarian_assign
from .gfl_detr_head import decode_boxes


class DetLossConfig(NamedTuple):
    num_classes: int = 80
    reg_max: int = 16
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 5.0
    loss_iou_weight: float = 2.0
    loss_dfl_weight: float = 0.5
    cost_cls_weight: float = 2.0
    cost_reg_weight: float = 5.0
    cost_iou_weight: float = 2.0


class LayerTargets(NamedTuple):
    """Per-decoder-layer assignment products, shapes (nl, B, Q, ...)."""
    labels: torch.Tensor        # (nl, B, Q) int64, num_classes = background
    bbox_targets: torch.Tensor  # (nl, B, Q, 4) normalized cxcywh
    pos_mask: torch.Tensor      # (nl, B, Q) bool
    assigned_gt: torch.Tensor   # (nl, B, Q) int64 GT index or -1


@torch.no_grad()
def assign_all_layers(cls_scores, bbox_cxcywh, gt_bboxes, gt_labels,
                      gt_valid, img_hw, cfg: DetLossConfig
                      ) -> Tuple[LayerTargets, torch.Tensor]:
    """Hungarian-assign every (layer, image) pair in one batched auction
    solve (the JAX package's default matcher; ``lap_jv`` is not ported).
    Returns the targets and the total count of fallback-placed rows."""
    nl, B, Q, K = cls_scores.shape
    G = gt_bboxes.shape[1]

    def per_layer(t):
        return t[None].expand((nl,) + t.shape).reshape((nl * B,) + t.shape[1:])

    boxes, labels, valid, hw = (per_layer(t) for t in (
        gt_bboxes, gt_labels, gt_valid, img_hw))
    cost = gfl_match_cost(
        cls_scores.reshape(nl * B, Q, K), bbox_cxcywh.reshape(nl * B, Q, 4),
        boxes, labels, hw, cls_weight=cfg.cost_cls_weight,
        reg_weight=cfg.cost_reg_weight, iou_weight=cfg.cost_iou_weight)
    res = hungarian_assign(cost, valid, labels)
    safe = res.assigned_gt.clamp(0, G - 1)
    hwf = hw.to(bbox_cxcywh.dtype)
    factor = torch.stack([hwf[:, 1], hwf[:, 0], hwf[:, 1], hwf[:, 0]],
                         -1)[:, None, :]
    gt_cxcywh = bbox_xyxy_to_cxcywh(boxes / factor)
    tgt = torch.gather(gt_cxcywh, 1, safe[..., None].expand(-1, -1, 4))
    tgt = torch.where(res.pos_mask[..., None], tgt, torch.zeros_like(tgt))
    lbl = torch.where(res.pos_mask, torch.gather(labels.long(), 1, safe),
                      cfg.num_classes)
    targets = LayerTargets(lbl.reshape(nl, B, Q),
                           tgt.reshape(nl, B, Q, 4),
                           res.pos_mask.reshape(nl, B, Q),
                           res.assigned_gt.reshape(nl, B, Q))
    return targets, res.num_fallback.sum()


def single_layer_losses(cls_scores, bbox_preds, bbox_cxcywh,
                        targets: LayerTargets, img_hw, num_total_pos,
                        cfg: DetLossConfig) -> Dict[str, torch.Tensor]:
    """Losses of one decoder layer; inputs are (B, Q, ...) slices."""
    B, Q, K = cls_scores.shape
    labels, bbox_targets, pos = (targets.labels, targets.bbox_targets,
                                 targets.pos_mask)
    pred_xyxy = bbox_cxcywh_to_xyxy(bbox_cxcywh)
    tgt_xyxy = bbox_cxcywh_to_xyxy(bbox_targets)
    score = torch.where(pos, bbox_overlaps(pred_xyxy, tgt_xyxy,
                                           is_aligned=True),
                        torch.zeros((), device=pos.device))
    loss_cls = cfg.loss_cls_weight * L.quality_focal_loss(
        cls_scores.reshape(-1, K), (labels.reshape(-1), score.reshape(-1)),
        weight=torch.ones((B * Q,), dtype=cls_scores.dtype,
                          device=cls_scores.device),
        avg_factor=num_total_pos)

    hw = img_hw.to(bbox_cxcywh.dtype)
    factors = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                          -1)[:, None, :]                     # (B, 1, 4)
    bbox_weights = pos[..., None].to(bbox_cxcywh.dtype).expand(B, Q, 4)
    loss_iou = cfg.loss_iou_weight * L.giou_loss(
        (pred_xyxy * factors).reshape(-1, 4),
        (tgt_xyxy * factors).reshape(-1, 4),
        weight=bbox_weights.reshape(-1, 4)[:, 0], avg_factor=num_total_pos)
    loss_bbox = cfg.loss_bbox_weight * L.l1_loss(
        bbox_cxcywh.reshape(-1, 4), bbox_targets.reshape(-1, 4),
        weight=bbox_weights.reshape(-1, 4), avg_factor=num_total_pos)

    n_bins = cfg.reg_max + 1
    pred_corners = bbox_preds[..., 2:].reshape(-1, n_bins)
    # (w, w, h, h) / 2 targets: the reference's quirk, kept for parity
    target_corners = bbox_targets[..., 2:].repeat_interleave(
        2, dim=-1).reshape(-1) / 2.0
    loss_dfl = cfg.loss_dfl_weight * L.distribution_focal_loss(
        pred_corners, target_corners, weight=bbox_weights.reshape(-1),
        avg_factor=num_total_pos * 4)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_iou=loss_iou,
                loss_dfl=loss_dfl)


def detection_loss(cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_valid,
                   img_hw, cfg: DetLossConfig,
                   assigned: Optional[Tuple[LayerTargets,
                                            torch.Tensor]] = None
                   ) -> Tuple[Dict[str, torch.Tensor], LayerTargets]:
    """Multi-layer detection loss.

    cls_scores (nl, B, Q, K) logits; bbox_preds (nl, B, Q, 2+4*(rm+1));
    gt_bboxes (B, G, 4) xyxy input coords; gt_labels, gt_valid (B, G);
    img_hw (B, 2). ``assigned`` replaces the assignment by a given
    (targets, fallback count), to compare two devices under one matching.

    Returns the loss dict (last layer unprefixed, earlier layers ``d{i}.``,
    plus the logged, unsummed ``auction_fallback``) and the per-layer
    targets the distill losses read.
    """
    nl = cls_scores.shape[0]
    bbox_cxcywh = decode_boxes(bbox_preds, cfg.reg_max)
    if assigned is None:
        assigned = assign_all_layers(cls_scores, bbox_cxcywh, gt_bboxes,
                                     gt_labels, gt_valid, img_hw, cfg)
    targets, num_fallback = assigned
    num_total_pos = torch.clamp(gt_valid.sum().to(cls_scores.dtype), min=1.0)
    losses = {"auction_fallback": num_fallback.to(torch.float32)}
    for i in range(nl):
        layer_t = LayerTargets(*(t[i] for t in targets))
        ld = single_layer_losses(cls_scores[i], bbox_preds[i],
                                 bbox_cxcywh[i], layer_t, img_hw,
                                 num_total_pos, cfg)
        prefix = "" if i == nl - 1 else f"d{i}."
        for k, v in ld.items():
            losses[prefix + k] = v
    return losses, targets
