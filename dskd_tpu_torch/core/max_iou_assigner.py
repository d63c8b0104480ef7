"""Max-IoU assignment (port of dskd_tpu/core/max_iou_assigner.py
``max_iou_assign`` and ``max_iou_assign_ious``), over a batch of images at
once. The samplers of that module are not ported.

A box whose best IoU with a valid GT reaches ``pos_iou_thr`` is positive
for that GT (the first of equal ones); one below ``neg_iou_thr`` is
negative; one in between is ignored. With ``match_low_quality`` each valid
GT whose best IoU reaches ``min_pos_iou`` then also takes its best box (the
first of equal ones), in GT order, so where two GTs share a best box the
later one wins: a scatter of the largest GT index, which CUDA's
``index_put_`` with repeated indices would not promise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import bbox_overlaps


class MaxIoUResult(NamedTuple):
    assigned_gt: torch.Tensor   # (B, N) GT index, -1 negative, -2 ignored
    labels: torch.Tensor        # (B, N) int64 label, num_classes if not pos
    max_ious: torch.Tensor      # (B, N)


def max_iou_assign(boxes: torch.Tensor, gt_bboxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   num_classes: int, pos_iou_thr: float = 0.7,
                   neg_iou_thr: float = 0.3, min_pos_iou: float = 0.3,
                   match_low_quality: bool = True) -> MaxIoUResult:
    """boxes (N, 4) or (B, N, 4) xyxy; gt_* (B, G, ...) padded."""
    B = gt_bboxes.shape[0]
    if boxes.dim() == 2:
        boxes = boxes[None].expand(B, -1, -1)
    return max_iou_assign_ious(bbox_overlaps(boxes, gt_bboxes), gt_labels,
                               gt_valid, num_classes, pos_iou_thr,
                               neg_iou_thr, min_pos_iou, match_low_quality)


def max_iou_assign_ious(ious: torch.Tensor, gt_labels: torch.Tensor,
                        gt_valid: torch.Tensor, num_classes: int,
                        pos_iou_thr: float = 0.7, neg_iou_thr: float = 0.3,
                        min_pos_iou: float = 0.3,
                        match_low_quality: bool = True) -> MaxIoUResult:
    """The assignment from a precomputed (B, N, G) overlap matrix."""
    B, N, G = ious.shape
    ious = torch.where(gt_valid[:, None], ious, torch.full_like(ious, -1.0))
    max_iou = ious.amax(dim=2)
    argmax_gt = ious.argmax(dim=2)                          # first on ties
    neg = torch.full_like(argmax_gt, -1)
    assigned = torch.where(max_iou >= pos_iou_thr, argmax_gt, neg)
    ignore = (max_iou >= neg_iou_thr) & (max_iou < pos_iou_thr)
    assigned = torch.where(ignore, torch.full_like(assigned, -2), assigned)
    if match_low_quality:
        gt_best_iou = ious.amax(dim=1)                      # (B, G)
        gt_best = ious.argmax(dim=1)                        # first on ties
        ok = gt_valid & (gt_best_iou >= min_pos_iou)
        idx = torch.where(ok, gt_best, torch.full_like(gt_best, N))
        g = torch.arange(G, device=ious.device).expand(B, G)
        last = torch.full((B, N + 1), -1, dtype=g.dtype, device=ious.device)
        last = last.scatter_reduce(1, idx, g, "amax")[:, :N]
        assigned = torch.where(last >= 0, last, assigned)
    pos = assigned >= 0
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1,
                                           assigned.clamp(0, G - 1)),
                         num_classes)
    return MaxIoUResult(assigned, labels, max_iou)
