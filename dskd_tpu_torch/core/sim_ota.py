"""The SimOTA assigner of the YOLOX-style YOLOY (port of
dskd_tpu/core/sim_ota.py ``sim_ota_assign``), over a batch of images at
once.

A prior is a candidate of a GT when its centre lies in the GT box or
within 2.5 strides of the GT's centre; the cost is BCE(sqrt(cls x obj),
one-hot) + 3 x -log IoU, plus 1e8 outside the intersection of box and
centre region; each GT takes its dynamic_k = max(1, int(sum of its 10
best IoUs)) cheapest priors, and a prior taken by several GTs keeps the
cheapest. The ranks come from a stable sort (ties to the lower prior, as
``jnp.argsort``) and the conflicts from ``argmin`` (the first GT on ties).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .boxes import bbox_overlaps

_INF = 1e8
_EPS = 1e-7


class SimOTAResult(NamedTuple):
    assigned_gt: torch.Tensor   # (B, N) GT index or -1
    labels: torch.Tensor        # (B, N) label or num_classes
    pos_mask: torch.Tensor      # (B, N)
    max_ious: torch.Tensor      # (B, N) IoU with the assigned GT, 0 if none
    num_pos: torch.Tensor       # (B,)


def sim_ota_assign(pred_scores: torch.Tensor, priors: torch.Tensor,
                   decoded_bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   num_classes: int, center_radius: float = 2.5,
                   candidate_topk: int = 10, iou_weight: float = 3.0,
                   cls_weight: float = 1.0) -> SimOTAResult:
    """pred_scores (B, N, C) sigmoid(cls) x sigmoid(obj); priors (N, 4)
    [cx, cy, stride_w, stride_h] with the half-stride offset; decoded_bboxes
    (B, N, 4) xyxy; gt_* (B, G, ...) padded. No input needs a gradient."""
    B, N = pred_scores.shape[:2]
    G = gt_bboxes.shape[1]
    cx, cy = priors[:, 0, None], priors[:, 1, None]       # (N, 1)
    sw, sh = priors[:, 2, None], priors[:, 3, None]
    gx1, gy1, gx2, gy2 = (gt_bboxes[:, None, :, i] for i in range(4))
    in_box = (cx > gx1) & (cx < gx2) & (cy > gy1) & (cy < gy2)  # (B, N, G)
    gcx, gcy = (gx1 + gx2) / 2, (gy1 + gy2) / 2
    in_center = ((cx > gcx - center_radius * sw)
                 & (cx < gcx + center_radius * sw)
                 & (cy > gcy - center_radius * sh)
                 & (cy < gcy + center_radius * sh))
    valid_prior = (in_box | in_center).any(2)               # (B, N)
    in_both = in_box & in_center

    ious = bbox_overlaps(decoded_bboxes, gt_bboxes)         # (B, N, G)
    iou_cost = -torch.log(ious + _EPS)
    onehot = F.one_hot(gt_labels.long().clamp(0, num_classes - 1),
                       num_classes).to(pred_scores.dtype)  # (B, G, C)
    sq = torch.sqrt(pred_scores.clamp(_EPS, 1.0))
    bce_pos = -torch.log(sq)
    bce_neg = -torch.log((1 - sq).clamp(min=_EPS))
    cls_cost = (bce_pos @ onehot.transpose(1, 2)
                + bce_neg @ (1 - onehot).transpose(1, 2))   # (B, N, G)
    zero = torch.zeros((), dtype=ious.dtype, device=ious.device)
    inf = torch.full((), _INF, dtype=ious.dtype, device=ious.device)
    cost = (cls_weight * cls_cost + iou_weight * iou_cost
            + torch.where(in_both, zero, inf)
            + torch.where(valid_prior[..., None], zero, inf)
            + torch.where(gt_valid[:, None], zero, inf))

    # dynamic k per GT from its candidate_topk best IoUs (a truncated sum)
    masked_ious = torch.where(valid_prior[..., None] & gt_valid[:, None],
                              ious, zero)
    k = min(candidate_topk, N)
    topk_ious = masked_ious.transpose(1, 2).topk(k, dim=-1).values
    dynamic_ks = topk_ious.sum(-1).to(torch.int32).clamp(min=1)   # (B, G)

    # the rank of each prior's cost per GT; selected if rank < dynamic_k
    order = torch.argsort(cost, dim=1, stable=True)         # (B, N, G)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(N, device=cost.device)[None, :, None]
        .expand(B, N, G).contiguous())
    selected = (ranks < dynamic_ks[:, None]) & (cost < _INF)

    # conflicts: the cheapest GT
    assigned = torch.where(selected, cost, inf).argmin(2)
    pos = selected.any(2)
    assigned = torch.where(pos, assigned, -1)
    safe = assigned.clamp(0, G - 1)
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, safe),
                         num_classes)
    max_ious = torch.where(pos, torch.gather(ious, 2, safe[..., None])[..., 0],
                           zero)
    return SimOTAResult(assigned, labels, pos, max_ious, pos.sum(1))
