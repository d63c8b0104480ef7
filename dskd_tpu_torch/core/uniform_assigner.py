"""YOLOF's uniform matching (port of dskd_tpu/core/uniform_assigner.py
``uniform_assign``), over a batch of images at once.

Each GT takes its ``match_times`` nearest predicted boxes and as many
nearest anchors by cxcywh L1 cost; a candidate whose anchor IoU with its GT
is below ``pos_ignore_thr`` is ignored; a prediction whose best IoU with a
valid GT exceeds ``neg_ignore_thr`` leaves the negatives. Where two GTs pick
one anchor the later candidate wins, as the reference's sequential scatter;
the candidates of padded GTs are dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import bbox_overlaps, bbox_xyxy_to_cxcywh


class UniformAssignResult(NamedTuple):
    labels: torch.Tensor           # (B, N) int64, background = num_classes
    label_weights: torch.Tensor    # (B, N) f32: 1 pos/neg, 0 ignored
    cand_anchor_idx: torch.Tensor  # (B, 2kG) candidate anchor index
    cand_gt_idx: torch.Tensor      # (B, 2kG) candidate GT index
    cand_pos_mask: torch.Tensor    # (B, 2kG) bool: counted in the box loss
    num_pos: torch.Tensor          # (B,) anchors with a positive GT


def _smallest_k(cost: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, G) -> (B, G, k): the rows of the k smallest costs per column,
    ties to the lower row, as ``lax.top_k`` of -cost orders them."""
    return torch.sort(cost.transpose(1, 2), dim=-1, stable=True)[1][..., :k]


def uniform_assign(bbox_pred: torch.Tensor, anchors: torch.Tensor,
                   gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, num_classes: int,
                   match_times: int = 4, pos_ignore_thr: float = 0.15,
                   neg_ignore_thr: float = 0.7) -> UniformAssignResult:
    """bbox_pred (B, N, 4) and anchors (N, 4) xyxy; gt_* (B, G, ...)
    padded."""
    B, N = bbox_pred.shape[:2]
    G = gt_bboxes.shape[1]
    k = match_times
    dev = bbox_pred.device
    pred_c = bbox_xyxy_to_cxcywh(bbox_pred)
    anc_c = bbox_xyxy_to_cxcywh(anchors)
    gt_c = bbox_xyxy_to_cxcywh(gt_bboxes)
    cost_pred = (pred_c[:, :, None] - gt_c[:, None]).abs().sum(-1)
    cost_anc = (anc_c[None, :, None] - gt_c[:, None]).abs().sum(-1)
    # per round of k: the predictions of every GT, then their anchors
    indexes = torch.cat([_smallest_k(cost_pred, k).transpose(1, 2),
                         _smallest_k(cost_anc, k).transpose(1, 2)],
                        dim=2).reshape(B, 2 * k * G)
    cand_gt = torch.arange(G, device=dev).repeat(2 * k)[None].expand(B, -1)

    pred_overlaps = bbox_overlaps(bbox_pred, gt_bboxes)          # (B, N, G)
    anchor_overlaps = bbox_overlaps(anchors[None].expand(B, -1, -1),
                                    gt_bboxes)
    pred_max = torch.where(gt_valid[:, None], pred_overlaps,
                           torch.zeros_like(pred_overlaps)).amax(-1)
    pos_ious = anchor_overlaps[torch.arange(B, device=dev)[:, None],
                               indexes, cand_gt]
    cand_valid = torch.gather(gt_valid, 1, cand_gt)
    pos_ignore = (pos_ious < pos_ignore_thr) | ~cand_valid
    # per candidate: its GT + 1, or -1 where ignored
    cand_val = torch.where(pos_ignore, -1, cand_gt + 1)
    base = torch.where(pred_max > neg_ignore_thr, -1, 0)

    # last-wins scatter: the highest candidate position per anchor; the
    # padded GTs' candidates go to a dropped column N
    order = torch.arange(2 * k * G, device=dev)[None].expand(B, -1)
    scatter_idx = torch.where(cand_valid, indexes, N)
    last = torch.full((B, N + 1), -1, dtype=order.dtype, device=dev)
    last = last.scatter_reduce(1, scatter_idx, order, "amax")[:, :N]
    assigned = torch.where(last >= 0,
                           torch.gather(cand_val, 1, last.clamp(min=0)),
                           base)
    pos_mask = assigned > 0
    safe_gt = (assigned - 1).clamp(0, G - 1)
    labels = torch.where(pos_mask, torch.gather(gt_labels.long(), 1, safe_gt),
                         num_classes)
    label_weights = (pos_mask | (assigned == 0)).float()
    return UniformAssignResult(labels, label_weights, indexes, cand_gt,
                               ~pos_ignore & cand_valid, pos_mask.sum(1))
