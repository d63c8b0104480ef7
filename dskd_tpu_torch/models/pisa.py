"""PISA, Prime Sample Attention (port of dskd_tpu/models/pisa.py
``_rank_desc``, ``isr_p_weights`` and ``carl_loss``), the two pieces that
``pisa_retinanet`` adds to RetinaNet's loss.

ISR-P reweights the positives' classification loss: the first
``MAX_POS`` positives of the flattened batch (a stable positives-first
sort) are ranked by IoU within their (GT, class) group, that rank lifts
each IoU into an IoU-HLR score, a second rank within the class maps
linearly to a weight, sharpened by (bias + w (1 - bias))^k, and the
weights are scaled so that the positives' focal loss keeps its sum.
Positives past the cap keep weight 1. CARL adds each positive's L1 again,
weighted by its own class score (bias + (1 - bias) sigmoid)^k normalised
to sum to the positives' count; the weight keeps its gradient, so CARL
trains the classifier too. Each rank is a masked (P, P) count, ties broken
by index.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import losses as L
from ..core.anchors import delta2bbox
from ..core.boxes import bbox_overlaps

ISR_K = 2.0
ISR_BIAS = 0.0
CARL_K = 1.0
CARL_BIAS = 0.2
MAX_POS = 256


def _rank_desc(vals, same_group, valid):
    """rank_i = the count of valid j in i's group with a higher value, or
    the same value and a lower index."""
    P = vals.shape[0]
    i_idx = torch.arange(P, device=vals.device)
    higher = (vals[None, :] > vals[:, None]) | (
        (vals[None, :] == vals[:, None]) & (i_idx[None, :] < i_idx[:, None]))
    return (higher & same_group & valid[None, :]).sum(1)


def isr_p_weights(cls_flat, deltas, anchors_flat, labels_flat, pos_flat,
                  gt_flat, tgt_deltas, num_classes: int, k: float = ISR_K,
                  bias: float = ISR_BIAS, target_stds=(1., 1., 1., 1.)):
    """(BN,) classification weights: 1 everywhere but at the first
    ``MAX_POS`` positives, which get their IoU-HLR importance. The caller
    detaches the score inputs."""
    BN = cls_flat.shape[0]
    P = min(MAX_POS, BN)
    idx = torch.argsort((~pos_flat).to(torch.uint8), stable=True)[:P]
    valid = pos_flat[idx]
    neg = torch.full_like(idx, -1)
    lab = torch.where(valid, labels_flat[idx].long(), neg)
    gt = torch.where(valid, gt_flat[idx].long(), neg)

    pred_box = delta2bbox(anchors_flat[idx], deltas[idx], stds=target_stds)
    tgt_box = delta2bbox(anchors_flat[idx], tgt_deltas[idx],
                         stds=target_stds)
    ious = bbox_overlaps(pred_box, tgt_box, is_aligned=True)

    cnt_c = (lab[None, :] == torch.arange(num_classes,
                                          device=lab.device)[:, None]).sum(1)
    max_l_num = cnt_c.max().clamp(min=1).to(ious.dtype)
    same_cls = lab[None, :] == lab[:, None]
    same_gt = (gt[None, :] == gt[:, None]) & same_cls
    rank_gt = _rank_desc(ious, same_gt, valid)
    iou_hlr = ious + (max_l_num - rank_gt.to(ious.dtype))
    rank_cls = _rank_desc(iou_hlr, same_cls, valid).to(ious.dtype)
    w = (max_l_num - rank_cls) / max_l_num
    imp = (bias + w * (1.0 - bias)) ** k

    # the positives' focal loss keeps its sum under the weights
    onehot = F.one_hot(lab.clamp(0, num_classes - 1),
                       num_classes).to(cls_flat.dtype)
    per = L.sigmoid_focal_loss(cls_flat[idx], onehot,
                               reduction="none").sum(-1) * valid
    ratio = per.sum() / (per * imp).sum().clamp(min=1e-12)
    ones = torch.ones_like(imp)
    imp = torch.where(valid, imp * ratio, ones)
    return cls_flat.new_ones(BN).index_put((idx,), imp)


def carl_loss(cls_flat, labels_flat, pos_flat, deltas, tgt_deltas,
              num_total_pos, num_classes: int, k: float = CARL_K,
              bias: float = CARL_BIAS):
    """The positives' L1 over ``num_total_pos``, each weighted by its own
    sigmoid class score (with gradient), the weights scaled to sum to the
    positives' count."""
    safe = labels_flat.long().clamp(0, num_classes - 1)
    score = torch.gather(torch.sigmoid(cls_flat), 1, safe[:, None])[:, 0]
    posf = pos_flat.to(cls_flat.dtype)
    w = ((bias + (1.0 - bias) * score) ** k) * posf
    num_pos = posf.sum().clamp(min=1.0)
    w = w * (num_pos / w.sum().clamp(min=1e-12))
    reg = L.l1_loss(deltas, tgt_deltas, reduction="none") / num_total_pos
    return (reg * w[:, None]).sum()
