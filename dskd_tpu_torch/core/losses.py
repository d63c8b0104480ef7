"""Detection losses with the weight + avg_factor protocol (port of
dskd_tpu/core/losses.py ``weight_reduce_loss``,
``binary_cross_entropy_with_logits``, ``l1_loss``, ``mse_loss``,
``giou_loss``, ``quality_focal_loss`` and ``distribution_focal_loss``).

Every loss is ``loss(pred, target, weight=None, reduction='mean',
avg_factor=None)``: the elementwise loss is multiplied by ``weight``; without
``avg_factor`` it is reduced by ``reduction``; with ``avg_factor`` and
'mean' it is ``loss.sum() / (avg_factor + eps)`` (eps = f32 machine eps);
``avg_factor`` with 'sum' raises. The other losses of the JAX module are not
ported yet (ROADMAP A3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .boxes import bbox_overlaps

_F32_EPS = float(torch.finfo(torch.float32).eps)


def weight_reduce_loss(loss, weight=None, reduction="mean", avg_factor=None):
    """Apply the elementwise weight, then reduce (the reference protocol)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        if reduction == "none":
            return loss
        if reduction == "mean":
            return loss.mean()
        if reduction == "sum":
            return loss.sum()
        raise ValueError(reduction)
    if reduction == "mean":
        return loss.sum() / (avg_factor + _F32_EPS)
    if reduction == "none":
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


def _weighted(elem_fn):
    def wrapper(pred, target, weight=None, reduction="mean", avg_factor=None,
                **kwargs):
        loss = elem_fn(pred, target, **kwargs)
        return weight_reduce_loss(loss, weight, reduction, avg_factor)
    wrapper.__name__ = elem_fn.__name__
    wrapper.__doc__ = elem_fn.__doc__
    return wrapper


def binary_cross_entropy_with_logits(pred, target):
    """Elementwise BCE on logits: max(x, 0) - x*t + log1p(exp(-|x|))."""
    return (torch.clamp(pred, min=0) - pred * target
            + torch.log1p(torch.exp(-pred.abs())))


@_weighted
def l1_loss(pred, target):
    return (pred - target).abs()


@_weighted
def mse_loss(pred, target):
    return (pred - target) ** 2


@_weighted
def giou_loss(pred, target, eps: float = 1e-7):
    """1 - GIoU of aligned xyxy boxes."""
    return 1.0 - bbox_overlaps(pred, target, mode="giou", is_aligned=True,
                               eps=eps)


@_weighted
def quality_focal_loss(pred, target, beta: float = 2.0):
    """QFL on (N, C) logits; target = (labels (N,) with background == C,
    IoU score (N,)). Returns the per-row loss (N,), summed over classes."""
    label, score = target
    num_classes = pred.shape[-1]
    pred_sigmoid = torch.sigmoid(pred)
    loss = binary_cross_entropy_with_logits(
        pred, torch.zeros_like(pred)) * pred_sigmoid ** beta
    is_pos = (label >= 0) & (label < num_classes)
    onehot = F.one_hot(label.clamp(0, num_classes - 1).long(),
                       num_classes).to(pred.dtype)
    pred_at = (pred * onehot).sum(-1)
    sig_at = (pred_sigmoid * onehot).sum(-1)
    pos_elem = binary_cross_entropy_with_logits(pred_at, score) * (
        score - sig_at).abs() ** beta
    neg_at = (loss * onehot).sum(-1)
    loss_rows = loss.sum(-1)
    return torch.where(is_pos, loss_rows - neg_at + pos_elem, loss_rows)


@_weighted
def distribution_focal_loss(pred, label):
    """DFL: cross entropy to the two integer bins around a continuous
    target. pred (N, n+1) logits (the flagship feeds sigmoid outputs);
    label (N,) in bin units."""
    dis_left = label.to(torch.int32)        # truncation, as astype(int32)
    dis_right = dis_left + 1
    weight_left = dis_right.to(pred.dtype) - label
    weight_right = label - dis_left.to(pred.dtype)
    logp = torch.log_softmax(pred, dim=-1)
    n_bins = pred.shape[-1]
    ce_left = -torch.gather(logp, -1, dis_left.clamp(0, n_bins - 1)
                            .long()[..., None])[..., 0]
    ce_right = -torch.gather(logp, -1, dis_right.clamp(0, n_bins - 1)
                             .long()[..., None])[..., 0]
    return ce_left * weight_left + ce_right * weight_right
