"""Detection losses with the weight + avg_factor protocol (port of
dskd_tpu/core/losses.py ``weight_reduce_loss``,
``binary_cross_entropy_with_logits``, ``l1_loss``, ``smooth_l1_loss``,
``mse_loss``, ``giou_loss``, ``iou_loss``, ``diou_loss``, ``ciou_loss``,
``quality_focal_loss``, ``distribution_focal_loss``, ``kd_kl_div_loss``,
``sigmoid_focal_loss``, ``gaussian_focal_loss``, ``varifocal_loss``,
``bce_loss``, ``cross_entropy_loss``, ``square_iou_loss``, ``ghm_c_loss``
and ``ghm_r_loss``), plus
``kd_kl_div_loss_outer``, the port's closed form of one broadcast of
``kd_kl_div_loss``.

Every loss is ``loss(pred, target, weight=None, reduction='mean',
avg_factor=None)``: the elementwise loss is multiplied by ``weight``; without
``avg_factor`` it is reduced by ``reduction``; with ``avg_factor`` and
'mean' it is ``loss.sum() / (avg_factor + eps)`` (eps = f32 machine eps);
``avg_factor`` with 'sum' raises. The other losses of the JAX module are not
ported yet (ROADMAP A3).
"""
from __future__ import annotations

import math

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
def smooth_l1_loss(pred, target, beta: float = 1.0):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


@_weighted
def mse_loss(pred, target):
    return (pred - target) ** 2


@_weighted
def giou_loss(pred, target, eps: float = 1e-7):
    """1 - GIoU of aligned xyxy boxes."""
    return 1.0 - bbox_overlaps(pred, target, mode="giou", is_aligned=True,
                               eps=eps)


@_weighted
def iou_loss(pred, target, eps: float = 1e-6, linear: bool = True):
    """1 - IoU (``linear``) or -log IoU of aligned xyxy boxes, the IoU
    clamped at ``eps``."""
    ious = bbox_overlaps(pred, target, mode="iou", is_aligned=True,
                         eps=eps).clamp(min=eps)
    return 1 - ious if linear else -torch.log(ious)


@_weighted
def square_iou_loss(pred, target, eps: float = 1e-16):
    """1 - IoU^2 of aligned xyxy boxes (YOLOX's IoULoss(mode='square'))."""
    ious = bbox_overlaps(pred, target, mode="iou", is_aligned=True, eps=eps)
    return 1.0 - ious * ious


def _diou_terms(pred, target, eps):
    """IoU and the centre-distance penalty rho^2 / c^2 of aligned boxes,
    c the diagonal of the enclosing box."""
    ious = bbox_overlaps(pred, target, mode="iou", is_aligned=True, eps=eps)
    enclose_lt = torch.minimum(pred[..., :2], target[..., :2])
    enclose_rb = torch.maximum(pred[..., 2:], target[..., 2:])
    cw = (enclose_rb[..., 0] - enclose_lt[..., 0]).clamp(min=0)
    ch = (enclose_rb[..., 1] - enclose_lt[..., 1]).clamp(min=0)
    c2 = cw ** 2 + ch ** 2 + eps
    px = (pred[..., 0] + pred[..., 2]) / 2
    py = (pred[..., 1] + pred[..., 3]) / 2
    tx = (target[..., 0] + target[..., 2]) / 2
    ty = (target[..., 1] + target[..., 3]) / 2
    rho2 = (px - tx) ** 2 + (py - ty) ** 2
    return ious, rho2 / c2


@_weighted
def diou_loss(pred, target, eps: float = 1e-7):
    """Distance-IoU: 1 - IoU + rho^2 / c^2."""
    ious, penalty = _diou_terms(pred, target, eps)
    return 1 - ious + penalty


@_weighted
def ciou_loss(pred, target, eps: float = 1e-7):
    """Complete-IoU: DIoU + alpha * v, v the aspect-ratio term and alpha
    detached."""
    ious, penalty = _diou_terms(pred, target, eps)
    w1 = pred[..., 2] - pred[..., 0] + eps
    h1 = pred[..., 3] - pred[..., 1] + eps
    w2 = target[..., 2] - target[..., 0] + eps
    h2 = target[..., 3] - target[..., 1] + eps
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (1 - ious + v + eps)).detach()
    return 1 - ious + penalty + alpha * v


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


@_weighted
def kd_kl_div_loss(pred, soft_label, T: float = 10.0, detach_target=True):
    """KL(softmax(t/T) || softmax(s/T)) * T^2, mean over the class axis,
    with 0 * log 0 := 0."""
    target = torch.softmax(soft_label / T, dim=-1)
    if detach_target:
        target = target.detach()
    logp = torch.log_softmax(pred / T, dim=-1)
    log_t = torch.where(target > 0, torch.log(target.clamp(min=_F32_EPS)),
                        torch.zeros_like(target))
    return (target * (log_t - logp)).mean(dim=-1) * (T * T)


@_weighted
def sigmoid_focal_loss(pred, target, gamma: float = 2.0, alpha: float = 0.25):
    """Sigmoid focal loss on logits; target one-hot or of pred's shape."""
    p = torch.sigmoid(pred)
    ce = binary_cross_entropy_with_logits(pred, target)
    p_t = p * target + (1 - p) * (1 - target)
    alpha_t = alpha * target + (1 - alpha) * (1 - target)
    return alpha_t * (1 - p_t) ** gamma * ce


@_weighted
def gaussian_focal_loss(pred, gaussian_target, alpha: float = 2.0,
                        gamma: float = 4.0):
    """CornerNet/CenterNet heatmap focal loss on post-sigmoid ``pred``:
    exact-1 targets are positives, the rest are discounted by
    (1 - target)^gamma."""
    eps = 1e-12
    pos_w = (gaussian_target == 1.0).to(pred.dtype)
    neg_w = (1 - gaussian_target) ** gamma
    pos = -torch.log(pred + eps) * (1 - pred) ** alpha * pos_w
    neg = -torch.log(1 - pred + eps) * pred ** alpha * neg_w * (1 - pos_w)
    return pos + neg


@_weighted
def varifocal_loss(pred, target, alpha: float = 0.75, gamma: float = 2.0,
                   iou_weighted: bool = True):
    """Varifocal loss on logits: positives (target = IoU quality > 0)
    weighted by the quality (or 1), negatives by alpha * p^gamma."""
    p = torch.sigmoid(pred)
    pos = (target > 0).to(pred.dtype)
    focal_w = (target if iou_weighted else 1.0) * pos \
        + alpha * (p ** gamma) * (1 - pos)
    return binary_cross_entropy_with_logits(pred, target) * focal_w


@_weighted
def bce_loss(pred, target):
    """Weighted BCE on logits (mmdet's CrossEntropyLoss(use_sigmoid=True),
    the ATSS and FCOS centerness loss)."""
    return binary_cross_entropy_with_logits(pred, target)


@_weighted
def cross_entropy_loss(pred, label, class_weight=None):
    """Softmax CE with integer labels, scaled by ``class_weight[label]``;
    (N, C) x (N,) -> (N,)."""
    label = label.long()
    loss = -torch.gather(torch.log_softmax(pred, dim=-1), -1,
                         label[..., None])[..., 0]
    if class_weight is not None:
        loss = loss * class_weight[label]
    return loss


def kd_kl_div_loss_outer(pred, soft_label, weight, avg_factor,
                         T: float = 10.0):
    """``kd_kl_div_loss(pred, soft_label, weight=weight[:, None],
    avg_factor=avg_factor, T=T)`` without its (N, N) product: the (N, 1)
    weight broadcasts against the (N,) per-row KL to (N, N), whose sum is
    (sum of weight) x (sum of KL). The JAX package's YOLOF and YOLOY pass
    such a weight (the reference's shapes); at their N of 10^4-10^5 rows
    the product would not fit, so the port sums in this order instead."""
    kl = kd_kl_div_loss(pred, soft_label, T=T, reduction="none")
    return weight.sum() * kl.sum() / (avg_factor + _F32_EPS)


def _ghm_edges(bins: int, like: torch.Tensor, last=None) -> torch.Tensor:
    """The bins + 1 edges i / bins, the last one 1 + 1e-6 or ``last``,
    computed in f32 as JAX's are, then in ``like``'s dtype and on its
    device."""
    edges = torch.arange(bins + 1, dtype=torch.float32) / bins
    if last is None:
        edges[-1] += 1e-6
    else:
        edges[-1] = last
    return edges.to(like.device, like.dtype)


def _ghm_weights(g, valid, tot, edges, bins: int, momentum: float, acc_sum):
    """GHM's per-element weights: uniform bins of the gradient norm ``g``
    (``edges[i] <= g < edges[i + 1]``), weight ``tot`` / (the bin's count,
    or its EMA ``acc_sum`` when ``momentum`` > 0) over the number of bins
    occupied. Only the occupied bins' EMA moves. Returns (weights of
    ``g``'s shape, the new EMA)."""
    gf = g.reshape(-1)
    vf = valid.reshape(-1)
    idx = (torch.searchsorted(edges, gf.contiguous(), right=True) - 1).clamp(
        0, bins - 1)
    # counted in int64: JAX's f32 weights stop counting at 2^24 elements,
    # which RetinaNet's P3 at 800x1344 passes from B=2 on (80 classes)
    num_in_bin = torch.bincount(torch.where(vf, idx, bins),
                                minlength=bins + 1)[:bins].to(g.dtype)
    occupied = num_in_bin > 0
    n = occupied.sum().to(g.dtype).clamp(min=1.0)
    if momentum > 0:
        new_acc = torch.where(occupied, momentum * acc_sum
                              + (1 - momentum) * num_in_bin, acc_sum)
        denom = new_acc
    else:
        new_acc = acc_sum
        denom = num_in_bin
    per_bin = torch.where(occupied, tot / denom.clamp(min=1e-12),
                          torch.zeros_like(denom)) / n
    weights = torch.where(vf, per_bin[idx], torch.zeros_like(gf))
    return weights.reshape(g.shape), new_acc


def ghm_c_loss(pred, target, label_weight, bins: int = 10,
               momentum: float = 0.0, acc_sum=None):
    """GHM-C: BCE on logits weighted by the inverse density of the
    gradient norm |sigmoid(pred) - target| (detached), over the count of
    elements with ``label_weight`` > 0. ``acc_sum`` (bins,) is the EMA of
    the bin counts (zeros if None). Returns (loss, new acc_sum)."""
    edges = _ghm_edges(bins, pred)
    if acc_sum is None:
        acc_sum = pred.new_zeros(bins)
    valid = label_weight > 0
    tot = valid.sum().to(pred.dtype).clamp(min=1.0)
    g = (torch.sigmoid(pred).detach() - target).abs()
    weights, new_acc = _ghm_weights(g, valid, tot, edges, bins, momentum,
                                    acc_sum)
    loss = binary_cross_entropy_with_logits(pred, target)
    return weight_reduce_loss(loss, weights, "mean", tot), new_acc


def ghm_r_loss(pred, target, label_weight, mu: float = 0.02, bins: int = 10,
               momentum: float = 0.0, acc_sum=None):
    """GHM-R: the smooth L1 sqrt(d^2 + mu^2) - mu weighted by the inverse
    density of its gradient norm |d / sqrt(d^2 + mu^2)| (detached); the
    last edge is 1e3 and ``tot`` is the sum of ``label_weight``. Returns
    (loss, new acc_sum)."""
    edges = _ghm_edges(bins, pred, last=1e3)
    if acc_sum is None:
        acc_sum = pred.new_zeros(bins)
    diff = pred - target
    loss = torch.sqrt(diff * diff + mu * mu) - mu
    g = (diff / torch.sqrt(mu * mu + diff * diff)).abs().detach()
    tot = label_weight.to(pred.dtype).sum().clamp(min=1.0)
    weights, new_acc = _ghm_weights(g, label_weight > 0, tot, edges, bins,
                                    momentum, acc_sum)
    return weight_reduce_loss(loss, weights, "mean", tot), new_acc
