"""SABL's bucketing box coder and YOLOv3's coder (port of
dskd_tpu/core/coders.py ``bbox_rescale``, ``_bucket_grid``,
``bbox2bucket``, ``bucket2bbox``, ``yolo_encode`` and ``yolo_decode``).

Each side of a proposal, rescaled about its centre by ``scale_factor``, is
cut into ``num_buckets`` buckets, of which the ceil(num_buckets / 2) nearest
that side are its candidates. Encoding: each side's label is the bucket
whose centre lies nearest the GT side, its two nearest buckets carry the
fine offset (the second only within ``offset_upperbound`` buckets), and
the other buckets within one bucket width are ignored by the bucket
classification. Decoding: each side takes its best bucket and subtracts
that bucket's offset; the localisation confidence is the best bucket's
score plus the second's where the two are adjacent, averaged over the
sides. Where two buckets tie, the lower index goes first, as JAX's
``top_k`` orders them: both functions rank with a stable sort.

YOLOv3's coder: a GT's centre as the pre-sigmoid fraction of its anchor's
cell (clamped to (eps, 1 - eps)) and its size as log(size / anchor size)
(clamped below at eps); decoding takes post-sigmoid centre fractions and
scales the anchor's half-extent by exp. The JAX module's TBLR and legacy
delta coders are not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

OFFSET_UPPERBOUND = 1.0    # the second offset bucket's reach, in buckets


def bbox_rescale(boxes: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """(..., 4) xyxy boxes scaled about their centres."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = (boxes[..., 2] - boxes[..., 0]) * scale_factor
    h = (boxes[..., 3] - boxes[..., 1]) * scale_factor
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def _bucket_grid(proposals, num_buckets: int, scale_factor: float):
    """(bucket width, bucket height, the left, right, top and bottom
    sides' candidate bucket centres (..., side)) of (..., 4) proposals."""
    p = bbox_rescale(proposals, scale_factor)
    side = math.ceil(num_buckets / 2.0)
    bw = (p[..., 2] - p[..., 0]) / num_buckets
    bh = (p[..., 3] - p[..., 1]) / num_buckets
    steps = 0.5 + torch.arange(side, dtype=p.dtype, device=p.device)
    l = p[..., 0, None] + steps * bw[..., None]
    r = p[..., 2, None] - steps * bw[..., None]
    t = p[..., 1, None] + steps * bh[..., None]
    d = p[..., 3, None] - steps * bh[..., None]
    return bw, bh, l, r, t, d


def bbox2bucket(proposals: torch.Tensor, gt: torch.Tensor, num_buckets: int,
                scale_factor: float):
    """(..., 4) proposals and their GT -> (offsets, offset weights, one-hot
    bucket labels, bucket classification weights), each (..., 4 * side),
    the sides in the order left, right, top, bottom. JAX's defaults are
    the only settings: two offset buckets, the second within one bucket,
    neighbours ignored."""
    side = math.ceil(num_buckets / 2.0)
    bw, bh, l, r, t, d = _bucket_grid(proposals, num_buckets, scale_factor)
    offs = [(l - gt[..., 0, None]) / bw[..., None],
            (r - gt[..., 2, None]) / bw[..., None],
            (t - gt[..., 1, None]) / bh[..., None],
            (d - gt[..., 3, None]) / bh[..., None]]
    w_parts, lbl_parts, clsw_parts = [], [], []
    for o in offs:
        # the nearest buckets first, the lower index first among equals
        dist, idx = torch.sort(o.abs(), dim=-1, stable=True)
        second = (dist[..., 1:2] < OFFSET_UPPERBOUND).to(o.dtype)
        w = torch.zeros_like(o).scatter(-1, idx[..., :2], torch.cat(
            [torch.ones_like(second), second], -1))
        label = F.one_hot(idx[..., 0], side).to(o.dtype)
        clsw = (~((o.abs() < 1) & (label == 0))).to(o.dtype)
        w_parts.append(w)
        lbl_parts.append(label)
        clsw_parts.append(clsw)
    return (torch.cat(offs, -1), torch.cat(w_parts, -1),
            torch.cat(lbl_parts, -1), torch.cat(clsw_parts, -1))


def bucket2bbox(proposals: torch.Tensor, cls_preds: torch.Tensor,
                offset_preds: torch.Tensor, num_buckets: int,
                scale_factor: float = 1.0):
    """(..., 4) proposals, (..., 4 * side) bucket logits and offsets ->
    (boxes (..., 4), localisation confidence (...)). JAX's ``max_hw``
    clip, which no caller sets, is not ported."""
    side = math.ceil(num_buckets / 2.0)
    lead = proposals.shape[:-1]
    scores = torch.softmax(cls_preds.reshape(*lead, 4, side), dim=-1)
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top2, idx2 = top[..., :2], idx[..., :2]
    best = idx2[..., 0]                                      # (..., 4)

    bw, bh, _, _, _, _ = _bucket_grid(proposals, num_buckets, scale_factor)
    p = bbox_rescale(proposals, scale_factor)
    steps = 0.5 + best.to(p.dtype)
    l_b = p[..., 0] + steps[..., 0] * bw
    r_b = p[..., 2] - steps[..., 1] * bw
    t_b = p[..., 1] + steps[..., 2] * bh
    d_b = p[..., 3] - steps[..., 3] * bh

    off = offset_preds.reshape(*lead, 4, side)
    sel = torch.gather(off, -1, best[..., None])[..., 0]
    boxes = torch.stack([l_b - sel[..., 0] * bw, t_b - sel[..., 2] * bh,
                         r_b - sel[..., 1] * bw, d_b - sel[..., 3] * bh],
                        dim=-1)
    adjacent = ((idx2[..., 0] - idx2[..., 1]).abs() == 1).to(top2.dtype)
    conf = top2[..., 0] + top2[..., 1] * adjacent
    return boxes, conf.mean(dim=-1)


def yolo_encode(anchors: torch.Tensor, gt_bboxes: torch.Tensor, stride,
                eps: float = 1e-6) -> torch.Tensor:
    """(..., 4) (x, y, log w, log h) targets of xyxy ``gt_bboxes`` against
    xyxy ``anchors`` at their level's ``stride``."""
    gcx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
    gcy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
    gw = gt_bboxes[..., 2] - gt_bboxes[..., 0]
    gh = gt_bboxes[..., 3] - gt_bboxes[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    acy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    wt = torch.log(torch.clamp(gw / aw, min=eps))
    ht = torch.log(torch.clamp(gh / ah, min=eps))
    xt = torch.clamp((gcx - acx) / stride + 0.5, eps, 1 - eps)
    yt = torch.clamp((gcy - acy) / stride + 0.5, eps, 1 - eps)
    return torch.stack([xt, yt, wt, ht], dim=-1)


def yolo_decode(anchors: torch.Tensor, pred: torch.Tensor,
                stride) -> torch.Tensor:
    """xyxy boxes of ``pred`` (..., 4): post-sigmoid centre fractions of the
    cell and log sizes against the anchor."""
    acx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    acy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    cx = acx + (pred[..., 0] - 0.5) * stride
    cy = acy + (pred[..., 1] - 0.5) * stride
    hw_half = (anchors[..., 2] - anchors[..., 0]) * 0.5 * torch.exp(
        pred[..., 2])
    hh_half = (anchors[..., 3] - anchors[..., 1]) * 0.5 * torch.exp(
        pred[..., 3])
    return torch.stack([cx - hw_half, cy - hh_half, cx + hw_half,
                        cy + hh_half], dim=-1)
