"""Box coordinate transforms and IoU family (port of dskd_tpu/core/boxes.py
``bbox_cxcywh_to_xyxy``, ``bbox_xyxy_to_cxcywh``, ``bbox_area``,
``bbox_overlaps``, ``bbox_clip``, ``distance2bbox`` and
``bbox2distance``)."""
from __future__ import annotations

import torch


def bbox_cxcywh_to_xyxy(bbox: torch.Tensor) -> torch.Tensor:
    """(..., 4) cxcywh -> xyxy."""
    cx, cy, w, h = bbox.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                        cy + h * 0.5], dim=-1)


def bbox_xyxy_to_cxcywh(bbox: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> cxcywh."""
    x1, y1, x2, y2 = bbox.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1],
                       dim=-1)


def bbox_area(bbox: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes (clamped at 0)."""
    w = torch.clamp(bbox[..., 2] - bbox[..., 0], min=0)
    h = torch.clamp(bbox[..., 3] - bbox[..., 1], min=0)
    return w * h


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                  mode: str = "iou", is_aligned: bool = False,
                  eps: float = 1e-6) -> torch.Tensor:
    """IoU / GIoU / IoF of xyxy boxes: (..., M, 4) x (..., N, 4) ->
    (..., M, N), or (..., M) elementwise when ``is_aligned``."""
    if mode not in ("iou", "iof", "giou"):
        raise ValueError(mode)
    area1 = bbox_area(bboxes1)
    area2 = bbox_area(bboxes2)
    if not is_aligned:
        b1 = bboxes1[..., :, None, :]
        b2 = bboxes2[..., None, :, :]
        area1 = area1[..., :, None]
        area2 = area2[..., None, :]
    else:
        b1, b2 = bboxes1, bboxes2
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1 if mode == "iof" else area1 + area2 - overlap
    union = torch.clamp(union, min=eps)
    ious = overlap / union
    if mode != "giou":
        return ious
    enclose_lt = torch.minimum(b1[..., :2], b2[..., :2])
    enclose_rb = torch.maximum(b1[..., 2:], b2[..., 2:])
    enclose_wh = torch.clamp(enclose_rb - enclose_lt, min=0)
    enclose_area = torch.clamp(enclose_wh[..., 0] * enclose_wh[..., 1],
                               min=eps)
    return ious - (enclose_area - union) / enclose_area


def bbox_clip(bbox: torch.Tensor, img_hw) -> torch.Tensor:
    """Clip xyxy boxes to [0, w] x [0, h]; ``img_hw`` = (h, w), scalars or
    tensors that broadcast against the boxes' leading axes."""
    h, w = (torch.as_tensor(v, dtype=bbox.dtype, device=bbox.device)
            for v in img_hw)
    return torch.stack([bbox[..., 0].clamp(min=0).minimum(w),
                        bbox[..., 1].clamp(min=0).minimum(h),
                        bbox[..., 2].clamp(min=0).minimum(w),
                        bbox[..., 3].clamp(min=0).minimum(h)], dim=-1)


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  max_shape=None) -> torch.Tensor:
    """(..., 2) centres and (..., 4) l, t, r, b distances -> xyxy boxes,
    clipped to ``max_shape`` = (h, w) if given."""
    out = torch.stack([points[..., 0] - distance[..., 0],
                       points[..., 1] - distance[..., 1],
                       points[..., 0] + distance[..., 2],
                       points[..., 1] + distance[..., 3]], dim=-1)
    return out if max_shape is None else bbox_clip(out, max_shape)


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor,
                  max_dis: float = None, eps: float = 0.1) -> torch.Tensor:
    """xyxy boxes -> l, t, r, b distances from the centres, clipped to
    [0, max_dis - eps] if ``max_dis`` is given (the DFL target)."""
    d = torch.stack([points[..., 0] - bbox[..., 0],
                     points[..., 1] - bbox[..., 1],
                     bbox[..., 2] - points[..., 0],
                     bbox[..., 3] - points[..., 1]], dim=-1)
    return d if max_dis is None else d.clamp(0, max_dis - eps)
