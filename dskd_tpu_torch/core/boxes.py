"""Box coordinate transforms and IoU family (port of dskd_tpu/core/boxes.py
``bbox_cxcywh_to_xyxy``, ``bbox_xyxy_to_cxcywh``, ``bbox_area`` and
``bbox_overlaps``)."""
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
