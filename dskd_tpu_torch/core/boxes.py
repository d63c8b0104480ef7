"""Box coordinate transforms (port of dskd_tpu/core/boxes.py
``bbox_cxcywh_to_xyxy``)."""
from __future__ import annotations

import torch


def bbox_cxcywh_to_xyxy(bbox: torch.Tensor) -> torch.Tensor:
    """(..., 4) cxcywh -> xyxy."""
    cx, cy, w, h = bbox.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                        cy + h * 0.5], dim=-1)
