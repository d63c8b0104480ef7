"""The padded batch of a train step (port of dskd_tpu/data/batch.py
``Batch``), as tensors on one device."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Batch(NamedTuple):
    """images: (B, H, W, 3) normalized NHWC; img_hw: (B, 2) valid (h, w)
    after resize; gt_bboxes: (B, G, 4) xyxy in input coords; gt_labels:
    (B, G) int; gt_valid: (B, G) bool. The mask fields of the JAX batch
    belong to other families and are not ported."""
    images: torch.Tensor
    img_hw: torch.Tensor
    gt_bboxes: torch.Tensor
    gt_labels: torch.Tensor
    gt_valid: torch.Tensor

    def to(self, device) -> "Batch":
        return Batch(*(t.to(device) for t in self))
