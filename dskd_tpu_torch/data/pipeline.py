"""Test-time image preprocessing on the device (port of the test path of
dskd_tpu/data/pipeline.py ``preprocess``, with the port's own copies of its
``PipelineConfig`` and ``rescale_size``).

Rescale to ``img_scale`` keeping the aspect ratio (``rescale_size``),
bilinear resize, normalize with the COCO mean/std, pad into the static
``bucket`` canvas. The JAX package resizes with OpenCV on the host; the port
resizes with ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` on the device, which is the same half-pixel bilinear map.
A uint8 image is rounded back to whole grey levels after the resize, as
OpenCV's uint8 output is; OpenCV's fixed-point weights put it within one
grey level of this.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclass
class PipelineConfig:
    """The port's copy of dskd_tpu/data/pipeline.py ``PipelineConfig``
    (same fields and defaults); the test path reads ``img_scale``, ``mean``,
    ``std`` and ``bucket``."""
    img_scale: Tuple[int, int] = (640, 640)   # (max_long, max_short) bucket
    multi_scales: Optional[Tuple[Tuple[int, int], ...]] = None
    keep_ratio: bool = True
    flip_ratio: float = 0.5
    mean: np.ndarray = field(default_factory=lambda: IMAGENET_MEAN.copy())
    std: np.ndarray = field(default_factory=lambda: IMAGENET_STD.copy())
    max_gt: int = 100
    bucket: Tuple[int, int] = (640, 640)      # static padded canvas (H, W)
    photo_metric_distortion: bool = False
    mosaic: bool = False
    mosaic_center_ratio: Tuple[float, float] = (0.5, 1.5)
    mixup: bool = False
    mixup_ratio_range: Tuple[float, float] = (0.5, 1.5)
    expand: bool = False
    expand_ratio_range: Tuple[float, float] = (1.0, 4.0)
    min_iou_crop: bool = False
    min_ious: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7, 0.9)
    min_crop_size: float = 0.3
    resize_ratio_range: Optional[Tuple[float, float]] = None
    random_crop: Optional[Tuple[int, int]] = None   # (h, w) crop_size
    corruption: Optional[Tuple[str, int]] = None
    auto_augment: object = False
    with_mask: bool = False
    mask_stride: int = 4
    with_semantic: bool = False


def rescale_size(h: int, w: int, scale: Tuple[int, int]
                 ) -> Tuple[int, int, float]:
    """mmdet Resize keep_ratio semantics: fit (h, w) into ``scale``."""
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5), f


def resize_bilinear(img: torch.Tensor, new_h: int, new_w: int
                    ) -> torch.Tensor:
    """(h, w, 3) image -> (new_h, new_w, 3) f32."""
    x = img.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=False)[0]
    if img.dtype == torch.uint8:
        y = y.round().clamp(0, 255)
    return y.permute(1, 2, 0)


def preprocess(img: Union[np.ndarray, torch.Tensor], cfg: PipelineConfig,
               device="cuda") -> Dict[str, torch.Tensor]:
    """One RGB (h0, w0, 3) image -> dict(image (H, W, 3) f32 normalized and
    zero-padded, img_hw (2,) int32 valid size, scale_factor (4,) f32), all on
    ``device``."""
    x = torch.as_tensor(np.ascontiguousarray(img) if isinstance(
        img, np.ndarray) else img).to(device)
    h0, w0 = x.shape[:2]
    new_h, new_w, _ = rescale_size(h0, w0, cfg.img_scale)
    x = resize_bilinear(x, new_h, new_w)
    mean = torch.as_tensor(cfg.mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(cfg.std, dtype=torch.float32, device=device)
    x = (x - mean) / std
    H, W = cfg.bucket
    canvas = torch.zeros((H, W, 3), dtype=torch.float32, device=device)
    canvas[:new_h, :new_w] = x[:H, :W]
    w_scale, h_scale = new_w / w0, new_h / h0
    return dict(
        image=canvas,
        img_hw=torch.tensor([new_h, new_w], dtype=torch.int32, device=device),
        scale_factor=torch.tensor([w_scale, h_scale, w_scale, h_scale],
                                  dtype=torch.float32, device=device))
