"""Test-time image preprocessing on the device (port of the test path of
dskd_tpu/data/pipeline.py ``preprocess``).

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

from typing import Dict, Union

import numpy as np
import torch
import torch.nn.functional as F

from dskd_tpu.data.pipeline import PipelineConfig, rescale_size


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
               device) -> Dict[str, torch.Tensor]:
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
