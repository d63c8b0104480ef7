"""Anchor generation and delta box coding (port of dskd_tpu/core/anchors.py
``base_anchors``, ``grid_anchors``, ``delta2bbox`` and ``bbox2delta``).

YOLOF's single C5 level: base size 32, scales 1-16, ratio 1.0. Anchors are
in row-major (y, x, anchor) order, as JAX's.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def base_anchors(base_size: float, scales: Sequence[float],
                 ratios: Sequence[float]) -> np.ndarray:
    """(S*R, 4) xyxy anchors centred at the origin (ratio-major)."""
    out = []
    for r in ratios:
        h_ratio = math.sqrt(r)
        w_ratio = 1.0 / h_ratio
        for s in scales:
            w = base_size * s * w_ratio
            h = base_size * s * h_ratio
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.array(out, np.float32)


def grid_anchors(featmap_size: Tuple[int, int], stride: int,
                 base: np.ndarray, device="cuda") -> torch.Tensor:
    """(H*W*A, 4) anchors of one level on ``device``."""
    h, w = featmap_size
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride
    shift_x = xs[None, :].expand(h, w).reshape(-1)
    shift_y = ys[:, None].expand(h, w).reshape(-1)
    shifts = torch.stack([shift_x, shift_y, shift_x, shift_y], -1)
    anchors = shifts[:, None, :] + torch.from_numpy(base).to(device)[None]
    return anchors.reshape(-1, 4)


def delta2bbox(anchors: torch.Tensor, deltas: torch.Tensor,
               means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
               wh_ratio_clip: float = 16 / 1000,
               add_ctr_clamp: bool = False,
               ctr_clamp: float = 32.0) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas against xyxy anchors -> xyxy boxes.
    YOLOF decodes with ``add_ctr_clamp=True``: the centre shift is clamped
    to +-``ctr_clamp`` pixels and dw, dh only from above."""
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    d = deltas * stds + means
    dxy, dwh = d[..., :2], d[..., 2:]
    pxy = (anchors[..., :2] + anchors[..., 2:]) * 0.5
    pwh = anchors[..., 2:] - anchors[..., :2]
    max_ratio = abs(math.log(wh_ratio_clip))
    dxy_wh = pwh * dxy
    if add_ctr_clamp:
        dxy_wh = dxy_wh.clamp(-ctr_clamp, ctr_clamp)
        dwh = dwh.clamp(max=max_ratio)
    else:
        dwh = dwh.clamp(-max_ratio, max_ratio)
    gxy = pxy + dxy_wh
    gwh = pwh * torch.exp(dwh)
    return torch.cat([gxy - gwh * 0.5, gxy + gwh * 0.5], dim=-1)


def bbox2delta(anchors: torch.Tensor, gt: torch.Tensor,
               means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
               eps: float = 1e-6) -> torch.Tensor:
    """Encode xyxy ``gt`` against xyxy anchors -> (dx, dy, dw, dh)."""
    pxy = (anchors[..., :2] + anchors[..., 2:]) * 0.5
    pwh = (anchors[..., 2:] - anchors[..., :2]).clamp(min=eps)
    gxy = (gt[..., :2] + gt[..., 2:]) * 0.5
    gwh = (gt[..., 2:] - gt[..., :2]).clamp(min=eps)
    d = torch.cat([(gxy - pxy) / pwh, torch.log(gwh / pwh)], -1)
    return (d - d.new_tensor(means)) / d.new_tensor(stds)
