"""CornerNet's gaussian targets (port of dskd_tpu/models/cornernet.py
``gaussian_radius`` and ``gaussian_splat_max``), which CenterNet renders
its heatmaps with. CornerNet itself is not ported.
"""
from __future__ import annotations

import torch


def gaussian_radius(h: torch.Tensor, w: torch.Tensor,
                    min_overlap: float = 0.3) -> torch.Tensor:
    """CornerNet's gaussian radius of boxes of size (h, w): the smallest
    root of the three quadratic cases."""
    a1 = 1.0
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp(b1 ** 2 - 4 * a1 * c1, min=0))) \
        / (2 * a1)
    a2 = 4.0
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0))) \
        / (2 * a2)
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0))) \
        / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


# elements of one chunk's (..., k, H, W, C) product in gaussian_splat_max
_SPLAT_CHUNK = 1 << 25


def gaussian_splat_max(ix: torch.Tensor, iy: torch.Tensor,
                       weights: torch.Tensor, radius: torch.Tensor, hw
                       ) -> torch.Tensor:
    """Max-combined windowed gaussians at integer centres
    (gen_gaussian_target): the radius truncated to an integer r, sigma =
    (2r + 1) / 6, the kernel zero outside the (2r + 1)^2 window. ix, iy
    (..., G) cells, weights (..., G, C), radius (..., G) -> (..., H, W, C);
    leading axes are batch axes. The max runs over chunks of G, so that
    no (..., G, H, W, C) product is held at once; a max is exact in any
    order."""
    H, W = hw
    dt = radius.dtype
    r = torch.floor(torch.clamp(radius, min=0.0))
    sigma = (2.0 * r + 1.0) / 6.0
    dy = (torch.arange(H, dtype=dt, device=radius.device)
          - iy[..., None].to(dt))                          # (..., G, H)
    dx = (torch.arange(W, dtype=dt, device=radius.device)
          - ix[..., None].to(dt))                          # (..., G, W)
    g = torch.exp(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2)
                  / torch.clamp(2 * sigma[..., None, None] ** 2, min=1e-12))
    window = ((dy.abs() <= r[..., None])[..., :, None]
              & (dx.abs() <= r[..., None])[..., None, :])
    g = torch.where(window, g, torch.zeros_like(g))        # (..., G, H, W)
    G, C = weights.shape[-2:]
    per_g = g[..., 0, :, :].numel() * C
    k = max(1, _SPLAT_CHUNK // max(per_g, 1))
    out = None
    for g0 in range(0, G, k):
        part = (g[..., g0:g0 + k, :, :, None]
                * weights[..., g0:g0 + k, None, None, :]).amax(-4)
        out = part if out is None else torch.maximum(out, part)
    if out is None:
        out = g.new_zeros(g.shape[:-3] + (H, W, C))
    return out
