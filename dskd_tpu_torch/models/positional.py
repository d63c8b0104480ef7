"""Sine positional encoding (port of dskd_tpu/models/positional.py
``sine_positional_encoding``)."""
from __future__ import annotations

import math

import torch


def sine_positional_encoding(mask: torch.Tensor, num_feats: int = 128,
                             temperature: float = 10000.0,
                             normalize: bool = True,
                             scale: float = 2 * math.pi,
                             offset: float = -0.5,
                             eps: float = 1e-6) -> torch.Tensor:
    """(B, H, W) bool mask, True at padded pixels -> (B, H, W, 2*num_feats)
    f32 embedding, channels [pos_y, pos_x], sin on even and cos on odd
    channels, phases from cumulative sums of the valid pixels."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)
