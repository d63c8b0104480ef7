"""Multi-scale deformable attention sampling (port of dskd_tpu/ops/msda.py
``ms_deform_attn_core``, default semantics only).

Each query bilinearly samples ``P`` points per head from every level and sums
them with its attention weights, as ``F.grid_sample(align_corners=False,
padding_mode='zeros')`` would: a normalized location p maps to pixel
``p * size - 0.5`` and corners outside the map contribute zero.

Per level the features go through ``pack_corners`` (one 4D-wide row holds the
four bilinear corners of a base pixel) and ``gather_weighted`` (P weighted
row reads per (query, head), summed in f32); the four D-chunks are then
folded. On the TPU only levels whose table has at most 2500 rows took the
one-hot Pallas gather, a limit set by VMEM and one-hot FLOPs; the GPU kernel
gathers rows directly, so every level takes the same two kernels.

The TPU layout variants of the JAX module (premap, notrans, window, fwin,
winbwd, fused) are not ported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .mxu_gather import gather_weighted
from .pack_kernel import pack_corners


def corner_index_and_weights(loc: torch.Tensor, attn: torch.Tensor, h: int,
                             w: int, dtype: torch.dtype):
    """Bilinear corner rows and weights of one level.

    loc: (B, Q, H, P, 2) normalized (x, y); attn: (B, Q, H, P).
    Returns ``flat`` (B, Q, H, P) int32, the clipped base row
    ``(y0+1)*(w+2) + (x0+1)`` of the packed table, and ``cw``
    (B, Q, H, P, 4) in ``dtype``: the in-bounds-gated bilinear weight of each
    corner times the attention weight.
    """
    x = loc[..., 0].float() * w - 0.5
    y = loc[..., 1].float() * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0).to(dtype)
    ty = (y - y0).to(dtype)
    inx0 = (x0 >= 0) & (x0 < w)
    inx1 = (x0 + 1 >= 0) & (x0 + 1 < w)
    iny0 = (y0 >= 0) & (y0 < h)
    iny1 = (y0 + 1 >= 0) & (y0 + 1 < h)
    cw = torch.stack([((1 - tx) * (1 - ty) * (inx0 & iny0)).to(dtype),
                      (tx * (1 - ty) * (inx1 & iny0)).to(dtype),
                      ((1 - tx) * ty * (inx0 & iny1)).to(dtype),
                      (tx * ty * (inx1 & iny1)).to(dtype)], dim=-1)
    cw = cw * attn[..., None].to(dtype)
    x0c = torch.clamp(x0 + 1, 0, w + 1)
    y0c = torch.clamp(y0 + 1, 0, h + 1)
    flat = (y0c * (w + 2) + x0c).to(torch.int32)
    return flat, cw


def ms_deform_attn_core(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable sampling.

    value: (B, S, H, D) flattened level features (S = sum h*w), contiguous.
    sampling_locations: (B, Q, H, L, P, 2) normalized (x, y).
    attention_weights: (B, Q, H, L, P), softmaxed over L*P.
    Returns (B, Q, H*D).
    """
    B, _, H, D = value.shape
    Q = sampling_locations.shape[1]
    value = value.contiguous()
    out = value.new_zeros((B, Q, H, D))
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        flat, cw = corner_index_and_weights(
            sampling_locations[:, :, :, lvl], attention_weights[:, :, :, lvl],
            h, w, value.dtype)
        table = pack_corners(value[:, start:start + h * w], h, w)
        acc = gather_weighted(table, flat, cw)          # (B, Q, H, 4D)
        out = out + acc.view(B, Q, H, 4, D).sum(dim=3)
        start += h * w
    return out.reshape(B, Q, H * D)
