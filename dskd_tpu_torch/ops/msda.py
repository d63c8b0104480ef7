"""Multi-scale deformable attention sampling (port of dskd_tpu/ops/msda.py
``ms_deform_attn_core``: its default branch and the ``DSKD_WGATHER=0`` and
``DSKD_FUSED_ROWS`` branches).

Each query bilinearly samples ``P`` points per head from every level and sums
them with its attention weights, as ``F.grid_sample(align_corners=False,
padding_mode='zeros')`` would: a normalized location p maps to pixel
``p * size - 0.5`` and corners outside the map contribute zero.

The default branch: per level the features go through ``pack_corners`` (one
4D-wide row holds the four bilinear corners of a base pixel) and
``gather_weighted`` (P weighted row reads per (query, head), summed in f32);
the four D-chunks are then folded. On the TPU only levels whose table has at
most ``mxu_gather_max_rows`` (2500) rows took the one-hot Pallas gather, a
limit set by VMEM and one-hot FLOPs; the GPU kernel gathers rows directly, so
every level takes the same two kernels.

The environment selects the JAX module's other two variants, read at call
time with its defaults, so one environment picks the same branch in both
packages:
  * ``DSKD_WGATHER=0`` (default "1"): a level whose packed table has at most
    ``mxu_gather_max_rows`` rows (``DSKD_MXU_GATHER_ROWS`` overrides it)
    gathers its P rows per (query, head) with ``mxu_gather`` and weights
    them with the corner weights in plain PyTorch, in the compute type;
  * ``DSKD_FUSED_ROWS=N`` (default 0, off): a level with ``0 < h*w <= N``
    skips the packing and samples the raw level slice with
    ``fused_msda_sample`` (four taps from the unclipped top-left corner,
    f32 weights). This check comes first, as in JAX.
``mxu_gather_max_rows = 0`` turns both off, as JAX's ``use_mxu`` does.
``DSKD_FORCE_MXU`` has no meaning here: the card always runs the kernels
and the CPU the plain versions.

Not ported: the windowed variants (``DSKD_WINDOW_ROWS``, ``DSKD_FWIN``,
``DSKD_WINBWD``), the ``premap`` and ``DSKD_PACK_NOTRANS`` layouts, and
``DSKD_PACK_KERNEL=0``.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch

from .fused_sample import fused_msda_sample
from .mxu_gather import gather_weighted, mxu_gather
from .pack_kernel import pack_corners


def _corners(loc: torch.Tensor, attn: torch.Tensor, h: int, w: int,
             dtype: torch.dtype):
    """Top-left corner (x0, y0), f32 and unclipped, and the gated corner
    weights ``cw`` (B, Q, H, P, 4) in ``dtype`` of one level."""
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
    return x0, y0, cw * attn[..., None].to(dtype)


def corner_index_and_weights(loc: torch.Tensor, attn: torch.Tensor, h: int,
                             w: int, dtype: torch.dtype):
    """Bilinear corner rows and weights of one level.

    loc: (B, Q, H, P, 2) normalized (x, y); attn: (B, Q, H, P).
    Returns ``flat`` (B, Q, H, P) int32, the clipped base row
    ``(y0+1)*(w+2) + (x0+1)`` of the packed table, and ``cw``
    (B, Q, H, P, 4) in ``dtype``: the in-bounds-gated bilinear weight of each
    corner times the attention weight.
    """
    x0, y0, cw = _corners(loc, attn, h, w, dtype)
    x0c = torch.clamp(x0 + 1, 0, w + 1)
    y0c = torch.clamp(y0 + 1, 0, h + 1)
    return (y0c * (w + 2) + x0c).to(torch.int32), cw


def fused_index_and_weights(loc: torch.Tensor, attn: torch.Tensor, h: int,
                            w: int, dtype: torch.dtype):
    """What ``fused_msda_sample`` takes for one level: the unclipped
    top-left corner ``y0*w + x0`` (B, Q, H, P) int32 and ``cw`` as f32
    weights (``msda.py:286-289`` of the JAX package). Taps outside the map
    carry zero weight; taps outside the table are skipped by the kernel."""
    x0, y0, cw = _corners(loc, attn, h, w, dtype)
    return (y0 * w + x0).to(torch.int32), cw.float()


def ms_deform_attn_core(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        mxu_gather_max_rows: int = 2500) -> torch.Tensor:
    """Multi-scale deformable sampling.

    value: (B, S, H, D) flattened level features (S = sum h*w), contiguous.
    sampling_locations: (B, Q, H, L, P, 2) normalized (x, y).
    attention_weights: (B, Q, H, L, P), softmaxed over L*P.
    mxu_gather_max_rows: the packed-table size up to which ``DSKD_WGATHER=0``
    takes ``mxu_gather`` (``DSKD_MXU_GATHER_ROWS`` overrides it).
    Returns (B, Q, H*D).
    """
    env_rows = os.environ.get("DSKD_MXU_GATHER_ROWS")
    if env_rows is not None:
        mxu_gather_max_rows = int(env_rows)
    variants = mxu_gather_max_rows > 0
    wgather = os.environ.get("DSKD_WGATHER", "1") == "1"
    fused_max_rows = int(os.environ.get("DSKD_FUSED_ROWS", "0"))
    B, _, H, D = value.shape
    Q = sampling_locations.shape[1]
    value = value.contiguous()
    out = value.new_zeros((B, Q, H, D))
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        args = (sampling_locations[:, :, :, lvl],
                attention_weights[:, :, :, lvl], h, w, value.dtype)
        v = value[:, start:start + h * w]
        start += h * w
        if variants and 0 < h * w <= fused_max_rows:
            c00, wts = fused_index_and_weights(*args)
            out = out + fused_msda_sample(v, c00, wts, w)
            continue
        flat, cw = corner_index_and_weights(*args)
        table = pack_corners(v, h, w)
        if (variants and not wgather
                and (h + 2) * (w + 2) <= mxu_gather_max_rows):
            g = mxu_gather(table, flat)                 # (B, Q, H, P, 4D)
            acc = (g * cw.repeat_interleave(D, dim=-1)).sum(dim=3)
        else:
            acc = gather_weighted(table, flat, cw)      # (B, Q, H, 4D)
        out = out + acc.view(B, Q, H, 4, D).sum(dim=3)
    return out.reshape(B, Q, H * D)
