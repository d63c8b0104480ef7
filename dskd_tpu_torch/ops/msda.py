"""Multi-scale deformable attention sampling (port of dskd_tpu/ops/msda.py
``ms_deform_attn_core``: its default branch, the ``DSKD_WGATHER=0`` and
``DSKD_FUSED_ROWS`` branches, and the windowed ``DSKD_WINBWD``, ``DSKD_FWIN``
and ``DSKD_WINDOW_ROWS`` branches).

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
The windowed variants act on a level whose packed table has more than
``mxu_gather_max_rows`` rows, for the encoder's queries (``raster_queries``;
ops/window.py says what a window is). In JAX's order of precedence, after
``DSKD_FUSED_ROWS``:
  * ``DSKD_WINBWD=1`` (default "0"), when neither of the next two is set and
    every token is a query: the level is cut into segments of queries of
    one source level; a segment whose window fits takes
    ``windowed_bwd_sample`` (``gather_weighted``'s forward, the windowed
    backward), the others ``gather_weighted``. The windows are sized by the
    JAX package's ``pack_corners_fused`` table (``pallas_pack_rows``);
  * ``DSKD_FWIN=1`` (default "0"), every token a query: the same segments
    take ``fused_window_sample`` and its windowed backward.
    ``DSKD_FWIN_MARGIN`` (default 6) sets the window's margin in image rows
    for both;
  * ``DSKD_WINDOW_ROWS=K`` (default 0, off; overrides ``window_rows``):
    level 0, when its h*w raster queries fill whole tiles of
    ``window_tile_q`` and its table has at least K rows: those queries take
    ``window_gather`` with K-row windows, weighted outside the kernel in the
    compute type, and the other queries ``gather_weighted``.
Setting ``DSKD_WINDOW_ROWS`` or ``DSKD_FWIN`` also turns off JAX's
pack-kernel branch for every big level; JAX then gathers in XLA, the same
function as the port's default branch, which those levels keep. Every
windowed kernel reads and adds an escaped sample in the table directly, so
each branch computes the default branch's function; JAX's ``lax.cond``
fallback needs no counterpart.
``mxu_gather_max_rows = 0`` turns every variant off, as JAX's ``use_mxu``
does. ``DSKD_FORCE_MXU`` has no meaning here: the card always runs the
kernels and the CPU the plain versions.

Not ported: the ``premap`` and ``DSKD_PACK_NOTRANS`` layouts, and
``DSKD_PACK_KERNEL=0``.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch

from .fused_sample import fused_msda_sample
from .fused_window import fused_window_sample
from .mxu_gather import gather_weighted, mxu_gather
from .pack_kernel import pack_corners
from .window import (pallas_pack_rows, segment_window_starts,
                     tile_window_starts)
from .window_bwd import windowed_bwd_sample
from .window_gather import window_gather


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


def segment_windows(spatial_shapes, hw, tile_q, margin, s_pad):
    """The JAX package's windows for the raster queries of every source
    level sampling the level of size ``hw`` whose table has ``s_pad`` rows
    (``msda.py:329-369`` and ``:463-497``): per source level, in order,
    ``(q0, n, window, starts)`` for its ``n`` queries from ``q0``, with
    ``window`` and ``starts`` None where the window would exceed half of the
    table or the segment has fewer than ``tile_q`` queries."""
    h, w = hw
    segments = []
    q0 = 0
    for (hs, ws_) in spatial_shapes:
        n = hs * ws_
        rows_per_tile = (tile_q / ws_) * (h / hs)
        need = int(rows_per_tile) + 2 * margin + 2
        k_seg = min(-(-(need * (w + 2)) // 16) * 16, s_pad)
        if k_seg > s_pad // 2 or n < tile_q:
            segments.append((q0, n, None, None))
        else:
            segments.append((q0, n, k_seg, segment_window_starts(
                n, tile_q, (hs, ws_), (h, w), s_pad, k_seg)))
        q0 += n
    return segments


def _segments(sample, table, flat, cw, segments, tile_q):
    """One level sampled per segment of ``segment_windows``: by ``sample``
    (``fused_window_sample`` or ``windowed_bwd_sample``) where its window
    fits, else by ``gather_weighted``."""
    parts = []
    for q0, n, window, starts in segments:
        f_s, w_s = flat[:, q0:q0 + n], cw[:, q0:q0 + n]
        if window is None:
            parts.append(gather_weighted(table, f_s, w_s))
        else:
            parts.append(sample(table, f_s, w_s.float(), starts, window,
                                tile_q))
    return torch.cat(parts, dim=1)


def _window_level0(table, flat, cw, hw, tile_q, window):
    """Level 0 with ``window_gather`` for the raster level-0 queries
    ``[0, h*w)`` and ``gather_weighted`` for the rest, weighted outside the
    kernel in the compute type (``msda.py:499-540``)."""
    h, w = hw
    n0 = h * w
    P, D = flat.shape[3], table.shape[3] // 4
    starts = tile_window_starts(n0, tile_q, w, w + 2, table.shape[1], window)
    g0 = window_gather(table, flat[:, :n0], starts, tile_q * P, window)
    wx = cw[:, :n0].repeat_interleave(D, dim=-1)        # (B, n0, H, P, 4D)
    # the points in gather_weighted's order, one multiply-add each, so that
    # the branch sums as the default one does
    acc = g0[:, :, :, 0] * wx[:, :, :, 0]
    for p in range(1, P):
        acc = torch.addcmul(acc, g0[:, :, :, p], wx[:, :, :, p])
    if flat.shape[1] == n0:
        return acc
    return torch.cat([acc, gather_weighted(table, flat[:, n0:],
                                           cw[:, n0:])], dim=1)


def ms_deform_attn_core(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        mxu_gather_max_rows: int = 2500,
                        raster_queries: bool = False,
                        window_tile_q: int = 128,
                        window_rows: int = 0,
                        fwin_tile_q: int = 128) -> torch.Tensor:
    """Multi-scale deformable sampling.

    value: (B, S, H, D) flattened level features (S = sum h*w), contiguous.
    sampling_locations: (B, Q, H, L, P, 2) normalized (x, y).
    attention_weights: (B, Q, H, L, P), softmaxed over L*P.
    mxu_gather_max_rows: the packed-table size up to which a level takes the
    JAX package's small-table variants and above which the windowed ones
    (``DSKD_MXU_GATHER_ROWS`` overrides it).
    raster_queries: True for the encoder's self-attention, where query q is
    flattened token q; the windowed branches need it.
    window_tile_q, window_rows: the query tile and window rows of
    ``DSKD_WINDOW_ROWS`` (which overrides ``window_rows``; 0 is off).
    fwin_tile_q: the query tile of ``DSKD_FWIN`` and ``DSKD_WINBWD``.
    Returns (B, Q, H*D).
    """
    env_rows = os.environ.get("DSKD_MXU_GATHER_ROWS")
    if env_rows is not None:
        mxu_gather_max_rows = int(env_rows)
    env_window = os.environ.get("DSKD_WINDOW_ROWS")
    if env_window is not None:
        window_rows = int(env_window)
    fwin_on = os.environ.get("DSKD_FWIN", "0") == "1"
    margin = int(os.environ.get("DSKD_FWIN_MARGIN", "6"))
    winbwd_on = os.environ.get("DSKD_WINBWD", "0") == "1"
    variants = mxu_gather_max_rows > 0
    wgather = os.environ.get("DSKD_WGATHER", "1") == "1"
    fused_max_rows = int(os.environ.get("DSKD_FUSED_ROWS", "0"))
    B, _, H, D = value.shape
    Q = sampling_locations.shape[1]
    # the segmented windows need every token as a query, in raster order
    all_tokens = raster_queries and Q == sum(h * w for h, w in spatial_shapes)
    value = value.contiguous()
    out = value.new_zeros((B, Q, H, D))
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        args = (sampling_locations[:, :, :, lvl],
                attention_weights[:, :, :, lvl], h, w, value.dtype)
        v = value[:, start:start + h * w]
        level_start, start = start, start + h * w
        if variants and 0 < h * w <= fused_max_rows:
            c00, wts = fused_index_and_weights(*args)
            out = out + fused_msda_sample(v, c00, wts, w)
            continue
        flat, cw = corner_index_and_weights(*args)
        table = pack_corners(v, h, w)
        sp = (h + 2) * (w + 2)
        big = variants and sp > mxu_gather_max_rows
        if big and window_rows == 0 and not fwin_on:
            # JAX's pack-kernel branch, where DSKD_WINBWD acts
            if winbwd_on and all_tokens:
                acc = _segments(windowed_bwd_sample, table, flat, cw,
                                segment_windows(spatial_shapes, (h, w),
                                                fwin_tile_q, margin,
                                                pallas_pack_rows(h, w)),
                                fwin_tile_q)
            else:
                acc = gather_weighted(table, flat, cw)
        elif variants and not big and not wgather:
            g = mxu_gather(table, flat)                 # (B, Q, H, P, 4D)
            acc = (g * cw.repeat_interleave(D, dim=-1)).sum(dim=3)
        elif big and fwin_on and all_tokens:
            acc = _segments(fused_window_sample, table, flat, cw,
                            segment_windows(spatial_shapes, (h, w),
                                            fwin_tile_q, margin, sp),
                            fwin_tile_q)
        elif (big and window_rows > 0 and raster_queries and level_start == 0
              and Q >= h * w and h * w % window_tile_q == 0
              and sp >= window_rows):
            acc = _window_level0(table, flat, cw, (h, w), window_tile_q,
                                 window_rows)
        else:
            acc = gather_weighted(table, flat, cw)      # (B, Q, H, 4D)
        out = out + acc.view(B, Q, H, 4, D).sum(dim=3)
    return out.reshape(B, Q, H * D)
