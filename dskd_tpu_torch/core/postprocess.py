"""Static-shape score filtering, top-k and class-aware NMS (port of
dskd_tpu/core/postprocess.py ``filter_scores_and_topk``,
``filter_scores_and_topk_mlvl``, ``_nms_keep_scan``, ``_nms_keep_tiled``
and ``batched_nms``).

The TPU-only approximate top-k branch is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import bbox_overlaps

NMS_TILE = 512   # rows of score-sorted candidates per tile of the fixpoint


class TopkResult(NamedTuple):
    scores: torch.Tensor     # (..., topk) float
    labels: torch.Tensor     # (..., topk) int32
    keep_idxs: torch.Tensor  # (..., topk) int32 row index into ``scores``
    valid: torch.Tensor      # (..., topk) bool


def filter_scores_and_topk(scores: torch.Tensor, score_thr: float,
                           topk: int) -> TopkResult:
    """Threshold + top-k over the last two axes (N, K), static shapes.

    Flattens all (box, class) pairs, replaces pairs <= ``score_thr`` by the
    sentinel -1.0 and keeps the ``topk`` best; the output always has
    ``topk`` entries, padded with -1.0, and ``valid`` marks the real ones.
    Leading axes are batch axes.

    Ties go to the lower flat index, as ``lax.top_k`` orders them:
    ``torch.topk`` promises no order on ties, so this sorts stably instead.
    """
    n, k = scores.shape[-2:]
    flat = scores.reshape(scores.shape[:-2] + (n * k,))
    cand = torch.where(flat > score_thr, flat, torch.full_like(flat, -1.0))
    kk = min(topk, n * k)
    top_scores, top_idx = torch.sort(cand, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[..., :kk], top_idx[..., :kk]
    if kk < topk:                 # keep the static output size
        pad = top_scores.shape[:-1] + (topk - kk,)
        top_scores = torch.cat(
            [top_scores, top_scores.new_full(pad, -1.0)], dim=-1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros(pad)], dim=-1)
    valid = top_scores > max(score_thr, -0.5)
    keep_idxs = torch.div(top_idx, k, rounding_mode="floor").to(torch.int32)
    labels = (top_idx % k).to(torch.int32)
    return TopkResult(top_scores, labels, keep_idxs, valid)


def filter_scores_and_topk_mlvl(scores: torch.Tensor, score_thr: float,
                                topk: int, level_sizes) -> TopkResult:
    """Threshold + top-k per pyramid level: ``filter_scores_and_topk`` on
    each level's rows of the (..., N, K) scores with ``min(topk,
    size * K)`` entries, concatenated level-major, so that up to ``topk``
    candidates of every level reach the NMS. ``keep_idxs`` index the
    concatenated rows."""
    parts, start = [], 0
    k = scores.shape[-1]
    for size in level_sizes:
        r = filter_scores_and_topk(scores[..., start:start + size, :],
                                   score_thr, min(topk, size * k))
        parts.append(r._replace(keep_idxs=r.keep_idxs + start))
        start += size
    return TopkResult(*(torch.cat(f, dim=-1) for f in zip(*parts)))


class NMSResult(NamedTuple):
    bboxes: torch.Tensor   # (..., max_out, 4) kept boxes first, by score
    scores: torch.Tensor   # (..., max_out) 0 where not kept
    labels: torch.Tensor   # (..., max_out)
    keep: torch.Tensor     # (..., max_out) bool
    src_idx: torch.Tensor  # (..., max_out) input row of each output slot


def _nms_keep_scan(shifted: torch.Tensor, svalid: torch.Tensor,
                   iou_thr: float) -> torch.Tensor:
    """Greedy keep mask over score-sorted boxes, (B, n): one sequential pass
    over the n rows of the full (n, n) IoU matrix, all images at once. The
    plain reference of ``_nms_keep_tiled``, which ``batched_nms`` runs."""
    n = shifted.shape[1]
    iou = bbox_overlaps(shifted, shifted) > iou_thr
    later = torch.arange(n, device=shifted.device)
    keep = svalid.clone()
    for i in range(n):
        sup = iou[:, i] & keep & (later > i)
        keep = torch.where(keep[:, i:i + 1], keep & ~sup, keep)
    return keep


def _nms_keep_tiled(shifted: torch.Tensor, svalid: torch.Tensor,
                    iou_thr: float, tile: int = NMS_TILE) -> torch.Tensor:
    """The exact greedy keep mask, (B, n), in n / tile sequential tiles
    (JAX's ``_nms_keep_tiled``): each tile of score-sorted rows is first
    suppressed by the kept rows of the earlier tiles in one (tile, n) pass,
    then iterated to the greedy fixpoint within the tile,
    ``act <- base & ~any_k(sup[i, k] & act[k])`` over k < i. The images of
    the batch iterate together until none changes (a host sync per round);
    a round at an image's fixpoint leaves it unchanged, so the masks are
    those of JAX's per-image loop."""
    B, n = svalid.shape
    npad = -(-n // tile) * tile
    if npad != n:
        shifted = torch.nn.functional.pad(shifted, (0, 0, 0, npad - n))
        svalid = torch.nn.functional.pad(svalid, (0, npad - n))
    dev = shifted.device
    col = torch.arange(npad, device=dev)
    ar = torch.arange(tile, device=dev)
    lower = ar[:, None] > ar[None, :]
    keep = svalid.clone()
    for start in range(0, npad, tile):
        iou_rows = bbox_overlaps(shifted[:, start:start + tile], shifted)
        over = iou_rows > iou_thr                        # (B, tile, npad)
        cross = over & (col < start) & keep[:, None, :]
        base = svalid[:, start:start + tile] & ~cross.any(-1)
        sup = over[:, :, start:start + tile] & lower

        def suppress(act):
            return base & ~(sup & act[:, None, :]).any(-1)

        act, prev, it = suppress(base), base, 0
        while it < tile and bool((act != prev).any()):
            act, prev, it = suppress(act), act, it + 1
        keep[:, start:start + tile] = act
    return keep[:, :n]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, iou_thr: float, max_out: int,
                valid=None) -> NMSResult:
    """Class-aware greedy NMS with a static output size (port of JAX's
    ``batched_nms``), over the last axis of (..., n) candidates; leading
    axes are images.

    Each class is moved to its own region by adding label x (max |box| over
    all n rows, the invalid ones included, + 1), then one class-agnostic
    greedy pass runs over the rows sorted by score: the tiled fixpoint, in
    tiles of up to NMS_TILE rows, which gives JAX's mask whichever of its
    paths (the scan or the tiles) JAX takes. Every sort is stable, as
    ``jnp.argsort`` is, so ties keep JAX's order and ``src_idx`` its
    rows."""
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    labels = labels.reshape(-1, n)
    valid = (torch.ones_like(scores, dtype=torch.bool) if valid is None
             else valid.reshape(-1, n))
    offset = labels.to(boxes.dtype)[..., None] * (
        boxes.abs().amax((1, 2))[:, None, None] + 1.0)
    shifted = boxes + offset
    inf = torch.full_like(scores, float("inf"))
    order = torch.argsort(torch.where(valid, -scores, inf), dim=1,
                          stable=True)

    def take(t):
        idx = order if t.dim() == 2 else order[..., None].expand_as(t)
        return torch.gather(t, 1, idx)

    shifted, sboxes, sscores, slabels, svalid = map(
        take, (shifted, boxes, scores, labels, valid))
    keep = _nms_keep_tiled(shifted, svalid, iou_thr, min(NMS_TILE, n))
    # the kept rows first, by score
    rank = torch.argsort(torch.where(keep, -sscores, inf), dim=1,
                         stable=True)[:, :max_out]
    out_keep = torch.gather(keep, 1, rank)
    out_scores = torch.gather(sscores, 1, rank)
    out = NMSResult(
        torch.gather(sboxes, 1, rank[..., None].expand(-1, -1, 4)),
        torch.where(out_keep, out_scores, torch.zeros_like(out_scores)),
        torch.gather(slabels, 1, rank), out_keep,
        torch.gather(order, 1, rank))
    k = rank.shape[1]
    return NMSResult(*(t.reshape(lead + (k,) + t.shape[2:]) for t in out))
