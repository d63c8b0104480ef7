"""Static-shape score filtering and top-k (port of
dskd_tpu/core/postprocess.py ``filter_scores_and_topk``).

The TPU-only approximate top-k branch is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
