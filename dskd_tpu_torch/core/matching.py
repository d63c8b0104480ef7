"""Hungarian matching with the auction solver and the GFL-DETR cost stack
(port of dskd_tpu/core/matching.py ``lap_auction``, ``_tie_jitter``,
``AssignResult``, ``gfl_match_cost`` and ``hungarian_assign``).

Every function takes a leading batch axis of independent problems: the
train step solves all (decoder layer, image) assignments of a step in one
auction loop, where the JAX package ``vmap``s them. Semantics follow the JAX
functions: ``torch.argmax`` takes the first maximum as ``jnp.argmax`` does,
``.at[].max`` / ``.at[].min`` are ``scatter_reduce`` with ``amax`` / ``amin``,
and the tie-break jitter is the same hash, bit for bit. ``lap_jv`` is not
ported (ROADMAP A3): the flagship matcher is the auction.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .boxes import bbox_cxcywh_to_xyxy, bbox_overlaps, bbox_xyxy_to_cxcywh
from .losses import binary_cross_entropy_with_logits

_MASK32 = 0xFFFFFFFF
_EPS_FRAC = 1 / 100      # auction eps as a share of the cost span
_TIEBREAK = 1e-6         # tie-break jitter as a share of the cost span
_CHECK_EVERY = 4         # auction rounds between convergence checks


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2**32 for int64 ``a`` in [0, 2**32): two 16-bit halves
    of ``k`` keep every product below 2**48, so nothing overflows int64."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _tie_jitter(shape, device=None) -> torch.Tensor:
    """Deterministic per-cell U[0, 1) tie-break noise of a (R, C) matrix,
    the JAX uint32 multiplicative hash computed in int64 with each product
    reduced mod 2**32."""
    R, C = shape
    r = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(C, dtype=torch.int64, device=device)[None, :]
    h = (_mul32(r, 2654435761) + c) & _MASK32
    h = _mul32(h, 2246822519)
    h = _mul32(h ^ (h >> 15), 2654435761)
    return (h >> 8).to(torch.float32) / float(1 << 24)


def lap_auction(cost: torch.Tensor, max_iters: int = 1500,
                row_mask: Optional[torch.Tensor] = None):
    """Near-optimal assignment of N independent (R, C) problems, R <= C, by
    Bertsekas' auction, one vectorized round per iteration over all N.

    cost (N, R, C); row_mask (N, R) bool, rows marked False never bid.
    eps = span / 100 per problem, so each result is within R*eps of the
    optimum. Rows still unassigned after ``max_iters`` rounds (and masked
    rows) take the free columns in rank order (k-th unassigned row <- k-th
    free column), so the result is always one-to-one.

    Returns (N, R) int64 columns and (N,) the number of live rows the
    completion fallback placed. A round on a problem that has converged
    changes nothing, so the loop checks for convergence only every
    ``_CHECK_EVERY`` rounds (one host sync each).
    """
    N, R, C = cost.shape
    if R > C:
        raise ValueError(f"lap_auction needs R <= C, got {R} x {C}")
    dev = cost.device
    v = -cost.to(torch.float32)
    span = torch.clamp(v.amax((1, 2)) - v.amin((1, 2)), min=1e-6)
    eps = (span * _EPS_FRAC)[:, None]                          # (N, 1)
    rows = torch.arange(R, device=dev).expand(N, R)
    cols = torch.arange(C, device=dev).expand(N, C)
    live = (torch.ones((N, R), dtype=torch.bool, device=dev)
            if row_mask is None else row_mask.to(torch.bool))
    owner = torch.full((N, C), -1, dtype=torch.int64, device=dev)
    rowcol = torch.full((N, R), -1, dtype=torch.int64, device=dev)
    prices = torch.zeros((N, C), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool(((rowcol < 0) & live).any()):
            break
        val = v - prices[:, None, :]                          # (N, R, C)
        best_col = torch.argmax(val, dim=-1)                  # first max
        m1 = torch.gather(val, -1, best_col[..., None])[..., 0]
        m2 = torch.where(cols[:, None, :] == best_col[..., None], neg_inf,
                         val).amax(-1)
        bid = torch.gather(prices, 1, best_col) + (m1 - m2) + eps
        active = (rowcol < 0) & live
        tgt = torch.where(active, best_col, C)
        best_bid = torch.full((N, C + 1), float("-inf"), device=dev)
        best_bid = best_bid.scatter_reduce(
            1, tgt, torch.where(active, bid, neg_inf), "amax")
        is_best = active & (bid >= torch.gather(best_bid, 1, tgt))
        win_row = torch.full((N, C + 1), R, dtype=torch.int64, device=dev)
        win_row = win_row.scatter_reduce(
            1, torch.where(is_best, tgt, C), rows, "amin")
        w = win_row[:, :C]
        has_winner = w < R
        # previous owners of re-auctioned columns lose their match
        prev = torch.where(has_winner, owner, -1)
        lost = torch.zeros((N, R + 1), dtype=torch.bool, device=dev)
        lost = lost.scatter(1, torch.where(prev >= 0, prev, R),
                            torch.ones_like(prev, dtype=torch.bool))[:, :R]
        rowcol = torch.where(lost, -1, rowcol)
        owner = torch.where(has_winner, w, owner)
        rc = torch.cat([rowcol, rowcol.new_zeros((N, 1))], 1)
        rowcol = rc.scatter(1, torch.where(has_winner, w, R), cols)[:, :R]
        prices = torch.where(has_winner, best_bid[:, :C], prices)

    unassigned = rowcol < 0
    free = owner < 0
    row_rank = torch.cumsum(unassigned.to(torch.int64), 1) - 1
    # free columns in increasing order, then C - 1 (jnp.nonzero's fill)
    order = torch.sort((~free).to(torch.int8), dim=1, stable=True).indices
    n_free = free.sum(1, keepdim=True)
    free_cols = torch.where(cols < n_free, order, C - 1)
    fallback = torch.gather(free_cols, 1, row_rank.clamp(0, C - 1))
    result = torch.where(unassigned, fallback, rowcol)
    return result, (unassigned & live).sum(1)


class AssignResult(NamedTuple):
    """Static-shape assignment of N problems (leading axis).

    assigned_gt: (N, Q) int64 matched GT index or -1.
    assigned_labels: (N, Q) int64 matched GT label or -1.
    pos_mask: (N, Q) bool, the query is matched to a valid GT.
    num_pos: (N,) number of valid GT matched.
    num_fallback: (N,) rows the auction's completion fallback placed.
    """
    assigned_gt: torch.Tensor
    assigned_labels: torch.Tensor
    pos_mask: torch.Tensor
    num_pos: torch.Tensor
    num_fallback: torch.Tensor


def gfl_match_cost(cls_logits, bbox_cxcywh, gt_bboxes, gt_labels, img_hw,
                   cls_weight: float = 2.0, reg_weight: float = 5.0,
                   iou_weight: float = 2.0, beta: float = 2.0):
    """(N, Q, G) weighted matching cost of the GFL-DETR head.

    cls_logits (N, Q, K); bbox_cxcywh (N, Q, 4) normalized; gt_bboxes
    (N, G, 4) unnormalized xyxy; gt_labels (N, G); img_hw (N, 2) valid
    (h, w) that normalizes the GT.
    """
    hw = img_hw.to(cls_logits.dtype)
    h, w = hw[:, 0], hw[:, 1]
    factor = torch.stack([w, h, w, h], -1)[:, None, :]       # (N, 1, 4)
    gt_norm = gt_bboxes / factor
    gt_cxcywh = bbox_xyxy_to_cxcywh(gt_norm)
    reg_cost = (bbox_cxcywh[:, :, None, :]
                - gt_cxcywh[:, None, :, :]).abs().sum(-1)
    pred_xyxy = bbox_cxcywh_to_xyxy(bbox_cxcywh)
    iou_cost = -bbox_overlaps(pred_xyxy * factor, gt_bboxes, mode="giou")
    score = bbox_overlaps(pred_xyxy, gt_norm)                  # (N, Q, G)
    safe = gt_labels.clamp(0, cls_logits.shape[-1] - 1).long()
    logit_at = torch.gather(
        cls_logits, 2, safe[:, None, :].expand(-1, cls_logits.shape[1], -1))
    cls_cost = binary_cross_entropy_with_logits(logit_at, score) * (
        score - torch.sigmoid(logit_at)).abs() ** beta
    return cls_weight * cls_cost + reg_weight * reg_cost + \
        iou_weight * iou_cost


def hungarian_assign(cost: torch.Tensor, gt_valid: torch.Tensor,
                     gt_labels: torch.Tensor) -> AssignResult:
    """One-to-one assignment of queries to GT for N problems with the
    auction solver. cost (N, Q, G); gt_valid, gt_labels (N, G).

    G <= Q: GT are the rows; padded GT rows are zeroed and never bid
    (``row_mask``). G > Q: queries are the rows and invalid GT columns cost
    1e6, so min(Q, G) pairs are matched as scipy's rectangular solve does.
    A jitter of 1e-6 of the cost span breaks exact ties.
    """
    N, Q, G = cost.shape
    dev = cost.device
    ar = torch.arange(N, device=dev)[:, None]
    if G > Q:
        cost_rows = torch.where(gt_valid[:, None, :], cost,
                                torch.full_like(cost, 1e6))    # (N, Q, G)
        span = torch.clamp(cost_rows.amax((1, 2)) - cost_rows.amin((1, 2)),
                           min=1e-3)
        cost_rows = cost_rows + span[:, None, None] * _TIEBREAK * \
            _tie_jitter((Q, G), dev)
        q2g, n_fb = lap_auction(cost_rows)
        hit = gt_valid[ar, q2g]
        assigned_gt = torch.where(hit, q2g, -1)
        assigned_labels = torch.where(hit, gt_labels[ar, q2g].long(), -1)
        pos_mask = assigned_gt >= 0
        return AssignResult(assigned_gt, assigned_labels, pos_mask,
                            pos_mask.sum(1), n_fb)

    cost_rows = torch.where(gt_valid[:, :, None], cost.transpose(1, 2),
                            torch.zeros((), device=dev))       # (N, G, Q)
    span = torch.clamp(cost_rows.amax((1, 2)) - cost_rows.amin((1, 2)),
                       min=1e-3)
    cost_rows = cost_rows + span[:, None, None] * _TIEBREAK * \
        _tie_jitter((G, Q), dev)
    row2col, n_fb = lap_auction(cost_rows, row_mask=gt_valid)  # (N, G)
    cols = torch.where(gt_valid, row2col, Q)                   # Q = dropped
    gidx = torch.arange(G, device=dev).expand(N, G)
    assigned_gt = torch.full((N, Q + 1), -1, dtype=torch.int64, device=dev)
    assigned_gt = assigned_gt.scatter(1, cols, gidx)[:, :Q]
    assigned_labels = torch.full((N, Q + 1), -1, dtype=torch.int64,
                                 device=dev)
    assigned_labels = assigned_labels.scatter(
        1, cols, gt_labels.long())[:, :Q]
    pos_mask = assigned_gt >= 0
    return AssignResult(assigned_gt, assigned_labels, pos_mask,
                        gt_valid.sum(1), n_fb)
