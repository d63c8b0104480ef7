"""Hungarian matching: the auction and JV solvers and the DETR cost stacks
(port of dskd_tpu/core/matching.py ``lap_jv``, ``lap_auction``,
``_tie_jitter``, ``AssignResult``, ``gfl_match_cost``, ``hungarian_assign``,
``gfl_hungarian_assign``, ``focal_loss_cost``, ``classification_cost``,
``detr_match_cost``, ``distill_hungarian_assign`` and
``distribution_focal_loss_cost``).

Every function but ``lap_jv`` takes a leading batch axis of independent
problems: the train step solves all (decoder layer, image) assignments of a
step at once, where the JAX package ``vmap``s them. Semantics follow the
JAX functions: ``torch.argmax`` takes the first maximum as ``jnp.argmax``
does, ``.at[].max`` / ``.at[].min`` are ``scatter_reduce`` with ``amax`` /
``amin``, and the tie-break jitter is the same hash, bit for bit.

Two solvers (``hungarian_assign(solver=...)``, ``DetLossConfig.matcher``):
  * ``"auction"`` (the flagship's, through ``DetLossConfig.matcher``):
    Bertsekas' auction, one vectorized round over all N problems per
    iteration, on the tensors' device;
  * ``"jv"`` (``hungarian_assign``'s default, as JAX's): the exact
    Jonker-Volgenant solve of ``native/lap_jv.cpp``.
    ``hungarian_assign`` copies the (N, R, C) cost to the host explicitly,
    solves the N problems there and copies the columns back. This is the
    design, not a fallback: JAX runs JV as a sequential ``lax.while_loop``
    and the reference solves with scipy on the host
    (gfl_hungarian_assigner.py:142-151); on the card a Python loop of
    tensor ops would sync with the host once per augmenting step.
``lap_jv`` below is the plain-torch twin of JAX's e-maxx formulation, one
problem at a time: the tests hold the C++ solve against it, and nothing
else calls it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..native.build import load_lap_jv
from .boxes import bbox_cxcywh_to_xyxy, bbox_overlaps, bbox_xyxy_to_cxcywh
from .losses import binary_cross_entropy_with_logits

_INF = 1e9
_BIG_M = 1e6             # cost of an invalid GT column when G > Q
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


def lap_jv(cost: torch.Tensor) -> torch.Tensor:
    """Exact assignment of one (R, C) problem, R <= C: the plain twin of
    JAX's ``lap_jv`` (e-maxx potentials, f32, columns scanned in order,
    the first minimum taken). Returns (R,) int64 columns."""
    R, C = cost.shape
    if R > C:
        raise ValueError(f"lap_jv needs R <= C, got {R} x {C}")
    dev = cost.device
    cost1 = F.pad(cost.to(torch.float32), (1, 0, 1, 0))   # 1-indexed
    u = torch.zeros(R + 1, device=dev)
    v = torch.zeros(C + 1, device=dev)
    p = torch.zeros(C + 1, dtype=torch.int64, device=dev)  # column -> row
    col_range = torch.arange(C + 1, device=dev)
    for i in range(1, R + 1):
        p[0] = i
        minv = torch.full((C + 1,), _INF, device=dev)
        used = torch.zeros(C + 1, dtype=torch.bool, device=dev)
        way = torch.zeros(C + 1, dtype=torch.int64, device=dev)
        j0 = 0
        while int(p[j0]) != 0:
            used[j0] = True
            i0 = p[j0]
            cur = cost1[i0] - u[i0] - v
            scan = ~used & (col_range >= 1)
            better = scan & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(scan, minv, torch.full_like(minv, _INF))
            j1 = int(torch.argmin(masked))
            delta = masked[j1]
            u = u.index_add(0, p, torch.where(used, delta, 0.0))
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
        while j0 != 0:
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    row2col = torch.full((R + 1,), -1, dtype=torch.int64, device=dev)
    row2col[p[1:]] = torch.arange(C, device=dev)    # free columns -> row 0
    return row2col[1:]


def lap_jv_native(cost: torch.Tensor) -> torch.Tensor:
    """Exact assignment of N (R, C) problems, R <= C, by the C++ JV solve:
    the cost is copied to the host as f64, solved there, and the (N, R)
    int64 columns come back to the cost's device."""
    N, R, C = cost.shape
    if R > C:
        raise ValueError(f"lap_jv needs R <= C, got {R} x {C}")
    host = cost.detach().to("cpu", torch.float64).contiguous()
    out = torch.empty((N, R), dtype=torch.int64)
    if load_lap_jv().lap_jv(host.data_ptr(), N, R, C, out.data_ptr()) != 0:
        raise RuntimeError("lap_jv refused the problem")
    return out.to(cost.device)


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


def _at_labels(t, gt_labels):
    """t (N, Q, K) at each GT's class -> (N, Q, G)."""
    safe = gt_labels.clamp(0, t.shape[-1] - 1).long()
    return torch.gather(t, 2, safe[:, None, :].expand(-1, t.shape[1], -1))


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
    logit_at = _at_labels(cls_logits, gt_labels)
    cls_cost = binary_cross_entropy_with_logits(logit_at, score) * (
        score - torch.sigmoid(logit_at)).abs() ** beta
    return cls_weight * cls_cost + reg_weight * reg_cost + \
        iou_weight * iou_cost


def _solve(cost_rows, solver, row_mask=None):
    """(N, R, C) -> ((N, R) columns, (N,) completion-fallback count)."""
    if solver == "auction":
        return lap_auction(cost_rows, row_mask=row_mask)
    if solver == "jv":
        cols = lap_jv_native(cost_rows)
        return cols, torch.zeros(cols.shape[0], dtype=torch.int64,
                                 device=cols.device)
    raise ValueError(f"unknown solver {solver!r}")


def _jittered(cost_rows):
    """Add 1e-6 of each problem's cost span (at least 1e-3) times the
    tie-break jitter."""
    _, R, C = cost_rows.shape
    span = torch.clamp(cost_rows.amax((1, 2)) - cost_rows.amin((1, 2)),
                       min=1e-3)
    return cost_rows + span[:, None, None] * _TIEBREAK * \
        _tie_jitter((R, C), cost_rows.device)


def hungarian_assign(cost: torch.Tensor, gt_valid: torch.Tensor,
                     gt_labels: torch.Tensor, *,
                     solver: str = "jv") -> AssignResult:
    """One-to-one assignment of queries to GT for N problems. cost
    (N, Q, G); gt_valid, gt_labels (N, G); ``solver`` "jv" (JAX's default)
    or "auction", by keyword only (the module docstring says where each
    runs).

    G <= Q: GT are the rows; padded GT rows are zeroed (and, for the
    auction, never bid). G > Q: queries are the rows and invalid GT columns
    cost 1e6, so min(Q, G) pairs are matched as scipy's rectangular solve
    does. A jitter of 1e-6 of the cost span breaks exact ties, before
    either solver.
    """
    N, Q, G = cost.shape
    dev = cost.device
    ar = torch.arange(N, device=dev)[:, None]
    if G > Q:
        cost_rows = _jittered(torch.where(gt_valid[:, None, :], cost,
                                          torch.full_like(cost, _BIG_M)))
        q2g, n_fb = _solve(cost_rows, solver)                 # (N, Q)
        hit = gt_valid[ar, q2g]
        assigned_gt = torch.where(hit, q2g, -1)
        assigned_labels = torch.where(hit, gt_labels[ar, q2g].long(), -1)
        pos_mask = assigned_gt >= 0
        return AssignResult(assigned_gt, assigned_labels, pos_mask,
                            pos_mask.sum(1), n_fb)

    cost_rows = _jittered(torch.where(gt_valid[:, :, None],
                                      cost.transpose(1, 2),
                                      torch.zeros((), device=dev)))
    row2col, n_fb = _solve(cost_rows, solver, row_mask=gt_valid)  # (N, G)
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


def gfl_hungarian_assign(cls_logits, bbox_cxcywh, gt_bboxes, gt_labels,
                         gt_valid, img_hw) -> AssignResult:
    """The GFL-DETR cost stack and its exact (JV) assignment for N images,
    as JAX's function solves with its ``hungarian_assign`` default."""
    cost = gfl_match_cost(cls_logits, bbox_cxcywh, gt_bboxes, gt_labels,
                          img_hw)
    return hungarian_assign(cost, gt_valid, gt_labels)


def focal_loss_cost(cls_logits, gt_labels, weight=1.0, alpha=0.25,
                    gamma=2.0, eps=1e-12):
    """FocalLossCost: the positive minus the negative focal term at the GT
    classes. cls_logits (N, Q, K), gt_labels (N, G) -> (N, Q, G)."""
    p = torch.sigmoid(cls_logits)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    return (_at_labels(pos, gt_labels) - _at_labels(neg, gt_labels)) * weight


def classification_cost(cls_logits, gt_labels, weight=1.0):
    """ClassificationCost: minus the softmax probability of the GT class,
    (N, Q, G)."""
    return -_at_labels(torch.softmax(cls_logits, dim=-1), gt_labels) * weight


def detr_match_cost(cls_logits, bbox_cxcywh, gt_bboxes, gt_labels, img_hw,
                    cls_cost: str = "focal", cls_weight: float = 2.0,
                    reg_weight: float = 5.0, iou_weight: float = 2.0):
    """The standard DETR HungarianAssigner cost stack for N images: focal
    (or softmax classification) cost + normalized-cxcywh L1 + GIoU."""
    hw = img_hw.to(cls_logits.dtype)
    factor = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                         -1)[:, None, :]
    gt_norm = gt_bboxes / factor
    reg = (bbox_cxcywh[:, :, None] - bbox_xyxy_to_cxcywh(gt_norm)[:, None]
           ).abs().sum(-1)
    iou = -bbox_overlaps(bbox_cxcywh_to_xyxy(bbox_cxcywh) * factor,
                         gt_bboxes, mode="giou")
    if cls_cost == "focal":
        cls = focal_loss_cost(cls_logits, gt_labels)
    else:
        cls = classification_cost(cls_logits, gt_labels)
    return cls_weight * cls + reg_weight * reg + iou_weight * iou


def distill_hungarian_assign(cls_logits, bbox_cxcywh, teacher_bboxes,
                             teacher_labels, teacher_valid,
                             img_hw) -> AssignResult:
    """DistillHungarianAssigner: student predictions matched one to one to
    the teacher's, classification + L1 + GIoU costs of weight 1 (JV, as in
    JAX)."""
    cost = detr_match_cost(cls_logits, bbox_cxcywh, teacher_bboxes,
                           teacher_labels, img_hw, cls_cost="softmax",
                           cls_weight=1.0, reg_weight=1.0, iou_weight=1.0)
    return hungarian_assign(cost, teacher_valid, teacher_labels)


def distribution_focal_loss_cost(pred_corner: torch.Tensor,
                                 target_corner: torch.Tensor,
                                 weight: float = 1.0) -> torch.Tensor:
    """DistributionFocalLossCost for N problems: pred_corner (N, Q*4,
    reg_max+1) logits, target_corner (N, G*4) bin targets -> (N, Q, G), the
    DFL of each query's corner c against the GT's corner c averaged over
    the four corners and scaled by 1 / (G*4) (the reference's
    normalization; JAX's intended semantics of the reference's dead
    code)."""
    N, Q4, n_bins = pred_corner.shape
    Q, G = Q4 // 4, target_corner.shape[1] // 4
    logp = torch.log_softmax(pred_corner, dim=-1)             # (N, Q*4, n)
    t = target_corner
    dis_left = t.to(torch.int32).clamp(0, n_bins - 1)
    dis_right = (dis_left + 1).clamp(0, n_bins - 1)
    w_left = (dis_left + 1).to(logp.dtype) - t
    w_right = t - dis_left.to(logp.dtype)

    def at(idx):                                               # (N, Q*4, G*4)
        return torch.gather(logp, 2, idx.long()[:, None, :].expand(
            -1, Q4, -1))

    loss = -at(dis_left) * w_left[:, None] - at(dis_right) * w_right[:, None]
    diag = torch.diagonal(loss.reshape(N, Q, 4, G, 4), dim1=2, dim2=4)
    return diag.mean(-1) / (G * 4) * weight                    # (N, Q, G)
