"""ATSS assignment (port of dskd_tpu/core/atss.py ``atss_assign``), over a
batch of images at once.

Per GT, the ``topk`` anchors of each level whose centres lie closest to
the GT's centre are its candidates; those whose IoU reaches the mean + the
unbiased standard deviation of the candidates' IoUs and whose centres lie
strictly inside the GT are positive for it; an anchor claimed by several
GTs goes to the one of highest IoU (the first of equal ones). Ties in
distance go to the lower anchor index, as ``lax.top_k`` orders them: anchor
centres lie on a grid, so equal distances are common, and ``torch.topk``
promises no order on ties, so this sorts stably instead.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .boxes import bbox_overlaps


class ATSSAssignResult(NamedTuple):
    assigned_gt: torch.Tensor   # (B, N) GT index or -1
    labels: torch.Tensor        # (B, N) int64 label, num_classes if not pos
    pos_mask: torch.Tensor      # (B, N) bool


def _centres(boxes: torch.Tensor) -> torch.Tensor:
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) / 2,
                        (boxes[..., 1] + boxes[..., 3]) / 2], -1)


def atss_assign(anchors: torch.Tensor, num_level_anchors: Sequence[int],
                gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, num_classes: int,
                topk: int = 9) -> ATSSAssignResult:
    """anchors (N, 4) xyxy, level-major; gt_* (B, G, ...) padded."""
    B, G = gt_bboxes.shape[:2]
    N = anchors.shape[0]
    ious = bbox_overlaps(anchors[None].expand(B, -1, -1), gt_bboxes)
    anchor_c = _centres(anchors)                             # (N, 2)
    gt_c = _centres(gt_bboxes)                               # (B, G, 2)
    dist = ((anchor_c[None, :, None] - gt_c[:, None]) ** 2).sum(-1).sqrt()

    cand, start = [], 0
    for n in num_level_anchors:
        d = dist[:, start:start + n].transpose(1, 2)         # (B, G, n)
        order = torch.sort(d, dim=-1, stable=True)[1]
        cand.append(order[..., :min(topk, n)] + start)
        start += n
    cand = torch.cat(cand, dim=-1)                           # (B, G, K)

    cand_ious = torch.gather(ious.transpose(1, 2), 2, cand)
    thr = cand_ious.mean(-1) + cand_ious.std(-1, correction=1)
    cxy = anchor_c[cand]                                     # (B, G, K, 2)
    gb = gt_bboxes[:, :, None]
    inside = ((cxy[..., 0] > gb[..., 0]) & (cxy[..., 0] < gb[..., 2])
              & (cxy[..., 1] > gb[..., 1]) & (cxy[..., 1] < gb[..., 3]))
    is_pos = (cand_ious >= thr[..., None]) & inside & gt_valid[..., None]

    # the (B, N, G) claims; negatives go to a dropped row N
    rows = torch.where(is_pos, cand, torch.full_like(cand, N))
    claims = torch.zeros(B, N + 1, G, dtype=torch.bool, device=ious.device)
    claims.scatter_(1, rows.transpose(1, 2), True)
    claims = claims[:, :N]
    claimed = torch.where(claims, ious, torch.full_like(ious, -1.0))
    pos = claims.any(dim=2)
    assigned = torch.where(pos, claimed.argmax(dim=2),
                           torch.full((B, N), -1, dtype=torch.long,
                                      device=ious.device))
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1,
                                           assigned.clamp(0, G - 1)),
                         num_classes)
    return ATSSAssignResult(assigned, labels, pos)
