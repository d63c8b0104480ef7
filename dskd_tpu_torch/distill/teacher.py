"""Frozen-teacher forward products for incremental distillation (port of
dskd_tpu/distill/teacher.py ``TeacherInfo``, ``out_teacher`` and
``merge_teacher_gt``).

The teacher's detections are fixed-size (B, K) tensors with a ``valid``
mask, decoded with the teacher test config (score_thr 0.3, max_per_img 100).
Every field is detached: the teacher gets no gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..models.detector import DetectorOutputs
from ..models.gfl_detr_head import DetResults, get_bboxes


class TeacherInfo(NamedTuple):
    neck_feats: Tuple[torch.Tensor, ...]   # NHWC per level
    cls_scores: torch.Tensor               # (nl, B, Q, K) raw logits
    bbox_preds: torch.Tensor               # (nl, B, Q, 2+4*(rm+1))
    memory: torch.Tensor                   # (B, S, C)
    hs: torch.Tensor                       # (nl, B, Q, C)
    det: DetResults                        # fixed-size kept predictions


def out_teacher(outputs: DetectorOutputs, img_hw: torch.Tensor,
                reg_max: int = 16, score_thr: float = 0.3,
                max_per_img: int = 100) -> TeacherInfo:
    """Distill products of a frozen teacher's forward outputs."""
    head = outputs.head
    det = get_bboxes(head.cls_scores[-1], head.bbox_preds[-1], img_hw,
                     reg_max=reg_max, score_thr=score_thr,
                     max_per_img=max_per_img, rescale=False)
    return TeacherInfo(
        neck_feats=tuple(f.detach() for f in outputs.neck_feats),
        cls_scores=head.cls_scores.detach(),
        bbox_preds=head.bbox_preds.detach(),
        memory=head.memory.detach(), hs=head.hs.detach(),
        det=DetResults(*(t.detach() for t in det)))


def merge_teacher_gt(teacher_det: DetResults, gt_bboxes, gt_labels,
                     gt_valid):
    """Hard distillation: GT <- teacher predictions ++ GT, teacher first
    (merged row k < K is teacher prediction k). Returns (bboxes (B, K+G, 4),
    labels (B, K+G), valid (B, K+G))."""
    boxes = torch.cat([teacher_det.bboxes, gt_bboxes], 1)
    labels = torch.cat([teacher_det.labels.to(gt_labels.dtype), gt_labels],
                       1)
    valid = torch.cat([teacher_det.valid, gt_valid], 1)
    return boxes, labels, valid
