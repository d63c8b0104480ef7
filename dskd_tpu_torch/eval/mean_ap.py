"""VOC-style mean AP in numpy on the host (a copy of dskd_tpu/eval/mean_ap.py
``average_precision``, ``_overlaps``, ``tpfp_default``, ``eval_map``,
``eval_recalls`` and ``print_map_summary``; the port imports nothing of the
JAX package).

Parity target: mmdet/core/evaluation/mean_ap.py — ``average_precision``
('area' envelope integration and 'voc07' 11-point sampling),
``tpfp_default`` (greedy score-ordered matching with ignore regions and
area ranges) and ``eval_map`` (per-class PR curves, num_gts excluding
ignored, mean over classes with GT). The forgetting A/B
(``tools/ab_forgetting.py``) scores with ``eval_map`` at IoU 0.5.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area"):
    """AP from a PR curve; 'area' = envelope integration, '11points' = VOC07.

    recalls/precisions: (num_dets,) or (num_scales, num_dets).
    """
    no_scale = recalls.ndim == 1
    if no_scale:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack([zeros, recalls, ones])
        mpre = np.hstack([zeros, precisions, zeros])
        # precision envelope (monotone non-increasing from the right)
        mpre = np.maximum.accumulate(mpre[:, ::-1], axis=1)[:, ::-1]
        for i in range(num_scales):
            idx = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, idx + 1] - mrec[i, idx])
                           * mpre[i, idx + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i] >= thr]
                ap[i] += precs.max() if precs.size else 0.0
        ap /= 11
    else:
        raise ValueError(mode)
    return ap[0] if no_scale else ap


def _overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (m, 4) x (n, 4) xyxy boxes."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None] - inter
    return inter / np.maximum(union, np.finfo(np.float32).eps)


def tpfp_default(det_bboxes: np.ndarray, gt_bboxes: np.ndarray,
                 gt_bboxes_ignore: Optional[np.ndarray] = None,
                 iou_thr: float = 0.5,
                 area_ranges: Optional[Sequence[Tuple]] = None):
    """Greedy TP/FP flags per detection (score-descending matching).

    det_bboxes: (m, 5) with score in the last column. Returns (tp, fp) of
    shape (num_scales, m). Detections matching an ignored GT (or a GT
    outside the area range) count neither tp nor fp.
    """
    if gt_bboxes_ignore is None:
        gt_bboxes_ignore = np.empty((0, 4), np.float32)
    gt_ignore = np.concatenate([
        np.zeros(len(gt_bboxes), bool), np.ones(len(gt_bboxes_ignore), bool)])
    gts = np.vstack([gt_bboxes.reshape(-1, 4),
                     gt_bboxes_ignore.reshape(-1, 4)])

    m = det_bboxes.shape[0]
    if area_ranges is None:
        area_ranges = [(None, None)]
    ns = len(area_ranges)
    tp = np.zeros((ns, m), np.float32)
    fp = np.zeros((ns, m), np.float32)

    if len(gts) == 0:
        det_areas = ((det_bboxes[:, 2] - det_bboxes[:, 0])
                     * (det_bboxes[:, 3] - det_bboxes[:, 1]))
        for k, (lo, hi) in enumerate(area_ranges):
            if lo is None:
                fp[k] = 1
            else:
                fp[k, (det_areas >= lo) & (det_areas < hi)] = 1
        return tp, fp

    ious = _overlaps(det_bboxes[:, :4], gts)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    order = np.argsort(-det_bboxes[:, -1])
    gt_areas = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    det_areas = ((det_bboxes[:, 2] - det_bboxes[:, 0])
                 * (det_bboxes[:, 3] - det_bboxes[:, 1]))

    for k, (lo, hi) in enumerate(area_ranges):
        covered = np.zeros(len(gts), bool)
        if lo is None:
            area_ignore = np.zeros(len(gts), bool)
        else:
            area_ignore = (gt_areas < lo) | (gt_areas >= hi)
        for i in order:
            if ious_max[i] >= iou_thr:
                g = ious_argmax[i]
                if not (gt_ignore[g] or area_ignore[g]):
                    if not covered[g]:
                        covered[g] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
                # else: matched an ignored GT -> neither tp nor fp
            elif lo is None:
                fp[k, i] = 1
            elif lo <= det_areas[i] < hi:
                fp[k, i] = 1
    return tp, fp


def eval_map(det_results: List[List[np.ndarray]],
             annotations: List[Dict],
             scale_ranges: Optional[Sequence[Tuple]] = None,
             iou_thr: float = 0.5,
             mode: str = "area") -> Tuple[float, List[Dict]]:
    """Dataset mAP over per-image, per-class detections.

    det_results[i][c]: (m, 5) dets of class c in image i (xyxy + score).
    annotations[i]: dict with 'bboxes' (n, 4), 'labels' (n,), optional
    'bboxes_ignore'/'labels_ignore'. mode='11points' gives the VOC07
    protocol (the reference switches on dataset == 'voc07').
    Returns (mean_ap over classes with GT, per-class result dicts).
    """
    assert len(det_results) == len(annotations)
    num_classes = len(det_results[0])
    area_ranges = ([(lo ** 2, hi ** 2) for lo, hi in scale_ranges]
                   if scale_ranges else None)
    ns = len(scale_ranges) if scale_ranges else 1

    results = []
    for c in range(num_classes):
        cls_dets, cls_gts, cls_ign = [], [], []
        for dets, ann in zip(det_results, annotations):
            cls_dets.append(dets[c].reshape(-1, 5))
            mask = ann["labels"] == c
            cls_gts.append(ann["bboxes"].reshape(-1, 4)[mask])
            if ann.get("labels_ignore") is not None and len(
                    ann.get("labels_ignore", [])):
                imask = ann["labels_ignore"] == c
                cls_ign.append(
                    ann["bboxes_ignore"].reshape(-1, 4)[imask])
            else:
                cls_ign.append(np.empty((0, 4), np.float32))

        tpfp = [tpfp_default(d, g, ig, iou_thr, area_ranges)
                for d, g, ig in zip(cls_dets, cls_gts, cls_ign)]
        tp_list, fp_list = zip(*tpfp)

        num_gts = np.zeros(ns, int)
        for g in cls_gts:
            if area_ranges is None:
                num_gts[0] += len(g)
            else:
                areas = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
                for k, (lo, hi) in enumerate(area_ranges):
                    num_gts[k] += int(((areas >= lo) & (areas < hi)).sum())

        all_dets = np.vstack(cls_dets)
        order = np.argsort(-all_dets[:, -1])
        tp = np.hstack(tp_list)[:, order]
        fp = np.hstack(fp_list)[:, order]
        tp = np.cumsum(tp, axis=1)
        fp = np.cumsum(fp, axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, None], eps)
        precisions = tp / np.maximum(tp + fp, eps)
        if scale_ranges is None:
            recalls, precisions = recalls[0], precisions[0]
            num_gts_out = int(num_gts[0])
        else:
            num_gts_out = num_gts
        ap = average_precision(recalls, precisions, mode)
        results.append(dict(num_gts=num_gts_out,
                            num_dets=int(all_dets.shape[0]),
                            recall=recalls, precision=precisions, ap=ap))

    if scale_ranges is not None:
        all_ap = np.vstack([r["ap"] for r in results])
        all_gts = np.vstack([r["num_gts"] for r in results])
        mean_ap = [float(all_ap[all_gts[:, i] > 0, i].mean())
                   if np.any(all_gts[:, i] > 0) else 0.0
                   for i in range(ns)]
    else:
        aps = [r["ap"] for r in results if r["num_gts"] > 0]
        mean_ap = float(np.mean(aps)) if aps else 0.0
    return mean_ap, results


def eval_recalls(gts: List[np.ndarray], proposals: List[np.ndarray],
                 proposal_nums: Sequence[int] = (100, 300, 1000),
                 iou_thrs: Sequence[float] = (0.5,)) -> np.ndarray:
    """Proposal recall matrix (recall.py eval_recalls): fraction of GT
    covered by the top-k proposals at each IoU threshold.

    Returns (len(proposal_nums), len(iou_thrs))."""
    total_gt = sum(len(g) for g in gts)
    out = np.zeros((len(proposal_nums), len(iou_thrs)), np.float32)
    if total_gt == 0:
        return out
    for pi, k in enumerate(proposal_nums):
        for ti, thr in enumerate(iou_thrs):
            hit = 0
            for g, p in zip(gts, proposals):
                if len(g) == 0:
                    continue
                if p.shape[1] == 5:
                    order = np.argsort(-p[:, 4])
                    pk = p[order[:k], :4]
                else:
                    pk = p[:k, :4]
                ious = _overlaps(g, pk)
                # greedy per-GT coverage
                hit += int((ious.max(axis=1) >= thr).sum()) if pk.size \
                    else 0
            out[pi, ti] = hit / total_gt
    return out


def print_map_summary(mean_ap: float, results: List[Dict],
                      class_names: Optional[Sequence[str]] = None,
                      log=print):
    """Plain-text per-class AP table (the reference's print_map_summary,
    mean_ap.py:689-750, without the terminaltables dependency)."""
    headers = ("class", "gts", "dets", "recall", "ap")
    rows = []
    for c, r in enumerate(results):
        name = class_names[c] if class_names else str(c)
        recall = (float(r["recall"][-1]) if np.ndim(r["recall"])
                  and len(np.atleast_1d(r["recall"])) else 0.0)
        rows.append((name, str(r["num_gts"]), str(r["num_dets"]),
                     f"{recall:.3f}", f"{float(np.mean(r['ap'])):.3f}"))
    rows.append(("mAP", "", "", "", f"{mean_ap:.3f}"))
    widths = [max(len(h), *(len(row[i]) for row in rows))
              for i, h in enumerate(headers)]
    fmt = "| " + " | ".join(f"{{:<{w}}}" for w in widths) + " |"
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    log(sep)
    log(fmt.format(*headers))
    log(sep)
    for row in rows:
        log(fmt.format(*row))
    log(sep)
