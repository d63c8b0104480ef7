"""COCO-protocol bbox evaluation in numpy (port of dskd_tpu/eval/coco_eval.py
``CocoDetectionEval`` for ``iou_type="bbox"``, with ``summarize`` and
``per_class_ap``).

Implements the COCOeval bbox metric (the contract of the reference's
vendored pycocotools + mmdet/datasets/coco.py evaluate()): greedy per-image
per-category matching at 10 IoU thresholds, 101-point interpolated
precision, area-range and maxDets stats, crowd/ignore handling.

Stats layout matches pycocotools summarize():
  [AP, AP50, AP75, APs, APm, APl, AR@1, AR@10, AR@100, ARs, ARm, ARl]

The greedy matching runs in the C++ matcher of ``native/coco_match.cpp``
(built at first use; a failed build raises). ``match_numpy`` is its plain
version. Instance-mask (segm) evaluation belongs to other families and
raises NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..native.build import load_library

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes; crowd GT uses IoF (pycocotools semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    iy = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = ix * iy
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-10)


def match_numpy(dts, gts, gt_ig, crowd, iou_thrs=IOU_THRS):
    """Pure-numpy greedy matching: the plain version of the C++ matcher."""
    T, D, G = len(iou_thrs), len(dts), len(gts)
    ious = bbox_iou_xywh(dts[:, :4], gts, crowd) if G \
        else np.zeros((D, 0))
    dtm = np.zeros((T, D), np.int64) - 1
    dt_ig = np.zeros((T, D), bool)
    gtm = np.zeros((T, G), np.int64) - 1
    for t, thr in enumerate(iou_thrs):
        for d in range(D):
            best, best_iou = -1, min(thr, 1 - 1e-10)
            for g in range(G):
                if gtm[t, g] >= 0 and not crowd[g]:
                    continue
                # non-ignored match found, later gts are all ignored: stop
                if best > -1 and not gt_ig[best] and gt_ig[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best = g
            if best == -1:
                continue
            dtm[t, d] = best
            dt_ig[t, d] = gt_ig[best]
            gtm[t, best] = d
    return dtm, dt_ig


def match_native(dts, gts, gt_ig, crowd, iou_thrs=IOU_THRS):
    """The C++ greedy matcher: (dt_matches (T, D), dt_ignore (T, D))."""
    import ctypes
    lib = load_library()
    T, D, G = len(iou_thrs), len(dts), len(gts)
    dtm = np.zeros((T, D), np.int64)
    dt_ig8 = np.zeros((T, D), np.uint8)
    c = ctypes.c_void_p
    lib.coco_match(
        np.ascontiguousarray(np.asarray(dts, np.float64).reshape(-1, 5)[:, :4]
                             ).ctypes.data_as(c),
        ctypes.c_int64(D),
        np.ascontiguousarray(np.asarray(gts, np.float64).reshape(-1, 4)
                             ).ctypes.data_as(c),
        np.ascontiguousarray(gt_ig, np.uint8).ctypes.data_as(c),
        np.ascontiguousarray(crowd, np.uint8).ctypes.data_as(c),
        ctypes.c_int64(G),
        np.ascontiguousarray(iou_thrs, np.float64).ctypes.data_as(c),
        ctypes.c_int64(T),
        dtm.ctypes.data_as(c), dt_ig8.ctypes.data_as(c))
    return dtm, dt_ig8.astype(bool)


def _evaluate_img(dts, gts, iscrowd, areas_gt, area_rng, max_det,
                  iou_thrs=IOU_THRS):
    """Greedy matching for one (image, category, area range).

    dts: (D, 5) [x, y, w, h, score] sorted desc by score (pre-truncated to
    max_det). gts: (G, 4) xywh. Returns (dt_matches (T, D), dt_ignore (T, D),
    gt_ignore (G,), dt_scores (D,))."""
    gt_ig = (iscrowd.astype(bool) | (areas_gt < area_rng[0])
             | (areas_gt > area_rng[1]))
    # sort gts: non-ignored first (pycocotools order)
    gt_order = np.argsort(gt_ig, kind="mergesort")
    gts = gts[gt_order]
    gt_ig = gt_ig[gt_order]
    crowd = iscrowd[gt_order].astype(bool)
    dtm, dt_ig = match_native(dts, gts, gt_ig, crowd, iou_thrs)
    dt_areas = dts[:, 2] * dts[:, 3]

    # unmatched dts whose area is outside the range are ignored
    out_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
    dt_ig = dt_ig | ((dtm == -1) & out_rng[None])
    return dtm, dt_ig, gt_ig, dts[:, 4]


def _no_masks(masks):
    if masks is not None:
        raise NotImplementedError("instance masks (segm) are not ported")


class CocoDetectionEval:
    """Accumulate per-image detections, produce COCO bbox stats.

    Ground truth is registered via add_gt(img_id, cat_id-labeled boxes);
    detections via add_dt. Boxes are xyxy (converted internally).
    """

    def __init__(self, cat_ids: Sequence[int], max_dets: Sequence[int] = None,
                 iou_thrs: Sequence[float] = None, iou_type: str = "bbox"):
        if iou_type != "bbox":
            raise NotImplementedError(f"iou_type={iou_type!r} is not ported "
                                      "(bbox only)")
        self.cat_ids = list(cat_ids)
        self.iou_type = iou_type
        self.max_dets = tuple(max_dets) if max_dets else MAX_DETS
        self.iou_thrs = (np.asarray(iou_thrs, np.float64)
                         if iou_thrs is not None else IOU_THRS)
        self.gts: Dict[Tuple[int, int], list] = {}
        self.dts: Dict[Tuple[int, int], list] = {}
        self.img_ids: set = set()

    @staticmethod
    def _xyxy_to_xywh(b):
        b = np.asarray(b, np.float64).reshape(-1, 4)
        return np.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0],
                         b[:, 3] - b[:, 1]], -1)

    def add_gt(self, img_id: int, boxes_xyxy, cat_ids, iscrowd=None,
               areas=None, ignore_flags=None, masks=None):
        """``ignore_flags`` marks GT that may match but never counts —
        the COCOEvalXclassWrapper's ignored_split semantics (they are folded
        into the crowd/ignore mechanics of the matcher). ``masks`` (segm)
        raise NotImplementedError."""
        _no_masks(masks)
        boxes = self._xyxy_to_xywh(boxes_xyxy)
        cat_ids = np.asarray(cat_ids).reshape(-1)
        iscrowd = (np.zeros(len(boxes)) if iscrowd is None
                   else np.asarray(iscrowd)).reshape(-1).astype(np.float64)
        if ignore_flags is not None:
            iscrowd = np.maximum(iscrowd,
                                 np.asarray(ignore_flags).reshape(-1))
        areas = (boxes[:, 2] * boxes[:, 3] if areas is None
                 else np.asarray(areas)).reshape(-1)
        self.img_ids.add(img_id)
        for c in set(cat_ids.tolist()):
            m = cat_ids == c
            self.gts.setdefault((img_id, int(c)), []).append(
                (boxes[m], iscrowd[m], areas[m]))

    def add_dt(self, img_id: int, boxes_xyxy, scores, cat_ids, masks=None):
        _no_masks(masks)
        boxes = self._xyxy_to_xywh(boxes_xyxy)
        scores = np.asarray(scores).reshape(-1)
        cat_ids = np.asarray(cat_ids).reshape(-1)
        self.img_ids.add(img_id)
        for c in set(cat_ids.tolist()):
            m = cat_ids == c
            det = np.concatenate([boxes[m], scores[m, None]], -1)
            self.dts.setdefault((img_id, int(c)), []).append(det)

    def _get(self, store, key, width):
        if key not in store:
            return (np.zeros((0, width)), np.zeros(0), np.zeros(0)) \
                if width == 4 else np.zeros((0, width))
        if width == 4:
            bs, cs, ars = zip(*store[key])
            return (np.concatenate(bs), np.concatenate(cs),
                    np.concatenate(ars))
        return np.concatenate(store[key])

    def accumulate(self):
        """Returns (precision (T,R,K,A,M), recall (T,K,A,M))."""
        img_ids = sorted(self.img_ids)
        K, A, M, T, R = (len(self.cat_ids), len(AREA_RANGES),
                         len(self.max_dets), len(self.iou_thrs),
                         len(REC_THRS))
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k, cat in enumerate(self.cat_ids):
            # gather per-image eval results once per area range
            for a, rng in enumerate(AREA_RANGES.values()):
                per_img = []
                for img in img_ids:
                    g_boxes, g_crowd, g_areas = self._get(
                        self.gts, (img, cat), 4)
                    d = self._get(self.dts, (img, cat), 5)
                    if len(g_boxes) == 0 and len(d) == 0:
                        continue
                    order = np.argsort(-d[:, 4], kind="mergesort")
                    order = order[:max(self.max_dets)]
                    d = d[order]
                    per_img.append(_evaluate_img(
                        d, g_boxes, g_crowd, g_areas, rng,
                        max(self.max_dets), self.iou_thrs))
                if not per_img:
                    continue
                n_gt = sum(int((~e[2]).sum()) for e in per_img)
                if n_gt == 0:
                    continue
                for m, md in enumerate(self.max_dets):
                    scores = np.concatenate([e[3][:md] for e in per_img])
                    dtm = np.concatenate([e[0][:, :md] for e in per_img], 1)
                    dtig = np.concatenate([e[1][:, :md] for e in per_img], 1)
                    order = np.argsort(-scores, kind="mergesort")
                    dtm, dtig = dtm[:, order], dtig[:, order]
                    tps = (dtm >= 0) & ~dtig
                    fps = (dtm == -1) & ~dtig
                    tp_cum = np.cumsum(tps, 1).astype(np.float64)
                    fp_cum = np.cumsum(fps, 1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_cum[t], fp_cum[t]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, 1e-10)
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        # monotone-decreasing interpolation
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        idx = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        ok = idx < len(pr)
                        q[ok] = pr[idx[ok]]
                        precision[t, :, k, a, m] = q
        return precision, recall

    def summarize(self) -> Dict[str, float]:
        precision, recall = self.accumulate()

        def ap(t=None, a="all", m=None):
            m = m if m is not None else max(self.max_dets)
            ai = list(AREA_RANGES).index(a)
            mi = self.max_dets.index(m)
            p = precision[..., ai, mi]
            if t is not None:
                p = p[[np.argmin(np.abs(self.iou_thrs - t))]]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def ar(a="all", m=None):
            m = m if m is not None else max(self.max_dets)
            ai = list(AREA_RANGES).index(a)
            mi = self.max_dets.index(m)
            r = recall[..., ai, mi]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        p = self.iou_type                      # the "bbox" key prefix
        stats = {
            f"{p}_mAP": ap(), f"{p}_mAP_50": ap(0.5),
            f"{p}_mAP_75": ap(0.75),
            f"{p}_mAP_s": ap(a="small"), f"{p}_mAP_m": ap(a="medium"),
            f"{p}_mAP_l": ap(a="large"),
        }
        for md in self.max_dets:
            stats[f"AR@{md}"] = ar(m=md)
        stats.update({"AR_s": ar(a="small"), "AR_m": ar(a="medium"),
                      "AR_l": ar(a="large")})
        return stats

    def per_class_ap(self) -> Dict[int, float]:
        precision, _ = self.accumulate()
        out = {}
        for k, cat in enumerate(self.cat_ids):
            p = precision[:, :, k, 0, len(self.max_dets) - 1]
            p = p[p > -1]
            out[cat] = float(p.mean()) if p.size else float("nan")
        return out
