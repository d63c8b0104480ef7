"""Model evaluation loop: the detector's forward -> COCO bbox metrics (port
of dskd_tpu/eval/evaluator.py ``make_eval_step`` and ``evaluate``).

The eval step is the family registry's ``eval_step`` (the model's forward
in eval mode and its family's decode with ``rescale=True``, under
``torch.inference_mode()``), as the JAX registry's. Box collection and COCO
matching run on the host. The scored classes are the dataset's
PRED_CLASSES (the x-class IL protocol: prev+cur classes), padded duplicates
of the last batch count once, and the ground truth comes from the
annotations of the evaluated images. One device: gathering results across
processes (JAX's ``collect_image_results``) is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.coco import TaskCocoDataset
from ..data.loader import DataLoader
from ..registry import get_family
from .coco_eval import CocoDetectionEval


def make_eval_step(model, reg_max: int = 16, score_thr: float = 0.0,
                   max_per_img: int = 100, arch: str = "gfl_deformable_detr"):
    """``step(images, img_hw, scale_factors) -> detections`` of ``model``
    (which the caller puts in eval mode): a lookup in the family registry,
    whose ``eval_step`` returns ``bboxes``, ``scores``, ``labels`` and
    ``valid``."""
    try:
        spec = get_family(arch)
    except ValueError:
        raise ValueError(f"no eval step for arch: {arch}") from None
    return spec["eval_step"](model, score_thr=score_thr,
                             max_per_img=max_per_img, reg_max=reg_max)


def evaluate(model, dataset: TaskCocoDataset, loader: DataLoader,
             reg_max: int = 16, score_thr: float = 0.0,
             max_per_img: int = 100, classwise: bool = False,
             arch: str = "gfl_deformable_detr",
             results_out: Optional[list] = None) -> Dict[str, float]:
    """Run inference over the loader and compute COCO bbox stats; the
    model's train/eval mode is restored afterwards. ``results_out`` gets one
    results2json dict (image_id, xywh bbox, score, category_id) per
    detection."""
    pred_cat_ids = [dataset.ALL_CLASSES_IDS[n] for n in dataset.PRED_CLASSES]
    pred_labels = np.array(sorted(dataset.cat2label[c]
                                  for c in pred_cat_ids))
    ev = CocoDetectionEval(cat_ids=pred_cat_ids)
    eval_step = make_eval_step(model, reg_max, score_thr, max_per_img, arch)
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    seen = set()
    try:
        for batch, meta in loader:
            det = eval_step(
                batch.images.to(device, non_blocking=True),
                batch.img_hw.to(device, non_blocking=True),
                torch.from_numpy(meta["scale_factors"]).to(device))
            boxes, scores, labels, valid = (t.cpu().numpy() for t in (
                det.bboxes, det.scores, det.labels, det.valid))
            for i, img_id in enumerate(meta["img_ids"]):
                if img_id in seen:     # last-batch padding duplicates
                    continue
                seen.add(img_id)
                keep = valid[i] & np.isin(labels[i], pred_labels)
                b, s = boxes[i][keep], scores[i][keep]
                cats = [dataset.label2cat[int(lb)] for lb in labels[i][keep]]
                ev.add_dt(img_id, b, s, cats)
                if results_out is not None:
                    for bb, sc, cat in zip(b, s, cats):
                        results_out.append(dict(
                            image_id=int(img_id),
                            bbox=[float(bb[0]), float(bb[1]),
                                  float(bb[2] - bb[0]),
                                  float(bb[3] - bb[1])],
                            score=float(sc), category_id=int(cat)))
    finally:
        model.train(was_training)

    # ground truth for the evaluated images
    pred_set = set(pred_cat_ids)
    for img_id in seen:
        anns = [a for a in dataset.coco.annotations(img_id)
                if a["category_id"] in pred_set]
        if not anns:
            continue
        gt = np.array([[a["bbox"][0], a["bbox"][1],
                        a["bbox"][0] + a["bbox"][2],
                        a["bbox"][1] + a["bbox"][3]] for a in anns])
        ev.add_gt(img_id, gt, [a["category_id"] for a in anns],
                  iscrowd=[a.get("iscrowd", 0) for a in anns],
                  areas=[a.get("area", None) or a["bbox"][2] * a["bbox"][3]
                         for a in anns])

    stats = ev.summarize()
    if classwise:
        for cid, ap in ev.per_class_ap().items():
            stats[f"AP_{dataset.ALL_IDS_CLASSES[cid]}"] = ap
    return stats
