"""Detection results <-> COCO json (port of dskd_tpu/eval/results_io.py
``results_to_coco_json`` and ``load_coco_results``; the reference's
results2json / format_results)."""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


def results_to_coco_json(results_per_image: Dict[int, List[np.ndarray]],
                         label2cat: Dict[int, int], out_file: str):
    """results_per_image: {img_id: per-class list of (n, 5) arrays in the
    reference's bbox2result layout}. Writes COCO detection-results json."""
    out = []
    for img_id, per_class in results_per_image.items():
        for label, dets in enumerate(per_class):
            for x1, y1, x2, y2, score in np.asarray(dets).reshape(-1, 5):
                out.append({
                    "image_id": int(img_id),
                    "category_id": int(label2cat[label]),
                    "bbox": [float(x1), float(y1),
                             float(x2 - x1), float(y2 - y1)],
                    "score": float(score)})
    with open(out_file, "w") as f:
        json.dump(out, f)
    return out_file


def load_coco_results(path: str, cat2label: Dict[int, int],
                      num_classes: int):
    """Inverse: COCO results json -> {img_id: per-class (n, 5) arrays}."""
    with open(path) as f:
        dets = json.load(f)
    by_img: Dict[int, List[list]] = {}
    for d in dets:
        per_class = by_img.setdefault(
            d["image_id"], [[] for _ in range(num_classes)])
        x, y, w, h = d["bbox"]
        label = cat2label[d["category_id"]]
        per_class[label].append([x, y, x + w, y + h, d["score"]])
    return {img: [np.array(c, np.float32).reshape(-1, 5) for c in pc]
            for img, pc in by_img.items()}
