"""COCO dataset with incremental task splits (port of dskd_tpu/data/coco.py:
``COCO_CLASSES_MMDET_ORDER``, ``COCO_CLASSES_ALPHA_ORDER``,
``CocoAnnotations``, ``split_classes`` and ``TaskCocoDataset``).

  * classes ordered ALPHABETICALLY (the IL convention) and sliced by
    ``catsplit``;
  * ``catload`` (one-hot for train, lower-triangular row for val) selects
    which tasks' classes are LOADED (annotations kept);
  * ``catpred='prev-cur'`` defines the prediction space;
  * images are filtered to those containing at least one loaded-class
    annotation; ``imgpercent`` optionally subsamples;
  * exposes ALL_CLASSES_IDS, cat2label, label2cat, LOAD_CLASSES,
    PRED_CLASSES, TASK_CLASSES, cat_ids_load.

Labels are indices into the alphabetical ordering, so previous-task classes
always occupy labels [0, num_prev), the contiguity the distillation losses
rely on. Instance masks and semantic maps belong to other families and are
not ported: ``seg_prefix`` raises.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# The 80 COCO detection classes with their official category ids
# (public COCO metadata; same table as mmdet's CocoDataset.CLASSES).
COCO_CLASSES_MMDET_ORDER: Tuple[Tuple[str, int], ...] = (
    ("person", 1), ("bicycle", 2), ("car", 3), ("motorcycle", 4),
    ("airplane", 5), ("bus", 6), ("train", 7), ("truck", 8), ("boat", 9),
    ("traffic light", 10), ("fire hydrant", 11), ("stop sign", 13),
    ("parking meter", 14), ("bench", 15), ("bird", 16), ("cat", 17),
    ("dog", 18), ("horse", 19), ("sheep", 20), ("cow", 21),
    ("elephant", 22), ("bear", 23), ("zebra", 24), ("giraffe", 25),
    ("backpack", 27), ("umbrella", 28), ("handbag", 31), ("tie", 32),
    ("suitcase", 33), ("frisbee", 34), ("skis", 35), ("snowboard", 36),
    ("sports ball", 37), ("kite", 38), ("baseball bat", 39),
    ("baseball glove", 40), ("skateboard", 41), ("surfboard", 42),
    ("tennis racket", 43), ("bottle", 44), ("wine glass", 46), ("cup", 47),
    ("fork", 48), ("knife", 49), ("spoon", 50), ("bowl", 51),
    ("banana", 52), ("apple", 53), ("sandwich", 54), ("orange", 55),
    ("broccoli", 56), ("carrot", 57), ("hot dog", 58), ("pizza", 59),
    ("donut", 60), ("cake", 61), ("chair", 62), ("couch", 63),
    ("potted plant", 64), ("bed", 65), ("dining table", 67), ("toilet", 70),
    ("tv", 72), ("laptop", 73), ("mouse", 74), ("remote", 75),
    ("keyboard", 76), ("cell phone", 77), ("microwave", 78), ("oven", 79),
    ("toaster", 80), ("sink", 81), ("refrigerator", 82), ("book", 84),
    ("clock", 85), ("vase", 86), ("scissors", 87), ("teddy bear", 88),
    ("hair drier", 89), ("toothbrush", 90))

# alphabetical ("pinyin") IL ordering — matches data_split.COCO_CATS_IDS
COCO_CLASSES_ALPHA_ORDER: Tuple[Tuple[str, int], ...] = tuple(
    sorted(COCO_CLASSES_MMDET_ORDER, key=lambda kv: kv[0]))


class CocoAnnotations:
    """Minimal COCO detection-JSON reader (replaces vendored pycocotools)."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.images = {im["id"]: im for im in data.get("images", [])}
        self.categories = {c["id"]: c for c in data.get("categories", [])}
        self.img_anns: Dict[int, List[dict]] = {i: [] for i in self.images}
        for ann in data.get("annotations", []):
            if ann["image_id"] in self.img_anns:
                self.img_anns[ann["image_id"]].append(ann)
        self.img_ids = sorted(self.images.keys())

    def annotations(self, img_id: int) -> List[dict]:
        return self.img_anns.get(img_id, [])


def split_classes(ordered: Sequence[Tuple[str, int]],
                  catsplit: Sequence[int]) -> List[List[Tuple[str, int]]]:
    """Slice the ordered (name, catid) list into per-task groups."""
    assert sum(catsplit) <= len(ordered), (catsplit, len(ordered))
    out, start = [], 0
    for n in catsplit:
        out.append(list(ordered[start:start + n]))
        start += n
    return out


class TaskCocoDataset:
    """COCO dataset sliced to an incremental task (see module docstring)."""

    def __init__(self, ann_file: str, img_prefix: str = "",
                 catsplit: Sequence[int] = (80,),
                 catload: Sequence[int] = (1,),
                 catpred: str = "prev-cur", catwise: bool = True,
                 imgpercent: float = 1.0, test_mode: bool = False,
                 class_order: str = "alpha", filter_empty: bool = True,
                 seed: int = 0, classes: Optional[Sequence[str]] = None,
                 seg_prefix: str = ""):
        """``classes`` overrides the COCO table for COCO-format custom
        datasets (the reference's HLKT/WRXT pattern): names are resolved
        against the annotation file's categories, ordered as given (or
        alphabetically when class_order='alpha')."""
        assert len(catsplit) == len(catload)
        if seg_prefix:
            raise NotImplementedError("semantic maps (seg_prefix) are not "
                                      "ported")
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.test_mode = test_mode
        self.coco = CocoAnnotations(ann_file)

        if classes is not None:
            name2id = {c["name"]: cid
                       for cid, c in self.coco.categories.items()}
            ordered = tuple((n, name2id[n]) for n in classes)
            if class_order == "alpha":
                ordered = tuple(sorted(ordered, key=lambda kv: kv[0]))
        else:
            ordered = (COCO_CLASSES_ALPHA_ORDER if class_order == "alpha"
                       else COCO_CLASSES_MMDET_ORDER)
        ordered = ordered[:sum(catsplit)]
        task_groups = split_classes(ordered, catsplit)

        self.TASK_CLASSES = [tuple(n for n, _ in g) for g in task_groups]
        self.ALL_CLASSES_IDS = {n: cid for n, cid in ordered}
        self.ALL_IDS_CLASSES = {cid: n for n, cid in ordered}
        self.CLASSES = tuple(n for n, _ in ordered)
        # labels are indices in the task ordering (prev classes first)
        self.cat2label = {cid: i for i, (_, cid) in enumerate(ordered)}
        self.label2cat = {i: cid for cid, i in self.cat2label.items()}

        loaded_tasks = [i for i, on in enumerate(catload) if on]
        self.LOAD_CLASSES = [n for t in loaded_tasks
                             for n in self.TASK_CLASSES[t]]
        last_loaded = max(loaded_tasks) if loaded_tasks else -1
        if catpred == "prev-cur":
            pred_tasks = range(last_loaded + 1)
        elif catpred == "only-cur":
            pred_tasks = loaded_tasks
        else:
            raise ValueError(catpred)
        self.PRED_CLASSES = [n for t in pred_tasks
                             for n in self.TASK_CLASSES[t]]
        self.cat_ids_load = [self.ALL_CLASSES_IDS[n]
                             for n in self.LOAD_CLASSES]
        self.catwise = catwise

        load_set = set(self.cat_ids_load)
        self.samples = []
        for img_id in self.coco.img_ids:
            anns = [a for a in self.coco.annotations(img_id)
                    if not a.get("iscrowd", 0)
                    and a["category_id"] in load_set
                    and a["bbox"][2] > 1 and a["bbox"][3] > 1]
            if filter_empty and not anns and not test_mode:
                continue
            if test_mode and not anns and filter_empty:
                # the reference's val split also filters to loaded classes
                continue
            self.samples.append((img_id, anns))

        if imgpercent < 1.0:
            rng = np.random.RandomState(seed)
            keep = max(1, int(len(self.samples) * imgpercent))
            idx = rng.permutation(len(self.samples))[:keep]
            self.samples = [self.samples[i] for i in sorted(idx)]

    def __len__(self):
        return len(self.samples)

    def get_raw(self, idx: int):
        """Returns (img_path, (h, w), bboxes xyxy float32 (N,4), labels (N,))."""
        img_id, anns = self.samples[idx]
        info = self.coco.images[img_id]
        path = os.path.join(self.img_prefix, info["file_name"])
        boxes = np.array(
            [[a["bbox"][0], a["bbox"][1],
              a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
             for a in anns], np.float32).reshape(-1, 4)
        labels = np.array([self.cat2label[a["category_id"]] for a in anns],
                          np.int32)
        return path, (info["height"], info["width"]), boxes, labels, img_id
