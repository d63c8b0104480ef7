"""The port's COCO evaluation against dskd_tpu.eval on the CPU.

* ``CocoDetectionEval``: ``summarize()`` and ``per_class_ap()`` equal
  JAX's (atol 1e-12) on random detections with crowd GT, explicit areas
  and more than 100 detections per image;
* the C++ matcher (``native/coco_match.cpp``, built at first use) equals
  the numpy matcher exactly, and a failed build raises;
* ``results_to_coco_json`` / ``load_coco_results`` write and read what
  JAX's do;
* ``evaluate`` on the tiny model (class logits widened, so scores are far
  apart) gives JAX's stats within 1e-4 and its detections, on GT made from
  the model's own detections so that the mAP is far from 0.
"""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from dskd_tpu.data.coco import COCO_CLASSES_ALPHA_ORDER
from dskd_tpu.eval.coco_eval import CocoDetectionEval as JaxEval
from dskd_tpu_torch.eval import coco_eval
from dskd_tpu_torch.eval.coco_eval import CocoDetectionEval
from dskd_tpu_torch.native import build as native_build

from test_torch_port_tiny import TINY, port_model, tiny_variables

torch.set_num_threads(1)


def _random_eval_inputs(seed, n_img=6, cats=(3, 7, 9)):
    """add_gt / add_dt argument lists: 0-9 GT per image (some crowd, some
    with an explicit area), 80-150 detections per image, half of them
    jittered copies of GT boxes, which mostly score higher."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for img in range(1, n_img + 1):
        n = rng.randint(0, 10)
        xy = rng.rand(n, 2) * 300
        wh = rng.choice([8, 20, 60, 150], (n, 2)) * (0.5 + rng.rand(n, 2))
        boxes = np.concatenate([xy, xy + wh], -1)
        gcats = rng.choice(cats, n)
        crowd = (rng.rand(n) < 0.15).astype(int)
        areas = [None if rng.rand() < 0.5 else float(a) for a in
                 wh.prod(-1) * (0.5 + rng.rand(n))]
        gts.append((img, boxes, gcats, crowd, areas))
        m = rng.randint(80, 151)
        d = rng.rand(m, 4) * 300
        d[:, 2:] = d[:, :2] + rng.rand(m, 2) * 120 + 2
        if n:
            k = m // 2
            src = boxes[rng.randint(n, size=k)]
            d[:k] = src + rng.randn(k, 4) * rng.choice([1, 4, 10], (k, 1))
        dcats = np.where(rng.rand(m) < 0.7, rng.choice(cats, m),
                         np.array(cats)[0])
        if n:
            dcats[:m // 2] = gcats[rng.randint(n, size=m // 2)]
        scores = rng.rand(m) * 0.6
        if n:       # the jittered copies mostly outrank the random boxes
            scores[:m // 2] += 0.4
        dts.append((img, d, scores, dcats))
    return gts, dts


def _fill(ev, gts, dts):
    for img, boxes, cats, crowd, areas in gts:
        if len(boxes):
            a = [x if x is not None else (b[2] - b[0]) * (b[3] - b[1])
                 for x, b in zip(areas, boxes)]
            ev.add_gt(img, boxes, cats, iscrowd=crowd, areas=a)
    for img, boxes, scores, cats in dts:
        ev.add_dt(img, boxes, scores, cats)
    return ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_eval_matches_jax(seed):
    gts, dts = _random_eval_inputs(seed)
    assert max(len(d[1]) for d in dts) > 100
    assert any(g[3].any() for g in gts)
    cats = [3, 7, 9, 11]       # 11: a class with neither GT nor detections
    want = _fill(JaxEval(cats), gts, dts)
    got = _fill(CocoDetectionEval(cats), gts, dts)
    ws, gs = want.summarize(), got.summarize()
    assert list(gs) == list(ws)
    for k in ws:
        assert abs(gs[k] - ws[k]) <= 1e-12, k
    assert 0.05 < ws["bbox_mAP"] < 0.95
    wp, gp = want.per_class_ap(), got.per_class_ap()
    assert list(gp) == list(wp)
    np.testing.assert_allclose([gp[c] for c in cats], [wp[c] for c in cats],
                               rtol=0, atol=1e-12)    # nan for class 11


def _matcher_cases():
    rng = np.random.RandomState(0)
    for D, G in ((0, 3), (5, 0), (1, 1), (40, 12), (150, 30)):
        g = rng.rand(G, 4) * [200, 200, 60, 60] + [0, 0, 2, 2]
        d = np.concatenate([rng.rand(D, 4) * [200, 200, 60, 60] + [0, 0, 2, 2],
                            np.sort(rng.rand(D, 1), 0)[::-1]], -1)
        if G and D:
            d[:D // 2, :4] = g[rng.randint(G, size=D // 2)] + \
                rng.randn(D // 2, 4) * 3
        ig = rng.rand(G) < 0.3
        order = np.argsort(ig, kind="mergesort")
        yield d, g[order], ig[order], (rng.rand(G) < 0.2)[order]


@pytest.mark.parametrize("case", list(range(5)))
def test_native_matcher_equals_numpy(case):
    d, g, ig, crowd = list(_matcher_cases())[case]
    from dskd_tpu.eval.coco_eval import _match_numpy as jax_numpy
    want = coco_eval.match_numpy(d, g, ig, crowd)
    got = coco_eval.match_native(d, g, ig, crowd)
    ref = jax_numpy(d, g, ig, crowd)
    for a, b, c in zip(got, want, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    assert got[0].dtype == np.int64 and got[1].dtype == bool


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "coco_match.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SRC", bad)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "_lib", None)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        native_build.load_library()


def test_segm_is_not_ported():
    with pytest.raises(NotImplementedError, match="segm"):
        CocoDetectionEval([1], iou_type="segm")
    with pytest.raises(NotImplementedError, match="masks"):
        CocoDetectionEval([1]).add_gt(1, [[0, 0, 4, 4]], [1],
                                      masks=np.ones((1, 4, 4)))


def test_results_io_matches_jax(tmp_path):
    from dskd_tpu.eval import results_io as jio
    from dskd_tpu_torch.eval import results_io as pio

    rng = np.random.RandomState(0)
    results = {i: [rng.rand(rng.randint(0, 4), 5).astype(np.float32)
                   for _ in range(3)] for i in (4, 9, 11)}
    label2cat = {0: 5, 1: 53, 2: 27}
    cat2label = {v: k for k, v in label2cat.items()}
    jio.results_to_coco_json(results, label2cat, str(tmp_path / "j.json"))
    pio.results_to_coco_json(results, label2cat, str(tmp_path / "p.json"))
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "p.json").read_text()
    want = jio.load_coco_results(str(tmp_path / "j.json"), cat2label, 3)
    got = pio.load_coco_results(str(tmp_path / "p.json"), cat2label, 3)
    assert list(got) == list(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)


CATS = [cid for _, cid in COCO_CLASSES_ALPHA_ORDER[:10]]
SHAPES = ((48, 64), (64, 48)) * 3 + ((48, 64),)    # 7: a padded last batch


def _jax_evaluate(model, variables, ds_kw, **kw):
    from dskd_tpu.data.coco import TaskCocoDataset
    from dskd_tpu.data.loader import DataLoader
    from dskd_tpu.data.pipeline import PipelineConfig
    from dskd_tpu.eval.evaluator import evaluate

    ds = TaskCocoDataset(**ds_kw)
    loader = DataLoader(ds, 2, PipelineConfig(img_scale=(64, 64),
                                              bucket=(64, 64), max_gt=8),
                        train=False, num_workers=2, drop_last=False)
    return evaluate(model, variables, ds, loader, **kw)


def _port_evaluate(model, ds_kw, **kw):
    from dskd_tpu_torch.data.coco import TaskCocoDataset
    from dskd_tpu_torch.data.loader import DataLoader
    from dskd_tpu_torch.data.pipeline import PipelineConfig
    from dskd_tpu_torch.eval.evaluator import evaluate

    ds = TaskCocoDataset(**ds_kw)
    loader = DataLoader(ds, 2, PipelineConfig(img_scale=(64, 64),
                                              bucket=(64, 64), max_gt=8),
                        train=False, num_workers=0, drop_last=False)
    return evaluate(model, ds, loader, **kw)


def test_evaluate_matches_jax(tmp_path):
    """JAX's detections on the images become the GT (the top five per
    image, jittered, one of them crowd), then both frameworks evaluate the
    tiny model against it on task 2's val split of a 5+5 split."""
    from dskd_tpu.models.detector import GFLDeformableDETR as JaxDETR

    root = str(tmp_path)
    ann, img_dir = chip_smoke.write_coco(root, "val", SHAPES, CATS, seed=2)
    variables = tiny_variables(seed=51, cls_scale=4.0)
    jmodel = JaxDETR(**TINY, remat=False)
    ds_kw = dict(ann_file=ann, img_prefix=img_dir, catsplit=(5, 5),
                 catload=(1, 1), test_mode=True)
    dets = []
    _jax_evaluate(jmodel, variables, ds_kw, results_out=dets)

    rng = np.random.RandomState(0)
    data = json.load(open(ann))
    data["annotations"] = []
    for img in data["images"]:
        mine = sorted((d for d in dets if d["image_id"] == img["id"]),
                      key=lambda d: -d["score"])[:5]
        for j, d in enumerate(mine):
            x, y, w, h = (np.array(d["bbox"]) + rng.randn(4) *
                          [1, 1, 2, 2] * j)
            data["annotations"].append({
                "id": len(data["annotations"]) + 1, "image_id": img["id"],
                "category_id": d["category_id"],
                "bbox": [float(x), float(y), max(float(w), 2.0),
                         max(float(h), 2.0)],
                "iscrowd": int(j == 4), "area": float(w * h) * 1.1})
    ds_kw["ann_file"] = os.path.join(root, "gt.json")
    json.dump(data, open(ds_kw["ann_file"], "w"))

    kw = dict(reg_max=16, score_thr=0.0, max_per_img=100, classwise=True)
    want_dets, got_dets = [], []
    want = _jax_evaluate(jmodel, variables, ds_kw, results_out=want_dets,
                         **kw)
    got = _port_evaluate(port_model(variables).eval(), ds_kw,
                         results_out=got_dets, **kw)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 or \
            (np.isnan(got[k]) and np.isnan(want[k])), k
    assert want["bbox_mAP_50"] > 0.5 and want["bbox_mAP"] > 0.2
    assert len(got_dets) == len(want_dets) == len(SHAPES) * 100
    for g, w in zip(got_dets, want_dets):
        assert (g["image_id"], g["category_id"]) == \
            (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"] + [g["score"]],
                                   w["bbox"] + [w["score"]], rtol=1e-4,
                                   atol=1e-3)
