"""The port's data layer against dskd_tpu.data on the CPU.

* ``TaskCocoDataset``: the same samples, class maps and class lists as
  JAX's for catsplit (2, 2) and (1, 1, 1, 1) under every catload row, with
  and without ``imgpercent``; exact;
* ``preprocess_sample(train=True)`` under the same ``RandomState``: the GT,
  sizes, scale factor and flip exact (boxes up to f32 rounding, atol 1e-4),
  the image exact where the resize is the identity and within one grey
  level (over the std) where OpenCV resizes in JAX; the same draws from the
  generator;
* ``DataLoader``: JAX's batches over two epochs with ``aspect_buckets`` and
  ``gt_buckets``, and the same batches with 0 and 2 (spawned) workers.
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from dskd_tpu.data.coco import COCO_CLASSES_ALPHA_ORDER
from dskd_tpu.data.coco import TaskCocoDataset as JaxDataset
from dskd_tpu.data.loader import DataLoader as JaxLoader
from dskd_tpu.data.pipeline import PipelineConfig as JaxPipe
from dskd_tpu.data.pipeline import preprocess as jax_preprocess
from dskd_tpu_torch.data import coco as pcoco
from dskd_tpu_torch.data.loader import DataLoader
from dskd_tpu_torch.data.pipeline import PipelineConfig, preprocess_sample

torch.set_num_threads(1)

USE = [5, 53, 27, 52]   # airplane, apple, backpack, banana: labels 0-3


@pytest.fixture(scope="module")
def ann_file(tmp_path_factory):
    """20 images, annotations over the four classes with crowd, tiny and
    empty images among them, and one annotation of another class."""
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(20):
        images.append({"id": 100 - i, "file_name": f"{i}.png",
                       "height": 64, "width": 80})
        for j in range(rng.randint(0, 4)):
            w, h = rng.choice([1, 8, 20]), rng.choice([1, 10, 30])
            anns.append({"id": len(anns) + 1, "image_id": 100 - i,
                         "category_id": int(USE[rng.randint(4)]),
                         "bbox": [3, 4, int(w), int(h)],
                         "iscrowd": int(rng.rand() < 0.15)})
    anns.append({"id": len(anns) + 1, "image_id": 100, "category_id": 90,
                 "bbox": [1, 1, 10, 10], "iscrowd": 0})
    path = tmp_path_factory.mktemp("ann") / "ann.json"
    path.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": n}
                       for n, c in COCO_CLASSES_ALPHA_ORDER]}))
    return str(path)


def _catloads(n):
    """Every train row (one-hot) and val row (lower triangle) of n tasks."""
    eye = [tuple(int(i == t) for i in range(n)) for t in range(n)]
    tril = [tuple(int(i <= t) for i in range(n)) for t in range(n)]
    return sorted(set(eye + tril))


CASES = [(split, load, mode, pct)
         for split in ((2, 2), (1, 1, 1, 1))
         for load in _catloads(len(split))
         for mode in (False, True) for pct in (1.0, 0.5)]


@pytest.mark.parametrize("split,load,test_mode,imgpercent", CASES)
def test_task_dataset_matches_jax(ann_file, split, load, test_mode,
                                  imgpercent):
    kw = dict(catsplit=split, catload=load, test_mode=test_mode,
              imgpercent=imgpercent)
    want, got = JaxDataset(ann_file, "p", **kw), \
        pcoco.TaskCocoDataset(ann_file, "p", **kw)
    assert got.samples == want.samples
    for name in ("cat2label", "label2cat", "PRED_CLASSES", "LOAD_CLASSES",
                 "TASK_CLASSES", "ALL_CLASSES_IDS", "CLASSES",
                 "cat_ids_load"):
        assert getattr(got, name) == getattr(want, name), name
    for i in range(len(want)):
        for g, w in zip(got.get_raw(i), want.get_raw(i)):
            np.testing.assert_array_equal(g, w)
    assert len(want) > 0


@pytest.mark.parametrize("classes,catpred", [
    (("banana", "apple", "backpack", "airplane"), "prev-cur"),
    (None, "only-cur")])
def test_task_dataset_options_match_jax(ann_file, classes, catpred):
    """Custom class names (resolved against the file's categories, sorted)
    and catpred='only-cur'."""
    kw = dict(catsplit=(2, 2), catload=(0, 1), catpred=catpred,
              classes=classes)
    want, got = JaxDataset(ann_file, "p", **kw), \
        pcoco.TaskCocoDataset(ann_file, "p", **kw)
    assert got.samples == want.samples and len(want) > 0
    for name in ("cat2label", "label2cat", "PRED_CLASSES", "LOAD_CLASSES",
                 "CLASSES"):
        assert getattr(got, name) == getattr(want, name), name


def test_class_tables_match_jax():
    from dskd_tpu.data import coco as jcoco
    assert pcoco.COCO_CLASSES_ALPHA_ORDER == jcoco.COCO_CLASSES_ALPHA_ORDER
    assert pcoco.COCO_CLASSES_MMDET_ORDER == jcoco.COCO_CLASSES_MMDET_ORDER
    assert pcoco.split_classes(pcoco.COCO_CLASSES_ALPHA_ORDER, (40, 20)) \
        == jcoco.split_classes(jcoco.COCO_CLASSES_ALPHA_ORDER, (40, 20))


PIPES = [  # (h0, w0, pipeline fields)
    (48, 64, dict(img_scale=(64, 64), bucket=(64, 64))),          # identity
    (64, 48, dict(img_scale=(64, 48), bucket=(64, 48))),          # identity
    (100, 150, dict(img_scale=(128, 96), bucket=(128, 128))),
    (90, 70, dict(img_scale=(64, 64), bucket=(64, 64), flip_ratio=1.0)),
    (120, 160, dict(multi_scales=((96, 64), (128, 96), (160, 120)),
                    bucket=(160, 160), max_gt=4)),
]


@pytest.mark.parametrize("h0,w0,fields", PIPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_preprocess_matches_jax(h0, w0, fields, seed):
    rng = np.random.RandomState(100 + seed)
    img = rng.randint(0, 256, (h0, w0, 3)).astype(np.uint8)
    xy = rng.rand(6, 2) * [w0 * 0.7, h0 * 0.7]
    boxes = np.concatenate([xy, xy + rng.rand(6, 2) * 30 + 2], -1).astype(
        np.float32)
    labels = rng.randint(0, 10, 6).astype(np.int32)
    r_jax, r_port = np.random.RandomState(seed), np.random.RandomState(seed)
    want = jax_preprocess(img, boxes.copy(), labels, JaxPipe(**fields),
                          r_jax, train=True)
    got = preprocess_sample(img, boxes.copy(), labels,
                            PipelineConfig(**fields), r_port, train=True)
    assert r_port.rand() == r_jax.rand()      # the same draws, in order
    assert set(got) == set(want)
    for k in ("img_hw", "gt_labels", "gt_valid", "ori_hw", "flip"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("gt_bboxes", "scale_factor"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert got["image"].shape == want["image"].shape
    assert got["image"].dtype == np.float32
    nh, nw = want["img_hw"]
    if (nh, nw) == (h0, w0):
        np.testing.assert_array_equal(got["image"], want["image"])
    else:
        # OpenCV's uint8 fixed-point bilinear is within one grey level
        diff = np.abs(got["image"] - want["image"]) * PipelineConfig().std
        assert diff.max() <= 1.0 + 1e-4
        assert not got["image"][nh:].any() and not got["image"][:, nw:].any()


def test_unported_augmentation_raises():
    img = np.zeros((8, 8, 3), np.uint8)
    for field in ("photo_metric_distortion", "mosaic", "expand"):
        args = (img, np.zeros((0, 4), np.float32), np.zeros(0, np.int32),
                PipelineConfig(**{field: True}), np.random.RandomState(0))
        if field == "mosaic":
            # ported: the loader mixes before this, which passes it on
            assert preprocess_sample(*args)["image"].shape == (640, 640, 3)
            continue
        with pytest.raises(NotImplementedError, match=field):
            preprocess_sample(*args)


# 40x56 and 56x40 are resized onto the canvas of their aspect; the others
# fit it as they are
LOADER_SHAPES = ((48, 64), (64, 48), (40, 56), (56, 40), (48, 64)) * 3


@pytest.fixture(scope="module")
def loader_coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader"))
    cats = [c for _, c in COCO_CLASSES_ALPHA_ORDER[:10]]
    ann, img_dir = chip_smoke.write_coco(root, "train", LOADER_SHAPES, cats,
                                         seed=3, n_boxes=(1, 7))
    return ann, img_dir


def _loaders(ann, img_dir, train, num_workers):
    kw = dict(catsplit=(10,), catload=(1,), test_mode=not train)
    pipe = dict(img_scale=(64, 64), bucket=(64, 64), max_gt=8,
                flip_ratio=0.5)
    lk = dict(train=train, seed=4, drop_last=train)
    if train:
        lk.update(aspect_buckets=((64, 48), (48, 64)), gt_buckets=(2, 4, 8))
    jax_loader = JaxLoader(JaxDataset(ann, img_dir, **kw), 3,
                           JaxPipe(**pipe), num_workers=2, **lk)
    port_loader = DataLoader(pcoco.TaskCocoDataset(ann, img_dir, **kw), 3,
                             PipelineConfig(**pipe), num_workers=num_workers,
                             **lk)
    return jax_loader, port_loader


def _epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


@pytest.mark.parametrize("train", [True, False])
def test_loader_matches_jax(loader_coco, train):
    jax_loader, port_loader = _loaders(*loader_coco, train, num_workers=0)
    assert len(port_loader) == len(jax_loader)
    want, got = _epochs(jax_loader), _epochs(port_loader)
    trims = set()
    for we, ge in zip(want, got):
        assert len(ge) == len(we) > 0
        for (wb, wm), (gb, gm) in zip(we, ge):
            assert gm["img_ids"] == wm["img_ids"]
            for k in ("scale_factors", "ori_hw"):
                np.testing.assert_array_equal(gm[k], wm[k], err_msg=k)
            assert gb.images.shape == wb.images.shape
            trims.add(gb.gt_valid.shape[1])
            for k in ("img_hw", "gt_labels", "gt_valid"):
                np.testing.assert_array_equal(getattr(gb, k).numpy(),
                                              getattr(wb, k), err_msg=k)
            np.testing.assert_allclose(gb.gt_bboxes.numpy(), wb.gt_bboxes,
                                       rtol=0, atol=1e-4)
            diff = np.abs(gb.images.numpy() - wb.images) * \
                PipelineConfig().std
            assert diff.max() <= 1.0 + 1e-4
    # two epochs differ in order; the GT pad was trimmed to buckets
    assert [m["img_ids"] for _, m in got[0]] != \
        [m["img_ids"] for _, m in got[1]] or not train
    if train:
        assert len(trims) > 1 and trims <= {2, 4, 8}
        canvases = {b.images.shape[1:3] for e in got for b, _ in e}
        assert canvases == {(64, 48), (48, 64)}


def test_loader_workers_give_the_same_batches(loader_coco):
    _, serial = _loaders(*loader_coco, True, num_workers=0)
    _, spawned = _loaders(*loader_coco, True, num_workers=2)
    try:
        want, got = _epochs(serial), _epochs(spawned)
    finally:
        spawned.close()
    assert len(got) == len(want)
    for we, ge in zip(want, got):
        assert len(ge) == len(we)
        for (wb, wm), (gb, gm) in zip(we, ge):
            assert gm["img_ids"] == wm["img_ids"]
            for a, b in zip(gb, wb):
                assert torch.equal(a, b)
