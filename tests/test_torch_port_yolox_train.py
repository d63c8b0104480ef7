"""YOLOX's training path on the port (``train/schedule.py
yolox_cosine_schedule``, ``data/mix_transforms.py``, the loader's mix and
the driver's no-aug phase) and its eval step and init, against dskd_tpu
on the CPU (tests/torch_port_zoo.py):

- the registry's eval step (f32: labels and valid exactly, scores 1e-5,
  boxes 1e-4) and the seeded init;
- ``yolox_cosine_schedule`` over 50 steps (1e-6 relative: JAX's is f32);
- ``mosaic`` and ``mixup`` equal to JAX's ``mix_transforms`` bit for bit
  on the same seeds (both raise without OpenCV), and the loader's Mosaic
  + MixUp batches against JAX's loader (the same GT; images within one
  grey level, as the pipeline's);
- a port-only YOLOX ``train_one_task`` at tiny size: Mosaic and MixUp off
  and ``loss_l1`` on from the first no-aug epoch, not before.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import torch_port_zoo as Z

torch.set_num_threads(1)

ARCH = "yolox"


def test_eval_step_matches_jax():
    Z.check_eval_step(ARCH)


def test_init_weights_seeded():
    from dskd_tpu_torch.models.yoloy_head import PRIOR_BIAS
    sd = Z.check_init_weights(ARCH)
    np.testing.assert_allclose(
        sd["bbox_head.multi_level_conv_obj.0.bias"].numpy(), PRIOR_BIAS)


def test_yolox_cosine_schedule_matches_jax():
    from dskd_tpu.train.schedule import yolox_cosine_schedule as jsched
    from dskd_tpu_torch.train.schedule import yolox_cosine_schedule
    kw = dict(warmup_iters=10, total_iters=50, last_iters=10,
              min_lr_ratio=0.05)
    want = jsched(0.01, **kw)
    got = yolox_cosine_schedule(0.01, **kw)
    w = np.array([float(want(s)) for s in range(50)])
    g = np.array([got(s) for s in range(50)])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    # quadratic warmup, the floor over the last 10
    assert g[0] == 0 and g[5] == pytest.approx(0.01 * 0.25)
    np.testing.assert_allclose(g[40:], 0.0005, rtol=1e-12)


def _samples(seed, n=5, empty=(3,)):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = rng.randint(20, 70, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        k = 0 if i in empty else rng.randint(1, 5)
        xy = rng.rand(k, 2) * [w - 4, h - 4]
        wh = rng.rand(k, 2) * ([w, h] - xy) + 1
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])],
                               1).astype(np.float32)
        out.append((img, boxes, rng.randint(0, 10, k).astype(np.int32)))
    return out


def _assert_mixed_equal(got, want):
    gi, gb, gl = got
    wi, wb, wl = want
    assert gi.dtype == wi.dtype == np.uint8 and gi.shape == wi.shape
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mosaic_and_mixup_match_jax_bit_for_bit(seed):
    from dskd_tpu.data import mix_transforms as J
    from dskd_tpu_torch.data import mix_transforms as P
    s = _samples(seed)
    order = [(seed + i) % 5 for i in range(4)]
    four = [s[i] for i in order]
    outs = []
    for mod in (J, P):
        rng = np.random.RandomState(seed)
        m = mod.mosaic(four, (48, 64), rng)
        r = s[4 - seed % 2]          # sample 3 has no boxes: no mixup
        x = mod.mixup(*m, *r, rng, dynamic_scale=(48, 64))
        outs.append((m, x, rng.randint(1 << 30)))
    (jm, jx, jnext), (pm, px, pnext) = outs
    _assert_mixed_equal(pm, jm)
    _assert_mixed_equal(px, jx)
    assert pnext == jnext            # the same number of draws
    assert len(pm[1]) > 0


def test_mosaic_and_mixup_without_opencv(monkeypatch):
    """The resize is OpenCV's, as JAX's: without cv2 both transforms raise
    rather than resize another way."""
    import builtins

    from dskd_tpu_torch.data import mix_transforms as P
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *a, **kw)

    s = _samples(7, empty=())
    m = P.mosaic(s[:4], (48, 64), np.random.RandomState(5))
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="cv2"):
        P.mosaic(s[:4], (48, 64), np.random.RandomState(5))
    with pytest.raises(ImportError, match="cv2"):
        P.mixup(*m, *s[4], np.random.RandomState(6), dynamic_scale=(48, 64))


LOADER_SHAPES = ((48, 64), (64, 48), (40, 56), (56, 40), (48, 64)) * 2


@pytest.fixture(scope="module")
def mix_coco(tmp_path_factory):
    import chip_smoke
    from dskd_tpu.data.coco import COCO_CLASSES_ALPHA_ORDER
    root = str(tmp_path_factory.mktemp("mix"))
    cats = [c for _, c in COCO_CLASSES_ALPHA_ORDER[:10]]
    return chip_smoke.write_coco(root, "train", LOADER_SHAPES, cats, seed=5,
                                 n_boxes=(1, 5))


def test_loader_mosaic_mixup_matches_jax(mix_coco):
    from dskd_tpu.data.coco import TaskCocoDataset as JaxDataset
    from dskd_tpu.data.loader import DataLoader as JaxLoader
    from dskd_tpu.data.pipeline import PipelineConfig as JaxPipe
    from dskd_tpu_torch.data import coco as pcoco
    from dskd_tpu_torch.data.loader import DataLoader
    from dskd_tpu_torch.data.pipeline import PipelineConfig

    ann, img_dir = mix_coco
    kw = dict(catsplit=(10,), catload=(1,))
    pipe = dict(img_scale=(64, 64), bucket=(64, 64), max_gt=16,
                mosaic=True, mixup=True)
    want = list(JaxLoader(JaxDataset(ann, img_dir, **kw), 2, JaxPipe(**pipe),
                          num_workers=2, seed=4))
    got = list(DataLoader(pcoco.TaskCocoDataset(ann, img_dir, **kw), 2,
                          PipelineConfig(**pipe), num_workers=0, seed=4))
    assert len(got) == len(want) > 0
    n_gt = 0
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gm["img_ids"] == wm["img_ids"]
        for k in ("img_hw", "gt_labels", "gt_valid"):
            np.testing.assert_array_equal(getattr(gb, k).numpy(),
                                          getattr(wb, k), err_msg=k)
        np.testing.assert_allclose(gb.gt_bboxes.numpy(), wb.gt_bboxes,
                                   rtol=0, atol=1e-4)
        diff = np.abs(gb.images.numpy() - wb.images) * PipelineConfig().std
        assert diff.max() <= 1.0 + 1e-4
        n_gt += int(wb.gt_valid.sum())
    # mosaics gather more GT than the four-box images hold alone
    assert n_gt > 5 * len(want)


def _train_rows(work):
    rows = []
    for path in glob.glob(os.path.join(work, "*.log.json")):
        rows += [json.loads(line) for line in open(path)]
    return [r for r in rows if r.get("mode") == "train"]


def test_no_aug_switch_turns_mix_off_and_l1_on(mix_coco, tmp_path,
                                                monkeypatch):
    from dskd_tpu_torch.data import loader as ploader
    from dskd_tpu_torch.train.incremental import (build_model,
                                                  init_variables,
                                                  train_one_task)
    from dskd_tpu_torch.utils import config as pconfig

    ann, img_dir = mix_coco
    cfg = pconfig.ExperimentConfig(
        model=pconfig.ModelConfig(arch=ARCH, num_classes=10),
        data=pconfig.DataConfig(
            catsplit=(10,), train_ann=ann, val_ann=ann,
            train_img_prefix=img_dir, val_img_prefix=img_dir,
            samples_per_device=4, num_workers=0, img_scale=(64, 64),
            bucket=(64, 64), max_gt=16, mosaic=True, mixup=True),
        train=pconfig.TrainConfig(
            base_lr=1e-3, weight_decay=5e-4, grad_clip=35.0,
            epochs_per_task=3, lr_policy="yolox_cosine", warmup_iters=2,
            no_aug_epochs=1, use_ema=True, log_interval=1,
            eval_interval=0, ckpt_interval=10, work_dir=str(tmp_path)))
    epochs = []
    mosaic = ploader.mosaic
    monkeypatch.setattr(ploader, "mosaic", lambda *a, **kw: (
        epochs.append(current[0]), mosaic(*a, **kw))[1])
    current = [0]
    make_loader = ploader.DataLoader.__iter__

    def iterate(self):
        current[0] += 1
        yield from make_loader(self)

    monkeypatch.setattr(ploader.DataLoader, "__iter__", iterate)
    model = build_model(cfg, "cpu")
    init_variables(model, cfg, 0)
    train_one_task(model, cfg, 1, 1, device="cpu")
    rows = _train_rows(str(tmp_path))
    assert sorted({r["epoch"] for r in rows}) == [1, 2, 3]
    for r in rows:
        assert ("loss_l1" in r) == (r["epoch"] == 3), r
    # every image of epochs 1-2 is a mosaic, none of epoch 3
    assert sorted(set(epochs)) == [1, 2]
    assert len(epochs) == 2 * 2 * 4
