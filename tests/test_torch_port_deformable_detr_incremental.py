"""A two-task ``run_incremental`` of the tiny two-stage, box-refining
Deformable-DETR (test_torch_port_deformable_detr's model: ResNet-18, 1+2
layers, 8 queries, 6 classes, 64x64, dropout 0, two steps per task with
eval and checkpoints) on a synthetic COCO, held row by row against JAX's
``train_one_task`` on a one-device mesh from the same weights, with val
mAP equal; ``init_detector`` restores the task-2 checkpoint through the
registry. The family trains without distillation in both packages: task 2
has a teacher, which its losses do not read.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dskd_tpu.data.coco import COCO_CLASSES_ALPHA_ORDER
from dskd_tpu_torch.utils import config as pconfig

from test_torch_port_deformable_detr import (B, TINY, batch_arrays,
                                             jax_variables)

torch.set_num_threads(1)

CATS = [cid for _, cid in COCO_CLASSES_ALPHA_ORDER[:6]]
SHAPES = ((48, 64), (64, 48))


def _run_cfg(mod, root, work, num_workers):
    cfg = mod.ExperimentConfig(
        model=mod.ModelConfig(arch="deformable_detr", dropout=0.0,
                              with_box_refine=True, as_two_stage=True,
                              **TINY),
        train=mod.TrainConfig(base_lr=1e-4, warmup_iters=2,
                              step_epochs=(10,), max_iters_per_task=2,
                              eval_interval=1, ckpt_interval=1,
                              log_interval=1, use_dropout=False, seed=0,
                              work_dir=work),
        distill=mod.DistillFlags(cates_distill="", feats_distill=""))
    cfg.data = mod.DataConfig(
        train_ann=os.path.join(root, "train.json"),
        val_ann=os.path.join(root, "val.json"),
        train_img_prefix=os.path.join(root, "train"),
        val_img_prefix=os.path.join(root, "val"),
        catsplit=(3, 3), samples_per_device=2, num_workers=num_workers,
        max_gt=8, bucket=(64, 64), img_scale=(64, 64))
    return cfg


def _rows(work):
    rows = {}
    for path in glob.glob(os.path.join(work, "*.log.json")):
        for line in open(path):
            r = json.loads(line)
            rows[(r["mode"], r["task"], r["epoch"], r["iter"])] = r
    return rows


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddetr_coco"))
    chip_smoke.write_coco(root, "train", SHAPES * 6, CATS, seed=0)
    chip_smoke.write_coco(root, "val", SHAPES * 2, CATS, seed=1)
    return root


def test_two_task_run_matches_jax_train_one_task(coco):
    """run_incremental against JAX's train_one_task from the same weights:
    train rows (1e-4 relative on a task's first step, 1e-3 after an
    update) and val mAP; then init_detector restores the task-2 checkpoint
    to the run's final detections bit for bit."""
    from dskd_tpu.parallel.mesh import make_mesh
    from dskd_tpu.train.incremental import build_model, train_one_task
    from dskd_tpu.utils import config as jconfig
    from dskd_tpu_torch.apis.inference import init_detector
    from dskd_tpu_torch.eval.evaluator import make_eval_step
    from dskd_tpu_torch.train.incremental import run_incremental

    v = jax_variables(True, True)
    pwork = os.path.join(coco, "port")
    pcfg = _run_cfg(pconfig, coco, pwork, num_workers=0)
    final = run_incremental(pcfg, variables=v, device="cpu")

    jwork = os.path.join(coco, "jax")
    jcfg = _run_cfg(jconfig, coco, jwork, num_workers=2)
    mesh = make_mesh(jax.devices()[:1])
    jmodel = build_model(jcfg)
    jv = train_one_task(jmodel, jcfg, 1, 2, v, None, mesh)
    train_one_task(jmodel, jcfg, 2, 2, jv, jax.tree.map(jnp.copy, jv), mesh)

    want, got = _rows(jwork), _rows(pwork)
    assert sorted(got) == sorted(want)
    assert sorted(k[:2] for k in want if k[0] == "val") == [("val", 1),
                                                             ("val", 2)]
    for key, w in want.items():
        g = got[key]
        if key[0] == "val":
            assert abs(g["bbox_mAP"] - w["bbox_mAP"]) <= 1e-3, key
            continue
        timing = {"img_s", "time"}
        assert set(g) - timing == set(w) - timing, key
        # "loss" also sums the d0. and enc. terms the rows leave out
        assert g["loss"] > g["loss_cls"] + g["loss_bbox"] + g["loss_iou"]
        for k in set(w) - timing - {"mode", "task", "epoch", "iter"}:
            rtol = 1e-4 if key[3] == 1 else 1e-3
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"{key} {k}")

    restored, _ = init_detector(pcfg, os.path.join(pwork, "task_2_epoch_1"),
                                device="cpu")
    images, img_hw, _, _, _ = batch_arrays(seed=6)
    args = (torch.from_numpy(images), torch.from_numpy(img_hw),
            torch.ones(B, 4))
    a = make_eval_step(final.eval(), arch="deformable_detr")(*args)
    b = make_eval_step(restored, arch="deformable_detr")(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
