"""dskd_tpu_torch runs its serving and training slices without importing JAX,
Flax or the JAX package: a fresh interpreter loads the flagship config file
through the port's ``load_config``, builds a tiny model from the port's own
config classes, runs init_detector + inference_detector and one incremental
train step, imports every module of the port, runs the
``dskd_tpu_torch.tools.train_increment`` CLI (two tasks with eval and
checkpoints on a synthetic COCO, tiny model, ``--device cpu``), the
``dskd_tpu_torch.tools.test`` CLI on its last checkpoint, a one-step
forgetting A/B (``tools/ab_forgetting.py``) and a JV assignment, then
loads ``configs/detr_40_40_il.py``, cut to a tiny size, runs one DETR-IL
family step with a teacher, the ``train_increment`` CLI on DETR for two
tasks and the ``test`` CLI on its last checkpoint, loads
``configs/yolof_40_40_il.py`` and ``configs/yoloy_40_40_il.py``, cut to a
tiny size, runs one family step of each with a teacher, the
``train_increment`` CLI for two tasks and the ``test`` CLI on each, a
class-aware NMS on both of its paths, and reports which modules it
loaded. A second fresh interpreter loads the three
``configs/deformable_detr_*.py``, cut to a tiny size, runs one family step
of each, and the ``train_increment`` and ``test`` CLIs on the two-stage
config. Further interpreters step the dense families, LD with its
ResNet-101 teacher and NAS-FPN from their configs, and the DCN families
(ATSS-DyHead, NAS-FCOS, VFNet, RepPoints) with both CLIs on VFNet, and the
dense heads TOOD, FSAF, FoveaBox, AutoAssign, FreeAnchor and SABL-RetinaNet
from their configs, and the RegNetX, EfficientNet, PVT and HRNet configs,
YOLOX (with both CLIs through its no-aug switch), YOLOv3 and CenterNet
from theirs. An import hook refuses
``jax``, ``jaxlib``, ``flax`` and ``dskd_tpu`` throughout."""
import json
import os
import subprocess
import sys

_REFUSE = r"""
import dataclasses, importlib.abc, json, sys


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "dskd_tpu"):
            raise ModuleNotFoundError(f"{name} is refused in this process")
        return None


sys.meta_path.insert(0, _Refuse())
"""
_SCRIPT = _REFUSE + r"""
import numpy as np
import torch
torch.set_num_threads(1)
from dskd_tpu_torch.apis.inference import init_detector, inference_detector
from dskd_tpu_torch.utils.config import load_config

flagship = load_config("configs/gfl_deformable_detr_40_40_il.py")
cfg = dataclasses.replace(
    flagship,
    model=dataclasses.replace(flagship.model, num_classes=7, num_query=12,
                              depth=18, num_encoder_layers=1,
                              num_decoder_layers=2),
    data=dataclasses.replace(flagship.data, bucket=(128, 128),
                             img_scale=(128, 128)))
model, cfg = init_detector(cfg, device="cpu", seed=0)
rng = np.random.RandomState(0)
imgs = [rng.randint(0, 256, (100, 128, 3)).astype(np.uint8),
        rng.randint(0, 256, (128, 90, 3)).astype(np.uint8)]
res = inference_detector(model, cfg, imgs)

from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.distill.losses import DistillConfig
from dskd_tpu_torch.models.gfl_detr_loss import DetLossConfig
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState, frozen_copy
from dskd_tpu_torch.train.step import make_train_step
state = TrainState.create(model, make_optimizer(model, step_lr_schedule(
    2e-4)), seed=0)
step = make_train_step(DetLossConfig(num_classes=7), DistillConfig.from_flags(
    cates_distill="hard + teacher-first",
    feats_distill="corr + fg_info + decode_v1", num_prev=3))
batch = Batch(torch.randn(2, 128, 128, 3), torch.tensor([[128, 100],
                                                         [96, 128]]),
              torch.tensor([[[10., 10., 60., 50.]] * 2] * 2),
              torch.tensor([[1, 2]] * 2), torch.tensor([[True, False]] * 2))
state, losses = step(state, batch, frozen_copy(model))

import glob, importlib, os, pkgutil, runpy, tempfile
import chip_smoke
import dskd_tpu_torch
for mod in pkgutil.walk_packages(dskd_tpu_torch.__path__, "dskd_tpu_torch."):
    importlib.import_module(mod.name)
root = tempfile.mkdtemp()
from dskd_tpu_torch.data.coco import COCO_CLASSES_ALPHA_ORDER
cats = [c for _, c in COCO_CLASSES_ALPHA_ORDER]
ann, img_dir = chip_smoke.write_coco(root, "train", ((48, 64), (64, 48)) * 6,
                                     cats[:8], seed=0)
work = os.path.join(root, "work")
sets = ["model.depth=18", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.num_query=12",
        "data.bucket=(64,64)", "data.img_scale=(64,64)",
        "data.aspect_buckets=((64,48),(48,64))", "data.catsplit=(4,4)",
        "model.num_classes=8", "data.num_workers=0",
        "data.samples_per_device=2", f"data.train_ann={ann}",
        f"data.val_ann={ann}", f"data.train_img_prefix={img_dir}",
        f"data.val_img_prefix={img_dir}", "train.max_iters_per_task=2",
        "train.log_interval=1"]
cfg_file = "configs/gfl_deformable_detr_40_40_il.py"
sys.argv = ["train_increment", cfg_file, "--work-dir", work, "--seed", "1",
            "--device", "cpu", "--set", *sets]
runpy.run_module("dskd_tpu_torch.tools.train_increment", run_name="__main__")
rows = [json.loads(l) for f in glob.glob(os.path.join(work, "*.log.json"))
        for l in open(f)]
# DETR-IL: its config, one family step with a teacher, and the CLI
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.incremental import build_model, init_variables
detr = load_config("configs/detr_40_40_il.py")
dcfg = dataclasses.replace(detr, model=dataclasses.replace(
    detr.model, num_classes=8, num_query=12, depth=18, num_encoder_layers=1,
    num_decoder_layers=1))
dmodel = init_variables(build_model(dcfg, "cpu"), dcfg, 0)
dstate = TrainState.create(dmodel, make_optimizer(dmodel, step_lr_schedule(
    1e-4)), seed=0)
dstep = make_family_train_step("detr", dmodel, dcfg, 4, True)
dstate, dlosses = dstep(dstate, batch, frozen_copy(dmodel))
dwork = os.path.join(root, "detr")
sys.argv = ["train_increment", "configs/detr_40_40_il.py", "--work-dir",
            dwork, "--seed", "1", "--device", "cpu", "--set", *sets]
runpy.run_module("dskd_tpu_torch.tools.train_increment", run_name="__main__")
drows = [json.loads(l) for f in glob.glob(os.path.join(dwork, "*.log.json"))
         for l in open(f)]
from dskd_tpu_torch.tools import test as test_cli
dstats = test_cli.main(["configs/detr_40_40_il.py", "--work-dir", dwork,
                        "--device", "cpu", "--set", *sets])
from dskd_tpu_torch.core.matching import hungarian_assign
from dskd_tpu_torch.tools.ab_forgetting import run_forgetting_ab
ab = run_forgetting_ab(1, 1, n_eval=2, device="cpu",
                       cates_distill="hard + teacher-first + soft")
jv = hungarian_assign(torch.rand(2, 9, 5), torch.ones(2, 5, dtype=bool),
                      torch.zeros(2, 5, dtype=torch.int64), solver="jv")
# YOLOF-IL and YOLOY-IL: their configs, one family step each with a
# teacher, and an NMS on the tiled and the scan path
from dskd_tpu_torch.core.postprocess import batched_nms
yolo = {}
for arch in ("yolof", "yoloy"):
    ycfg = load_config(f"configs/{arch}_40_40_il.py")
    ycfg = dataclasses.replace(ycfg, model=dataclasses.replace(
        ycfg.model, num_classes=8, depth=18))
    ymodel = init_variables(build_model(ycfg, "cpu"), ycfg, 0)
    ystate = TrainState.create(ymodel, make_optimizer(
        ymodel, step_lr_schedule(1e-4)), seed=0)
    ystep = make_family_train_step(arch, ymodel, ycfg, 4, True)
    ystate, ylosses = ystep(ystate, batch, frozen_copy(ymodel))
    ywork = os.path.join(root, arch)
    yfile = f"configs/{arch}_40_40_il.py"
    sys.argv = ["train_increment", yfile, "--work-dir", ywork, "--seed", "1",
                "--device", "cpu", "--set", *sets]
    runpy.run_module("dskd_tpu_torch.tools.train_increment",
                     run_name="__main__")
    ystats = test_cli.main([yfile, "--work-dir", ywork, "--device", "cpu",
                            "--set", *sets])
    yolo[arch] = [ycfg.model.arch, ycfg.distill.cates_distill,
                  ycfg.distill.locat_distill, ycfg.distill.feats_distill,
                  sorted(k for k, v in ylosses.items()
                         if bool(torch.isfinite(v))),
                  sorted(os.path.basename(p) for p in
                         glob.glob(os.path.join(ywork, "task_*"))),
                  0.0 <= ystats["bbox_mAP"] <= 1.0]
xy = torch.rand(2, 900, 2) * 60
nms_boxes = torch.cat([xy, xy + 20], -1)
nms_args = (nms_boxes, torch.rand(2, 900), torch.randint(0, 3, (2, 900)),
            0.5, 300)
tiled = batched_nms(*nms_args)
from dskd_tpu_torch.core import postprocess
keep_tiled = postprocess._nms_keep_tiled
postprocess._nms_keep_tiled = (lambda shifted, svalid, iou_thr, tile:
                               postprocess._nms_keep_scan(shifted, svalid,
                                                          iou_thr))
scan = batched_nms(*nms_args)
postprocess._nms_keep_tiled = keep_tiled
out = os.path.join(root, "dets.json")
sys.argv = ["test", cfg_file, "--work-dir", work, "--device", "cpu",
            "--classwise", "--out", out, "--set", *sets]
runpy.run_module("dskd_tpu_torch.tools.test", run_name="__main__")
print(json.dumps({
    "ckpts": sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(work, "task_*"))),
    "rows": sorted((r["mode"], r["task"]) for r in rows),
    "dets": len(json.load(open(out))),
    "ab": sorted(k for k, v in ab.items() if np.isfinite(v)),
    "jv_pos": int(jv.pos_mask.sum()),
    "detr": [detr.model.arch, detr.model.num_query,
             detr.distill.cates_distill, detr.distill.feats_distill],
    "detr_step": sorted(k for k, v in dlosses.items()
                        if bool(torch.isfinite(v))),
    "detr_ckpts": sorted(os.path.basename(p) for p in
                         glob.glob(os.path.join(dwork, "task_*"))),
    "detr_rows": sorted((r["mode"], r["task"]) for r in drows),
    "detr_map": 0.0 <= dstats["bbox_mAP"] <= 1.0,
    "yolo": yolo,
    "nms": [int(tiled.keep.sum()), all(bool(torch.equal(a, b))
                                       for a, b in zip(tiled, scan))],
    "trained": bool(torch.isfinite(losses["loss"])),
    "n_images": len(res), "n_classes": len(res[0]),
    "shapes_ok": all(r.ndim == 2 and r.shape[1] == 5 for per in res
                     for r in per),
    "finite": all(bool(np.isfinite(r).all()) for per in res for r in per),
    "flagship": [flagship.model.depth, flagship.distill.feats_distill,
                 list(flagship.data.aspect_buckets[0])],
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "dskd_tpu"))}))
"""


_DDETR_SCRIPT = _REFUSE + r"""
import glob, os, runpy, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
import chip_smoke
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.data.coco import COCO_CLASSES_ALPHA_ORDER
from dskd_tpu_torch.tools import test as test_cli
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.incremental import build_model, init_variables
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState, frozen_copy
from dskd_tpu_torch.utils.config import load_config
batch = Batch(torch.randn(2, 128, 128, 3), torch.tensor([[128, 100],
                                                         [96, 128]]),
              torch.tensor([[[10., 10., 60., 50.]] * 2] * 2),
              torch.tensor([[1, 2]] * 2), torch.tensor([[True, False]] * 2))
root = tempfile.mkdtemp()
cats = [c for _, c in COCO_CLASSES_ALPHA_ORDER]
ann, img_dir = chip_smoke.write_coco(root, "train", ((48, 64), (64, 48)) * 6,
                                     cats[:8], seed=0)
sets = ["model.depth=18", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.num_query=12",
        "data.bucket=(64,64)", "data.img_scale=(64,64)",
        "data.aspect_buckets=((64,48),(48,64))", "data.catsplit=(4,4)",
        "model.num_classes=8", "data.num_workers=0",
        "data.samples_per_device=2", f"data.train_ann={ann}",
        f"data.val_ann={ann}", f"data.train_img_prefix={img_dir}",
        f"data.val_img_prefix={img_dir}", "train.max_iters_per_task=2",
        "train.log_interval=1"]
# vanilla Deformable DETR: its three configs, a family step each, and both
# CLIs on the two-stage config
ddetr = {}
for name in ("", "refine_", "twostage_"):
    xfile = f"configs/deformable_detr_{name}r50_50e.py"
    xcfg = load_config(xfile)
    xcfg = dataclasses.replace(xcfg, model=dataclasses.replace(
        xcfg.model, num_classes=8, num_query=12, depth=18,
        num_encoder_layers=1, num_decoder_layers=1))
    xmodel = init_variables(build_model(xcfg, "cpu"), xcfg, 0)
    xstate = TrainState.create(xmodel, make_optimizer(
        xmodel, step_lr_schedule(1e-4)), seed=0)
    xstep = make_family_train_step("deformable_detr", xmodel, xcfg, 4, True)
    xstate, xlosses = xstep(xstate, batch, frozen_copy(xmodel))
    ddetr[name or "base"] = [xcfg.model.with_box_refine,
                             xcfg.model.as_two_stage,
                             sorted(k for k, v in xlosses.items()
                                    if bool(torch.isfinite(v)))]
xwork = os.path.join(root, "ddetr")
xfile = "configs/deformable_detr_twostage_r50_50e.py"
sys.argv = ["train_increment", xfile, "--work-dir", xwork, "--seed", "1",
            "--device", "cpu", "--set", *sets]
runpy.run_module("dskd_tpu_torch.tools.train_increment", run_name="__main__")
xstats = test_cli.main([xfile, "--work-dir", xwork, "--device", "cpu",
                        "--set", *sets])
ddetr["cli"] = [sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(xwork, "task_*"))),
                0.0 <= xstats["bbox_mAP"] <= 1.0]
print(json.dumps({
    "ddetr": ddetr,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "dskd_tpu"))}))
"""

_DENSE_SCRIPT = _REFUSE + r"""
import importlib
import numpy as np
import torch
torch.set_num_threads(1)
from dskd_tpu_torch import registry
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.eval.evaluator import make_eval_step
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState
from dskd_tpu_torch.utils.config import (ExperimentConfig, ModelConfig,
                                         load_config)

for name in ("core.atss", "core.max_iou_assigner", "core.boxes",
             "core.integral", "core.postprocess", "models.fpn",
             "models.backbones", "models.gfl_head", "models.gfl",
             "models.atss", "models.retinanet", "models.fcos",
             "utils.weights"):
    importlib.import_module("dskd_tpu_torch." + name)
rng = np.random.RandomState(0)
images = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
img_hw = torch.tensor([[64, 64], [48, 60]], dtype=torch.int32)
gt = torch.tensor([[[4., 6., 40., 50.], [30., 10., 60., 30.]],
                   [[2., 2., 20., 30.], [0., 0., 0., 0.]]])
batch = Batch(images, img_hw, gt, torch.tensor([[1, 3], [2, 0]]),
              torch.tensor([[True, True], [True, False]]))
report = {}
for arch in ("retinanet", "atss", "gfl", "fcos"):
    cfg = load_config(f"configs/{arch}_r50_1x.py")
    cfg.model = ModelConfig(arch=arch, num_classes=5, depth=18)
    spec = registry.get_family(arch)
    model = spec["build"](cfg.model, "cpu")
    spec["init_weights"](model, 0)
    with torch.no_grad():
        out = model(images, img_hw)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    step = make_family_train_step(arch, model, cfg, num_prev=0,
                                  has_teacher=False)
    state, losses = step(state, batch)
    det = make_eval_step(model.eval(), cfg.model.reg_max, 0.0, 20,
                         arch)(images, img_hw, torch.ones(2, 4))
    report[arch] = [len(out.neck_feats), sorted(losses),
                    all(bool(torch.isfinite(v)) for v in losses.values()),
                    list(det.bboxes.shape)]
print(json.dumps({
    "dense": report,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "dskd_tpu"))}))
"""

_LD_NASFPN_SCRIPT = _REFUSE + r"""
import importlib
import numpy as np
import torch
torch.set_num_threads(1)
from dskd_tpu_torch import registry
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.incremental import build_teacher_model
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState, frozen_copy
from dskd_tpu_torch.utils.config import load_config

for name in ("models.ld", "models.paa", "models.pisa", "models.fpg",
             "models.nas_fpn", "models.retinanet", "core.losses",
             "utils.weights"):
    importlib.import_module("dskd_tpu_torch." + name)
rng = np.random.RandomState(0)
images = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
img_hw = torch.tensor([[64, 64], [48, 60]], dtype=torch.int32)
gt = torch.tensor([[[4., 6., 40., 50.], [30., 10., 60., 30.]],
                   [[2., 2., 20., 30.], [0., 0., 0., 0.]]])
batch = Batch(images, img_hw, gt, torch.tensor([[1, 3], [2, 0]]),
              torch.tensor([[True, True], [True, False]]))
report = {}
for config, sets in (("ld_r18_gflv1_r101_1x", {}),
                     ("retinanet_r50_nasfpn_50e", {"depth": 18})):
    cfg = load_config(f"configs/{config}.py")
    cfg.model = dataclasses.replace(cfg.model, num_classes=5, **sets)
    spec = registry.get_family(cfg.model.arch)
    model = spec["build"](cfg.model, "cpu")
    spec["init_weights"](model, 0)
    teacher = None
    if cfg.model.teacher_depth:
        t = build_teacher_model(cfg, "cpu")
        spec["init_weights"](t, 1)
        teacher = frozen_copy(t)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    step = make_family_train_step(cfg.model.arch, model, cfg, num_prev=0,
                                  has_teacher=teacher is not None)
    state, losses = step(state, batch, teacher)
    report[cfg.model.arch] = [
        cfg.model.depth, None if teacher is None else
        len(teacher.backbone.layer3), sorted(losses),
        all(bool(torch.isfinite(v)) for v in losses.values())]
print(json.dumps({
    "variants": report,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "dskd_tpu"))}))
"""

_DCN_SCRIPT = _REFUSE + r"""
import glob, importlib, os, runpy, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
import chip_smoke
from dskd_tpu_torch import registry
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.data.coco import COCO_CLASSES_ALPHA_ORDER
from dskd_tpu_torch.eval.evaluator import make_eval_step
from dskd_tpu_torch.tools import test as test_cli
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState
from dskd_tpu_torch.utils.config import load_config

for name in ("ops.deform_conv", "models.dyhead", "models.nasfcos_fpn",
             "models.vfnet", "models.reppoints", "utils.weights"):
    importlib.import_module("dskd_tpu_torch." + name)
rng = np.random.RandomState(0)
images = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
img_hw = torch.tensor([[64, 64], [48, 60]], dtype=torch.int32)
gt = torch.tensor([[[4., 6., 40., 50.], [30., 10., 60., 30.]],
                   [[2., 2., 20., 30.], [0., 0., 0., 0.]]])
batch = Batch(images, img_hw, gt, torch.tensor([[1, 3], [2, 0]]),
              torch.tensor([[True, True], [True, False]]))
report = {}
for config in ("atss_r50_dyhead_1x", "nasfcos_r50_1x", "vfnet_r50_1x",
               "reppoints_moment_r50_1x"):
    cfg = load_config(f"configs/{config}.py")
    cfg.model = dataclasses.replace(cfg.model, num_classes=5, depth=18)
    spec = registry.get_family(cfg.model.arch)
    model = spec["build"](cfg.model, "cpu")
    spec["init_weights"](model, 0)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    step = make_family_train_step(cfg.model.arch, model, cfg, num_prev=0,
                                  has_teacher=False)
    state, losses = step(state, batch)
    det = make_eval_step(model.eval(), cfg.model.reg_max, 0.0, 20,
                         cfg.model.arch)(images, img_hw, torch.ones(2, 4))
    report[config] = [cfg.model.arch, cfg.model.dyhead_blocks,
                      sorted(losses),
                      all(bool(torch.isfinite(v)) for v in losses.values()),
                      list(det.bboxes.shape)]
root = tempfile.mkdtemp()
cats = [c for _, c in COCO_CLASSES_ALPHA_ORDER]
ann, img_dir = chip_smoke.write_coco(root, "train", ((48, 64), (64, 48)) * 6,
                                     cats[:8], seed=0)
sets = ["model.depth=18", "data.bucket=(64,64)", "data.img_scale=(64,64)",
        "data.aspect_buckets=((64,48),(48,64))", "data.catsplit=(4,4)",
        "model.num_classes=8", "data.num_workers=0",
        "data.samples_per_device=2", f"data.train_ann={ann}",
        f"data.val_ann={ann}", f"data.train_img_prefix={img_dir}",
        f"data.val_img_prefix={img_dir}", "train.max_iters_per_task=2",
        "train.log_interval=1"]
work = os.path.join(root, "vfnet")
sys.argv = ["train_increment", "configs/vfnet_r50_1x.py", "--work-dir", work,
            "--seed", "1", "--device", "cpu", "--set", *sets]
runpy.run_module("dskd_tpu_torch.tools.train_increment", run_name="__main__")
stats = test_cli.main(["configs/vfnet_r50_1x.py", "--work-dir", work,
                       "--device", "cpu", "--set", *sets])
report["cli"] = [sorted(os.path.basename(p) for p in
                        glob.glob(os.path.join(work, "task_*"))),
                 0.0 <= stats["bbox_mAP"] <= 1.0]
print(json.dumps({
    "dcn": report,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "dskd_tpu"))}))
"""

_HEADS_SCRIPT = _REFUSE + r"""
import importlib
import numpy as np
import torch
torch.set_num_threads(1)
from dskd_tpu_torch import registry
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.eval.evaluator import make_eval_step
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState
from dskd_tpu_torch.utils.config import load_config

for name in ("core.coders", "models.tood", "models.fsaf", "models.foveabox",
             "models.autoassign", "models.free_anchor", "models.sabl_retina",
             "utils.weights"):
    importlib.import_module("dskd_tpu_torch." + name)
rng = np.random.RandomState(0)
images = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
img_hw = torch.tensor([[64, 64], [48, 60]], dtype=torch.int32)
gt = torch.tensor([[[4., 6., 40., 50.], [30., 10., 60., 30.]],
                   [[2., 2., 20., 30.], [0., 0., 0., 0.]]])
batch = Batch(images, img_hw, gt, torch.tensor([[1, 3], [2, 0]]),
              torch.tensor([[True, True], [True, False]]))
report = {}
for config in ("tood_r50_1x", "fsaf_r50_1x", "foveabox_r50_1x",
               "autoassign_r50_1x", "retinanet_free_anchor_r50_1x",
               "sabl_retinanet_r50_1x"):
    cfg = load_config(f"configs/{config}.py")
    cfg.model = dataclasses.replace(cfg.model, num_classes=5, depth=18)
    spec = registry.get_family(cfg.model.arch)
    model = spec["build"](cfg.model, "cpu")
    spec["init_weights"](model, 0)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    step = make_family_train_step(cfg.model.arch, model, cfg, num_prev=0,
                                  has_teacher=False)
    state, losses = step(state, batch)
    det = make_eval_step(model.eval(), cfg.model.reg_max, 0.0, 20,
                         cfg.model.arch)(images, img_hw, torch.ones(2, 4))
    report[config] = [cfg.model.arch, sorted(losses),
                      all(bool(torch.isfinite(v)) for v in losses.values()),
                      list(det.bboxes.shape)]
print(json.dumps({
    "heads": report,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "dskd_tpu"))}))
"""

_ZOO_SCRIPT = _REFUSE + r"""
import glob, importlib, os, runpy, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
import chip_smoke
from dskd_tpu_torch import registry
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.data.coco import COCO_CLASSES_ALPHA_ORDER
from dskd_tpu_torch.eval.evaluator import make_eval_step
from dskd_tpu_torch.tools import test as test_cli
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState
from dskd_tpu_torch.utils.config import load_config

for name in ("models.regnet", "models.efficientnet", "models.pvt",
             "models.hrnet", "models.mobilenet_v2", "models.csp_darknet",
             "models.yolox", "models.yolov3", "models.cornernet",
             "models.centernet", "data.mix_transforms", "train.schedule",
             "core.coders", "utils.weights"):
    importlib.import_module("dskd_tpu_torch." + name)
rng = np.random.RandomState(0)
images = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
img_hw = torch.tensor([[64, 64], [48, 60]], dtype=torch.int32)
gt = torch.tensor([[[4., 6., 40., 50.], [30., 10., 60., 30.]],
                   [[2., 2., 20., 30.], [0., 0., 0., 0.]]])
batch = Batch(images, img_hw, gt, torch.tensor([[1, 3], [2, 0]]),
              torch.tensor([[True, True], [True, False]]))
report = {}
for config in ("retinanet_regnetx_3_2gf_1x", "retinanet_effb3_1x",
               "retinanet_pvt_t_1x", "fcos_hrnetv2p_w18_1x", "yolox_s_300e",
               "yolov3_d53_coco", "yolov3_mobilenetv2_416",
               "centernet_r18_140e"):
    cfg = load_config(f"configs/{config}.py")
    cfg.model = dataclasses.replace(cfg.model, num_classes=5)
    spec = registry.get_family(cfg.model.arch)
    model = spec["build"](cfg.model, "cpu")
    spec["init_weights"](model, 0)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    step = make_family_train_step(cfg.model.arch, model, cfg, num_prev=0,
                                  has_teacher=False)
    state, losses = step(state, batch)
    det = make_eval_step(model.eval(), cfg.model.reg_max, 0.0, 20,
                         cfg.model.arch)(images, img_hw, torch.ones(2, 4))
    report[config] = [cfg.model.arch, cfg.model.backbone, sorted(losses),
                      all(bool(torch.isfinite(v)) for v in losses.values()),
                      list(det.bboxes.shape)]
root = tempfile.mkdtemp()
cats = [c for _, c in COCO_CLASSES_ALPHA_ORDER]
ann, img_dir = chip_smoke.write_coco(root, "train", ((48, 64), (64, 48)) * 2,
                                     cats[:8], seed=0)
work = os.path.join(root, "yolox")
sets = ["data.bucket=(64,64)", "data.img_scale=(64,64)",
        "data.catsplit=(8,)", "model.num_classes=8", "data.num_workers=0",
        "data.samples_per_device=2", f"data.train_ann={ann}",
        f"data.val_ann={ann}", f"data.train_img_prefix={img_dir}",
        f"data.val_img_prefix={img_dir}", "train.epochs_per_task=2",
        "train.no_aug_epochs=1", "train.warmup_iters=1",
        "train.log_interval=1"]
sys.argv = ["train_increment", "configs/yolox_s_300e.py", "--work-dir", work,
            "--seed", "1", "--device", "cpu", "--set", *sets]
runpy.run_module("dskd_tpu_torch.tools.train_increment", run_name="__main__")
stats = test_cli.main(["configs/yolox_s_300e.py", "--work-dir", work,
                       "--device", "cpu", "--set", *sets])
rows = [json.loads(line) for p in glob.glob(os.path.join(work, "*.log.json"))
        for line in open(p)]
report["cli"] = [sorted(os.path.basename(p) for p in
                        glob.glob(os.path.join(work, "task_*"))),
                 0.0 <= stats["bbox_mAP"] <= 1.0,
                 sorted({(r["epoch"], "loss_l1" in r) for r in rows
                         if r["mode"] == "train"})]
print(json.dumps({
    "zoo": report,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "dskd_tpu"))}))
"""


def _run(script, tmp_path):
    """Runs ``script`` in a fresh interpreter from the repo's root and
    returns its last line as JSON."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the script's work directories (checkpoints) go under pytest's tmp_path
    env = dict(os.environ, PYTHONPATH=root, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", script], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_slice_imports_no_jax(tmp_path):
    report = _run(_SCRIPT, tmp_path)
    assert report["loaded"] == []
    assert report["flagship"] == [50, "corr + fg_info + decode_v1",
                                  [640, 480]]
    assert report["n_images"] == 2 and report["n_classes"] == 7
    assert report["shapes_ok"] and report["finite"] and report["trained"]
    assert report["ckpts"] == ["task_1_epoch_1", "task_2_epoch_1"]
    assert [tuple(r) for r in report["rows"]] == [
        ("train", 1)] * 2 + [("train", 2)] * 2 + [("val", 1), ("val", 2)]
    assert report["dets"] > 0
    assert report["ab"] == sorted([
        "teacher_old", "teacher_new", "distill_old", "distill_new",
        "finetune_old", "finetune_new", "task1_ms", "distill_ms",
        "finetune_ms", "wall_s"])
    assert report["jv_pos"] == 10
    assert report["detr"] == ["detr", 100, "hard + soft", "kldv"]
    assert report["detr_step"] == ["loss", "loss_bbox", "loss_cls",
                                   "loss_fd", "loss_iou", "loss_kd"]
    assert report["detr_ckpts"] == ["task_1_epoch_1", "task_2_epoch_1"]
    assert [tuple(r) for r in report["detr_rows"]] == [
        ("train", 1)] * 2 + [("train", 2)] * 2 + [("val", 1), ("val", 2)]
    assert report["detr_map"]
    assert report["yolo"] == {
        "yolof": ["yolof", "hard + soft", "bbox", "kldv",
                  ["loss", "loss_bbox", "loss_cls", "loss_fd", "loss_kd",
                   "loss_ld_bbox"], ["task_1_epoch_1", "task_2_epoch_1"],
                  True],
        "yoloy": ["yoloy", "hard + soft", "", "kldv",
                  ["loss", "loss_bbox", "loss_cls", "loss_fd", "loss_kd",
                   "loss_obj"], ["task_1_epoch_1", "task_2_epoch_1"], True]}
    n_kept, same = report["nms"]
    assert 0 < n_kept < 600 and same


def test_deformable_detr_imports_no_jax(tmp_path):
    report = _run(_DDETR_SCRIPT, tmp_path)
    assert report["loaded"] == []
    dec = ["loss", "loss_bbox", "loss_cls", "loss_iou"]
    enc = ["enc.loss_bbox", "enc.loss_cls", "enc.loss_iou"]
    assert report["ddetr"] == {
        "base": [False, False, dec], "refine_": [True, False, dec],
        "twostage_": [True, True, sorted(enc + dec)],
        "cli": [["task_1_epoch_1", "task_2_epoch_1"], True]}


def test_dense_families_import_no_jax(tmp_path):
    report = _run(_DENSE_SCRIPT, tmp_path)
    assert report["loaded"] == []
    det = ["loss", "loss_bbox", "loss_centerness", "loss_cls"]
    assert report["dense"] == {
        "retinanet": [5, ["loss", "loss_bbox", "loss_cls"], True, [2, 20, 4]],
        "atss": [5, det, True, [2, 20, 4]],
        "gfl": [5, ["loss", "loss_bbox", "loss_cls", "loss_dfl"], True,
                [2, 20, 4]],
        "fcos": [5, det, True, [2, 20, 4]]}


def test_ld_teacher_and_nasfpn_import_no_jax(tmp_path):
    """A third interpreter: LD's R18 step with its R101 teacher
    (``build_teacher_model``) and a NAS-FPN RetinaNet step at R18, loaded
    from their configs."""
    report = _run(_LD_NASFPN_SCRIPT, tmp_path)
    assert report["loaded"] == []
    assert report["variants"] == {
        "ld": [18, 23, ["loss", "loss_bbox", "loss_cls", "loss_dfl",
                        "loss_ld"], True],
        "retinanet_nasfpn": [18, None, ["loss", "loss_bbox", "loss_cls"],
                             True]}


def test_dcn_families_import_no_jax(tmp_path):
    """A fifth interpreter: ATSS-DyHead (six blocks), NAS-FCOS, VFNet and
    RepPoints from their configs at R18 on 64x64, a step and an eval step
    each, then the ``train_increment`` CLI for two tasks and the ``test``
    CLI on VFNet."""
    report = _run(_DCN_SCRIPT, tmp_path)
    assert report["loaded"] == []
    det = ["loss", "loss_bbox", "loss_centerness", "loss_cls"]
    assert report["dcn"] == {
        "atss_r50_dyhead_1x": ["atss", 6, det, True, [2, 20, 4]],
        "nasfcos_r50_1x": ["nasfcos", 0, det, True, [2, 20, 4]],
        "vfnet_r50_1x": ["vfnet", 0, ["loss", "loss_bbox", "loss_bbox_rf",
                                      "loss_cls"], True, [2, 20, 4]],
        "reppoints_moment_r50_1x": [
            "reppoints", 0, ["loss", "loss_cls", "loss_pts_init",
                             "loss_pts_refine"], True, [2, 20, 4]],
        "cli": [["task_1_epoch_1", "task_2_epoch_1"], True]}


def test_head_families_import_no_jax(tmp_path):
    """A sixth interpreter: TOOD, FSAF, FoveaBox, AutoAssign, FreeAnchor and
    SABL-RetinaNet from their configs at R18 on 64x64, a step and an eval
    step each."""
    report = _run(_HEADS_SCRIPT, tmp_path)
    assert report["loaded"] == []
    two = ["loss", "loss_bbox", "loss_cls"]
    assert report["heads"] == {
        "tood_r50_1x": ["tood", two, True, [2, 20, 4]],
        "fsaf_r50_1x": ["fsaf", two, True, [2, 20, 4]],
        "foveabox_r50_1x": ["foveabox", two, True, [2, 20, 4]],
        "autoassign_r50_1x": ["autoassign", ["loss", "loss_center",
                                             "loss_neg", "loss_pos"], True,
                              [2, 20, 4]],
        "retinanet_free_anchor_r50_1x": [
            "free_anchor", ["loss", "negative_bag_loss",
                            "positive_bag_loss"], True, [2, 20, 4]],
        "sabl_retinanet_r50_1x": [
            "sabl_retina", ["loss", "loss_bbox_cls", "loss_bbox_reg",
                            "loss_cls"], True, [2, 20, 4]]}


def test_zoo_families_import_no_jax(tmp_path):
    """A seventh interpreter: the RegNetX, EfficientNet, PVT and HRNet
    configs, YOLOX, YOLOv3 (Darknet-53 and MobileNetV2) and CenterNet from
    their configs at full width on 64x64, a step and an eval step each,
    then the ``train_increment`` CLI on YOLOX for two epochs with Mosaic
    and MixUp, the second without them and with the L1 branch, and the
    ``test`` CLI on its checkpoint."""
    report = _run(_ZOO_SCRIPT, tmp_path)
    assert report["loaded"] == []
    retina = ["loss", "loss_bbox", "loss_cls"]
    yolov3 = ["loss", "loss_cls", "loss_conf", "loss_wh", "loss_xy"]
    assert report["zoo"] == {
        "retinanet_regnetx_3_2gf_1x": ["retinanet", "regnetx_3.2gf", retina,
                                       True, [2, 20, 4]],
        "retinanet_effb3_1x": ["retinanet", "effb3", retina, True,
                               [2, 20, 4]],
        "retinanet_pvt_t_1x": ["retinanet", "pvt_tiny", retina, True,
                               [2, 20, 4]],
        "fcos_hrnetv2p_w18_1x": ["fcos", "hrnet_w18", [
            "loss", "loss_bbox", "loss_centerness", "loss_cls"], True,
            [2, 20, 4]],
        "yolox_s_300e": ["yolox", "", ["loss", "loss_bbox", "loss_cls",
                                       "loss_obj"], True, [2, 20, 4]],
        "yolov3_d53_coco": ["yolov3", "", yolov3, True, [2, 20, 4]],
        "yolov3_mobilenetv2_416": ["yolov3", "mobilenet_v2", yolov3, True,
                                   [2, 20, 4]],
        "centernet_r18_140e": ["centernet", "", [
            "loss", "loss_center_heatmap", "loss_offset", "loss_wh"], True,
            [2, 20, 4]],
        "cli": [["task_1_epoch_1", "task_1_epoch_2"], True,
                [[1, False], [2, True]]]}
