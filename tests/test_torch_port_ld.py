"""LD and a teacher of another depth on the port against dskd_tpu on the
CPU, at the tiny configuration of tests/torch_port_dense_more.py:

- ``build_teacher_model``: the student's module unless ``teacher_depth``
  differs, else the same model at that depth; its ResNet-101 GFL takes
  JAX's R101 variables through ``from_jax`` and computes JAX's forward
  (1e-4);
- ``ld_loss`` on JAX's head outputs in f64 (1e-6 relative), one family
  step in f64 with a frozen teacher (losses 1e-6, named gradients 1e-5
  relative L2) and the registry's eval step (GFL's);
- a one-task ``run_incremental`` of the R18 student (10 classes, 64x64,
  one step with eval, lr 1e-5) with an external ResNet-101 teacher that
  the port wrote as its own checkpoint, held row by row against JAX's
  ``train_one_task`` given the same teacher variables (the step's losses
  1e-4 relative; val mAP after the update 1e-3; one step keeps JAX's
  compiles to one, and no task checkpoint is written, to spare the disk);
- a run of two tasks with such a teacher, and LD without a teacher, raise
  a ValueError that names the problem."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch import registry

torch.set_num_threads(1)

GRAD_NAMES = ("bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "bbox_head.gfl_cls.weight", "bbox_head.gfl_reg.weight",
              "bbox_head.scales.0.scale", "neck.lateral_convs.0.conv.weight")


def _cfg(mod, teacher_depth=101, catsplit=None, **train):
    cfg = mod.ExperimentConfig(
        model=M.model_cfg(mod, "ld", teacher_depth=teacher_depth),
        train=mod.TrainConfig(**train),
        distill=mod.DistillFlags(cates_distill="hard", feats_distill=""))
    if catsplit:
        cfg.data = mod.DataConfig(catsplit=catsplit)
    return cfg


def test_resnet101_teacher_forward_matches_jax():
    """``build_teacher_model`` gives the R18 student's R101 teacher, which
    takes JAX's R101 GFL variables (strict) and computes its forward."""
    from dskd_tpu_torch.train.incremental import build_teacher_model
    from dskd_tpu_torch.utils import config as pconfig

    images, img_hw = M.batch_arrays("ld")[:2]
    tv = M.jax_variables("ld", 101)
    want = M.jax_apply("ld", 101)(tv, jnp.asarray(images),
                                  jnp.asarray(img_hw))
    teacher = build_teacher_model(_cfg(pconfig), "cpu")
    assert len(teacher.backbone.layer3) == 23
    teacher.load_state_dict(registry.get_family("ld")["from_jax"](tv),
                            strict=True)
    got = teacher.eval()(torch.from_numpy(images), torch.from_numpy(img_hw))
    for field in want.head._fields:
        for g, w in zip(getattr(got.head, field), getattr(want.head, field)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       err_msg=field, **D.FWD_TOL)
    for td in (None, 18):
        same = build_teacher_model(_cfg(pconfig, teacher_depth=td), "cpu")
        assert len(same.backbone.layer3) == 2


def test_ld_loss_matches_jax_in_f64():
    losses = M.check_losses_f64("ld", teacher_depth=18)
    assert float(losses["loss_ld"]) > 0


def test_family_step_matches_jax_grad_in_f64():
    M.check_family_step_f64("ld", GRAD_NAMES, teacher_depth=18)


def test_eval_step_matches_jax():
    M.check_eval_step("ld")


def test_one_task_run_with_an_external_r101_teacher_matches_jax(tmp_path):
    import chip_smoke
    from dskd_tpu.data.coco import COCO_CLASSES_ALPHA_ORDER
    from dskd_tpu.parallel.mesh import make_mesh
    from dskd_tpu.train.incremental import build_model, train_one_task
    from dskd_tpu.utils import config as jconfig
    from dskd_tpu_torch.train.checkpoint import save_checkpoint
    from dskd_tpu_torch.train.incremental import run_incremental
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState
    from dskd_tpu_torch.utils import config as pconfig
    from test_torch_port_yolof import _rows

    root = str(tmp_path)

    def run_cfg(mod, work, num_workers):
        cfg = _cfg(mod, base_lr=1e-5, warmup_iters=2, step_epochs=(10,),
                   max_iters_per_task=1, eval_interval=1, ckpt_interval=10,
                   log_interval=1, use_dropout=False, seed=0, work_dir=work)
        cfg.data = mod.DataConfig(
            train_ann=os.path.join(root, "train.json"),
            val_ann=os.path.join(root, "val.json"),
            train_img_prefix=os.path.join(root, "train"),
            val_img_prefix=os.path.join(root, "val"), catsplit=(M.NC,),
            samples_per_device=2, num_workers=num_workers, max_gt=8,
            bucket=(64, 64), img_scale=(64, 64))
        return cfg

    cats = [cid for _, cid in COCO_CLASSES_ALPHA_ORDER[:M.NC]]
    shapes = ((48, 64), (64, 48))
    chip_smoke.write_coco(root, "train", shapes * 2, cats, seed=0)
    chip_smoke.write_coco(root, "val", shapes * 2, cats, seed=1)
    v, tv = M.jax_variables("ld"), M.jax_variables("ld", 101, seed=1)

    # the teacher checkpoint, written by the port
    teacher = M.port_model("ld", tv, depth=101)
    save_checkpoint(os.path.join(root, "teacher"), 1, 12, TrainState.create(
        teacher, make_optimizer(teacher, step_lr_schedule(1e-5)), seed=0))
    pwork = os.path.join(root, "port")
    final = run_incremental(run_cfg(pconfig, pwork, 0),
                            teacher_ckpt=os.path.join(root, "teacher",
                                                      "task_1_epoch_12"),
                            variables=v, device="cpu")

    jwork = os.path.join(root, "jax")
    jcfg = run_cfg(jconfig, jwork, 1)
    train_one_task(build_model(jcfg), jcfg, 1, 1, v, tv,
                   make_mesh(jax.devices()[:1]))

    want, got = _rows(jwork), _rows(pwork)
    assert sorted(got) == sorted(want)
    assert sorted(k[0] for k in want) == ["train", "val"]
    for key, w in want.items():
        g = got[key]
        if key[0] == "val":
            assert abs(g["bbox_mAP"] - w["bbox_mAP"]) <= 1e-3, key
            continue
        timing = {"img_s", "time"}
        assert set(g) - timing == set(w) - timing, key
        assert g["loss_ld"] > 0
        for k in set(w) - timing - {"mode", "task", "epoch", "iter"}:
            rtol = 1e-4 if key[3] == 1 else 1e-3
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"{key} {k}")
    assert len(final.backbone.layer3) == 2


def test_two_tasks_with_a_teacher_of_another_depth_raise():
    from dskd_tpu_torch.train.incremental import run_incremental
    from dskd_tpu_torch.utils import config as pconfig

    with pytest.raises(ValueError, match="teacher_depth=101.*depth=18"):
        run_incremental(_cfg(pconfig, catsplit=(5, 5)), device="cpu")


def test_ld_without_teacher_raises():
    from dskd_tpu_torch.utils import config as pconfig

    fn = registry.get_family("ld")["losses"](
        None, _cfg(pconfig), num_prev=0, has_teacher=False,
        use_dropout=False)
    model = M.port_model("ld", M.jax_variables("ld"))
    with pytest.raises(ValueError, match="teacher"):
        fn(model, D.torch_batch(M.batch_arrays("ld")), None, None)
