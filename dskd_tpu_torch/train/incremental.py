"""The incremental training loop (port of dskd_tpu/train/incremental.py
``build_model``, ``init_variables``, ``make_datasets``, ``train_one_task``
and ``run_incremental``).

Task loop:
  * per-task class loads: the identity row of the task for train, the
    lower-triangular row for val;
  * task 1 trains plain detection; each later task promotes the previous
    student to a frozen teacher (``train.state.frozen_copy``: a real copy,
    with its own BatchNorm buffers) and trains the student with the
    distillation recipe on that task's classes, ``num_prev =
    sum(catsplit[:tid - 1])``;
  * per-task optimizer and ``step_lr_schedule``, or with ``lr_policy``
    "yolox_cosine" ``yolox_cosine_schedule`` over the task's epochs (from
    ``max_iters_per_task`` where it is set), its last ``no_aug_epochs``
    at the floor; ``max_iters_per_task`` slices an endless reshuffled
    stream into epochs of ``len(loader)``;
  * YOLOX's no-aug phase: with ``no_aug_epochs`` and Mosaic or MixUp on,
    the last ``no_aug_epochs`` epochs load without them, and YOLOX's step
    is rebuilt with its L1 branch (``use_l1``);
  * train rows every ``log_interval`` steps, ``task_{t}_epoch_{e}``
    checkpoints every ``ckpt_interval`` epochs, COCO bbox eval every
    ``eval_interval`` epochs (``val`` rows), EMA weights with ``use_ema``;
  * ``resume_by_task`` skips the tasks before it, restoring their latest
    checkpoint; ``student_ckpt`` / ``teacher_ckpt`` seed the first task's
    student / an external teacher from the port's own checkpoints. With
    ``model.teacher_depth`` other than ``depth`` (LD's and LAD's R101
    teachers) the external teacher is its own module
    (``build_teacher_model``); a run of more than one task cannot promote
    the student to such a teacher and raises a ValueError before task 1.

The JAX package evaluates on a background thread while the next epoch
trains; the port evaluates synchronously at the end of the epoch. One
process drives one device (``device``, the card unless the caller asks for
the CPU). Not ported (raise NotImplementedError, naming the option):
non-COCO dataset types, learning-rate policies other than "step" and
"yolox_cosine", FSDP, ResNet weights from a file and mmdet ``.pth``
checkpoints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import time
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..data.coco import TaskCocoDataset
from ..data.loader import DataLoader
from ..data.pipeline import PipelineConfig
from ..eval import evaluator
from ..registry import get_family
from ..utils.config import ExperimentConfig
from ..utils.logging import MetricsLogger, collect_env, dump_config
from ..utils.seed import init_random_seed, set_random_seed
from . import family
from .checkpoint import find_latest_checkpoint, load_weights, \
    save_checkpoint
from .hooks import assert_loss_keys_consistent, check_invalid_loss, \
    ema_update
from .optim import make_optimizer
from .schedule import step_lr_schedule, yolox_cosine_schedule
from .state import TrainState, frozen_copy

log = logging.getLogger("dskd_tpu")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return device


def build_model(cfg: ExperimentConfig, device="cuda") -> nn.Module:
    """The detector of ``cfg.model`` on ``device``, built by its family's
    registry ``build``; with ``cfg.train.use_dropout`` False its dropout
    rate is 0."""
    m = cfg.model
    if not cfg.train.use_dropout:
        m = dataclasses.replace(m, dropout=0.0)
    return get_family(m.arch)["build"](m, torch.device(device))


def other_depth_teacher(cfg: ExperimentConfig) -> bool:
    """Whether ``model.teacher_depth`` names a depth other than the
    student's."""
    td = cfg.model.teacher_depth
    return bool(td) and td != cfg.model.depth


def build_teacher_model(cfg: ExperimentConfig, device="cuda") -> nn.Module:
    """The frozen teacher's module, before its weights: the student's
    unless ``model.teacher_depth`` names another backbone depth (LD's R18
    and LAD's R50 students learn from R101 teachers), then the same model
    at that depth."""
    if not other_depth_teacher(cfg):
        return build_model(cfg, device)
    tcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, depth=cfg.model.teacher_depth))
    return build_model(tcfg, device)


def init_variables(model: nn.Module, cfg: ExperimentConfig, seed: int,
                   variables: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Seeded random weights (the family's ``init_weights``), or the JAX
    package's ``{"params", "batch_stats"}`` tree ``variables`` through the
    family's ``from_jax``; in place."""
    if cfg.model.backbone_ckpt:
        raise NotImplementedError("model.backbone_ckpt (ResNet weights from "
                                  "a file) is not ported")
    spec = get_family(cfg.model.arch)
    if variables is None:
        spec["init_weights"](model, seed)
    else:
        model.load_state_dict(spec["from_jax"](variables), strict=True)
    return model


def make_datasets(cfg: ExperimentConfig, tid: int, task_nums: int):
    """Task tid (1-based): train loads only task tid's classes; val loads
    all classes up to tid (the identity / tril rows)."""
    dt = cfg.data.dataset_type
    if dt != "coco":
        raise NotImplementedError(f"dataset_type={dt!r} is not ported "
                                  "(coco only)")
    train_load = [1 if i == tid - 1 else 0 for i in range(task_nums)]
    val_load = [1 if i <= tid - 1 else 0 for i in range(task_nums)]
    custom = (tuple(cfg.data.classes) if cfg.data.classes else None)
    train_ds = TaskCocoDataset(
        cfg.data.train_ann, cfg.data.train_img_prefix,
        catsplit=cfg.data.catsplit, catload=train_load,
        catpred=cfg.data.catpred, imgpercent=cfg.data.imgpercent,
        seg_prefix=cfg.data.seg_prefix, classes=custom)
    val_ds = TaskCocoDataset(
        cfg.data.val_ann, cfg.data.val_img_prefix,
        catsplit=cfg.data.catsplit, catload=val_load,
        catpred=cfg.data.catpred, test_mode=True, classes=custom)
    return train_ds, val_ds


def pipeline_config(cfg: ExperimentConfig) -> PipelineConfig:
    d = cfg.data
    return PipelineConfig(
        img_scale=d.img_scale, flip_ratio=d.flip_ratio, max_gt=d.max_gt,
        bucket=d.bucket, multi_scales=d.multi_scales,
        photo_metric_distortion=d.photo_metric_distortion,
        mosaic=d.mosaic, mixup=d.mixup, auto_augment=d.auto_augment,
        expand=d.expand, min_iou_crop=d.min_iou_crop,
        resize_ratio_range=d.resize_ratio_range, random_crop=d.random_crop)


@contextlib.contextmanager
def _weights(model: nn.Module, params: Optional[Dict[str, torch.Tensor]]):
    """Run with ``params`` (EMA weights) in ``model``; restore after."""
    if params is None:
        yield
        return
    named = dict(model.named_parameters())
    saved = {k: p.detach().clone() for k, p in named.items()}
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(params[k])
    try:
        yield
    finally:
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(saved[k])


def train_one_task(model: nn.Module, cfg: ExperimentConfig, tid: int,
                   task_nums: int, teacher: Optional[nn.Module] = None,
                   device="cuda") -> nn.Module:
    """Train task ``tid`` on ``model`` in place (with ``teacher``, the
    distillation recipe); returns it, holding the EMA weights with
    ``use_ema``."""
    device = resolve_device(device)
    if cfg.train.lr_policy not in ("step", "yolox_cosine"):
        raise NotImplementedError(f"train.lr_policy={cfg.train.lr_policy!r} "
                                  "is not ported")
    if cfg.train.fsdp:
        raise NotImplementedError("train.fsdp is not ported")
    train_ds, val_ds = make_datasets(cfg, tid, task_nums)
    num_prev = sum(cfg.data.catsplit[:tid - 1])
    pipe = pipeline_config(cfg)
    pin = device.type == "cuda"
    batch_size = cfg.data.samples_per_device      # one device
    loader = DataLoader(train_ds, batch_size, pipe, train=True,
                        seed=cfg.train.seed + tid,
                        num_workers=cfg.data.num_workers,
                        aspect_buckets=cfg.data.aspect_buckets,
                        gt_buckets=cfg.data.gt_buckets, pin_memory=pin)
    val_loader = None
    iters_per_epoch = max(len(loader), 1)
    if cfg.train.lr_policy == "yolox_cosine":
        ep = (cfg.train.epochs_per_task
              if cfg.train.max_iters_per_task <= 0 else
              -(-cfg.train.max_iters_per_task // iters_per_epoch))
        sched = yolox_cosine_schedule(
            cfg.train.base_lr, cfg.train.warmup_iters,
            total_iters=ep * iters_per_epoch,
            last_iters=cfg.train.no_aug_epochs * iters_per_epoch,
            min_lr_ratio=cfg.train.min_lr_ratio)
    else:
        sched = step_lr_schedule(cfg.train.base_lr, cfg.train.warmup_iters,
                                 cfg.train.warmup_ratio,
                                 cfg.train.step_epochs, iters_per_epoch)
    opt = make_optimizer(model, sched, weight_decay=cfg.train.weight_decay,
                         max_norm=cfg.train.grad_clip,
                         frozen_stages=cfg.model.frozen_stages)
    state = TrainState.create(model, opt, seed=cfg.train.seed + 131 * tid)
    step_fn = family.make_family_train_step(
        cfg.model.arch, model, cfg, num_prev, has_teacher=teacher is not None,
        use_dropout=cfg.train.use_dropout)
    log.info("Task %d: %d train imgs, %d iters/epoch, num_prev=%d, "
             "teacher=%s", tid, len(train_ds), iters_per_epoch, num_prev,
             teacher is not None)
    metrics = MetricsLogger(cfg.train.work_dir)
    params = dict(model.named_parameters())
    ema = ({k: p.detach().clone() for k, p in params.items()}
           if cfg.train.use_ema else None)

    # iter-based schedule: slice an endless reshuffled stream into
    # iters_per_epoch-sized epochs
    if cfg.train.max_iters_per_task > 0:
        total_iters = cfg.train.max_iters_per_task
        n_epochs = -(-total_iters // iters_per_epoch)
        stream = loader.infinite()

        def epoch_batches(e):
            k = min(iters_per_epoch, total_iters - (e - 1) * iters_per_epoch)
            return itertools.islice(stream, k)
    else:
        n_epochs = cfg.train.epochs_per_task

        def epoch_batches(e):
            return iter(loader)

    no_aug_switched = False
    try:
        for epoch in range(1, n_epochs + 1):
            # YOLOXModeSwitchHook: the last no_aug_epochs train without
            # Mosaic and MixUp, and YOLOX's with its L1 branch
            if (cfg.train.no_aug_epochs and not no_aug_switched
                    and (pipe.mosaic or pipe.mixup)
                    and epoch > n_epochs - cfg.train.no_aug_epochs):
                no_aug_switched = True
                loader.set_mix(False)
                log.info("task %d epoch %d: mosaic/mixup OFF (no-aug phase)",
                         tid, epoch)
                if cfg.model.arch == "yolox":
                    step_fn = family.make_family_train_step(
                        cfg.model.arch, model, cfg, num_prev,
                        has_teacher=teacher is not None,
                        use_dropout=cfg.train.use_dropout, use_l1=True)
            t0, n_img = time.time(), 0
            for it, (batch, _meta) in enumerate(epoch_batches(epoch)):
                batch = batch.to(device, non_blocking=pin)
                state, losses = step_fn(state, batch, teacher)
                if ema is not None:
                    ema_update(ema, params, state.step,
                               momentum=cfg.train.ema_momentum)
                n_img += batch.images.shape[0]
                if it == 0:
                    assert_loss_keys_consistent(losses)
                if (it + 1) % cfg.train.log_interval == 0:
                    host_losses = {k: float(v) for k, v in losses.items()
                                   if "." not in k}
                    check_invalid_loss(host_losses, it + 1, interval=1)
                    dt = time.time() - t0
                    host_losses["img_s"] = n_img / dt
                    host_losses["time"] = dt / (it + 1)
                    metrics.log_metrics("train", epoch, it + 1, host_losses,
                                        task=tid, lr=sched(state.step))
            if epoch % cfg.train.ckpt_interval == 0:
                save_checkpoint(cfg.train.work_dir, tid, epoch, state)
            if cfg.train.eval_interval and \
                    epoch % cfg.train.eval_interval == 0:
                if val_loader is None:
                    val_loader = DataLoader(
                        val_ds, batch_size, pipe, train=False,
                        num_workers=cfg.data.num_workers, drop_last=False,
                        pin_memory=pin)
                with _weights(model, ema):
                    stats = evaluator.evaluate(
                        model, val_ds, val_loader, reg_max=cfg.model.reg_max,
                        score_thr=cfg.test_score_thr,
                        max_per_img=cfg.test_max_per_img,
                        arch=cfg.model.arch)
                log.info("task %d epoch %d eval: %s", tid, epoch,
                         {k: round(v, 4) for k, v in stats.items()
                          if not k.startswith("AP_")})
                metrics.log_metrics(
                    "val", epoch, 0, {k: v for k, v in stats.items()
                                      if not k.startswith("AP_")}, task=tid)
    finally:
        opt.zero_grad()
        loader.close()
        if val_loader is not None:
            val_loader.close()
        metrics.close()

    # with EMA on, the task's final weights are the averaged ones
    if ema is not None:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(ema[k])
    return model


def run_incremental(cfg: ExperimentConfig, student_ckpt: Optional[str] = None,
                    teacher_ckpt: Optional[str] = None, *,
                    variables: Optional[Dict[str, Any]] = None,
                    device="cuda") -> nn.Module:
    """Full multi-task run on ``device``; returns the final student.

    ``student_ckpt`` / ``teacher_ckpt``: checkpoint directories
    (``task_{t}_epoch_{e}``) of the port to seed the first task's student /
    an external teacher. ``variables``: the JAX package's weights to start
    from instead of seeded random ones.
    """
    device = resolve_device(device)
    task_nums = len(cfg.data.catsplit)
    if task_nums > 1 and other_depth_teacher(cfg):
        # each task after the first promotes the student to its teacher
        # (JAX snapshots the student's variables), which a teacher module
        # of another depth cannot take: refused before task 1 trains
        raise ValueError(
            f"model.teacher_depth={cfg.model.teacher_depth} differs from "
            f"model.depth={cfg.model.depth}, so task 2 of "
            f"catsplit={tuple(cfg.data.catsplit)} cannot promote the "
            f"student to its teacher; a teacher of another depth trains "
            f"single-task configs only")
    log.info("environment: %s", collect_env())
    dump_config(cfg, cfg.train.work_dir)
    cfg.train.seed = init_random_seed(cfg.train.seed)
    set_random_seed(cfg.train.seed, device)
    model = build_model(cfg, device)
    init_variables(model, cfg, cfg.train.seed, variables)
    teacher = None
    if student_ckpt:
        load_weights(model, student_ckpt)
        log.info("student initialized from %s", student_ckpt)
    if teacher_ckpt:
        external = build_teacher_model(cfg, device)
        load_weights(external, teacher_ckpt)
        teacher = frozen_copy(external)
        log.info("external teacher loaded from %s", teacher_ckpt)

    for tid in range(1, task_nums + 1):
        if tid < cfg.train.resume_by_task:
            ck = find_latest_checkpoint(cfg.train.work_dir, task=tid)
            if ck:
                load_weights(model, ck[2])
            log.info("Task %d skipped (resume_by_task)", tid)
            teacher = frozen_copy(model)
            continue
        if tid > 1:
            teacher = frozen_copy(model)
        model = train_one_task(model, cfg, tid, task_nums,
                               teacher if (tid > 1 or teacher_ckpt) else None,
                               device)
    return model
