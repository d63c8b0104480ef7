"""The incremental train step, teacher + student (port of
dskd_tpu/train/step.py ``teacher_info``, ``compute_losses``,
``parse_losses`` and ``make_train_step``).

One step: the frozen teacher's forward under ``no_grad`` -> the student's
forward with dropout -> the merged-GT ("hard + teacher-first") Hungarian
assignment -> QFL/DFL/GIoU/L1 on every decoder layer -> the corr and
semantic-guided fg distills -> the sum of every key holding "loss" ->
backward -> global-norm clip 0.1 -> AdamW. Where the JAX ``compute_losses``
takes the teacher's variables, the port's takes its ``teacher_info``.

``compute_dtype=torch.bfloat16`` mirrors the JAX package's ``_cast_floats``:
the model runs through ``torch.func.functional_call`` on bf16 casts of the
f32 master parameters and buffers, with bf16 images, and its outputs are
cast back to f32 before the matcher and the losses; the gradients reach the
f32 masters through the casts. ``torch.autocast`` keeps LayerNorm and
softmax in f32, which makes it a different function, so it is not used.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from ..data.batch import Batch
from ..distill.losses import DistillConfig, distill_losses
from ..distill.teacher import TeacherInfo, merge_teacher_gt, out_teacher
from ..models.detector import DetectorOutputs
from ..models.gfl_detr_head import HeadOutputs
from ..models.gfl_detr_loss import DetLossConfig, detection_loss
from .state import TrainState


def _to_f32(out: DetectorOutputs) -> DetectorOutputs:
    def f(t):
        return t.float() if t.is_floating_point() else t
    return DetectorOutputs(HeadOutputs(*(f(t) for t in out.head)),
                           tuple(f(t) for t in out.neck_feats))


def forward(model: nn.Module, images: torch.Tensor, img_hw: torch.Tensor,
            compute_dtype: torch.dtype = torch.float32,
            generator: Optional[torch.Generator] = None) -> DetectorOutputs:
    """The model's forward in ``compute_dtype``, outputs in f32."""
    if compute_dtype == torch.float32:
        return model(images, img_hw, generator=generator)
    tensors = {n: t.to(compute_dtype) if t.is_floating_point() else t
               for n, t in itertools.chain(model.named_parameters(),
                                           model.named_buffers())}
    out = functional_call(model, tensors, (images.to(compute_dtype), img_hw),
                          {"generator": generator})
    return _to_f32(out)


def teacher_info(teacher: nn.Module, batch: Batch, det_cfg: DetLossConfig,
                 teacher_score_thr: float = 0.3,
                 teacher_max_per_img: int = 100,
                 compute_dtype: torch.dtype = torch.float32) -> TeacherInfo:
    """The frozen teacher's forward -> TeacherInfo, outside autograd.
    ``teacher`` is an eval-mode copy of the model (``state.frozen_copy``)."""
    with torch.no_grad():
        out = forward(teacher, batch.images, batch.img_hw, compute_dtype)
        return out_teacher(out, batch.img_hw, reg_max=det_cfg.reg_max,
                           score_thr=teacher_score_thr,
                           max_per_img=teacher_max_per_img)


def compute_losses(model: nn.Module, batch: Batch, det_cfg: DetLossConfig,
                   tinfo: Optional[TeacherInfo] = None,
                   distill_cfg: Optional[DistillConfig] = None,
                   generator: Optional[torch.Generator] = None,
                   compute_dtype: torch.dtype = torch.float32,
                   assigned=None):
    """Student forward + every loss -> (losses, targets); differentiable in
    the model's parameters.

    ``tinfo`` is the teacher's ``teacher_info`` (none: no distillation).
    ``generator`` draws the dropout masks of a training-mode model at p > 0.
    ``assigned`` replaces the matching by a given (targets, fallback count),
    so two devices can be compared under one assignment.
    """
    out = forward(model, batch.images, batch.img_hw, compute_dtype,
                  generator)
    gt_bboxes, gt_labels, gt_valid = (batch.gt_bboxes, batch.gt_labels,
                                      batch.gt_valid)
    if tinfo is not None and distill_cfg.hard:
        gt_bboxes, gt_labels, gt_valid = merge_teacher_gt(
            tinfo.det, gt_bboxes, gt_labels, gt_valid)
    losses, targets = detection_loss(
        out.head.cls_scores, out.head.bbox_preds, gt_bboxes, gt_labels,
        gt_valid, batch.img_hw, det_cfg, assigned=assigned)
    if tinfo is not None:
        losses.update(distill_losses(
            out.head, out.neck_feats, tinfo, targets, batch.img_hw,
            det_cfg.num_classes, distill_cfg,
            num_merged=gt_bboxes.shape[1]))
    return losses, targets


def parse_losses(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum every entry whose key contains 'loss' (reference _parse_losses)."""
    return sum(v for k, v in losses.items() if "loss" in k)


def make_train_step(det_cfg: DetLossConfig,
                    distill_cfg: Optional[DistillConfig] = None,
                    teacher_score_thr: float = 0.3,
                    teacher_max_per_img: int = 100,
                    compute_dtype: torch.dtype = torch.float32) -> Callable:
    """Build ``train_step(state, batch, teacher=None) -> (state, losses)``;
    ``teacher=None`` trains without distillation. Dropout draws from
    ``state.generator``; the model's dropout p = 0 turns it off."""

    def train_step(state: TrainState, batch: Batch,
                   teacher: Optional[nn.Module] = None):
        tinfo = None if teacher is None else teacher_info(
            teacher, batch, det_cfg, teacher_score_thr, teacher_max_per_img,
            compute_dtype)
        losses, _ = compute_losses(state.model, batch, det_cfg, tinfo,
                                   distill_cfg, state.generator,
                                   compute_dtype)
        total = parse_losses(losses)
        state.optimizer.zero_grad()
        total.backward()
        state.optimizer.step(state.step)
        state.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss"] = total.detach()
        return state, losses

    return train_step
