"""GFL (port of dskd_tpu/models/gfl.py ``GFL`` and its registry entry
``gfl``): ResNet -> FPN (C3-C5, P3-P7 with extra convs on the output and a
ReLU between them) -> the GFL head; the baseline the DSKD pipeline
pretrains its teachers with.

``gfl_eval_step`` is the family's eval step as a plain function, so that
a family sharing GFL's decode (LD) can take it by name. Images enter NHWC;
``neck_feats`` stay NCHW.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn

from .dilated_encoder import init_conv_bn
from .fpn import FPN
from .gfl_head import (GFLHead, GFLHeadOutputs, GFLLossConfig,
                       gfl_detection_loss, gfl_get_bboxes)
from .resnet import ResNet

GFL_CLS_BIAS = -4.595      # the JAX head's constant, prior ~0.01


class GFLOutputs(NamedTuple):
    head: GFLHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


class GFL(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1, reg_max: int = 16):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1)
        self.bbox_head = GFLHead(device, num_classes, reg_max=reg_max)

    def forward(self, images, img_hw) -> GFLOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw (B, 2) is unused by
        the forward (the decode clips to it)."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return GFLOutputs(self.bbox_head(neck), neck)


def build_gfl(model_cfg, device="cuda") -> GFL:
    m = model_cfg
    return GFL(device, num_classes=m.num_classes, depth=m.depth,
               frozen_stages=m.frozen_stages, reg_max=m.reg_max)


def dense_init_of(name: str) -> str:
    """The JAX dense detectors' initializers by module name: lecun-normal
    for the backbone, xavier-uniform for the FPN, normal(0.01) for the
    head."""
    if name.startswith("neck."):
        return "xavier"
    if name.startswith("bbox_head."):
        return "normal_001"
    return "lecun"


@torch.no_grad()
def init_dense(model: nn.Module, seed: int, cls_conv: str,
               cls_bias: float, init_of=dense_init_of) -> None:
    """A dense detector's seeded random weights at the scales of JAX's
    initializers (``init_of``, by default ``dense_init_of``), drawn on the
    CPU; zero biases but the head's ``cls_conv``'s, ``cls_bias``; identity
    norms; scales 1."""
    init_conv_bn(model, torch.Generator().manual_seed(seed), init_of)
    getattr(model.bbox_head, cls_conv).bias.fill_(cls_bias)
    for s in getattr(model.bbox_head, "scales", ()):
        s.scale.fill_(1.0)


def init_gfl(model: GFL, seed: int = 0) -> None:
    init_dense(model, seed, "gfl_cls", GFL_CLS_BIAS)


def gfl_eval_step(model, *, score_thr, max_per_img, reg_max=16):
    """``step(images, img_hw, scale_factors) -> Detections``: the forward
    and ``gfl_get_bboxes`` at ``max(score_thr, 0.05)``, boxes rescaled to
    the original images."""
    @torch.inference_mode()
    def step(images, img_hw, scale_factors):
        out = model(images, img_hw)
        return gfl_get_bboxes(out.head, img_hw, scale_factor=scale_factors,
                              reg_max=reg_max,
                              score_thr=max(score_thr, 0.05),
                              max_per_img=max_per_img, rescale=True)
    return step


def _register():
    from ..registry import register_family
    from ..utils.weights import gfl_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = GFLLossConfig(num_classes=cfg.model.num_classes,
                                reg_max=cfg.model.reg_max)

        # JAX's GFL losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            return gfl_detection_loss(out.head, batch.gt_bboxes,
                                      batch.gt_labels, batch.gt_valid,
                                      det_cfg)
        return losses_fn

    register_family("gfl", build=build_gfl, init_weights=init_gfl,
                    from_jax=gfl_state_dict_from_jax, losses=losses,
                    eval_step=gfl_eval_step)


_register()
