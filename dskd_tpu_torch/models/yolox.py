"""YOLOX (port of dskd_tpu/models/yolox.py ``YOLOX`` and its registry
entry ``yolox``): CSPDarknet (YOLOX-s: deepen 0.33, widen 0.5; C3-C5 of
128, 256 and 512 channels) -> the port's YOLOY PAFPN (128 channels) ->
YOLOY's decoupled head at strides 8-32, every BatchNorm trained. Loss:
SimOTA with the IoU(mode="square") box loss, and the L1 branch once the
driver's no-aug phase rebuilds the step with ``use_l1=True``
(``train/incremental.py``). Decoding: YOLOY's at ``max(score_thr,
0.01)``. Images enter NHWC; ``neck_feats`` stay NCHW.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .csp_darknet import CSPDarknet
from .dilated_encoder import init_conv_bn
from .yolof_head import Detections
from .yoloy import YOLOYOutputs
from .yoloy_head import (PRIOR_BIAS, YOLOYHead, YOLOYLossConfig,
                         yoloy_detection_loss, yoloy_get_bboxes)
from .yoloy_pafpn import YOLOYPAFPN


class YOLOX(nn.Module):
    def __init__(self, device, num_classes: int = 80,
                 deepen_factor: float = 0.33, widen_factor: float = 0.5,
                 neck_channels: int = 128, frozen_stages: int = -1):
        super().__init__()
        self.backbone = CSPDarknet(device, deepen_factor, widen_factor,
                                   out_indices=(2, 3, 4),
                                   frozen_stages=frozen_stages)
        self.neck = YOLOYPAFPN(self.backbone.out_channels, device,
                               out_channels=neck_channels)
        self.bbox_head = YOLOYHead(device, num_classes, neck_channels,
                                   neck_channels)

    def forward(self, images, img_hw) -> YOLOYOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return YOLOYOutputs(self.bbox_head(neck), neck)


def build_yolox(model_cfg, device="cuda") -> YOLOX:
    # JAX's registry builds YOLOX-s with its own frozen_stages (-1)
    return YOLOX(device, num_classes=model_cfg.num_classes)


@torch.no_grad()
def init_yolox(model: YOLOX, seed: int = 0) -> None:
    """Seeded random weights at the scales of JAX's initializers:
    lecun-normal convs, zero biases but the class and objectness convs',
    -4.595; identity BatchNorms."""
    init_conv_bn(model, torch.Generator().manual_seed(seed),
                 lambda name: "lecun")
    head = model.bbox_head
    for conv in (*head.multi_level_conv_cls, *head.multi_level_conv_obj):
        conv.bias.fill_(PRIOR_BIAS)


def _register():
    from ..registry import register_family
    from ..utils.weights import yolox_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout,
               use_l1=False):
        det_cfg = YOLOYLossConfig(num_classes=cfg.model.num_classes,
                                  bbox_loss="square_iou", use_l1=use_l1)

        # JAX's YOLOX losses read no teacher; a training-mode model
        # normalises by the batch statistics and updates its running ones
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            return yoloy_detection_loss(out.head, batch.gt_bboxes,
                                        batch.gt_labels, batch.gt_valid,
                                        det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors) -> Detections:
            return yoloy_get_bboxes(
                model(images, img_hw).head, img_hw,
                scale_factor=scale_factors, score_thr=max(score_thr, 0.01),
                max_per_img=max_per_img, rescale=True)
        return step

    register_family("yolox", build=build_yolox, init_weights=init_yolox,
                    from_jax=yolox_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
