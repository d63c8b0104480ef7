"""Detector assembly (port of dskd_tpu/models/detector.py
``GFLDeformableDETR`` and its registry ``build``): ResNet -> ChannelMapper
-> GFL Deformable-DETR head.

``model.train()`` turns on the transformer's dropout (its masks come from the
generator passed to ``forward``); the backbone's BatchNorm stays frozen in
both modes and ``frozen_stages`` detaches the stem and layer1.

Images enter NHWC, as in the JAX package; the backbone and neck run NCHW and
``neck_feats`` are returned NHWC.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn

from .channel_mapper import ChannelMapper
from .gfl_detr_head import GFLDeformableDETRHead, HeadOutputs, \
    bias_init_with_prob
from .resnet import FrozenBatchNorm, ResNet
from .transformer import MSDeformAttention, _InOutProj, msda_offset_bias


class DetectorOutputs(NamedTuple):
    head: HeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]   # NHWC per level


class GFLDeformableDETR(nn.Module):
    """ResNet + ChannelMapper + GFL-Deformable-DETR head (the flagship)."""

    def __init__(self, device, num_classes=80, num_query=300, reg_max=16,
                 depth=50, embed_dims=256, num_encoder_layers=6,
                 num_decoder_layers=6, num_levels=4, frozen_stages=1,
                 dropout=0.1):
        super().__init__()
        self.reg_max = reg_max
        self.backbone = ResNet(depth, device, out_indices=(1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = ChannelMapper(self.backbone.out_channels[1:], device,
                                  out_channels=embed_dims,
                                  num_outs=num_levels)
        self.bbox_head = GFLDeformableDETRHead(
            device, num_classes=num_classes, num_query=num_query,
            embed_dims=embed_dims, reg_max=reg_max,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, num_levels=num_levels,
            dropout=dropout)

    def forward(self, images: torch.Tensor, img_hw: torch.Tensor,
                generator=None) -> DetectorOutputs:
        """images (B, H, W, 3) normalized NHWC; img_hw (B, 2) valid (h, w);
        ``generator`` draws the dropout masks in training mode."""
        batch_input_shape = (images.shape[1], images.shape[2])
        feats = self.backbone(images.permute(0, 3, 1, 2))
        neck = self.neck(feats)
        head = self.bbox_head(neck, img_hw, batch_input_shape, generator)
        return DetectorOutputs(head, tuple(f.permute(0, 2, 3, 1)
                                           for f in neck))


# the archs the port builds: the flagship family of the JAX registry
ARCHS = ("gfl_deformable_detr", "deformable_detr_il")


def build_detector(model_cfg, device="cuda") -> GFLDeformableDETR:
    """``ModelConfig`` -> detector; raises on options the port lacks."""
    m = model_cfg
    if m.arch not in ARCHS:
        raise ValueError(f"the port has no arch {m.arch!r}")
    if any(m.dcn_stages) or any(m.gcb_stages) or any(m.gen_attn_stages) \
            or m.with_box_refine or m.as_two_stage or m.backbone:
        raise NotImplementedError("backbone plugins, box refinement and "
                                  "two-stage are not ported")
    return GFLDeformableDETR(
        device, num_classes=m.num_classes, num_query=m.num_query,
        reg_max=m.reg_max, depth=m.depth, embed_dims=m.embed_dims,
        num_encoder_layers=m.num_encoder_layers,
        num_decoder_layers=m.num_decoder_layers, num_levels=m.num_levels,
        frozen_stages=m.frozen_stages, dropout=m.dropout)


@torch.no_grad()
def init_weights(model: GFLDeformableDETR, seed: int = 0) -> None:
    """Seeded random weights at the JAX package's initializer scales.

    Values are drawn on the CPU from one ``torch.Generator`` and copied to
    the model's device, so a seed gives the same weights on every device.
    Backbone convs: normal(0, 1/fan_in) (flax's lecun scale); neck convs and
    linears: xavier-uniform with zero bias; norms: identity; MSDA offsets and
    attention weights: zero kernels with the rotational-grid offset bias;
    embeddings: normal(1); classification bias at prior 0.01; the regression
    output: zero kernel and bias [0, 0, -2, ...].
    """
    g = torch.Generator().manual_seed(seed)

    def put(t, values):
        t.copy_(values.to(t.dtype))

    def xavier(t):
        fan_out, fan_in = t.shape[0], t[0].numel()
        if t.dim() > 2:
            fan_out *= t[0, 0].numel()
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        put(t, torch.empty(t.shape).uniform_(-bound, bound, generator=g))

    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            if name.startswith("backbone"):
                std = mod.weight[0].numel() ** -0.5
                put(mod.weight, torch.empty(mod.weight.shape).normal_(
                    0, std, generator=g))
            else:
                xavier(mod.weight)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            xavier(mod.weight)
            mod.bias.zero_()
        elif isinstance(mod, _InOutProj):
            for chunk in mod.in_proj_weight.chunk(3):
                xavier(chunk)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, FrozenBatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    for mod in model.modules():
        if isinstance(mod, MSDeformAttention):
            mod.sampling_offsets.weight.zero_()
            put(mod.sampling_offsets.bias, msda_offset_bias(
                mod.num_heads, mod.num_levels, mod.num_points))
            mod.attention_weights.weight.zero_()
    head = model.bbox_head
    for t in (head.query_embedding.weight, head.transformer.level_embeds):
        put(t, torch.empty(t.shape).normal_(0, 1, generator=g))
    head.prototype.weight.zero_()
    head.cls_branches[0].bias.fill_(bias_init_with_prob(0.01))
    reg_out = head.reg_branches[0][-1]
    reg_out.weight.zero_()
    reg_out.bias.fill_(-2.0)
    reg_out.bias[:2] = 0.0
