"""Detector assembly (port of dskd_tpu/models/detector.py
``GFLDeformableDETR`` and its registry entry): ResNet -> ChannelMapper ->
GFL Deformable-DETR head, registered as ``gfl_deformable_detr`` and
``deformable_detr_il`` with the flagship's own train step
(``train.step.make_train_step``).

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


# the flagship family's archs in the registry
FLAGSHIP_ARCHS = ("gfl_deformable_detr", "deformable_detr_il")


def build_detector(model_cfg, device="cuda") -> GFLDeformableDETR:
    """``ModelConfig`` -> detector; raises on options the port lacks."""
    m = model_cfg
    if m.arch not in FLAGSHIP_ARCHS:
        raise ValueError(f"arch {m.arch!r} is not the flagship's")
    if m.with_box_refine or m.as_two_stage:
        raise NotImplementedError(
            "the flagship has no box refinement or two-stage; the "
            "'deformable_detr' arch (models/deformable_detr.py) has both")
    if any(m.dcn_stages) or any(m.gcb_stages) or any(m.gen_attn_stages) \
            or m.backbone:
        raise NotImplementedError("backbone plugins (DCN, GCB, gen-attn) "
                                  "and other backbones are not ported")
    return GFLDeformableDETR(
        device, num_classes=m.num_classes, num_query=m.num_query,
        reg_max=m.reg_max, depth=m.depth, embed_dims=m.embed_dims,
        num_encoder_layers=m.num_encoder_layers,
        num_decoder_layers=m.num_decoder_layers, num_levels=m.num_levels,
        frozen_stages=m.frozen_stages, dropout=m.dropout)


def put_(t: torch.Tensor, values: torch.Tensor) -> None:
    t.copy_(values.to(t.dtype))


def xavier_(t: torch.Tensor, g: torch.Generator) -> None:
    """xavier-uniform over (out, in[, kh, kw]), drawn on the CPU."""
    fan_out, fan_in = t.shape[0], t[0].numel()
    if t.dim() > 2:
        fan_out *= t[0, 0].numel()
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    put_(t, torch.empty(t.shape).uniform_(-bound, bound, generator=g))


def lecun_(t: torch.Tensor, g: torch.Generator) -> None:
    """normal(0, 1/fan_in): the scale of flax's default lecun_normal."""
    put_(t, torch.empty(t.shape).normal_(0, t[0].numel() ** -0.5,
                                         generator=g))


@torch.no_grad()
def init_modules(model: nn.Module, g: torch.Generator, lecun) -> None:
    """Convs and linears whose name ``lecun(name)`` picks: lecun-normal,
    the others xavier-uniform, each with zero bias; packed attention
    projections xavier-uniform per q/k/v chunk with zero bias; norms
    identity. Values are drawn on the CPU from ``g`` in module order."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            (lecun_ if lecun(name) else xavier_)(mod.weight, g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, _InOutProj):
            for chunk in mod.in_proj_weight.chunk(3):
                xavier_(chunk, g)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, FrozenBatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)


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
    init_modules(model, g, lambda name: name.startswith("backbone"))
    for mod in model.modules():
        if isinstance(mod, MSDeformAttention):
            mod.sampling_offsets.weight.zero_()
            put_(mod.sampling_offsets.bias, msda_offset_bias(
                mod.num_heads, mod.num_levels, mod.num_points))
            mod.attention_weights.weight.zero_()
    head = model.bbox_head
    for t in (head.query_embedding.weight, head.transformer.level_embeds):
        put_(t, torch.empty(t.shape).normal_(0, 1, generator=g))
    head.prototype.weight.zero_()
    head.cls_branches[0].bias.fill_(bias_init_with_prob(0.01))
    reg_out = head.reg_branches[0][-1]
    reg_out.weight.zero_()
    reg_out.bias.fill_(-2.0)
    reg_out.bias[:2] = 0.0


# --- family registration (dskd_tpu_torch/registry.py) ----------------------

def _register():
    from ..registry import register_family

    def train_step(model, cfg, *, num_prev, has_teacher, use_dropout,
                   compute_dtype):
        from ..distill.losses import DistillConfig
        from ..train.step import make_train_step
        from .gfl_detr_loss import DetLossConfig

        det_cfg = DetLossConfig(num_classes=cfg.model.num_classes,
                                reg_max=cfg.model.reg_max)
        distill_cfg = None
        if has_teacher:
            distill_cfg = DistillConfig.from_flags(
                cates_distill=cfg.distill.cates_distill,
                locat_distill=cfg.distill.locat_distill,
                feats_distill=cfg.distill.feats_distill,
                memory_distill=cfg.distill.memory_distill,
                num_prev=max(num_prev, 1), reg_max=cfg.model.reg_max,
                fix_fg_grad_direction=cfg.distill.fix_fg_grad_direction)
        return make_train_step(
            det_cfg, distill_cfg,
            teacher_score_thr=cfg.distill.teacher_score_thr,
            teacher_max_per_img=cfg.distill.teacher_max_per_img,
            compute_dtype=compute_dtype)

    def eval_step(model, *, score_thr, max_per_img, reg_max):
        from .gfl_detr_head import get_bboxes

        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            return get_bboxes(out.head.cls_scores[-1],
                              out.head.bbox_preds[-1], img_hw,
                              scale_factor=scale_factors, reg_max=reg_max,
                              score_thr=score_thr, max_per_img=max_per_img,
                              rescale=True)
        return step

    def from_jax(variables):
        from ..utils.weights import state_dict_from_jax
        return state_dict_from_jax(variables)

    for arch in FLAGSHIP_ARCHS:
        register_family(arch, build=build_detector, init_weights=init_weights,
                        from_jax=from_jax, train_step=train_step,
                        eval_step=eval_step)


_register()
