"""Vanilla Deformable-DETR: base, iterative box refinement and two-stage
(port of dskd_tpu/models/deformable_detr.py ``proposal_pos_embed``,
``gen_encoder_output_proposals``, ``DeformableDETRHead``,
``DeformableDETR``, ``DDETRLossConfig``, ``_layer_loss``,
``deformable_detr_loss``, ``deformable_detr_get_bboxes`` and its registry
entry ``deformable_detr``).

ResNet (C3-C5) -> ChannelMapper (four levels) -> the flagship's MSDA
encoder and decoder layers -> per-layer (``with_box_refine``) or shared
classification and regression branches. Refinement feeds each layer's
regression back into the next layer's (detached) box reference; layer i
decodes from the reference before it. Two-stage (``as_two_stage``) scores
every encoder token against an anchor proposal, starts the decoder from the
top ``num_query`` of them by class-0 logit (detached, ties to the lower
token, as ``lax.top_k``) and trains the proposals class-agnostically
(``enc.`` losses). JAX's opt-in premap decoder layout (``DSKD_PREMAP``)
is not ported.

Parameter names follow mmdet's ``deformable_detr_head.py`` and
``DeformableDetrTransformer`` (``bbox_head.cls_branches.i``,
``bbox_head.reg_branches.i.{0,2,4}``, ``bbox_head.query_embedding``,
``bbox_head.transformer.{level_embeds,reference_points,enc_output,
enc_output_norm,pos_trans,pos_trans_norm}``); without refinement every
index of ``cls_branches`` and ``reg_branches`` holds the same module, as
mmdet's shared ``ModuleList`` does. Images enter NHWC.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.boxes import bbox_cxcywh_to_xyxy, bbox_xyxy_to_cxcywh
from ..core.matching import detr_match_cost, hungarian_assign
from ..core.postprocess import filter_scores_and_topk
from .channel_mapper import ChannelMapper
from .detector import init_modules, put_
from .gfl_detr_head import DetResults, bias_init_with_prob
from .positional import sine_positional_encoding
from .resnet import ResNet
from .transformer import (DecoderLayer, EncoderLayer, MSDeformAttention,
                          _Layers, encoder_reference_points, inverse_sigmoid,
                          level_masks_and_ratios, msda_offset_bias)


class DDETRHeadOutputs(NamedTuple):
    """cls_scores (nl, B, Q, C) logits; bbox_preds (nl, B, Q, 4) sigmoid
    cxcywh; two-stage only (else None): enc_cls_scores (B, S, C),
    enc_bbox_preds (B, S, 4) and enc_token_valid (B, S), the tokens whose
    proposal lies inside the image."""
    cls_scores: torch.Tensor
    bbox_preds: torch.Tensor
    enc_cls_scores: Optional[torch.Tensor]
    enc_bbox_preds: Optional[torch.Tensor]
    enc_token_valid: Optional[torch.Tensor]


class DDETROutputs(NamedTuple):
    head: DDETRHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]   # NHWC per level


def proposal_pos_embed(proposals: torch.Tensor, num_pos_feats: int = 128,
                       temperature: float = 10000.0) -> torch.Tensor:
    """(B, Q, 4) normalized boxes -> (B, Q, 4 * num_pos_feats) sine
    embedding, sin and cos interleaved per coordinate."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=proposals.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    pos = (proposals * (2 * math.pi))[..., None] / dim_t     # (B, Q, 4, F)
    pos = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()],
                      dim=-1).reshape(pos.shape)
    return pos.flatten(2)


def level_valid_wh(valid_ratios, spatial_shapes):
    """(B, L, 2) f32 valid (w, h) token counts of each level."""
    level_wh = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                            dtype=torch.float32, device=valid_ratios.device)
    return valid_ratios.float() * level_wh[None]


def gen_encoder_output_proposals(mask_flat, spatial_shapes, valid_wh):
    """Per-token anchor proposals in logit space and their validity.

    Level l's grid centres are normalized by the level's valid (w, h), its
    (w, h) is 0.05 * 2^l; a token's proposal is valid iff all four
    coordinates lie in (0.01, 0.99) and the token is not padding. Invalid
    rows take 1e6, whose sigmoid is exactly 1. Returns (proposals_unact
    (B, S, 4), valid (B, S))."""
    B = mask_flat.shape[0]
    dev = mask_flat.device
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        vw = valid_wh[:, lvl, 0][:, None, None]
        vh = valid_wh[:, lvl, 1][:, None, None]
        ys = (torch.arange(h, dtype=torch.float32, device=dev)
              + 0.5)[None, :, None]
        xs = (torch.arange(w, dtype=torch.float32, device=dev)
              + 0.5)[None, None, :]
        grid = torch.stack([(xs / vw).expand(B, h, w),
                            (ys / vh).expand(B, h, w)], -1)
        wh = torch.full((B, h, w, 2), 0.05 * (2.0 ** lvl), device=dev)
        props.append(torch.cat([grid, wh], -1).reshape(B, h * w, 4))
    proposals = torch.cat(props, 1)
    valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1) & ~mask_flat
    unact = torch.log(proposals / (1 - proposals.clamp(max=0.999999)))
    return torch.where(valid[..., None], unact,
                       torch.full_like(unact, 1e6)), valid


def select_proposals(enc_cls, enc_valid, k):
    """(B, k) indices of the top ``k`` valid tokens by class-0 logit of
    ``enc_cls`` (B, S, C); stable, so that among equal scores the lower
    token comes first, as ``lax.top_k`` does."""
    score0 = torch.where(enc_valid, enc_cls[..., 0],
                         torch.full_like(enc_cls[..., 0], -1e9))
    return torch.sort(score0, dim=1, descending=True, stable=True)[1][:, :k]


def _reg_branch(C, device):
    return nn.Sequential(nn.Linear(C, C, device=device), nn.ReLU(),
                         nn.Linear(C, C, device=device), nn.ReLU(),
                         nn.Linear(C, 4, device=device))


class _Transformer(nn.Module):
    """The transformer's parameters under mmdet's names; the head runs it."""

    def __init__(self, device, C, num_heads, num_levels, num_points,
                 num_encoder_layers, num_decoder_layers, ffn, dropout,
                 as_two_stage):
        super().__init__()
        args = (device, C, num_heads, num_levels, num_points, ffn, dropout)
        self.level_embeds = nn.Parameter(torch.zeros(num_levels, C,
                                                     device=device))
        self.encoder = _Layers(EncoderLayer(*args)
                               for _ in range(num_encoder_layers))
        self.decoder = _Layers(DecoderLayer(*args)
                               for _ in range(num_decoder_layers))
        if as_two_stage:
            self.enc_output = nn.Linear(C, C, device=device)
            self.enc_output_norm = nn.LayerNorm(C, eps=1e-5, device=device)
            self.pos_trans = nn.Linear(2 * C, 2 * C, device=device)
            self.pos_trans_norm = nn.LayerNorm(2 * C, eps=1e-5,
                                               device=device)
        else:
            self.reference_points = nn.Linear(C, 2, device=device)


class DeformableDETRHead(nn.Module):
    """Encoder, decoder and the per-layer or shared branches."""

    def __init__(self, device, num_classes=80, num_query=300, embed_dims=256,
                 num_heads=8, num_levels=4, num_points=4,
                 num_encoder_layers=6, num_decoder_layers=6,
                 feedforward_channels=1024, dropout=0.1,
                 with_box_refine=False, as_two_stage=False):
        super().__init__()
        C = embed_dims
        self.num_query = num_query
        self.with_box_refine, self.as_two_stage = with_box_refine, as_two_stage
        self.transformer = _Transformer(
            device, C, num_heads, num_levels, num_points, num_encoder_layers,
            num_decoder_layers, feedforward_channels, dropout, as_two_stage)
        if not as_two_stage:
            self.query_embedding = nn.Embedding(num_query, 2 * C,
                                                device=device)
        num_pred = num_decoder_layers + int(as_two_stage)
        if with_box_refine:
            cls = [nn.Linear(C, num_classes, device=device)
                   for _ in range(num_pred)]
            reg = [_reg_branch(C, device) for _ in range(num_pred)]
        else:
            cls = [nn.Linear(C, num_classes, device=device)] * num_pred
            reg = [_reg_branch(C, device)] * num_pred
        self.cls_branches = nn.ModuleList(cls)
        self.reg_branches = nn.ModuleList(reg)

    def forward(self, mlvl_feats, img_hw, batch_input_shape,
                generator=None) -> DDETRHeadOutputs:
        """mlvl_feats NCHW (B, C, h, w) per level; img_hw (B, 2) valid
        (h, w); ``generator`` draws the dropout masks in training mode."""
        t = self.transformer
        B, C = mlvl_feats[0].shape[:2]
        spatial_shapes = tuple((f.shape[2], f.shape[3]) for f in mlvl_feats)
        masks, valid_ratios = level_masks_and_ratios(
            img_hw, batch_input_shape, spatial_shapes)
        valid_wh = level_valid_wh(valid_ratios, spatial_shapes)
        feat_flat, mask_flat, pos_flat = [], [], []
        for lvl, (feat, mask) in enumerate(zip(mlvl_feats, masks)):
            pos = sine_positional_encoding(mask, num_feats=C // 2)
            feat_flat.append(feat.flatten(2).transpose(1, 2))
            mask_flat.append(mask.flatten(1))
            pos_flat.append(pos.flatten(1, 2).to(feat.dtype)
                            + t.level_embeds[lvl])
        feat_flat = torch.cat(feat_flat, 1)
        mask_flat = torch.cat(mask_flat, 1)
        pos_flat = torch.cat(pos_flat, 1)

        enc_refs = encoder_reference_points(spatial_shapes, valid_ratios)
        x = feat_flat
        for layer in t.encoder.layers:
            x = layer(x, pos_flat, enc_refs, spatial_shapes, mask_flat,
                      generator)
        memory = x

        enc_cls = enc_coord = enc_valid = None
        if self.as_two_stage:
            proposals_unact, enc_valid = gen_encoder_output_proposals(
                mask_flat, spatial_shapes, valid_wh)
            om = memory.masked_fill((mask_flat | ~enc_valid)[..., None], 0.0)
            om = t.enc_output_norm(t.enc_output(om))
            enc_cls = self.cls_branches[-1](om)                 # (B, S, C)
            enc_coord_unact = self.reg_branches[-1](om) + proposals_unact
            enc_coord = enc_coord_unact.sigmoid()
            topk = select_proposals(enc_cls, enc_valid, self.num_query)
            topk_unact = torch.gather(enc_coord_unact, 1, topk[..., None]
                                      .expand(-1, -1, 4)).detach()
            reference_points = topk_unact.sigmoid()
            pt = t.pos_trans_norm(t.pos_trans(
                proposal_pos_embed(reference_points)))
            query_pos, query = pt.split(C, dim=-1)
        else:
            query_pos, query = self.query_embedding.weight.split(C, dim=1)
            query_pos = query_pos[None].expand(B, -1, -1)
            query = query[None].expand(B, -1, -1)
            reference_points = t.reference_points(query_pos).sigmoid()

        cls_scores, bbox_preds = [], []
        for i, layer in enumerate(t.decoder.layers):
            ref = reference_points
            ratios = (torch.cat([valid_ratios] * 2, -1) if ref.shape[-1] == 4
                      else valid_ratios)
            query = layer(query, query_pos, memory,
                          ref[:, :, None, :] * ratios[:, None], spatial_shapes,
                          mask_flat, generator)
            tmp = self.reg_branches[i](query)
            # layer i decodes from the reference it was given
            if ref.shape[-1] == 4:
                unact = tmp + inverse_sigmoid(ref)
            else:
                unact = torch.cat([tmp[..., :2] + inverse_sigmoid(ref),
                                   tmp[..., 2:]], -1)
            if self.with_box_refine:
                reference_points = unact.sigmoid().detach()
            cls_scores.append(self.cls_branches[i](query))
            bbox_preds.append(unact.sigmoid())
        return DDETRHeadOutputs(torch.stack(cls_scores, 0),
                                torch.stack(bbox_preds, 0), enc_cls,
                                enc_coord, enc_valid)


class DeformableDETR(nn.Module):
    """ResNet + ChannelMapper + DeformableDETRHead. ``model.train()`` turns
    on the dropout, whose masks come from the generator passed to
    ``forward``; the backbone's BatchNorm stays frozen."""

    def __init__(self, device, num_classes=80, num_query=300, depth=50,
                 frozen_stages=1, embed_dims=256, num_encoder_layers=6,
                 num_decoder_layers=6, num_levels=4, dropout=0.1,
                 with_box_refine=False, as_two_stage=False):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = ChannelMapper(self.backbone.out_channels[1:], device,
                                  out_channels=embed_dims,
                                  num_outs=num_levels)
        self.bbox_head = DeformableDETRHead(
            device, num_classes=num_classes, num_query=num_query,
            embed_dims=embed_dims, num_levels=num_levels,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, dropout=dropout,
            with_box_refine=with_box_refine, as_two_stage=as_two_stage)

    def forward(self, images, img_hw, generator=None) -> DDETROutputs:
        """images (B, H, W, 3) normalized NHWC; img_hw (B, 2) valid (h, w)."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        head = self.bbox_head(neck, img_hw,
                              (images.shape[1], images.shape[2]), generator)
        return DDETROutputs(head, tuple(f.permute(0, 2, 3, 1) for f in neck))


class DDETRLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 5.0
    loss_iou_weight: float = 2.0


def _assign(cls_s, bbox_p, gt_bboxes, gt_labels, gt_valid, img_hw):
    """The focal-cost Hungarian assignment (JV) of N problems at once:
    cls_s (N, Q, C), bbox_p (N, Q, 4), the GT of each problem."""
    with torch.no_grad():
        cost = detr_match_cost(cls_s, bbox_p, gt_bboxes, gt_labels, img_hw,
                               cls_cost="focal", cls_weight=2.0,
                               reg_weight=5.0, iou_weight=2.0)
        return hungarian_assign(cost, gt_valid, gt_labels)


def _layer_loss(cls_s, bbox_p, assigned, pos_mask, gt_bboxes, gt_labels,
                img_hw, cfg: DDETRLossConfig):
    """Focal + L1 + GIoU of one prediction layer (B, Q, ...) under its
    assignment."""
    B, Q, C = cls_s.shape
    G = gt_bboxes.shape[1]
    safe = assigned.clamp(0, G - 1)
    num_pos = torch.clamp(pos_mask.sum().float(), min=1.0)
    labels_q = torch.where(pos_mask, torch.gather(gt_labels.long(), 1, safe),
                           C)
    onehot = F.one_hot(labels_q, C + 1)[..., :C].to(cls_s.dtype)
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_s.reshape(-1, C), onehot.reshape(-1, C), avg_factor=num_pos,
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    hw = img_hw.float()
    factor = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                         -1)[:, None]
    tgt_xyxy_n = torch.gather(gt_bboxes, 1,
                              safe[..., None].expand(B, Q, 4)) / factor
    wpos = pos_mask.float()[..., None]
    loss_bbox = cfg.loss_bbox_weight * L.l1_loss(
        bbox_p.reshape(-1, 4), bbox_xyxy_to_cxcywh(tgt_xyxy_n).reshape(-1, 4),
        weight=wpos.expand(B, Q, 4).reshape(-1, 4), avg_factor=num_pos)
    loss_iou = cfg.loss_iou_weight * L.giou_loss(
        (bbox_cxcywh_to_xyxy(bbox_p) * factor).reshape(-1, 4),
        (tgt_xyxy_n * factor).reshape(-1, 4), weight=wpos.reshape(-1),
        avg_factor=num_pos)
    return loss_cls, loss_bbox, loss_iou


def deformable_detr_loss(out: DDETRHeadOutputs, gt_bboxes, gt_labels,
                         gt_valid, img_hw, cfg: DDETRLossConfig
                         ) -> Dict[str, torch.Tensor]:
    """Every decoder layer's losses (the layers before the last under
    ``d{i}.``; their nl x B problems in one JV call) and, in two-stage, the
    class-agnostic encoder-proposal losses under ``enc.`` (every token a
    candidate, label 0; one more JV call)."""
    nl, B, Q, C = out.cls_scores.shape

    def per_layer(t):
        return t[None].expand((nl,) + t.shape).reshape((nl * B,) + t.shape[1:])

    res = _assign(out.cls_scores.reshape(nl * B, Q, C),
                  out.bbox_preds.reshape(nl * B, Q, 4), per_layer(gt_bboxes),
                  per_layer(gt_labels), per_layer(gt_valid),
                  per_layer(img_hw))
    assigned = res.assigned_gt.reshape(nl, B, Q)
    pos_mask = res.pos_mask.reshape(nl, B, Q)
    losses = {}
    for lyr in range(nl):
        terms = _layer_loss(out.cls_scores[lyr], out.bbox_preds[lyr],
                            assigned[lyr], pos_mask[lyr], gt_bboxes,
                            gt_labels, img_hw, cfg)
        prefix = "" if lyr == nl - 1 else f"d{lyr}."
        for name, v in zip(("loss_cls", "loss_bbox", "loss_iou"), terms):
            losses[prefix + name] = v
    if out.enc_cls_scores is not None:
        zeros = torch.zeros_like(gt_labels)
        res = _assign(out.enc_cls_scores, out.enc_bbox_preds, gt_bboxes,
                      zeros, gt_valid, img_hw)
        terms = _layer_loss(out.enc_cls_scores, out.enc_bbox_preds,
                            res.assigned_gt, res.pos_mask, gt_bboxes, zeros,
                            img_hw, cfg)
        for name, v in zip(("loss_cls", "loss_bbox", "loss_iou"), terms):
            losses["enc." + name] = v
    return losses


def deformable_detr_get_bboxes(out: DDETRHeadOutputs, img_hw,
                               score_thr: float = 0.0,
                               max_per_img: int = 100, scale_factor=None,
                               rescale: bool = False) -> DetResults:
    """The last layer's sigmoid scores: threshold and top ``max_per_img``
    over the (query, class) pairs (ties to the lower flat index), boxes in
    image coordinates with x clamped to [0, w] and y to [0, h], divided by
    ``scale_factor`` under ``rescale``; no NMS."""
    cls = out.cls_scores[-1]
    box = out.bbox_preds[-1]
    B, Q, C = cls.shape
    top = filter_scores_and_topk(cls.sigmoid(), score_thr, max_per_img)
    keep = top.keep_idxs.long()
    k = keep.shape[1]
    hw = img_hw.to(box.dtype)
    factor = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                         -1)[:, None]
    xyxy = bbox_cxcywh_to_xyxy(torch.gather(
        box, 1, keep[..., None].expand(B, k, 4))) * factor
    xyxy = torch.minimum(xyxy.clamp(min=0.0), factor)
    if rescale and scale_factor is not None:
        xyxy = xyxy / scale_factor[:, None, :]
    logits = torch.gather(cls, 1, keep[..., None].expand(B, k, C))
    return DetResults(xyxy, top.scores, top.labels, logits, top.keep_idxs,
                      top.valid)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_deformable_detr(model_cfg, device="cuda") -> DeformableDETR:
    """``ModelConfig`` -> DeformableDETR, with the fields JAX's registry
    passes."""
    m = model_cfg
    return DeformableDETR(
        device, num_classes=m.num_classes, num_query=m.num_query,
        depth=m.depth, frozen_stages=m.frozen_stages,
        embed_dims=m.embed_dims, num_encoder_layers=m.num_encoder_layers,
        num_decoder_layers=m.num_decoder_layers, num_levels=m.num_levels,
        dropout=m.dropout, with_box_refine=m.with_box_refine,
        as_two_stage=m.as_two_stage)


@torch.no_grad()
def init_deformable_detr(model: DeformableDETR, seed: int = 0) -> None:
    """Seeded random weights at the scales of JAX's initializers, drawn on
    the CPU: lecun-normal backbone convs; xavier-uniform neck, attention,
    FFN, branches, ``enc_output``, ``pos_trans`` and ``reference_points``
    (JAX's fan_avg uniform is xavier's), zero biases, identity norms; MSDA
    offsets and attention weights zero with the rotational-grid offset
    bias; normal(1) ``level_embeds`` and ``query_embedding``; class biases
    at prior 0.01; regression outputs zero, branch 0's (w, h) bias -2
    except in two-stage."""
    g = torch.Generator().manual_seed(seed)
    init_modules(model, g, lambda name: name.startswith("backbone"))
    for mod in model.modules():
        if isinstance(mod, MSDeformAttention):
            mod.sampling_offsets.weight.zero_()
            put_(mod.sampling_offsets.bias, msda_offset_bias(
                mod.num_heads, mod.num_levels, mod.num_points))
            mod.attention_weights.weight.zero_()
    head = model.bbox_head
    embeds = [head.transformer.level_embeds]
    if not head.as_two_stage:
        embeds.append(head.query_embedding.weight)
    for t in embeds:
        put_(t, torch.empty(t.shape).normal_(0, 1, generator=g))
    for cls in head.cls_branches:
        cls.bias.fill_(bias_init_with_prob(0.01))
    for reg in head.reg_branches:
        reg[-1].weight.zero_()
        reg[-1].bias.zero_()
    if not head.as_two_stage:
        head.reg_branches[0][-1].bias[2:] = -2.0


def _register():
    from ..registry import register_family
    from ..utils.weights import deformable_detr_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        # JAX's family trains without distillation: the teacher is unused
        det_cfg = DDETRLossConfig(num_classes=cfg.model.num_classes)

        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw, generator=generator)
            return deformable_detr_loss(out.head, batch.gt_bboxes,
                                        batch.gt_labels, batch.gt_valid,
                                        batch.img_hw, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            return deformable_detr_get_bboxes(
                model(images, img_hw).head, img_hw, score_thr=score_thr,
                max_per_img=max_per_img, scale_factor=scale_factors,
                rescale=True)
        return step

    register_family("deformable_detr", build=build_deformable_detr,
                    init_weights=init_deformable_detr,
                    from_jax=deformable_detr_state_dict_from_jax,
                    losses=losses, eval_step=eval_step)


_register()
