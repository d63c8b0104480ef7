"""Vanilla DETR and the DETR-IL teacher protocol (port of
dskd_tpu/models/detr.py ``DETREncoderLayer``, ``DETRDecoderLayer``,
``DETR``, ``DETRLossConfig``, ``detr_detection_loss``, ``detr_get_bboxes``,
``DETRDistillConfig``, ``detr_teacher_out``, ``detr_compute_losses`` and its
registry entry ``detr``).

ResNet C5 -> 1x1 ``input_proj`` -> post-norm full-attention encoder ->
post-norm decoder (zero initial queries, ``query_embedding`` positions, the
shared ``post_norm`` on every layer's output) -> softmax classifier over
C+1 (background last) and a two-FC ReLU regression branch with a sigmoid
cxcywh output. The padded keys are masked out of every encoder
self-attention and decoder cross-attention. Training matches each (decoder
layer, image) pair by Hungarian assignment on the softmax classification +
L1 + GIoU cost (JV), all of a step's problems in one ``hungarian_assign``
call, then CE (background weight 0.1) + L1 + GIoU.

Parameter names follow mmdet's ``detr_head.py`` and mmcv's
``DetrTransformer`` (``bbox_head.input_proj``, ``bbox_head.transformer.
encoder.layers.i.attentions.0.attn``, ``ffns.0.layers.0.0``, ``norms.k``,
``bbox_head.transformer.decoder.post_norm``, ``bbox_head.fc_cls``,
``bbox_head.reg_ffn.layers.{0.0,1}``, ``bbox_head.fc_reg``), the keys
``utils.weights.detr_state_dict_from_jax`` writes. The attention is plain
torch (projections, einsum, masked softmax, dropout): its dropout shares one
(Q, K) mask across batch and heads, which ``scaled_dot_product_attention``
cannot draw. Images enter NHWC.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.boxes import bbox_cxcywh_to_xyxy, bbox_xyxy_to_cxcywh
from ..core.matching import detr_match_cost, hungarian_assign
from ..distill.losses import _kd_kl_axis, _kept_query_weight
from .detector import init_modules, put_
from .gfl_detr_head import DetResults
from .positional import sine_positional_encoding
from .resnet import ResNet
from .transformer import FFN, MultiheadAttention, _Layers, _norms

FFN_CHANNELS = 2048     # the reference's DETR FFN width (detr.py:42)


class DETROutputs(NamedTuple):
    cls_scores: torch.Tensor   # (nl, B, Q, C+1) softmax logits
    bbox_preds: torch.Tensor   # (nl, B, Q, 4) sigmoid cxcywh
    hs: torch.Tensor           # (nl, B, Q, C)
    memory: torch.Tensor       # (B, HW, C) encoder output


class DETREncoderLayer(nn.Module):
    """('self_attn', 'norm', 'ffn', 'norm'), full attention."""

    def __init__(self, device, embed_dims=256, num_heads=8,
                 feedforward_channels=FFN_CHANNELS, dropout=0.1):
        super().__init__()
        self.attentions = nn.ModuleList([MultiheadAttention(
            device, embed_dims, num_heads, dropout)])
        self.ffns = nn.ModuleList([FFN(device, embed_dims,
                                       feedforward_channels, dropout)])
        self.norms = _norms(2, embed_dims, device)

    def forward(self, x, pos, key_padding_mask=None, generator=None):
        x = self.norms[0](self.attentions[0](
            x, query_pos=pos, key_padding_mask=key_padding_mask,
            generator=generator))
        return self.norms[1](self.ffns[0](x, generator))


class DETRDecoderLayer(nn.Module):
    """('self_attn', 'norm', 'cross_attn', 'norm', 'ffn', 'norm')."""

    def __init__(self, device, embed_dims=256, num_heads=8,
                 feedforward_channels=FFN_CHANNELS, dropout=0.1):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(device, embed_dims, num_heads, dropout)
            for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(device, embed_dims,
                                       feedforward_channels, dropout)])
        self.norms = _norms(3, embed_dims, device)

    def forward(self, q, query_pos, memory, mem_pos, key_padding_mask=None,
                generator=None):
        q = self.norms[0](self.attentions[0](q, query_pos=query_pos,
                                             generator=generator))
        q = self.norms[1](self.attentions[1](
            q, memory, memory, query_pos=query_pos, key_pos=mem_pos,
            key_padding_mask=key_padding_mask, generator=generator))
        return self.norms[2](self.ffns[0](q, generator))


class _Decoder(_Layers):
    """Decoder layers and the ``post_norm`` they share."""

    def __init__(self, layers, embed_dims, device):
        super().__init__(layers)
        self.post_norm = nn.LayerNorm(embed_dims, eps=1e-5, device=device)


class _Transformer(nn.Module):
    def __init__(self, device, embed_dims, num_encoder_layers,
                 num_decoder_layers, dropout):
        super().__init__()
        self.encoder = _Layers(
            DETREncoderLayer(device, embed_dims, dropout=dropout)
            for _ in range(num_encoder_layers))
        self.decoder = _Decoder(
            [DETRDecoderLayer(device, embed_dims, dropout=dropout)
             for _ in range(num_decoder_layers)], embed_dims, device)


class _RegFFN(nn.Module):
    """Two FCs, each followed by ReLU (mmdet's ``reg_ffn`` + activate)."""

    def __init__(self, embed_dims, device):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, embed_dims, device=device),
                          nn.ReLU()),
            nn.Linear(embed_dims, embed_dims, device=device))

    def forward(self, x):
        return F.relu(self.layers(x))


class DETRHead(nn.Module):
    def __init__(self, device, in_channels, num_classes=80, num_query=100,
                 embed_dims=256, num_encoder_layers=6, num_decoder_layers=6,
                 dropout=0.1):
        super().__init__()
        C = embed_dims
        self.input_proj = nn.Conv2d(in_channels, C, 1, device=device)
        self.query_embedding = nn.Embedding(num_query, C, device=device)
        self.transformer = _Transformer(device, C, num_encoder_layers,
                                        num_decoder_layers, dropout)
        self.fc_cls = nn.Linear(C, num_classes + 1, device=device)
        self.reg_ffn = _RegFFN(C, device)
        self.fc_reg = nn.Linear(C, 4, device=device)

    def forward(self, feat, img_hw, batch_input_shape,
                generator=None) -> DETROutputs:
        """feat (B, Cin, H, W) the C5 map; img_hw (B, 2) valid (h, w)."""
        x = self.input_proj(feat)
        B, C, H, W = x.shape
        dev = x.device
        # pixel i of the map stands for input row i * (integer stride)
        ys = (torch.arange(H, device=dev)
              * (batch_input_shape[0] // H))[None, :, None]
        xs = (torch.arange(W, device=dev)
              * (batch_input_shape[1] // W))[None, None, :]
        pad = (ys >= img_hw[:, 0, None, None]) | (xs >= img_hw[:, 1, None,
                                                              None])
        pos = sine_positional_encoding(pad, num_feats=C // 2).to(
            x.dtype).reshape(B, H * W, C)
        pad_flat = pad.reshape(B, H * W)
        tokens = x.flatten(2).transpose(1, 2)
        for layer in self.transformer.encoder.layers:
            tokens = layer(tokens, pos, pad_flat, generator)
        memory = tokens

        qp = self.query_embedding.weight[None].expand(B, -1, -1)
        q = torch.zeros_like(qp)
        decoder = self.transformer.decoder
        inter = []
        for layer in decoder.layers:
            q = layer(q, qp, memory, pos, pad_flat, generator)
            inter.append(decoder.post_norm(q))
        hs = torch.stack(inter, 0)
        cls = self.fc_cls(hs)
        bbox = self.fc_reg(self.reg_ffn(hs)).sigmoid()
        return DETROutputs(cls, bbox, hs, memory)


class DETR(nn.Module):
    """ResNet (C5) + DETR head. ``model.train()`` turns on the dropout,
    whose masks come from the generator passed to ``forward``; the
    backbone's BatchNorm stays frozen."""

    def __init__(self, device, num_classes=80, num_query=100,
                 embed_dims=256, num_encoder_layers=6, num_decoder_layers=6,
                 depth=50, frozen_stages=1, dropout=0.1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(3,),
                               frozen_stages=frozen_stages)
        self.bbox_head = DETRHead(
            device, self.backbone.out_channels[3], num_classes, num_query,
            embed_dims, num_encoder_layers, num_decoder_layers, dropout)

    def forward(self, images, img_hw, generator=None) -> DETROutputs:
        """images (B, H, W, 3) normalized NHWC; img_hw (B, 2) valid (h, w)."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        return self.bbox_head(feats[0], img_hw,
                              (images.shape[1], images.shape[2]), generator)


class DETRLossConfig(NamedTuple):
    num_classes: int = 80
    bg_cls_weight: float = 0.1
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 5.0
    loss_iou_weight: float = 2.0


def detr_detection_loss(out: DETROutputs, gt_bboxes, gt_labels, gt_valid,
                        img_hw, cfg: DETRLossConfig
                        ) -> Dict[str, torch.Tensor]:
    """Hungarian (JV) + CE (background weight 0.1) + L1 + GIoU on every
    decoder layer; the keys of the layers before the last carry
    ``d{i}.``."""
    nl, B, Q, Cp1 = out.cls_scores.shape
    C = cfg.num_classes
    G = gt_bboxes.shape[1]

    def per_layer(t):
        return t[None].expand((nl,) + t.shape).reshape(
            (nl * B,) + t.shape[1:])

    with torch.no_grad():
        cost = detr_match_cost(
            out.cls_scores.reshape(nl * B, Q, Cp1),
            out.bbox_preds.reshape(nl * B, Q, 4), per_layer(gt_bboxes),
            per_layer(gt_labels), per_layer(img_hw), cls_cost="softmax",
            cls_weight=1.0, reg_weight=5.0, iou_weight=2.0)
        res = hungarian_assign(cost, per_layer(gt_valid),
                               per_layer(gt_labels))
    assigned = res.assigned_gt.reshape(nl, B, Q)
    pos_mask = res.pos_mask.reshape(nl, B, Q)

    n_valid = gt_valid.sum().float()
    num_pos = torch.clamp(n_valid, min=1.0)
    cls_avg = torch.clamp(num_pos + (B * Q - n_valid) * cfg.bg_cls_weight,
                          min=1.0)
    class_weight = torch.ones(C + 1, device=out.cls_scores.device)
    class_weight[C] = cfg.bg_cls_weight
    hw = img_hw.float()
    factor = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                         -1)[:, None]                       # (B, 1, 4)

    losses = {}
    for lyr in range(nl):
        safe = assigned[lyr].clamp(0, G - 1)
        pos = pos_mask[lyr]
        tgt_xyxy_n = torch.gather(gt_bboxes, 1,
                                  safe[..., None].expand(B, Q, 4)) / factor
        tgt_cxcywh = bbox_xyxy_to_cxcywh(tgt_xyxy_n)
        labels_q = torch.where(pos, torch.gather(gt_labels.long(), 1, safe),
                               C)
        loss_cls = cfg.loss_cls_weight * L.cross_entropy_loss(
            out.cls_scores[lyr].reshape(-1, Cp1), labels_q.reshape(-1),
            avg_factor=cls_avg, class_weight=class_weight)
        wpos = pos.float()[..., None]
        loss_bbox = cfg.loss_bbox_weight * L.l1_loss(
            out.bbox_preds[lyr].reshape(-1, 4), tgt_cxcywh.reshape(-1, 4),
            weight=wpos.expand(B, Q, 4).reshape(-1, 4), avg_factor=num_pos)
        pred_xyxy = bbox_cxcywh_to_xyxy(out.bbox_preds[lyr]) * factor
        loss_iou = cfg.loss_iou_weight * L.giou_loss(
            pred_xyxy.reshape(-1, 4), (tgt_xyxy_n * factor).reshape(-1, 4),
            weight=wpos.reshape(-1), avg_factor=num_pos)
        prefix = "" if lyr == nl - 1 else f"d{lyr}."
        losses[prefix + "loss_cls"] = loss_cls
        losses[prefix + "loss_bbox"] = loss_bbox
        losses[prefix + "loss_iou"] = loss_iou
    return losses


def detr_get_bboxes(out: DETROutputs, img_hw, score_thr: float = 0.0,
                    max_per_img: int = 100, scale_factor=None,
                    rescale: bool = False) -> DetResults:
    """The last decoder layer as fixed-size detections: per query the max
    over the foreground classes of softmax(C+1), the top ``max_per_img``
    queries (ties to the lower index, as ``lax.top_k``), boxes in image
    coordinates, with the queries' ids (``keep_qid``) and ``valid`` =
    score > ``score_thr``. The boxes are clamped as JAX clamps them: first
    x to h and y to w, then x to w and y to h."""
    cls = out.cls_scores[-1]                       # (B, Q, C+1)
    box = out.bbox_preds[-1]                       # (B, Q, 4)
    B, Q, _ = cls.shape
    probs = torch.softmax(cls, -1)[..., :-1]
    scores = probs.amax(-1)
    labels = probs.argmax(-1)
    k = min(max_per_img, Q)
    top, keep = torch.sort(scores, dim=1, descending=True, stable=True)
    top, keep = top[:, :k], keep[:, :k]
    valid = top > score_thr
    hw = img_hw.to(box.dtype)
    h, w = hw[:, 0, None], hw[:, 1, None]
    factor = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                         -1)[:, None]
    xyxy = bbox_cxcywh_to_xyxy(torch.gather(
        box, 1, keep[..., None].expand(B, k, 4))) * factor
    swapped = torch.stack([hw[:, 0], hw[:, 1], hw[:, 0], hw[:, 1]],
                          -1)[:, None]
    xyxy = torch.minimum(xyxy.clamp(min=0.0), swapped)
    xyxy = torch.stack([xyxy[..., 0].clamp(min=0).minimum(w),
                        xyxy[..., 1].clamp(min=0).minimum(h),
                        xyxy[..., 2].clamp(min=0).minimum(w),
                        xyxy[..., 3].clamp(min=0).minimum(h)], -1)
    if rescale and scale_factor is not None:
        xyxy = xyxy / scale_factor[:, None, :]
    return DetResults(
        xyxy, top, torch.gather(labels, 1, keep),
        torch.gather(cls, 1, keep[..., None].expand(B, k, cls.shape[-1])),
        keep, valid)


class DETRDistillConfig(NamedTuple):
    """The DETR-IL distill menu: ``hard`` merges the teacher's detections
    into the GT, ``soft`` KL-divs the logits at the teacher's kept
    queries, ``feats_kldv`` KL-divs the encoder memory."""
    hard: bool = True
    soft: bool = False
    feats_kldv: bool = False
    kd_weight: float = 10.0
    kd_T: float = 2.0
    fd_weight: float = 10.0
    fd_T: float = 2.0

    @classmethod
    def from_flags(cls, cates_distill="", locat_distill="",
                   feats_distill="", **kw):
        return cls(hard="hard" in cates_distill,
                   soft="soft" in cates_distill,
                   feats_kldv="kldv" in feats_distill, **kw)


def detr_teacher_out(outputs: DETROutputs, img_hw, score_thr: float = 0.3,
                     max_per_img: int = 100):
    """The frozen teacher's detections and outputs, detached."""
    det = detr_get_bboxes(outputs, img_hw, score_thr=score_thr,
                          max_per_img=max_per_img)
    return (DetResults(*(t.detach() for t in det)),
            DETROutputs(*(t.detach() for t in outputs)))


def detr_compute_losses(out: DETROutputs, batch, cfg: DETRLossConfig,
                        teacher_out: Optional[DETROutputs] = None,
                        distill_cfg: Optional[DETRDistillConfig] = None,
                        teacher_score_thr: float = 0.3,
                        teacher_max_per_img: int = 100
                        ) -> Dict[str, torch.Tensor]:
    """Detection losses and the DETR-IL distills for one batch.

    hard: the teacher's detections concatenated ahead of the GT
    (teacher-first); soft: ``kd_kl_div_loss`` of the last layer's logits
    with JAX's (N, 1) weight of kept queries against the (N,) per-row KL,
    which broadcasts to (Σw)(ΣKL)/num_keep; kldv: ``_kd_kl_axis`` over the
    memory's channels, summed and divided by B."""
    gt_bboxes, gt_labels, gt_valid = (batch.gt_bboxes, batch.gt_labels,
                                      batch.gt_valid)
    tdet = None
    if teacher_out is not None:
        tdet, teacher_out = detr_teacher_out(
            teacher_out, batch.img_hw, teacher_score_thr,
            teacher_max_per_img)
        if distill_cfg.hard:
            gt_bboxes = torch.cat([tdet.bboxes, gt_bboxes], 1)
            gt_labels = torch.cat([tdet.labels.to(gt_labels.dtype),
                                   gt_labels], 1)
            gt_valid = torch.cat([tdet.valid, gt_valid], 1)

    losses = detr_detection_loss(out, gt_bboxes, gt_labels, gt_valid,
                                 batch.img_hw, cfg)
    if tdet is not None:
        B, Q, Cp1 = out.cls_scores.shape[1:]
        num_keep = torch.clamp(tdet.valid.sum().float(), min=1.0)
        if distill_cfg.soft:
            keep_w = _kept_query_weight(tdet, B, Q).to(out.cls_scores.dtype)
            losses["loss_kd"] = distill_cfg.kd_weight * L.kd_kl_div_loss(
                out.cls_scores[-1].reshape(-1, Cp1),
                teacher_out.cls_scores[-1].reshape(-1, Cp1),
                weight=keep_w.reshape(-1, 1), avg_factor=num_keep,
                T=distill_cfg.kd_T)
        if distill_cfg.feats_kldv:
            kl = _kd_kl_axis(out.memory, teacher_out.memory,
                             distill_cfg.fd_T, axis=-1)
            losses["loss_fd"] = distill_cfg.fd_weight * kl.sum() / B
    return losses


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

_LECUN = ("backbone.", "bbox_head.input_proj", "bbox_head.fc_cls",
          "bbox_head.reg_ffn", "bbox_head.fc_reg")


def build_detr(model_cfg, device="cuda") -> DETR:
    """``ModelConfig`` -> DETR, with the fields JAX's registry passes (the
    width is DETR's 256)."""
    m = model_cfg
    return DETR(device, num_classes=m.num_classes, num_query=m.num_query,
                depth=m.depth, frozen_stages=m.frozen_stages,
                num_encoder_layers=m.num_encoder_layers,
                num_decoder_layers=m.num_decoder_layers, dropout=m.dropout)


@torch.no_grad()
def init_detr(model: DETR, seed: int = 0) -> None:
    """Seeded random weights at the scales of JAX's initializers, drawn on
    the CPU: lecun-normal (flax's default) for the backbone's convs,
    ``input_proj``, ``fc_cls``, ``reg_ffn`` and ``fc_reg``; xavier-uniform
    for the attention and FFN projections; zero biases; identity norms;
    normal(1) for ``query_embedding``."""
    g = torch.Generator().manual_seed(seed)
    init_modules(model, g, lambda name: name.startswith(_LECUN))
    t = model.bbox_head.query_embedding.weight
    put_(t, torch.empty(t.shape).normal_(0, 1, generator=g))


def _register():
    from ..registry import register_family
    from ..utils.weights import detr_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = DETRLossConfig(num_classes=cfg.model.num_classes)
        distill_cfg = DETRDistillConfig.from_flags(
            cates_distill=cfg.distill.cates_distill,
            feats_distill=cfg.distill.feats_distill) if has_teacher else None

        def losses_fn(model, batch, teacher, generator):
            # the reference trains DETR with dropout 0.1 (a model built
            # with p = 0 when use_dropout is off); the frozen teacher runs
            # in eval mode
            out = model(batch.images, batch.img_hw, generator=generator)
            t_out = None
            if teacher is not None:
                with torch.no_grad():
                    t_out = teacher(batch.images, batch.img_hw)
            return detr_compute_losses(
                out, batch, det_cfg, teacher_out=t_out,
                distill_cfg=distill_cfg,
                teacher_score_thr=cfg.distill.teacher_score_thr,
                teacher_max_per_img=cfg.distill.teacher_max_per_img)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            return detr_get_bboxes(model(images, img_hw), img_hw,
                                   score_thr=score_thr,
                                   max_per_img=max_per_img,
                                   scale_factor=scale_factors, rescale=True)
        return step

    register_family("detr", build=build_detr, init_weights=init_detr,
                    from_jax=detr_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
