"""GFL Deformable-DETR head, decoding and detections (port of
dskd_tpu/models/gfl_detr_head.py ``GFLDeformableDETRHead``,
``decode_boxes`` and ``get_bboxes``).

The classification and regression branches are shared by all decoder layers
(no box refinement). The regression branch emits ``2 + 4*(reg_max+1)``
channels; the inverse-sigmoid reference is added to the first two before the
whole vector is sigmoided, and (w, h) decode with ``integral_average``.
Parameter names follow mmdet (``cls_branches.0``, ``reg_branches.0.{0,2,4}``,
``query_embedding``, ``prototype``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn

from ..core.boxes import bbox_cxcywh_to_xyxy
from ..core.integral import integral_average
from ..core.postprocess import filter_scores_and_topk
from .transformer import DeformableDetrTransformer, inverse_sigmoid


def bias_init_with_prob(prior_prob: float) -> float:
    return -math.log((1 - prior_prob) / prior_prob)


class HeadOutputs(NamedTuple):
    """cls_scores (nl, B, Q, K) logits; bbox_preds (nl, B, Q, 2+4*(rm+1))
    sigmoided; memory (B, S, C); hs (nl, B, Q, C); mask_flat (B, S)."""
    cls_scores: torch.Tensor
    bbox_preds: torch.Tensor
    memory: torch.Tensor
    hs: torch.Tensor
    mask_flat: torch.Tensor


class GFLDeformableDETRHead(nn.Module):
    def __init__(self, device, num_classes=80, num_query=300, embed_dims=256,
                 reg_max=16, num_encoder_layers=6, num_decoder_layers=6,
                 num_heads=8, num_levels=4, num_points=4,
                 feedforward_channels=1024, dropout=0.1):
        super().__init__()
        C = embed_dims
        self.query_embedding = nn.Embedding(num_query, 2 * C, device=device)
        # unused by the forward but part of the reference's parameters
        self.prototype = nn.Embedding(num_classes, C, device=device)
        self.transformer = DeformableDetrTransformer(
            device, C, num_heads, num_levels, num_points, num_encoder_layers,
            num_decoder_layers, feedforward_channels, dropout)
        self.cls_branches = nn.ModuleList([nn.Linear(C, num_classes,
                                                     device=device)])
        self.reg_branches = nn.ModuleList([nn.Sequential(
            nn.Linear(C, C, device=device), nn.ReLU(),
            nn.Linear(C, C, device=device), nn.ReLU(),
            nn.Linear(C, 2 + 4 * (reg_max + 1), device=device))])

    def forward(self, mlvl_feats, img_hw, batch_input_shape,
                generator=None) -> HeadOutputs:
        hs, init_ref, inter_refs, memory, mask_flat = self.transformer(
            mlvl_feats, img_hw, batch_input_shape,
            self.query_embedding.weight, generator)
        tmp = self.reg_branches[0](hs)
        # layer l uses init_ref for l=0 and inter_refs[l-1] after
        refs = torch.cat([init_ref[None], inter_refs[:-1]], 0)
        tmp = torch.cat([tmp[..., :2] + inverse_sigmoid(refs), tmp[..., 2:]],
                        dim=-1)
        return HeadOutputs(self.cls_branches[0](hs), tmp.sigmoid(), memory,
                           hs, mask_flat)


class DetResults(NamedTuple):
    """Fixed-size per-image detections, masked by ``valid``: bboxes (B, k, 4)
    xyxy; scores, labels, keep_qid, valid (B, k); logits (B, k, K)."""
    bboxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    logits: torch.Tensor
    keep_qid: torch.Tensor
    valid: torch.Tensor


def decode_boxes(bbox_preds: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 2+4*(reg_max+1)) sigmoided head output -> (..., 4) cxcywh."""
    return torch.cat([bbox_preds[..., :2],
                      integral_average(bbox_preds[..., 2:], reg_max)], -1)


def get_bboxes(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
               img_hw: torch.Tensor, scale_factor: torch.Tensor = None,
               reg_max: int = 16, score_thr: float = 0.0,
               max_per_img: int = 100, rescale: bool = False) -> DetResults:
    """Batched detections from the last decoder layer's outputs.

    cls_scores (B, Q, K) logits; bbox_preds (B, Q, 2+4*(rm+1)); img_hw (B, 2)
    valid (h, w); scale_factor (B, 4) resize factors for ``rescale``.
    Sigmoid, threshold + top-k over the Q*K pairs, integral decode, scale to
    the image, clamp.
    """
    B, Q, K = cls_scores.shape
    top = filter_scores_and_topk(cls_scores.sigmoid(), score_thr,
                                 max_per_img)
    keep = top.keep_idxs.long()
    sel = torch.gather(bbox_preds, 1, keep[..., None].expand(
        -1, -1, bbox_preds.shape[-1]))
    boxes = bbox_cxcywh_to_xyxy(decode_boxes(sel, reg_max))
    hw = img_hw.to(boxes.dtype)
    wh = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)[:, None]
    boxes = torch.minimum(torch.clamp(boxes * wh, min=0), wh)
    if rescale:
        if scale_factor is None:
            scale_factor = torch.ones((B, 4), dtype=boxes.dtype,
                                      device=boxes.device)
        boxes = boxes / scale_factor[:, None, :]
    logits = torch.gather(cls_scores, 1, keep[..., None].expand(-1, -1, K))
    return DetResults(boxes, top.scores, top.labels, logits, top.keep_idxs,
                      top.valid)
