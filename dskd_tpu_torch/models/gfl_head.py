"""The GFL head: forward, detection loss and box decoding (port of
dskd_tpu/models/gfl_head.py ``Scale``, ``GFLHead``, ``gfl_anchors``,
``GFLLossConfig``, ``gfl_detection_loss`` and ``gfl_get_bboxes``), and the
pieces the dense single-stage heads share.

Forward: two towers of 4 x (3x3 conv without bias, GroupNorm(32), ReLU),
shared across the levels, then ``gfl_cls`` (C logits) and ``gfl_reg``
(4 x (reg_max + 1) bin logits) times a learnable per-level ``Scale``.
Outputs are NHWC per level, as JAX's, so flattening a level to
(B, H*W*A, X) gives its priors' row-major (y, x, anchor) order. Loss: ATSS
assignment over one square anchor of 8 strides per position, QFL with the
IoU of the decoded box (detached) as the positives' quality, GIoU and DFL
in stride units weighted by the detached max class score. Decoding: the
softmax integral times the stride from each position's centre, per-level
threshold and top-k, boxes clipped to the image, class-aware NMS.
Module names are mmdet's (``cls_convs.i.conv/.gn``, ``scales.i.scale``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.anchors import base_anchors, grid_anchors
from ..core.atss import atss_assign
from ..core.boxes import bbox2distance, bbox_overlaps, distance2bbox
from ..core.integral import integral
from ..core.postprocess import filter_scores_and_topk_mlvl
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)


class Scale(nn.Module):
    """A learnable scalar that multiplies its input."""

    def __init__(self, device, init: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(init, device=device))

    def forward(self, x):
        return x * self.scale


class ConvGN(nn.Module):
    """3x3 conv without bias -> GroupNorm(32) -> ReLU, mmdet's ConvModule
    names ``conv`` and ``gn``."""

    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False,
                              device=device)
        self.gn = nn.GroupNorm(32, cout, eps=1e-5, device=device)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


def tower(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = layer(x)
    return x


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def cat_levels(levels: Sequence[torch.Tensor], last: int) -> torch.Tensor:
    """Per-level (B, H, W, A*last) -> (B, sum H*W*A, last), level-major."""
    B = levels[0].shape[0]
    return torch.cat([t.reshape(B, -1, last) for t in levels], dim=1)


def level_sizes(levels: Sequence[torch.Tensor], last: int):
    """The flat rows of each level of ``cat_levels(levels, last)``."""
    return [t.shape[1] * t.shape[2] * (t.shape[3] // last) for t in levels]


def centres(anchors: torch.Tensor) -> torch.Tensor:
    return torch.stack([(anchors[..., 0] + anchors[..., 2]) / 2,
                        (anchors[..., 1] + anchors[..., 3]) / 2], -1)


class GFLHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]   # per level (B, H, W, 4*(rm+1))


class GFLHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 reg_max: int = 16, num_levels: int = 5):
        super().__init__()
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvGN(in_channels if i == 0 else feat_channels,
                       feat_channels, device)
                for i in range(stacked_convs)))
        self.gfl_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1,
                                 device=device)
        self.gfl_reg = nn.Conv2d(feat_channels, 4 * (reg_max + 1), 3,
                                 padding=1, device=device)
        self.scales = nn.ModuleList(Scale(device) for _ in range(num_levels))

    def forward(self, feats: Sequence[torch.Tensor]) -> GFLHeadOutputs:
        cls, reg = [], []
        for lvl, x in enumerate(feats):
            cls.append(nhwc(self.gfl_cls(tower(self.cls_convs, x))))
            reg.append(nhwc(self.scales[lvl](
                self.gfl_reg(tower(self.reg_convs, x)))))
        return GFLHeadOutputs(tuple(cls), tuple(reg))


def gfl_anchors(featmap_sizes, device, strides=STRIDES,
                octave_base_scale: int = 8):
    """Per level, one square anchor of ``octave_base_scale`` strides per
    position: a list of (H*W, 4)."""
    return [grid_anchors((h, w), s, base_anchors(s * octave_base_scale,
                                                 (1.0,), (1.0,)), device)
            for (h, w), s in zip(featmap_sizes, strides)]


class GFLLossConfig(NamedTuple):
    num_classes: int = 80
    reg_max: int = 16
    strides: Tuple[int, ...] = STRIDES
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 2.0
    loss_dfl_weight: float = 0.25
    atss_topk: int = 9


def gfl_detection_loss(out: GFLHeadOutputs, gt_bboxes, gt_labels, gt_valid,
                       cfg: GFLLossConfig) -> Dict[str, torch.Tensor]:
    """QFL, GIoU and DFL over every level; gt_* (B, G, ...) padded."""
    C = cfg.num_classes
    n_bins = cfg.reg_max + 1
    device = out.cls_scores[0].device
    per_level = gfl_anchors([c.shape[1:3] for c in out.cls_scores], device,
                            cfg.strides)
    counts = [a.shape[0] for a in per_level]
    anchors = torch.cat(per_level)
    assign = atss_assign(anchors, counts, gt_bboxes, gt_labels, gt_valid, C,
                         cfg.atss_topk)
    pos = assign.pos_mask
    num_total_pos = pos.sum().float().clamp(min=1.0)
    G = gt_bboxes.shape[1]
    tgt_boxes = torch.gather(
        gt_bboxes, 1, assign.assigned_gt.clamp(0, G - 1)[..., None]
        .expand(-1, -1, 4))
    stride = torch.cat([torch.full((n,), float(s), device=device)
                        for n, s in zip(counts, cfg.strides)])

    cls_flat = cat_levels(out.cls_scores, C)                 # (B, N, C)
    reg_flat = cat_levels(out.bbox_preds, 4 * n_bins)
    centers_s = centres(anchors)[None] / stride[None, :, None]
    decoded_s = distance2bbox(centers_s, integral(reg_flat, cfg.reg_max))
    tgt_s = tgt_boxes / stride[None, :, None]

    posf = pos.to(cls_flat.dtype)
    # the weight: the detached max class probability at the positives
    w_cls = torch.sigmoid(cls_flat).amax(-1).detach() * posf
    score = torch.where(pos, bbox_overlaps(decoded_s.detach(), tgt_s,
                                           is_aligned=True),
                        torch.zeros_like(posf))
    loss_cls = cfg.loss_cls_weight * L.quality_focal_loss(
        cls_flat.reshape(-1, C), (assign.labels.reshape(-1),
                                  score.reshape(-1)),
        avg_factor=num_total_pos)
    avg_w = w_cls.sum().clamp(min=1.0)
    loss_bbox = cfg.loss_bbox_weight * L.giou_loss(
        decoded_s.reshape(-1, 4), tgt_s.reshape(-1, 4),
        weight=w_cls.reshape(-1), avg_factor=avg_w)
    # the reference averages DFL by 4 per level, then divides the sum over
    # the levels by the global weight sum
    target_corners = bbox2distance(centers_s, tgt_s,
                                   max_dis=cfg.reg_max).reshape(-1)
    loss_dfl = cfg.loss_dfl_weight * L.distribution_focal_loss(
        reg_flat.reshape(-1, n_bins), target_corners,
        weight=w_cls.reshape(-1).repeat_interleave(4), avg_factor=4.0) / avg_w
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_dfl=loss_dfl)


def gfl_get_bboxes(out: GFLHeadOutputs, img_hw, scale_factor=None,
                   reg_max: int = 16, strides=STRIDES,
                   score_thr: float = 0.05, nms_pre: int = 1000,
                   nms_iou: float = 0.6, max_per_img: int = 100,
                   rescale: bool = False) -> Detections:
    """Fixed-size detections per image: sigmoid scores, the ``nms_pre``
    best of each level above ``score_thr``, the integral's distances times
    the stride from each position's centre, clipped to the image,
    class-aware NMS; ``keep_qid`` is each survivor's flat position (the
    teacher's keep-ids LD reads)."""
    B, C = out.cls_scores[0].shape[0], out.cls_scores[0].shape[-1]
    device = out.cls_scores[0].device
    per_level = gfl_anchors([c.shape[1:3] for c in out.cls_scores], device,
                            strides)
    boxes = torch.cat([
        distance2bbox(centres(a)[None], integral(
            r.reshape(B, -1, 4 * (reg_max + 1)), reg_max) * s)
        for a, r, s in zip(per_level, out.bbox_preds, strides)], dim=1)
    scores = torch.sigmoid(cat_levels(out.cls_scores, C))
    top = filter_scores_and_topk_mlvl(scores, score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    return nms_detections(
        torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), top,
        img_hw, scale_factor, rescale, nms_iou, max_per_img)
