"""TOOD (port of dskd_tpu/models/tood.py ``_sample_sides``,
``TaskDecomposition``, ``TOODHead``, ``TOOD``, ``tood_points``,
``task_aligned_assign``, ``_qfl_activated``, ``_focal_activated``,
``TOODLossConfig``, ``tood_loss``, ``tood_get_bboxes`` and its registry
entry ``tood``).

ResNet -> FPN (C3-C5, P3-P7, extra convs on the output, no ReLU between
them) -> the task-interactive head, shared across the levels: six inter
convs (conv, GroupNorm(32), ReLU) whose outputs, stacked to 6 x 256
channels, feed a cls and a reg TaskDecomposition (global average pool,
two 1x1 layer-attention convs to one sigmoid weight per inter layer, the
weighted stack reduced by a 1x1 conv, GroupNorm, ReLU). The cls output is
a probability, sqrt(sigmoid(``tood_cls``) x sigmoid(the stack's
``cls_prob_module``)); the reg output exp(``tood_reg``) x Scale gives l,
t, r, b in strides from the offset-0 grid index, decoded to corner maps,
of which each corner channel is read bilinearly at its own learned offset
(``reg_offset_module``; out-of-bounds corners weigh 0), then x stride.
Loss (the family step): task-aligned assignment, alignment s x IoU^6, the
13 best per GT by a sort's 13th value (ties there admit more) among the
points inside it, a point claimed twice going to the first GT of largest
IoU; activated quality focal loss towards the per-GT normalised alignment
over its sum, GIoU weighted by it. ``use_tal=False`` is the first epochs'
ATSS assignment with activated focal loss and GIoU weighted by ATSS's
centerness. Decoding: the cls probabilities, per-level threshold and
top-k, the sampled boxes clipped, class-aware NMS at IoU 0.6. Module
names are mmdet's ``tood_head.py`` (``inter_convs``, ``cls_decomp`` /
``reg_decomp`` with ``layer_attention`` and ``reduction_conv``,
``cls_prob_module``, ``reg_offset_module``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.anchors import base_anchors, grid_anchors
from ..core.atss import atss_assign
from ..core.boxes import bbox_overlaps
from ..core.postprocess import filter_scores_and_topk_mlvl
from .atss import PRIOR_BIAS, _centerness_target
from .fpn import FPN
from .gfl import init_dense
from .gfl_head import ConvGN, Scale, cat_levels, level_sizes, nhwc
from .resnet import ResNet
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
ANCHOR_SCALE = 8


class TOODHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, C) probs
    bbox_preds: Tuple[torch.Tensor, ...]   # per level (B, H, W, 4) xyxy


class TOODOutputs(NamedTuple):
    head: TOODHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


def _sample_sides(dist_map: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """Each of the 4 channels of ``dist_map`` (B, H, W, 4) read bilinearly
    at its own offset, (dy, dx) per channel in ``offsets`` (B, H, W, 8):
    one gather per corner; a corner outside the map weighs 0 (its index
    clipped)."""
    B, H, W, _ = dist_map.shape
    off = offsets.reshape(B, H, W, 4, 2)
    ii = torch.arange(H, dtype=dist_map.dtype,
                      device=dist_map.device)[:, None, None]
    jj = torch.arange(W, dtype=dist_map.dtype, device=dist_map.device)[
        :, None]
    ys = ii + off[..., 0]
    xs = jj + off[..., 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ty, tx = ys - y0, xs - x0
    flat_map = dist_map.reshape(B, H * W, 4)

    def corner(yc, xc, wgt):
        inb = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
        yi = yc.clamp(0, H - 1).long()
        xi = xc.clamp(0, W - 1).long()
        v = torch.gather(flat_map, 1, (yi * W + xi).reshape(B, H * W, 4))
        return v.reshape(B, H, W, 4) * (wgt * inb.to(dist_map.dtype))

    return (corner(y0, x0, (1 - ty) * (1 - tx))
            + corner(y0, x0 + 1, (1 - ty) * tx)
            + corner(y0 + 1, x0, ty * (1 - tx))
            + corner(y0 + 1, x0 + 1, ty * tx))


class TaskDecomposition(nn.Module):
    def __init__(self, device, feat_channels: int = 256,
                 stacked_convs: int = 6, la_down_rate: int = 8):
        super().__init__()
        nC = feat_channels * stacked_convs
        self.stacked_convs = stacked_convs
        self.layer_attention = nn.Sequential(
            nn.Conv2d(nC, nC // la_down_rate, 1, device=device), nn.ReLU(),
            nn.Conv2d(nC // la_down_rate, stacked_convs, 1, device=device),
            nn.Sigmoid())
        self.reduction_conv = nn.Module()
        self.reduction_conv.conv = nn.Conv2d(nC, feat_channels, 1,
                                             bias=False, device=device)
        self.reduction_conv.gn = nn.GroupNorm(32, feat_channels, eps=1e-5,
                                              device=device)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """feat (B, n x C, H, W): the inter convs' outputs, stacked."""
        B, nC, H, W = feat.shape
        n = self.stacked_convs
        a = self.layer_attention(feat.mean((2, 3), keepdim=True))
        y = (feat.reshape(B, n, nC // n, H, W) * a[:, :, None]).reshape(
            B, nC, H, W)
        rc = self.reduction_conv
        return F.relu(rc.gn(rc.conv(y)))


class TOODHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 6,
                 feat_channels: int = 256, num_levels: int = 5):
        super().__init__()
        C = feat_channels
        nC = C * stacked_convs
        self.inter_convs = nn.ModuleList(ConvGN(C, C, device)
                                         for _ in range(stacked_convs))
        self.cls_decomp = TaskDecomposition(device, C, stacked_convs)
        self.reg_decomp = TaskDecomposition(device, C, stacked_convs)
        self.tood_cls = nn.Conv2d(C, num_classes, 3, padding=1, device=device)
        self.tood_reg = nn.Conv2d(C, 4, 3, padding=1, device=device)
        self.cls_prob_module = nn.Sequential(
            nn.Conv2d(nC, C // 4, 1, device=device), nn.ReLU(),
            nn.Conv2d(C // 4, 1, 3, padding=1, device=device))
        self.reg_offset_module = nn.Sequential(
            nn.Conv2d(nC, C // 4, 1, device=device), nn.ReLU(),
            nn.Conv2d(C // 4, 8, 3, padding=1, device=device))
        self.scales = nn.ModuleList(Scale(device) for _ in range(num_levels))

    def forward(self, feats) -> TOODHeadOutputs:
        cls, reg = [], []
        for lvl, f in enumerate(feats):
            x, layers = f, []
            for conv in self.inter_convs:
                x = conv(x)
                layers.append(x)
            feat = torch.cat(layers, 1)                      # (B, nC, H, W)
            logits = self.tood_cls(self.cls_decomp(feat))
            prob = self.cls_prob_module(feat)
            score = torch.sqrt((torch.sigmoid(logits) * torch.sigmoid(prob))
                               .clamp(min=1e-12))
            # the Scale multiplies after the exp; strides from the offset-0
            # grid index
            dist = nhwc(self.scales[lvl](torch.exp(self.tood_reg(
                self.reg_decomp(feat)))))
            H, W = f.shape[2:]
            cy = torch.arange(H, dtype=dist.dtype, device=dist.device)[
                :, None]
            cx = torch.arange(W, dtype=dist.dtype, device=dist.device)
            corners = torch.stack([cx - dist[..., 0], cy - dist[..., 1],
                                   cx + dist[..., 2], cy + dist[..., 3]], -1)
            offsets = nhwc(self.reg_offset_module(feat))
            cls.append(nhwc(score))
            reg.append(_sample_sides(corners, offsets) * STRIDES[lvl])
        return TOODHeadOutputs(tuple(cls), tuple(reg))


class TOOD(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_output",
                        relu_before_extra_convs=False)
        self.bbox_head = TOODHead(device, num_classes)

    def forward(self, images, img_hw) -> TOODOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return TOODOutputs(self.bbox_head(neck), neck)


def tood_points(featmap_sizes, device):
    """The offset-0 grid points (N, 2), ATSS's anchors (one square of 8
    strides a point) and their per-level counts."""
    pts, per_level = [], []
    for (h, w), stride in zip(featmap_sizes, STRIDES):
        ys, xs = np.mgrid[:h, :w]
        pts.append(np.stack([xs * stride, ys * stride], -1).reshape(-1, 2))
        per_level.append(grid_anchors((h, w), stride, base_anchors(
            stride, (ANCHOR_SCALE,), (1.0,)), device))
    points = torch.from_numpy(np.concatenate(pts).astype(np.float32))
    return (points.to(device), torch.cat(per_level),
            tuple(a.shape[0] for a in per_level))


class TALResult(NamedTuple):
    assigned_gt: torch.Tensor   # (B, N) the GT of each positive, else 0
    pos: torch.Tensor           # (B, N) bool
    labels: torch.Tensor        # (B, N) int64, num_classes if not positive
    align: torch.Tensor         # (B, N) the positives' alignment, else 0
    iou: torch.Tensor           # (B, N) the positives' IoU, else 0


def tal_candidates(scores, boxes, points, gt_bboxes, gt_labels, gt_valid,
                   num_classes: int, topk: int = 13, alpha: float = 1.0,
                   beta: float = 6.0):
    """The task-aligned candidates: (IoUs, alignment s^alpha x IoU^beta,
    each (B, N, G); each GT's k-th largest alignment over all points,
    (B, 1, G), the invalid GTs' -1; the candidate mask (B, N, G)). A GT's
    candidates reach its k-th value (ties there admit more), are positive
    and lie inside it: the global top-k first, then the inside filter, so
    that slots spent on points outside are not refilled."""
    B, N, _ = scores.shape
    G = gt_bboxes.shape[1]
    ious = bbox_overlaps(boxes, gt_bboxes)                   # (B, N, G)
    safe_lbl = gt_labels.long().clamp(0, num_classes - 1)
    s = torch.gather(scores, 2, safe_lbl[:, None, :].expand(B, N, G))
    align = (s ** alpha) * (ious ** beta)
    px, py = points[:, 0, None], points[:, 1, None]
    gb = gt_bboxes[:, None]
    inside = ((px > gb[..., 0]) & (px < gb[..., 2]) & (py > gb[..., 1])
              & (py < gb[..., 3]))
    cand = torch.where(gt_valid[:, None], align, torch.full_like(align, -1.0))
    # the k-th value of a sort, not top-k's indices
    kth = torch.topk(cand, min(topk, N), dim=1).values[:, -1:]
    is_pos = (cand >= kth.clamp(min=1e-12)) & (cand > 0) & inside
    return ious, align, kth, is_pos


def task_aligned_assign(scores, boxes, points, gt_bboxes, gt_labels,
                        gt_valid, num_classes: int, topk: int = 13,
                        alpha: float = 1.0, beta: float = 6.0) -> TALResult:
    """scores (B, N, C) probabilities, boxes (B, N, 4) decoded, points
    (N, 2); gt_* (B, G, ...) padded. tal_candidates, then a point claimed
    by several GTs goes to the first of largest IoU."""
    ious, align, _, is_pos = tal_candidates(
        scores, boxes, points, gt_bboxes, gt_labels, gt_valid, num_classes,
        topk, alpha, beta)
    safe_lbl = gt_labels.long().clamp(0, num_classes - 1)
    iou_masked = torch.where(is_pos, ious, torch.full_like(ious, -1.0))
    best = iou_masked.amax(dim=2)
    assigned = iou_masked.argmax(dim=2)                      # the first
    pos = best > 0
    labels = torch.where(pos, torch.gather(safe_lbl, 1, assigned),
                         num_classes)
    zero = torch.zeros_like(best)
    a_sel = torch.gather(align, 2, assigned[..., None])[..., 0]
    i_sel = torch.gather(ious, 2, assigned[..., None])[..., 0]
    return TALResult(assigned, pos, labels, torch.where(pos, a_sel, zero),
                     torch.where(pos, i_sel, zero))


def _qfl_activated(p, q, beta: float = 2.0):
    """Activated quality focal loss: BCE on probabilities x |q - p|^beta."""
    eps = 1e-12
    ce = -(q * torch.log(p + eps) + (1 - q) * torch.log(1 - p + eps))
    return ce * (q - p).abs() ** beta


def _focal_activated(p, onehot, gamma: float = 2.0, alpha: float = 0.25):
    """Activated sigmoid focal loss, on probabilities."""
    eps = 1e-12
    pt = (1 - p) * onehot + p * (1 - onehot)
    fw = (alpha * onehot + (1 - alpha) * (1 - onehot)) * pt ** gamma
    ce = -(onehot * torch.log(p + eps) + (1 - onehot) * torch.log(1 - p + eps))
    return ce * fw


class TOODLossConfig(NamedTuple):
    num_classes: int = 80
    topk: int = 13
    alpha: float = 1.0
    beta: float = 6.0
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 2.0


def tal_targets(res: TALResult, num_gt: int) -> torch.Tensor:
    """The positives' alignment normalised per GT, t / max t x max IoU of
    the GT's positives, else 0 (B, N)."""
    B = res.pos.shape[0]
    a = torch.where(res.pos, res.align, torch.zeros_like(res.align))
    i = torch.where(res.pos, res.iou, torch.zeros_like(res.iou))
    max_a = a.new_zeros(B, num_gt).scatter_reduce(1, res.assigned_gt, a,
                                                  "amax")
    max_i = i.new_zeros(B, num_gt).scatter_reduce(1, res.assigned_gt, i,
                                                  "amax")
    norm = torch.gather(max_i / max_a.clamp(min=1e-12), 1, res.assigned_gt)
    return torch.where(res.pos, res.align * norm, torch.zeros_like(a))


def tood_loss(out: TOODHeadOutputs, points, anchors, level_counts,
              gt_bboxes, gt_labels, gt_valid, cfg: TOODLossConfig,
              use_tal: bool = True) -> Dict[str, torch.Tensor]:
    C = cfg.num_classes
    cls_flat = cat_levels(out.cls_scores, C)                 # probabilities
    boxes = cat_levels(out.bbox_preds, 4)                    # xyxy
    G = gt_bboxes.shape[1]
    if use_tal:
        with torch.no_grad():
            res = task_aligned_assign(cls_flat, boxes, points, gt_bboxes,
                                      gt_labels, gt_valid, C, cfg.topk,
                                      cfg.alpha, cfg.beta)
            t = tal_targets(res, G)
        assigned, pos, labels = res.assigned_gt, res.pos, res.labels
    else:
        assign = atss_assign(anchors, level_counts, gt_bboxes, gt_labels,
                             gt_valid, C, topk=9)
        assigned, pos, labels = (assign.assigned_gt, assign.pos_mask,
                                 assign.labels)
        t = pos.to(cls_flat.dtype)
    num_pos = pos.sum().to(torch.float32).clamp(min=1.0)
    tgt = torch.gather(gt_bboxes, 1, assigned.clamp(0, G - 1)[..., None]
                       .expand(-1, -1, 4))
    onehot = F.one_hot(labels, C + 1)[..., :C].to(cls_flat.dtype)
    if use_tal:
        lc = _qfl_activated(cls_flat, onehot * t[..., None]).sum()
        loss_cls = cfg.loss_cls_weight * lc / t.sum().clamp(min=1.0)
        w = t.reshape(-1)
    else:
        # the first epochs: activated focal loss over the positives, GIoU
        # weighted by ATSS's centerness of the anchor in its GT
        lc = _focal_activated(cls_flat, onehot).sum()
        loss_cls = cfg.loss_cls_weight * lc / num_pos
        ctr = _centerness_target(anchors[None].expand_as(tgt), tgt)
        w = torch.where(pos, ctr, torch.zeros_like(ctr)).reshape(-1)
    loss_bbox = cfg.loss_bbox_weight * L.giou_loss(
        boxes.reshape(-1, 4), tgt.reshape(-1, 4), weight=w,
        avg_factor=w.sum().clamp(min=1.0))
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)


def tood_get_bboxes(out: TOODHeadOutputs, img_hw, scale_factor=None,
                    score_thr: float = 0.05, nms_iou: float = 0.6,
                    nms_pre: int = 1000, max_per_img: int = 100,
                    rescale: bool = False) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    point)."""
    C = out.cls_scores[0].shape[-1]
    top = filter_scores_and_topk_mlvl(cat_levels(out.cls_scores, C),
                                      score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    boxes = torch.gather(cat_levels(out.bbox_preds, 4), 1,
                         idx[..., None].expand(-1, -1, 4))
    return nms_detections(boxes, top, img_hw, scale_factor, rescale,
                          nms_iou, max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_tood(model_cfg, device="cuda") -> TOOD:
    m = model_cfg
    return TOOD(device, num_classes=m.num_classes, depth=m.depth,
                frozen_stages=m.frozen_stages)


@torch.no_grad()
def init_tood(model: TOOD, seed: int = 0) -> None:
    """init_dense (normal(0.01) head convs, ``tood_cls``'s prior), then
    JAX's other scales: the layer-attention and offset convs
    normal(0.001), ``cls_prob_module``'s last bias at the prior."""
    init_dense(model, seed, "tood_cls", PRIOR_BIAS)
    head = model.bbox_head
    g = torch.Generator().manual_seed(seed + 1)
    for seq in (head.cls_decomp.layer_attention,
                head.reg_decomp.layer_attention, head.reg_offset_module):
        for conv in (seq[0], seq[2]):
            conv.weight.copy_(torch.empty(conv.weight.shape).normal_(
                0, 0.001, generator=g))
    head.cls_prob_module[2].bias.fill_(PRIOR_BIAS)


def _register():
    from ..registry import register_family
    from ..utils.weights import tood_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = TOODLossConfig(num_classes=cfg.model.num_classes)

        # JAX's TOOD losses read no teacher; the family step is TAL's
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            points, anchors, counts = tood_points(
                [c.shape[1:3] for c in out.head.cls_scores],
                batch.images.device)
            return tood_loss(out.head, points, anchors, counts,
                             batch.gt_bboxes, batch.gt_labels,
                             batch.gt_valid, det_cfg, use_tal=True)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            return tood_get_bboxes(out.head, img_hw,
                                   scale_factor=scale_factors,
                                   score_thr=max(score_thr, 0.05),
                                   max_per_img=max_per_img, rescale=True)
        return step

    register_family("tood", build=build_tood, init_weights=init_tood,
                    from_jax=tood_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
