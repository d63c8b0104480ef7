"""VarifocalNet (port of dskd_tpu/models/vfnet.py ``star_dcn_offsets``,
``VFNetHead``, ``VFNet``, ``vfnet_points``, ``VFNetLossConfig``,
``vfnet_loss``, ``vfnet_get_bboxes`` and its registry entry ``vfnet``).

ResNet -> FPN (C3-C5, P3-P7, extra convs on the output with a ReLU
between them) -> two towers of 3 x (conv, GroupNorm(32), ReLU) shared
across the levels. The reg tower -> ``vfnet_reg_conv`` (conv, GN, ReLU)
-> ``vfnet_reg``: initial l, t, r, b = exp(Scale x reg) x 8 strides. Its
star offsets (0.1 x the distances + 0.9 x them detached, in strides) put
the nine taps of two 3x3 deformable convs on the box's corners, edge
midpoints and centre: one on the reg tower -> ReLU -> ``vfnet_reg_refine``
gives factors exp(Scale x refine) of the detached initial distances, the
other on the cls tower -> ReLU -> ``vfnet_cls``, the IoU-aware logits.
Loss: ATSS over one square anchor of 8 strides per position; GIoU of the
initial and of the refined boxes, each positive weighted by its detached
IoU with its GT and averaged over their sum; varifocal loss with target
IoU(refined, GT) at the positives. Decoding: sigmoid(cls), per-level
threshold and top-k, refined boxes, clipped, class-aware NMS at IoU 0.6.
Head outputs are NHWC per level; ``neck_feats`` NCHW. Module names are
mmdet's ``vfnet_head.py`` (``vfnet_reg_refine_dconv``, ``vfnet_cls_dconv``
and ``scales_refine`` among them).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.atss import atss_assign
from ..core.boxes import bbox_overlaps, distance2bbox
from ..core.postprocess import filter_scores_and_topk_mlvl
from ..ops.deform_conv import DeformConv
from .atss import PRIOR_BIAS, atss_anchors
from .fpn import FPN
from .gfl import init_dense
from .gfl_head import ConvGN, Scale, cat_levels, level_sizes, nhwc, tower
from .resnet import ResNet
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
GRADIENT_MUL = 0.1


class VFNetHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]         # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]         # (B, H, W, 4) initial ltrb
    bbox_preds_refine: Tuple[torch.Tensor, ...]  # (B, H, W, 4) refined ltrb


class VFNetOutputs(NamedTuple):
    head: VFNetHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


def star_dcn_offsets(ltrb: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, 4) image-space initial distances -> (B, H, W, 18) DCN
    offsets, (dy, dx) per tap, that put the nine taps on the box's star
    points; relative to the regular 3x3 grid, which deform_conv2d adds."""
    d = (GRADIENT_MUL * ltrb + (1 - GRADIENT_MUL) * ltrb.detach()) / stride
    l, t, r, b = d.unbind(-1)
    zero = torch.zeros_like(l)
    offs = []
    for i, dy in enumerate((-t, zero, b)):        # tap rows: top/mid/bottom
        for j, dx in enumerate((-l, zero, r)):    # tap cols: left/ctr/right
            offs.append(dy - (i - 1))
            offs.append(dx - (j - 1))
    return torch.stack(offs, -1)


class VFNetHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 3,
                 feat_channels: int = 256, num_levels: int = 5):
        super().__init__()
        C = feat_channels
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvGN(C, C, device) for _ in range(stacked_convs)))
        self.vfnet_reg_conv = ConvGN(C, C, device)
        self.vfnet_reg = nn.Conv2d(C, 4, 3, padding=1, device=device)
        self.scales = nn.ModuleList(Scale(device) for _ in range(num_levels))
        self.vfnet_reg_refine_dconv = DeformConv(C, C, device)
        self.vfnet_reg_refine = nn.Conv2d(C, 4, 3, padding=1, device=device)
        self.scales_refine = nn.ModuleList(Scale(device)
                                           for _ in range(num_levels))
        self.vfnet_cls_dconv = DeformConv(C, C, device)
        self.vfnet_cls = nn.Conv2d(C, num_classes, 3, padding=1,
                                   device=device)

    def forward(self, feats) -> VFNetHeadOutputs:
        cls, init, refine = [], [], []
        for lvl, f in enumerate(feats):
            stride = STRIDES[lvl]
            c, r = tower(self.cls_convs, f), tower(self.reg_convs, f)
            # the regress-range ends [64, ..., 1024] are 8 strides a level
            dist = nhwc(torch.exp(self.scales[lvl](self.vfnet_reg(
                self.vfnet_reg_conv(r))))) * (stride * 8.0)
            offs = star_dcn_offsets(dist, stride)
            factor = torch.exp(self.scales_refine[lvl](self.vfnet_reg_refine(
                F.relu(self.vfnet_reg_refine_dconv(r, offs)))))
            # the refine loss reaches the initial branch only through the
            # star offsets' 0.1 share, never through this product
            refine.append(nhwc(factor) * dist.detach())
            cls.append(nhwc(self.vfnet_cls(F.relu(self.vfnet_cls_dconv(
                c, offs)))))
            init.append(dist)
        return VFNetHeadOutputs(tuple(cls), tuple(init), tuple(refine))


class VFNet(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_output",
                        relu_before_extra_convs=True)
        self.bbox_head = VFNetHead(device, num_classes)

    def forward(self, images, img_hw) -> VFNetOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return VFNetOutputs(self.bbox_head(neck), neck)


def vfnet_points(featmap_sizes, device):
    """Every level's cell centres (N, 2), level-major, and ATSS's anchors
    (one square of 8 strides per cell) with their per-level counts."""
    pts = []
    for (h, w), s in zip(featmap_sizes, STRIDES):
        ys, xs = np.mgrid[:h, :w]
        pts.append(np.stack([(xs + 0.5) * s, (ys + 0.5) * s],
                            -1).reshape(-1, 2))
    points = torch.from_numpy(np.concatenate(pts).astype(np.float32))
    anchors, counts = atss_anchors(featmap_sizes, device)
    return points.to(device), anchors, counts


class VFNetLossConfig(NamedTuple):
    num_classes: int = 80
    vfl_alpha: float = 0.75
    vfl_gamma: float = 2.0
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.5      # initial GIoU
    loss_bbox_refine_weight: float = 2.0
    topk: int = 9


def vfnet_loss(out: VFNetHeadOutputs, points, anchors, level_counts,
               gt_bboxes, gt_labels, gt_valid, cfg: VFNetLossConfig
               ) -> Dict[str, torch.Tensor]:
    C = cfg.num_classes
    B = out.cls_scores[0].shape[0]
    cls_flat = cat_levels(out.cls_scores, C)
    pts = points[None].expand(B, -1, -1)
    init_boxes = distance2bbox(pts, cat_levels(out.bbox_preds, 4))
    ref_boxes = distance2bbox(pts, cat_levels(out.bbox_preds_refine, 4))
    assign = atss_assign(anchors, level_counts, gt_bboxes, gt_labels,
                         gt_valid, C, topk=cfg.topk)
    pos = assign.pos_mask
    posf = pos.to(cls_flat.dtype)
    num_pos = pos.sum().float().clamp(min=1.0)     # f32, as JAX's
    G = gt_bboxes.shape[1]
    tgt = torch.gather(gt_bboxes, 1, assign.assigned_gt.clamp(0, G - 1)[
        ..., None].expand(-1, -1, 4))

    def giou(boxes, weight):
        iou = bbox_overlaps(boxes, tgt, is_aligned=True).detach()
        w = (iou.clamp(min=1e-6) * posf).reshape(-1)
        return weight * L.giou_loss(boxes.reshape(-1, 4), tgt.reshape(-1, 4),
                                    weight=w, avg_factor=w.sum().clamp(
                                        min=1.0)), iou

    loss_bbox, _ = giou(init_boxes, cfg.loss_bbox_weight)
    loss_bbox_rf, iou_rf = giou(ref_boxes, cfg.loss_bbox_refine_weight)
    # varifocal target: IoU(refined, GT) on the positive's class
    q = torch.where(pos, iou_rf, torch.zeros_like(iou_rf))
    onehot = F.one_hot(assign.labels, C + 1)[..., :C].to(cls_flat.dtype)
    loss_cls = cfg.loss_cls_weight * L.varifocal_loss(
        cls_flat.reshape(-1, C), (onehot * q[..., None]).reshape(-1, C),
        avg_factor=num_pos, alpha=cfg.vfl_alpha, gamma=cfg.vfl_gamma)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                loss_bbox_rf=loss_bbox_rf)


def vfnet_get_bboxes(out: VFNetHeadOutputs, points, img_hw,
                     scale_factor=None, score_thr: float = 0.05,
                     nms_iou: float = 0.6, nms_pre: int = 1000,
                     max_per_img: int = 100, rescale: bool = False
                     ) -> Detections:
    """The refined boxes scored by sigmoid(cls) alone (the score is
    already IoU-aware); fixed-size detections per image."""
    C = out.cls_scores[0].shape[-1]
    top = filter_scores_and_topk_mlvl(torch.sigmoid(cat_levels(
        out.cls_scores, C)), score_thr, nms_pre,
        level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    dist = torch.gather(cat_levels(out.bbox_preds_refine, 4), 1,
                        idx[..., None].expand(-1, -1, 4))
    return nms_detections(distance2bbox(points[idx], dist), top, img_hw,
                          scale_factor, rescale, nms_iou, max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_vfnet(model_cfg, device="cuda") -> VFNet:
    m = model_cfg
    return VFNet(device, num_classes=m.num_classes, depth=m.depth,
                 frozen_stages=m.frozen_stages)


@torch.no_grad()
def init_vfnet(model: VFNet, seed: int = 0) -> None:
    """init_dense (normal(0.01) head convs, the class prior) and the two
    deformable kernels normal(0.01), JAX's scales."""
    init_dense(model, seed, "vfnet_cls", PRIOR_BIAS)
    g = torch.Generator().manual_seed(seed + 1)
    for mod in (model.bbox_head.vfnet_reg_refine_dconv,
                model.bbox_head.vfnet_cls_dconv):
        mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
            0, 0.01, generator=g))
    for s in model.bbox_head.scales_refine:
        s.scale.fill_(1.0)


def _register():
    from ..registry import register_family
    from ..utils.weights import vfnet_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = VFNetLossConfig(num_classes=cfg.model.num_classes)

        # JAX's VFNet losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            points, anchors, counts = vfnet_points(
                [c.shape[1:3] for c in out.head.cls_scores],
                batch.images.device)
            return vfnet_loss(out.head, points, anchors, counts,
                              batch.gt_bboxes, batch.gt_labels,
                              batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            points, _, _ = vfnet_points(
                [c.shape[1:3] for c in out.head.cls_scores], images.device)
            return vfnet_get_bboxes(out.head, points, img_hw,
                                    scale_factor=scale_factors,
                                    score_thr=max(score_thr, 0.05),
                                    max_per_img=max_per_img, rescale=True)
        return step

    register_family("vfnet", build=build_vfnet, init_weights=init_vfnet,
                    from_jax=vfnet_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
