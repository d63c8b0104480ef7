"""FCOS (port of dskd_tpu/models/fcos.py ``Scale``, ``FCOSHead``,
``FCOS``, ``fcos_points``, ``_fcos_targets``, ``FCOSLossConfig``,
``fcos_detection_loss``, ``fcos_get_bboxes`` and its registry entry
``fcos`` and ``nasfcos``).

ResNet -> FPN (C3-C5, P3-P7, extra convs on the output with a ReLU
between them) -> two towers of 4 x (conv, GroupNorm(32), ReLU) shared
across the levels; ``conv_cls`` and ``conv_centerness`` on the cls tower,
``conv_reg`` on the reg tower: exp(Scale x reg) gives the l, t, r, b
distances from each point. Targets: a point is positive for the GT of
least area (the first of equal ones) that contains it and whose largest
distance falls in the level's regress range. Loss: focal loss, -log IoU
weighted by the centerness target, BCE on the centerness. Decoding:
sigmoid(cls) x sigmoid(centerness), per-level threshold and top-k, clipped,
class-aware NMS at IoU 0.5. ``nasfcos`` swaps the FPN for the NAS-FCOS
searched neck on C3-C5 (``models/nasfcos_fpn.py``). The other backbones
of ``models/backbones.py`` feed the FPN as ResNet does; HRNet's branches
go through HRFPN (``models/hrnet.py``), under ``nasfcos`` too, as the JAX
module wires them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.boxes import distance2bbox
from ..core.postprocess import filter_scores_and_topk_mlvl
from .atss import PRIOR_BIAS
from .backbones import apply_backbone, build_backbone, init_backbone
from .fpn import FPN
from .gfl import dense_init_of, init_dense
from .gfl_head import ConvGN, Scale, cat_levels, level_sizes, nhwc, tower
from .hrnet import HRFPN
from .nasfcos_fpn import NASFCOSFPN
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))
INF = 1e8


class FCOSHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]    # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]    # per level (B, H, W, 4) l,t,r,b
    centernesses: Tuple[torch.Tensor, ...]  # per level (B, H, W, 1)


class FCOSOutputs(NamedTuple):
    head: FCOSHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


class FCOSHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 4,
                 feat_channels: int = 256, num_levels: int = 5):
        super().__init__()
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvGN(feat_channels, feat_channels, device)
                for _ in range(stacked_convs)))

        def conv(cout):
            return nn.Conv2d(feat_channels, cout, 3, padding=1,
                             device=device)

        self.conv_cls = conv(num_classes)
        self.conv_reg = conv(4)
        self.conv_centerness = conv(1)
        self.scales = nn.ModuleList(Scale(device) for _ in range(num_levels))

    def forward(self, feats) -> FCOSHeadOutputs:
        cls, reg, ctr = [], [], []
        for lvl, f in enumerate(feats):
            c, r = tower(self.cls_convs, f), tower(self.reg_convs, f)
            cls.append(nhwc(self.conv_cls(c)))
            # the centerness reads the cls tower
            ctr.append(nhwc(self.conv_centerness(c)))
            reg.append(nhwc(torch.exp(self.scales[lvl](self.conv_reg(r)))))
        return FCOSHeadOutputs(tuple(cls), tuple(reg), tuple(ctr))


class FCOS(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1, backbone: str = "",
                 nas_fpn: bool = False):
        super().__init__()
        self.backbone_spec = backbone
        self.backbone, kind = build_backbone(backbone, depth, device,
                                             frozen_stages)
        start = 1 if kind == "c2345" else 0
        self.neck_start = start if nas_fpn and kind != "hr" else 0
        if kind == "hr":
            self.neck = HRFPN(self.backbone.out_channels, device)
        elif nas_fpn:
            self.neck = NASFCOSFPN(self.backbone.out_channels[start:],
                                   device)
        else:
            self.neck = FPN(self.backbone.out_channels, device,
                            start_level=start, add_extra_convs="on_output",
                            relu_before_extra_convs=True)
        self.bbox_head = FCOSHead(device, num_classes)

    def forward(self, images, img_hw, generator=None) -> FCOSOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward; ``generator`` draws a stochastic-depth backbone's masks in
        training."""
        feats = apply_backbone(self.backbone, self.backbone_spec,
                               images.permute(0, 3, 1, 2), generator)
        neck = self.neck(feats[self.neck_start:])
        return FCOSOutputs(self.bbox_head(neck), neck)


def fcos_points(featmap_sizes, device):
    """All levels' point centres (N, 2) and each point's (stride, regress
    low, regress high) (N, 3), level-major, row-major in a level."""
    pts, meta = [], []
    for (h, w), s, (lo, hi) in zip(featmap_sizes, STRIDES, REGRESS_RANGES):
        ys, xs = np.mgrid[:h, :w]
        pts.append(np.stack([(xs + 0.5) * s, (ys + 0.5) * s],
                            -1).reshape(-1, 2))
        meta.append(np.tile([[s, lo, min(hi, INF)]], (h * w, 1)))
    return tuple(torch.from_numpy(np.concatenate(a).astype(np.float32)).to(
        device) for a in (pts, meta))


def _fcos_targets(points, meta, gt_bboxes, gt_labels, gt_valid,
                  num_classes):
    """Per image of the batch: labels (B, N) (num_classes where not
    positive), l, t, r, b targets (B, N, 4), positive mask (B, N)."""
    xs, ys = points[None, :, 0:1], points[None, :, 1:2]      # (1, N, 1)
    gb = gt_bboxes[:, None]                                  # (B, 1, G, 4)
    ltrb = torch.stack([xs - gb[..., 0], ys - gb[..., 1], gb[..., 2] - xs,
                        gb[..., 3] - ys], -1)                # (B, N, G, 4)
    max_dist = ltrb.amax(-1)
    ok = ((ltrb.amin(-1) > 0) & (max_dist >= meta[None, :, 1:2])
          & (max_dist <= meta[None, :, 2:3]) & gt_valid[:, None])
    areas = ((gt_bboxes[..., 2] - gt_bboxes[..., 0])
             * (gt_bboxes[..., 3] - gt_bboxes[..., 1]))[:, None]
    areas = torch.where(ok, areas, torch.full_like(areas, INF))
    gt_idx = areas.argmin(dim=2)                             # first on ties
    pos = areas.amin(dim=2) < INF
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         num_classes)
    tgt = torch.gather(ltrb, 2, gt_idx[..., None, None].expand(
        -1, -1, 1, 4))[:, :, 0]
    return labels, tgt, pos


class FCOSLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    loss_ctr_weight: float = 1.0


def fcos_detection_loss(out: FCOSHeadOutputs, points, meta, gt_bboxes,
                        gt_labels, gt_valid, cfg: FCOSLossConfig):
    """Focal loss, centerness-weighted -log IoU (mmdet's IoULoss) on
    image-space boxes, centerness BCE. The IoU is clamped at 1e-6 before
    its log, so the negatives' zero weight meets a finite loss."""
    C = cfg.num_classes
    B = out.cls_scores[0].shape[0]
    cls_flat = cat_levels(out.cls_scores, C)
    reg_flat = cat_levels(out.bbox_preds, 4)
    ctr_flat = cat_levels(out.centernesses, 1)[..., 0]
    labels, tgt, pos = _fcos_targets(points, meta, gt_bboxes, gt_labels,
                                     gt_valid, C)
    num_pos = pos.sum().float().clamp(min=1.0)
    onehot = F.one_hot(labels, C + 1)[..., :C].to(cls_flat.dtype)
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot.reshape(-1, C), avg_factor=num_pos,
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    lr, tb = tgt[..., 0::2], tgt[..., 1::2]
    ctr_t = ((lr.amin(-1) / lr.amax(-1).clamp(min=1e-6))
             * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6))).clamp(
                 min=0).sqrt()
    ctr_t = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))
    pts = points[None].expand(B, -1, -1).reshape(-1, 2)
    pred_boxes = distance2bbox(pts, reg_flat.reshape(-1, 4))
    tgt_boxes = distance2bbox(pts, tgt.reshape(-1, 4))
    posf = pos.to(ctr_t.dtype)
    loss_bbox = cfg.loss_bbox_weight * L.iou_loss(
        pred_boxes, tgt_boxes, linear=False,
        weight=(posf * ctr_t).reshape(-1),
        avg_factor=ctr_t.sum().clamp(min=1e-6))
    loss_ctr = cfg.loss_ctr_weight * L.bce_loss(
        ctr_flat.reshape(-1), ctr_t.reshape(-1), weight=posf.reshape(-1),
        avg_factor=num_pos)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                loss_centerness=loss_ctr)


def fcos_get_bboxes(out: FCOSHeadOutputs, points, img_hw,
                    scale_factor=None, score_thr: float = 0.05,
                    nms_iou: float = 0.5, nms_pre: int = 1000,
                    max_per_img: int = 100, rescale: bool = False
                    ) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    point)."""
    C = out.cls_scores[0].shape[-1]
    probs = (torch.sigmoid(cat_levels(out.cls_scores, C))
             * torch.sigmoid(cat_levels(out.centernesses, 1)))
    top = filter_scores_and_topk_mlvl(probs, score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    reg = torch.gather(cat_levels(out.bbox_preds, 4), 1,
                       idx[..., None].expand(-1, -1, 4))
    boxes = distance2bbox(points[idx], reg)
    return nms_detections(boxes, top, img_hw, scale_factor, rescale,
                          nms_iou, max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_fcos(model_cfg, device="cuda") -> FCOS:
    m = model_cfg
    return FCOS(device, num_classes=m.num_classes, depth=m.depth,
                frozen_stages=m.frozen_stages, backbone=m.backbone,
                nas_fpn=m.arch == "nasfcos")


def _nasfcos_init_of(name: str) -> str:
    """flax's default lecun-normal for the NAS-FCOS and HRFPN necks'
    convs."""
    return "lecun" if name.startswith("neck.") else dense_init_of(name)


def init_fcos(model: FCOS, seed: int = 0) -> None:
    init_dense(model, seed, "conv_cls", PRIOR_BIAS,
               _nasfcos_init_of if isinstance(model.neck, (NASFCOSFPN, HRFPN))
               else dense_init_of)
    init_backbone(model.backbone, seed)


def _register():
    from ..registry import register_family
    from ..utils.weights import fcos_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = FCOSLossConfig(num_classes=cfg.model.num_classes)

        # JAX's FCOS losses read no teacher; a stochastic-depth backbone
        # draws its masks where the step asks for dropout
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw,
                        generator if use_dropout else None)
            points, meta = fcos_points(
                [c.shape[1:3] for c in out.head.cls_scores],
                batch.images.device)
            return fcos_detection_loss(out.head, points, meta,
                                       batch.gt_bboxes, batch.gt_labels,
                                       batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            points, _ = fcos_points(
                [c.shape[1:3] for c in out.head.cls_scores], images.device)
            return fcos_get_bboxes(out.head, points, img_hw,
                                   scale_factor=scale_factors,
                                   score_thr=max(score_thr, 0.05),
                                   max_per_img=max_per_img, rescale=True)
        return step

    for name in ("fcos", "nasfcos"):
        register_family(name, build=build_fcos, init_weights=init_fcos,
                        from_jax=fcos_state_dict_from_jax, losses=losses,
                        eval_step=eval_step)


_register()
