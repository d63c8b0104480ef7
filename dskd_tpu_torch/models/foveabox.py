"""FoveaBox (port of dskd_tpu/models/foveabox.py ``FoveaHead``,
``FoveaBox``, ``_level_targets``, ``FoveaLossConfig``, ``fovea_loss``,
``fovea_get_bboxes`` and its registry entry ``foveabox``).

ResNet -> FPN (C3-C5, P3-P7, the extra convs on the C5 input, no ReLU
between them) -> two towers of 4 x (conv, GroupNorm(32), ReLU) shared
across the levels -> ``conv_cls`` (C logits a position) and ``conv_reg``
(log-encoded distances). Targets: a valid GT lands on each level whose
scale range holds sqrt(area); its positives are the cells inside its
0.4-shrunk box (the fovea), the smallest GT winning a cell that several
claim (a stable sort of the areas, largest first, so that the later of two
equal GTs wins); the targets are log(clip(distance / base edge, 1/16,
16)). Loss: focal loss over every position over positives + B, smooth-L1
(beta 0.11) over the positives. Decoding: sigmoid(cls), per-level
threshold and top-k, exp(pred) x base edge, clipped to the image's last
pixel, class-aware NMS at IoU 0.5.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.boxes import bbox_clip
from ..core.postprocess import filter_scores_and_topk_mlvl
from .atss import PRIOR_BIAS
from .fpn import FPN
from .fsaf import cell_centres
from .gfl import init_dense
from .gfl_head import ConvGN, cat_levels, level_sizes, nhwc, tower
from .resnet import ResNet
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
BASE_EDGES = (16, 32, 64, 128, 256)
SCALE_RANGES = ((1, 64), (32, 128), (64, 256), (128, 512), (256, 2048))
SIGMA = 0.4


class FoveaHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]   # per level (B, H, W, 4) log


class FoveaOutputs(NamedTuple):
    head: FoveaHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


class FoveaHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 4,
                 feat_channels: int = 256):
        super().__init__()
        C = feat_channels
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvGN(C, C, device) for _ in range(stacked_convs)))
        self.conv_cls = nn.Conv2d(C, num_classes, 3, padding=1, device=device)
        self.conv_reg = nn.Conv2d(C, 4, 3, padding=1, device=device)

    def forward(self, feats) -> FoveaHeadOutputs:
        cls, reg = [], []
        for f in feats:
            cls.append(nhwc(self.conv_cls(tower(self.cls_convs, f))))
            reg.append(nhwc(self.conv_reg(tower(self.reg_convs, f))))
        return FoveaHeadOutputs(tuple(cls), tuple(reg))


class FoveaBox(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_input",
                        relu_before_extra_convs=False)
        self.bbox_head = FoveaHead(device, num_classes)

    def forward(self, images, img_hw) -> FoveaOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return FoveaOutputs(self.bbox_head(neck), neck)


def _level_targets(h: int, w: int, lvl: int, gt_bboxes, gt_labels,
                   gt_valid, num_classes: int):
    """One level, a batch: labels (B, h*w), log targets (B, h*w, 4),
    positive mask (B, h*w)."""
    stride, base = STRIDES[lvl], BASE_EDGES[lvl]
    lo, hi = SCALE_RANGES[lvl]
    B, G = gt_bboxes.shape[:2]
    gw = gt_bboxes[..., 2] - gt_bboxes[..., 0]
    gh = gt_bboxes[..., 3] - gt_bboxes[..., 1]
    areas = torch.sqrt((gw * gh).clamp(min=0))
    in_range = (areas >= lo) & (areas <= hi) & gt_valid
    ys, xs = cell_centres(h, w, stride, gt_bboxes)
    cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
    cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
    inx = ((xs >= (cx - SIGMA * gw / 2)[..., None])
           & (xs <= (cx + SIGMA * gw / 2)[..., None]))       # (B, G, w)
    iny = ((ys >= (cy - SIGMA * gh / 2)[..., None])
           & (ys <= (cy + SIGMA * gh / 2)[..., None]))       # (B, G, h)
    inside = ((iny[..., :, None] & inx[..., None, :]).reshape(B, G, -1)
              & in_range[..., None])                         # (B, G, hw)

    # the larger areas first, stably, so that the smaller GT (the later of
    # two equal ones) ranks higher and wins
    key = -torch.where(in_range, areas, torch.full_like(areas, -1.0))
    order = torch.argsort(key, dim=1, stable=True)
    rank = torch.zeros_like(order).scatter_(
        1, order, torch.arange(1, G + 1, device=order.device).expand(B, G))
    best = (inside * rank[..., None]).argmax(1)              # (B, hw)
    pos = inside.any(1)
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best),
                         num_classes)
    bx = torch.gather(gt_bboxes, 1, best[..., None].expand(-1, -1, 4))
    px = xs[None, :].expand(h, w).reshape(-1)
    py = ys[:, None].expand(h, w).reshape(-1)
    t = torch.stack([(px - bx[..., 0]) / base, (py - bx[..., 1]) / base,
                     (bx[..., 2] - px) / base, (bx[..., 3] - py) / base], -1)
    # the clamp's floor keeps the log finite
    return labels, torch.log(t.clamp(1.0 / 16, 16.0)), pos


def fovea_targets(out: FoveaHeadOutputs, gt_bboxes, gt_labels, gt_valid,
                  num_classes: int):
    """Every level's targets, level-major: labels (B, N), log targets
    (B, N, 4), positive mask (B, N)."""
    parts = [_level_targets(c.shape[1], c.shape[2], lvl, gt_bboxes,
                            gt_labels, gt_valid, num_classes)
             for lvl, c in enumerate(out.cls_scores)]
    return tuple(torch.cat(p, 1) for p in zip(*parts))


class FoveaLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    smooth_beta: float = 0.11


def fovea_loss(out: FoveaHeadOutputs, gt_bboxes, gt_labels, gt_valid,
               cfg: FoveaLossConfig) -> Dict[str, torch.Tensor]:
    C = cfg.num_classes
    B = out.cls_scores[0].shape[0]
    labels, t, pos = fovea_targets(out, gt_bboxes, gt_labels, gt_valid, C)
    cls_flat = cat_levels(out.cls_scores, C)
    reg_flat = cat_levels(out.bbox_preds, 4)
    num_pos = pos.sum().to(torch.float32)
    onehot = F.one_hot(labels, C + 1)[..., :C].to(cls_flat.dtype)
    # the classification over positives + images
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot.reshape(-1, C),
        avg_factor=num_pos + B, gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    w = pos.to(reg_flat.dtype)[..., None].expand(-1, -1, 4).reshape(-1, 4)
    loss_bbox = cfg.loss_bbox_weight * L.smooth_l1_loss(
        reg_flat.reshape(-1, 4), t.reshape(-1, 4), weight=w,
        beta=cfg.smooth_beta, avg_factor=num_pos.clamp(min=1.0))
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)


def fovea_get_bboxes(out: FoveaHeadOutputs, img_hw, scale_factor=None,
                     score_thr: float = 0.05, nms_iou: float = 0.5,
                     nms_pre: int = 1000, max_per_img: int = 100,
                     rescale: bool = False) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    position)."""
    C = out.cls_scores[0].shape[-1]
    B = out.cls_scores[0].shape[0]
    boxes = []
    for lvl, rs in enumerate(out.bbox_preds):
        h, w = rs.shape[1:3]
        ys, xs = cell_centres(h, w, STRIDES[lvl], rs)
        px = xs[None, :].expand(h, w).reshape(-1)
        py = ys[:, None].expand(h, w).reshape(-1)
        d = torch.exp(rs.reshape(B, -1, 4)) * BASE_EDGES[lvl]
        boxes.append(torch.stack([px - d[..., 0], py - d[..., 1],
                                  px + d[..., 2], py + d[..., 3]], -1))
    top = filter_scores_and_topk_mlvl(torch.sigmoid(cat_levels(
        out.cls_scores, C)), score_thr, nms_pre,
        level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    sel = torch.gather(torch.cat(boxes, 1), 1,
                       idx[..., None].expand(-1, -1, 4))
    # clipped to the last pixel, (h - 1, w - 1)
    hw = img_hw.to(sel.dtype) - 1
    sel = bbox_clip(sel, (hw[:, 0, None], hw[:, 1, None]))
    return nms_detections(sel, top, img_hw, scale_factor, rescale, nms_iou,
                          max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_foveabox(model_cfg, device="cuda") -> FoveaBox:
    m = model_cfg
    return FoveaBox(device, num_classes=m.num_classes, depth=m.depth,
                    frozen_stages=m.frozen_stages)


def init_foveabox(model: FoveaBox, seed: int = 0) -> None:
    init_dense(model, seed, "conv_cls", PRIOR_BIAS)


def _register():
    from ..registry import register_family
    from ..utils.weights import foveabox_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = FoveaLossConfig(num_classes=cfg.model.num_classes)

        # JAX's FoveaBox losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            return fovea_loss(out.head, batch.gt_bboxes, batch.gt_labels,
                              batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            return fovea_get_bboxes(out.head, img_hw,
                                    scale_factor=scale_factors,
                                    score_thr=max(score_thr, 0.05),
                                    max_per_img=max_per_img, rescale=True)
        return step

    register_family("foveabox", build=build_foveabox,
                    init_weights=init_foveabox,
                    from_jax=foveabox_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
