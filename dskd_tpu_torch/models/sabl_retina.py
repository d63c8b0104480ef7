"""SABL RetinaNet (port of dskd_tpu/models/sabl_retina.py
``SABLRetinaHead``, ``SABLRetinaNet``, ``sabl_anchors``,
``approx_max_iou_assign``, ``SABLLossConfig``, ``sabl_loss``,
``sabl_get_bboxes`` and its registry entry ``sabl_retina``).

Side-Aware Boundary Localization on RetinaNet's trunk: ResNet -> FPN
(C3-C5, P3-P7, the extra convs on the C5 input, no ReLU between them) ->
two towers of 4 x (3x3 conv with bias, ReLU) shared across the levels ->
``retina_cls`` (C logits of one square anchor of 4 strides a position) on
the cls tower, ``retina_bbox_cls`` and ``retina_bbox_reg`` (4 sides x 7
buckets: the bucket logits and their fine offsets) on the reg tower.
Assignment: each position's nine approx anchors (3 octave scales x 3
ratios) vote with their largest IoU, then max-IoU's rules (positive from
0.5, negative below 0.4, each GT also its best position). Loss: focal loss
over the positions not ignored; BCE over the buckets of the positives
(``core/coders.py bbox2bucket``, 14 buckets, rescale 3) over positives x 4
x 7, smooth-L1 of the offsets over positives x 4 x 2. Decoding: each
class score times the position's bucketing confidence, per-level
threshold and top-k, ``bucket2bbox``, clipped, class-aware NMS at IoU
0.5.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.anchors import base_anchors, grid_anchors
from ..core.boxes import bbox_overlaps
from ..core.coders import bbox2bucket, bucket2bbox
from ..core.max_iou_assigner import max_iou_assign_ious
from ..core.postprocess import filter_scores_and_topk_mlvl
from .atss import PRIOR_BIAS
from .fpn import FPN, ConvWrap
from .gfl import init_dense
from .gfl_head import cat_levels, level_sizes, nhwc
from .resnet import ResNet
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
NUM_BUCKETS = 14
SCALE_FACTOR = 3.0
SIDE = math.ceil(NUM_BUCKETS / 2.0)
APPROX_SCALES = tuple(4 * 2 ** (i / 3) for i in range(3))
APPROX_RATIOS = (0.5, 1.0, 2.0)


class SABLHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, C)
    bucket_cls: Tuple[torch.Tensor, ...]   # per level (B, H, W, 4*side)
    bucket_reg: Tuple[torch.Tensor, ...]   # per level (B, H, W, 4*side)


class SABLOutputs(NamedTuple):
    head: SABLHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


class SABLRetinaHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 4,
                 feat_channels: int = 256):
        super().__init__()
        C = feat_channels
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvWrap(C, C, 3, device) for _ in range(stacked_convs)))
        self.retina_cls = nn.Conv2d(C, num_classes, 3, padding=1,
                                    device=device)
        self.retina_bbox_cls = nn.Conv2d(C, 4 * SIDE, 3, padding=1,
                                         device=device)
        self.retina_bbox_reg = nn.Conv2d(C, 4 * SIDE, 3, padding=1,
                                         device=device)

    def forward(self, feats) -> SABLHeadOutputs:
        cls, bc, br = [], [], []
        for f in feats:
            c = r = f
            for cc, rc in zip(self.cls_convs, self.reg_convs):
                c, r = F.relu(cc(c)), F.relu(rc(r))
            cls.append(nhwc(self.retina_cls(c)))
            bc.append(nhwc(self.retina_bbox_cls(r)))
            br.append(nhwc(self.retina_bbox_reg(r)))
        return SABLHeadOutputs(tuple(cls), tuple(bc), tuple(br))


class SABLRetinaNet(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_input",
                        relu_before_extra_convs=False)
        self.bbox_head = SABLRetinaHead(device, num_classes)

    def forward(self, images, img_hw) -> SABLOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return SABLOutputs(self.bbox_head(neck), neck)


def sabl_anchors(featmap_sizes, device):
    """(the square anchors (N, 4), the approx anchors (N, 9, 4)), row-major
    per level, level-major."""
    sq, ap = [], []
    for (h, w), stride in zip(featmap_sizes, STRIDES):
        sq.append(grid_anchors((h, w), stride,
                               base_anchors(stride, (4,), (1.0,)), device))
        base = base_anchors(stride, APPROX_SCALES, APPROX_RATIOS)
        ap.append(grid_anchors((h, w), stride, base, device).reshape(-1, 9,
                                                                     4))
    return torch.cat(sq), torch.cat(ap)


def approx_max_iou_assign(approxs, gt_bboxes, gt_labels, gt_valid,
                          num_classes: int, pos_thr: float = 0.5,
                          neg_thr: float = 0.4, min_pos_iou: float = 0.0):
    """approxs (N, 9, 4); gt_* (B, G, ...) padded -> (assigned GT (B, N),
    -1 negative, -2 ignored; positive mask; labels)."""
    N = approxs.shape[0]
    B, G = gt_bboxes.shape[:2]
    ious = bbox_overlaps(approxs.reshape(1, -1, 4).expand(B, -1, -1),
                         gt_bboxes)
    ious = ious.reshape(B, N, 9, G).amax(dim=2)             # (B, N, G)
    res = max_iou_assign_ious(ious, gt_labels, gt_valid, num_classes,
                              pos_iou_thr=pos_thr, neg_iou_thr=neg_thr,
                              min_pos_iou=min_pos_iou)
    return res.assigned_gt, res.assigned_gt >= 0, res.labels


class SABLLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bucket_cls_weight: float = 1.5
    loss_bucket_reg_weight: float = 1.5
    smooth_beta: float = 0.1111


def sabl_targets(squares, approxs, gt_bboxes, gt_labels, gt_valid,
                 num_classes: int):
    """The assignment and the bucket targets of a batch: (assigned GT,
    positive mask, labels, (offsets, offset weights, bucket labels,
    bucket weights) each (B, N, 4 * side))."""
    assigned, pos, labels = approx_max_iou_assign(
        approxs, gt_bboxes, gt_labels, gt_valid, num_classes)
    G = gt_bboxes.shape[1]
    tgt = torch.gather(gt_bboxes, 1, assigned.clamp(0, G - 1)[..., None]
                       .expand(-1, -1, 4))
    buckets = bbox2bucket(squares[None].expand_as(tgt), tgt, NUM_BUCKETS,
                          SCALE_FACTOR)
    return assigned, pos, labels, buckets


def sabl_loss(out: SABLHeadOutputs, squares, approxs, gt_bboxes, gt_labels,
              gt_valid, cfg: SABLLossConfig) -> Dict[str, torch.Tensor]:
    C = cfg.num_classes
    cls_flat = cat_levels(out.cls_scores, C)
    bc_flat = cat_levels(out.bucket_cls, 4 * SIDE)
    br_flat = cat_levels(out.bucket_reg, 4 * SIDE)
    assigned, pos, labels, (offs, ow, blab, bw) = sabl_targets(
        squares, approxs, gt_bboxes, gt_labels, gt_valid, C)
    num_pos = pos.sum().float().clamp(min=1.0)

    onehot = F.one_hot(labels, C + 1)[..., :C].to(cls_flat.dtype)
    wcls = (assigned != -2).to(cls_flat.dtype)
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot.reshape(-1, C),
        weight=wcls.reshape(-1, 1), avg_factor=num_pos,
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    pw = pos.to(offs.dtype)[..., None]
    loss_bc = cfg.loss_bucket_cls_weight * L.bce_loss(
        bc_flat.reshape(-1), blab.reshape(-1), weight=(bw * pw).reshape(-1),
        avg_factor=num_pos * 4 * SIDE)
    # over positives x 4 sides x offset_topk 2
    loss_br = cfg.loss_bucket_reg_weight * L.smooth_l1_loss(
        br_flat.reshape(-1), offs.reshape(-1), weight=(ow * pw).reshape(-1),
        avg_factor=num_pos * 4 * 2, beta=cfg.smooth_beta)
    return dict(loss_cls=loss_cls, loss_bbox_cls=loss_bc,
                loss_bbox_reg=loss_br)


def sabl_get_bboxes(out: SABLHeadOutputs, squares, img_hw,
                    scale_factor=None, score_thr: float = 0.05,
                    nms_iou: float = 0.5, nms_pre: int = 1000,
                    max_per_img: int = 100, rescale: bool = False
                    ) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    position)."""
    C = out.cls_scores[0].shape[-1]
    B = out.cls_scores[0].shape[0]
    boxes, conf = bucket2bbox(
        squares[None].expand(B, -1, -1), cat_levels(out.bucket_cls, 4 * SIDE),
        cat_levels(out.bucket_reg, 4 * SIDE), NUM_BUCKETS, SCALE_FACTOR)
    probs = torch.sigmoid(cat_levels(out.cls_scores, C)) * conf[..., None]
    top = filter_scores_and_topk_mlvl(probs, score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    sel = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return nms_detections(sel, top, img_hw, scale_factor, rescale, nms_iou,
                          max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_sabl(model_cfg, device="cuda") -> SABLRetinaNet:
    m = model_cfg
    return SABLRetinaNet(device, num_classes=m.num_classes, depth=m.depth,
                         frozen_stages=m.frozen_stages)


def init_sabl(model: SABLRetinaNet, seed: int = 0) -> None:
    init_dense(model, seed, "retina_cls", PRIOR_BIAS)


def _register():
    from ..registry import register_family
    from ..utils.weights import sabl_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = SABLLossConfig(num_classes=cfg.model.num_classes)

        # JAX's SABL losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            squares, approxs = sabl_anchors(
                [c.shape[1:3] for c in out.head.cls_scores],
                batch.images.device)
            return sabl_loss(out.head, squares, approxs, batch.gt_bboxes,
                             batch.gt_labels, batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            squares, _ = sabl_anchors(
                [c.shape[1:3] for c in out.head.cls_scores], images.device)
            return sabl_get_bboxes(out.head, squares, img_hw,
                                   scale_factor=scale_factors,
                                   score_thr=max(score_thr, 0.05),
                                   max_per_img=max_per_img, rescale=True)
        return step

    register_family("sabl_retina", build=build_sabl, init_weights=init_sabl,
                    from_jax=sabl_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
