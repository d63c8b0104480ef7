"""RetinaNet (port of dskd_tpu/models/retinanet.py ``RetinaHead``,
``RetinaNet``, ``retina_anchors``, ``RetinaLossConfig``,
``retina_detection_loss``, ``retina_get_bboxes`` and its registry entry
``retinanet``).

ResNet -> FPN (C3-C5, P3-P7, the extra convs on the C5 input, no ReLU
between them) -> two towers of 4 x (3x3 conv with bias, ReLU) shared
across the levels -> ``retina_cls`` (A x C logits) and ``retina_reg``
(A x 4 deltas), A = 9 anchors per position (3 octave scales x 3 ratios).
Loss: max-IoU assignment (positive from 0.5, negative below 0.4, each GT
also its best anchor), focal loss over the anchors not ignored, L1 on the
deltas of the positives. Decoding: per-level threshold and top-k of the
(anchor, class) sigmoid scores, deltas decoded, clipped, class-aware NMS
at IoU 0.5. The JAX module's other variants (``pisa_retinanet``,
``retinanet_ghm``, ``retinanet_fpg``, ``retinanet_nasfpn``, the SepBN head
and the non-ResNet backbones) are not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.anchors import base_anchors, bbox2delta, delta2bbox, grid_anchors
from ..core.max_iou_assigner import max_iou_assign
from ..core.postprocess import filter_scores_and_topk_mlvl
from .atss import PRIOR_BIAS
from .backbones import build_backbone
from .fpn import FPN, ConvWrap
from .gfl import init_dense
from .gfl_head import cat_levels, level_sizes, nhwc
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
OCTAVE_BASE_SCALE = 4
SCALES_PER_OCTAVE = 3
RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = SCALES_PER_OCTAVE * len(RATIOS)


class RetinaHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, A*C)
    bbox_preds: Tuple[torch.Tensor, ...]   # per level (B, H, W, A*4)


class RetinaNetOutputs(NamedTuple):
    head: RetinaHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


class RetinaHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 4,
                 feat_channels: int = 256, sepbn: bool = False):
        super().__init__()
        if sepbn:
            raise NotImplementedError("RetinaHead sepbn=True "
                                      "(RetinaSepBNHead) is not ported")
        self.num_classes = num_classes
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvWrap(feat_channels, feat_channels, 3, device)
                for _ in range(stacked_convs)))
        self.retina_cls = nn.Conv2d(feat_channels, NUM_ANCHORS * num_classes,
                                    3, padding=1, device=device)
        self.retina_reg = nn.Conv2d(feat_channels, NUM_ANCHORS * 4, 3,
                                    padding=1, device=device)

    def forward(self, feats) -> RetinaHeadOutputs:
        cls, reg = [], []
        for f in feats:
            c = r = f
            for cc, rc in zip(self.cls_convs, self.reg_convs):
                c, r = F.relu(cc(c)), F.relu(rc(r))
            cls.append(nhwc(self.retina_cls(c)))
            reg.append(nhwc(self.retina_reg(r)))
        return RetinaHeadOutputs(tuple(cls), tuple(reg))


class RetinaNet(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1, backbone: str = "",
                 neck: str = "fpn", ghm: bool = False):
        super().__init__()
        if neck != "fpn":
            raise NotImplementedError(f"RetinaNet neck={neck!r} is not "
                                      f"ported (the port builds 'fpn')")
        if ghm:
            raise NotImplementedError("RetinaNet ghm=True (GHM's EMA state) "
                                      "is not ported")
        self.backbone, kind = build_backbone(backbone, depth, device,
                                             frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device,
                        start_level=1 if kind == "c2345" else 0,
                        add_extra_convs="on_input",
                        relu_before_extra_convs=False)
        self.bbox_head = RetinaHead(device, num_classes)

    def forward(self, images, img_hw) -> RetinaNetOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return RetinaNetOutputs(self.bbox_head(neck), neck)


def retina_anchors(featmap_sizes, device) -> torch.Tensor:
    """All levels' anchors (sum H*W*A, 4) in row-major (y, x, anchor)
    order per level, level-major: octave base scale 4, 3 scales per octave,
    ratios 0.5, 1, 2."""
    scales = tuple(OCTAVE_BASE_SCALE * 2 ** (i / SCALES_PER_OCTAVE)
                   for i in range(SCALES_PER_OCTAVE))
    return torch.cat([grid_anchors((h, w), s, base_anchors(s, scales,
                                                           RATIOS), device)
                      for (h, w), s in zip(featmap_sizes, STRIDES)])


class RetinaLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4


def retina_detection_loss(out: RetinaHeadOutputs, anchors, gt_bboxes,
                          gt_labels, gt_valid, cfg: RetinaLossConfig,
                          pisa: bool = False, ghm_state=None):
    """Focal loss over the anchors not ignored and L1 on the positives'
    deltas, both over the positives' count; anchors (N, 4), gt_* (B, G,
    ...) padded. The ``pisa`` and GHM (``ghm_state``) variants raise."""
    if pisa:
        raise NotImplementedError("retina_detection_loss pisa=True (ISR-P "
                                  "and CARL) is not ported")
    if ghm_state is not None:
        raise NotImplementedError("retina_detection_loss ghm_state (GHM-C "
                                  "and GHM-R) is not ported")
    C = cfg.num_classes
    cls_flat = cat_levels(out.cls_scores, C)
    deltas = cat_levels(out.bbox_preds, 4)
    assign = max_iou_assign(anchors, gt_bboxes, gt_labels, gt_valid, C,
                            pos_iou_thr=cfg.pos_iou_thr,
                            neg_iou_thr=cfg.neg_iou_thr, min_pos_iou=0.0)
    pos = assign.assigned_gt >= 0
    ignored = assign.assigned_gt == -2
    num_total_pos = pos.sum().float().clamp(min=1.0)
    G = gt_bboxes.shape[1]
    tgt = torch.gather(gt_bboxes, 1, assign.assigned_gt.clamp(0, G - 1)[
        ..., None].expand(-1, -1, 4))
    delta_tgt = bbox2delta(anchors[None], tgt)
    onehot = F.one_hot(assign.labels, C + 1)[..., :C].to(cls_flat.dtype)
    w = (~ignored).float().reshape(-1, 1)
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot.reshape(-1, C), weight=w,
        avg_factor=num_total_pos, gamma=cfg.focal_gamma,
        alpha=cfg.focal_alpha)
    loss_bbox = cfg.loss_bbox_weight * L.l1_loss(
        deltas.reshape(-1, 4), delta_tgt.reshape(-1, 4),
        weight=pos.float().reshape(-1, 1), avg_factor=num_total_pos)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)


def retina_get_bboxes(out: RetinaHeadOutputs, anchors, img_hw,
                      scale_factor=None, score_thr: float = 0.05,
                      nms_iou: float = 0.5, nms_pre: int = 1000,
                      max_per_img: int = 100, rescale: bool = False
                      ) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    anchor)."""
    C = out.cls_scores[0].shape[-1] // NUM_ANCHORS
    probs = torch.sigmoid(cat_levels(out.cls_scores, C))
    top = filter_scores_and_topk_mlvl(probs, score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    deltas = torch.gather(cat_levels(out.bbox_preds, 4), 1,
                          idx[..., None].expand(-1, -1, 4))
    boxes = delta2bbox(anchors[idx], deltas)
    return nms_detections(boxes, top, img_hw, scale_factor, rescale,
                          nms_iou, max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_retinanet(model_cfg, device="cuda") -> RetinaNet:
    m = model_cfg
    return RetinaNet(device, num_classes=m.num_classes, depth=m.depth,
                     frozen_stages=m.frozen_stages, backbone=m.backbone)


def init_retinanet(model: RetinaNet, seed: int = 0) -> None:
    init_dense(model, seed, "retina_cls", PRIOR_BIAS)


def _register():
    from ..registry import register_family
    from ..utils.weights import retinanet_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = RetinaLossConfig(num_classes=cfg.model.num_classes)

        # JAX's RetinaNet losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            anchors = retina_anchors(
                [c.shape[1:3] for c in out.head.cls_scores],
                batch.images.device)
            return retina_detection_loss(out.head, anchors, batch.gt_bboxes,
                                         batch.gt_labels, batch.gt_valid,
                                         det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            anchors = retina_anchors(
                [c.shape[1:3] for c in out.head.cls_scores], images.device)
            return retina_get_bboxes(out.head, anchors, img_hw,
                                     scale_factor=scale_factors,
                                     score_thr=max(score_thr, 0.05),
                                     max_per_img=max_per_img, rescale=True)
        return step

    register_family("retinanet", build=build_retinanet,
                    init_weights=init_retinanet,
                    from_jax=retinanet_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
