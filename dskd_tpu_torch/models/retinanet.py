"""RetinaNet and its variants (port of dskd_tpu/models/retinanet.py
``RetinaHead``, ``RetinaNet``, ``retina_anchors``, ``RetinaLossConfig``,
``retina_detection_loss``, ``retina_get_bboxes`` and its registry entries
``retinanet``, ``pisa_retinanet``, ``retinanet_ghm``, ``retinanet_fpg`` and
``retinanet_nasfpn``).

ResNet -> FPN (C3-C5, P3-P7, the extra convs on the C5 input, no ReLU
between them) -> two towers of 4 x (3x3 conv with bias, ReLU) shared
across the levels -> ``retina_cls`` (A x C logits) and ``retina_reg``
(A x 4 deltas), A = 9 anchors per position (3 octave scales x 3 ratios).
Loss: max-IoU assignment (positive from 0.5, negative below 0.4, each GT
also its best anchor), focal loss over the anchors not ignored, L1 on the
deltas of the positives. Decoding: per-level threshold and top-k of the
(anchor, class) sigmoid scores, deltas decoded, clipped, class-aware NMS
at IoU 0.5.

The variants: ``pisa_retinanet`` weights the focal loss by ISR-P and adds
CARL (``models/pisa.py``); ``retinanet_ghm`` swaps focal and L1 for GHM-C
and GHM-R (L1 weight 10) level by level, their EMAs in the buffers
``ghm_acc_c`` (30 bins) and ``ghm_acc_r`` (10), updated in place by the
loss; ``retinanet_fpg`` and ``retinanet_nasfpn`` replace the FPN by FPG
(``models/fpg.py``) or NAS-FPN (``models/nas_fpn.py``), which take all
four ResNet stages (C2-C5, strides 4-32) and add one level, as the JAX
module wires them, while the anchors stay at strides 8-128; NAS-FPN pairs
with RetinaSepBNHead (``sepbn``): the towers' convs, without bias, shared
across the levels, and a BatchNorm of each level's own after each, on the
batch's statistics in training.

Backbones (``models/backbones.py``): RegNetX and PVT feed the FPN from C3
as ResNet does; HRNet's branches go through HRFPN; EfficientNet's C3-C5
take the reference's EfficientNet recipe: nothing frozen in the backbone,
stochastic depth 0.2, every BatchNorm trained (backbone, FPN and head),
the FPN with BatchNorm after its output and extra convs and a ReLU before
the second extra conv, the SepBN head, and negatives below IoU 0.5. The
stochastic-depth backbones (EfficientNet, PVT) draw their masks from the
step's generator in training where the step asks for dropout
(``use_dropout``); JAX's losses draw them whatever ``use_dropout`` says.
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
from .backbones import apply_backbone, build_backbone, init_backbone
from .dilated_encoder import TrainableBatchNorm
from .fpg import FPG
from .fpn import FPN, ConvWrap
from .gfl import dense_init_of, init_dense
from .gfl_head import cat_levels, level_sizes, nhwc
from .hrnet import HRFPN
from .nas_fpn import NASFPN
from .pisa import carl_loss, isr_p_weights
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
                 feat_channels: int = 256, sepbn: bool = False,
                 num_levels: int = 5):
        super().__init__()
        self.num_classes = num_classes
        self.sepbn = sepbn
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvWrap(feat_channels, feat_channels, 3, device,
                         bias=not sepbn)
                for _ in range(stacked_convs)))
            if sepbn:
                self.add_module(f"{prefix}_norms", nn.ModuleList(
                    nn.ModuleList(TrainableBatchNorm(feat_channels, device)
                                  for _ in range(stacked_convs))
                    for _ in range(num_levels)))
        self.retina_cls = nn.Conv2d(feat_channels, NUM_ANCHORS * num_classes,
                                    3, padding=1, device=device)
        self.retina_reg = nn.Conv2d(feat_channels, NUM_ANCHORS * 4, 3,
                                    padding=1, device=device)

    def forward(self, feats) -> RetinaHeadOutputs:
        cls, reg = [], []
        for lvl, f in enumerate(feats):
            c = r = f
            for i, (cc, rc) in enumerate(zip(self.cls_convs, self.reg_convs)):
                c, r = cc(c), rc(r)
                if self.sepbn:
                    c = self.cls_norms[lvl][i](c)
                    r = self.reg_norms[lvl][i](r)
                c, r = F.relu(c), F.relu(r)
            cls.append(nhwc(self.retina_cls(c)))
            reg.append(nhwc(self.retina_reg(r)))
        return RetinaHeadOutputs(tuple(cls), tuple(reg))


class RetinaNet(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1, backbone: str = "",
                 neck: str = "fpn", ghm: bool = False):
        super().__init__()
        if neck not in ("fpn", "fpg", "nasfpn"):
            raise ValueError(f"RetinaNet neck={neck!r}")
        effb = backbone.startswith("effb")
        self.backbone_spec = backbone
        self.backbone, kind = build_backbone(
            backbone, depth, device, 0 if effb else frozen_stages,
            drop_path_rate=0.2 if effb else 0.0)
        if neck == "fpg":
            self.neck = FPG(self.backbone.out_channels, device)
        elif neck == "nasfpn":
            self.neck = NASFPN(self.backbone.out_channels, device)
        elif kind == "hr":
            self.neck = HRFPN(self.backbone.out_channels, device)
        else:
            self.neck = FPN(self.backbone.out_channels, device,
                            start_level=1 if kind == "c2345" else 0,
                            add_extra_convs="on_input",
                            relu_before_extra_convs=effb,
                            norm="bn" if effb else "",
                            no_norm_on_lateral=effb)
        self.bbox_head = RetinaHead(device, num_classes,
                                    sepbn=neck == "nasfpn" or effb)
        if ghm:
            # the EMAs of GHM-C's 30 and GHM-R's 10 bin counts
            # (RetinaLossConfig)
            self.register_buffer("ghm_acc_c", torch.zeros(30, device=device))
            self.register_buffer("ghm_acc_r", torch.zeros(10, device=device))

    def forward(self, images, img_hw, generator=None) -> RetinaNetOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward; ``generator`` draws a stochastic-depth backbone's masks in
        training."""
        neck = self.neck(apply_backbone(self.backbone, self.backbone_spec,
                                        images.permute(0, 3, 1, 2),
                                        generator))
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
    # GHM-C (30 bins, momentum 0.75) and GHM-R (mu 0.02, 10 bins, momentum
    # 0.7) in place of focal and L1
    ghm: bool = False
    ghm_c_bins: int = 30
    ghm_c_momentum: float = 0.75
    ghm_r_mu: float = 0.02
    ghm_r_bins: int = 10
    ghm_r_momentum: float = 0.7


def retina_detection_loss(out: RetinaHeadOutputs, anchors, gt_bboxes,
                          gt_labels, gt_valid, cfg: RetinaLossConfig,
                          pisa: bool = False, ghm_state=None):
    """Focal loss over the anchors not ignored and L1 on the positives'
    deltas, both over the positives' count; anchors (N, 4), gt_* (B, G,
    ...) padded. ``pisa``: the focal loss weighted by ISR-P and
    ``loss_carl`` added. ``cfg.ghm``: GHM-C and GHM-R level by level, one
    shared EMA updated once per level, from ``ghm_state`` ({"acc_c",
    "acc_r"}); returns (losses, the new state)."""
    C = cfg.num_classes
    B = out.cls_scores[0].shape[0]
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
    w = (~ignored).to(cls_flat.dtype)                       # (B, N)
    if cfg.ghm:
        acc_c, acc_r = ghm_state["acc_c"], ghm_state["acc_r"]
        posf = pos.to(cls_flat.dtype)
        loss_cls = loss_bbox = 0.0
        start = 0
        for S in level_sizes(out.cls_scores, C):
            sl = slice(start, start + S)
            start += S
            lc, acc_c = L.ghm_c_loss(
                cls_flat[:, sl].reshape(-1, C), onehot[:, sl].reshape(-1, C),
                w[:, sl].reshape(-1, 1).expand(B * S, C),
                bins=cfg.ghm_c_bins, momentum=cfg.ghm_c_momentum,
                acc_sum=acc_c)
            lr, acc_r = L.ghm_r_loss(
                deltas[:, sl].reshape(-1, 4), delta_tgt[:, sl].reshape(-1, 4),
                posf[:, sl].reshape(-1, 1).expand(B * S, 4),
                mu=cfg.ghm_r_mu, bins=cfg.ghm_r_bins,
                momentum=cfg.ghm_r_momentum, acc_sum=acc_r)
            loss_cls = loss_cls + lc
            loss_bbox = loss_bbox + lr
        losses = dict(loss_cls=cfg.loss_cls_weight * loss_cls,
                      loss_bbox=cfg.loss_bbox_weight * loss_bbox)
        return losses, {"acc_c": acc_c, "acc_r": acc_r}
    w = w.reshape(-1)
    if pisa:
        N = cls_flat.shape[1]
        gt_off = assign.assigned_gt + torch.arange(
            B, device=pos.device)[:, None] * G
        imp = isr_p_weights(
            cls_flat.reshape(-1, C).detach(), deltas.reshape(-1, 4).detach(),
            anchors[None].expand(B, N, 4).reshape(-1, 4),
            assign.labels.reshape(-1), pos.reshape(-1), gt_off.reshape(-1),
            delta_tgt.reshape(-1, 4).detach(), C)
        w = w * imp.detach()
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot.reshape(-1, C),
        weight=w.reshape(-1, 1), avg_factor=num_total_pos,
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    loss_bbox = cfg.loss_bbox_weight * L.l1_loss(
        deltas.reshape(-1, 4), delta_tgt.reshape(-1, 4),
        weight=pos.to(deltas.dtype).reshape(-1, 1), avg_factor=num_total_pos)
    losses = dict(loss_cls=loss_cls, loss_bbox=loss_bbox)
    if pisa:
        losses["loss_carl"] = carl_loss(
            cls_flat.reshape(-1, C), assign.labels.reshape(-1),
            pos.reshape(-1), deltas.reshape(-1, 4),
            delta_tgt.reshape(-1, 4).detach(), num_total_pos, C)
    return losses


def retina_get_bboxes(out: RetinaHeadOutputs, anchors, img_hw,
                      scale_factor=None, score_thr: float = 0.05,
                      nms_iou: float = 0.5, nms_pre: int = 1000,
                      max_per_img: int = 100, rescale: bool = False,
                      delta_stds=(1.0, 1.0, 1.0, 1.0)) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    anchor); the deltas decode at ``delta_stds`` (FreeAnchor's coder
    takes (0.1, 0.1, 0.2, 0.2))."""
    C = out.cls_scores[0].shape[-1] // NUM_ANCHORS
    probs = torch.sigmoid(cat_levels(out.cls_scores, C))
    top = filter_scores_and_topk_mlvl(probs, score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    deltas = torch.gather(cat_levels(out.bbox_preds, 4), 1,
                          idx[..., None].expand(-1, -1, 4))
    boxes = delta2bbox(anchors[idx], deltas, stds=delta_stds)
    return nms_detections(boxes, top, img_hw, scale_factor, rescale,
                          nms_iou, max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

VARIANTS = ("retinanet", "pisa_retinanet", "retinanet_ghm", "retinanet_fpg",
            "retinanet_nasfpn")
_NECK = {"retinanet_fpg": "fpg", "retinanet_nasfpn": "nasfpn"}


def build_retinanet(model_cfg, device="cuda") -> RetinaNet:
    m = model_cfg
    return RetinaNet(device, num_classes=m.num_classes, depth=m.depth,
                     frozen_stages=m.frozen_stages, backbone=m.backbone,
                     neck=_NECK.get(m.arch, "fpn"),
                     ghm=m.arch == "retinanet_ghm")


def _retina_init_of(name: str) -> str:
    """FPG's and NAS-FPN's convs take flax's default lecun-normal; the
    rest as ``dense_init_of``."""
    return "lecun" if name.startswith("neck.") else dense_init_of(name)


def init_retinanet(model: RetinaNet, seed: int = 0) -> None:
    """Seeded random weights at JAX's scales; the GHM EMAs zero."""
    init_of = (dense_init_of if isinstance(model.neck, FPN)
               else _retina_init_of)
    init_dense(model, seed, "retina_cls", PRIOR_BIAS, init_of)
    init_backbone(model.backbone, seed)
    for name, buf in model.named_buffers():
        if name.startswith("ghm_acc_"):
            buf.zero_()


def retina_losses_fn(arch: str, det_cfg: RetinaLossConfig,
                     use_dropout: bool = True):
    """``losses_fn(model, batch, teacher, generator)`` of a RetinaNet
    variant; JAX's read no teacher. GHM's loss writes the new EMAs into the
    model's buffers in place, as a train-mode BatchNorm carries JAX's
    ``new_batch_stats``. With ``use_dropout`` the generator draws a
    stochastic-depth backbone's masks."""
    def losses_fn(model, batch, teacher, generator):
        out = model(batch.images, batch.img_hw,
                    generator if use_dropout else None)
        anchors = retina_anchors([c.shape[1:3] for c in out.head.cls_scores],
                                 batch.images.device)
        args = (out.head, anchors, batch.gt_bboxes, batch.gt_labels,
                batch.gt_valid, det_cfg)
        if not det_cfg.ghm:
            return retina_detection_loss(
                *args, pisa=arch == "pisa_retinanet")
        losses, new = retina_detection_loss(
            *args, ghm_state={"acc_c": model.ghm_acc_c,
                              "acc_r": model.ghm_acc_r})
        with torch.no_grad():
            model.ghm_acc_c.copy_(new["acc_c"])
            model.ghm_acc_r.copy_(new["acc_r"])
        return losses
    return losses_fn


def _register():
    from ..registry import register_family
    from ..utils.weights import retinanet_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        ghm = cfg.model.arch == "retinanet_ghm"
        # the GHM recipe's GHM-R weighs 10; the EfficientNet recipe's
        # assigner takes negatives below IoU 0.5
        det_cfg = RetinaLossConfig(
            num_classes=cfg.model.num_classes, ghm=ghm,
            neg_iou_thr=0.5 if cfg.model.backbone.startswith("effb")
            else 0.4, loss_bbox_weight=10.0 if ghm else 1.0)
        return retina_losses_fn(cfg.model.arch, det_cfg, use_dropout)

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

    for name in VARIANTS:
        register_family(name, build=build_retinanet,
                        init_weights=init_retinanet,
                        from_jax=retinanet_state_dict_from_jax,
                        losses=losses, eval_step=eval_step)


_register()
