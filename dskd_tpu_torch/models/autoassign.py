"""AutoAssign (port of dskd_tpu/models/autoassign.py ``AutoAssignHead``,
``AutoAssign``, ``autoassign_points``, ``AutoAssignLossConfig``,
``autoassign_loss``, ``autoassign_get_bboxes`` and its registry entry
``autoassign``).

ResNet -> FPN (C3-C5, P3-P7, extra convs on the output with a ReLU
between them) -> two towers of 4 x (conv, GroupNorm(32), ReLU) shared
across the levels -> ``conv_cls`` (bias at prior 0.02) on the cls tower,
``conv_reg`` (bias 4; l, t, r, b = clamp(Scale x reg, 0) x stride) and
``conv_objectness`` on the reg tower, at the offset-0 grid points. The
learnable centre prior (a mean and a sigma per class and axis, in stride
units) belongs to the detector: ``center_prior_mean`` and
``center_prior_sigma``. Loss, fully differentiable:
  * positives: per GT, the points inside its box weighted by exp(3 x
    p_pos) x prior, p_pos = sigmoid(cls) x sigmoid(obj) x exp(-5 x GIoU
    loss); -log of the weighted confidence, x 0.25, over the valid GTs;
  * negatives: each (point, class) a negative of weight 1, or, inside a
    GT of that class, 1 - its per-GT min-max normalised 1 / (1 - IoU) of
    the point's best detached IoU (the last such GT where several hold the
    point, as JAX's loop over the GTs overwrites); focal-like (w x conf)^2
    x BCE(w x conf, 0), x 0.75, over the summed centre priors;
  * centre: per image the valid GTs over the summed priors, mean x 0.75.
The negative weights take one pass: the last GT of each (point, class) is
a scatter of the largest 1 + GT index by max, in place of JAX's loop of
one (N, C) write per padded GT. Decoding: sigmoid(cls) x sigmoid(obj),
per-level threshold and top-k, clipped, class-aware NMS at IoU 0.6.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.boxes import bbox_overlaps, distance2bbox
from ..core.postprocess import filter_scores_and_topk_mlvl
from .fpn import FPN
from .gfl import init_dense
from .gfl_head import ConvGN, Scale, cat_levels, level_sizes, nhwc, tower
from .resnet import ResNet
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
EPS = 1e-12
CLS_PRIOR_BIAS = -math.log((1 - 0.02) / 0.02)    # bias_init_with_prob(0.02)
REG_BIAS = 4.0


class AutoAssignHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]   # per level (B, H, W, 4) ltrb
    objectness: Tuple[torch.Tensor, ...]   # per level (B, H, W, 1)


class AutoAssignOutputs(NamedTuple):
    head: AutoAssignHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]
    prior_mean: torch.Tensor               # (C, 2)
    prior_sigma: torch.Tensor              # (C, 2)


class AutoAssignHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 4,
                 feat_channels: int = 256, num_levels: int = 5):
        super().__init__()
        C = feat_channels
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvGN(C, C, device) for _ in range(stacked_convs)))
        self.conv_cls = nn.Conv2d(C, num_classes, 3, padding=1, device=device)
        self.conv_reg = nn.Conv2d(C, 4, 3, padding=1, device=device)
        self.conv_objectness = nn.Conv2d(C, 1, 3, padding=1, device=device)
        self.scales = nn.ModuleList(Scale(device) for _ in range(num_levels))

    def forward(self, feats) -> AutoAssignHeadOutputs:
        cls, reg, obj = [], [], []
        for lvl, f in enumerate(feats):
            c, r = tower(self.cls_convs, f), tower(self.reg_convs, f)
            cls.append(nhwc(self.conv_cls(c)))
            obj.append(nhwc(self.conv_objectness(r)))
            d = self.scales[lvl](self.conv_reg(r)).clamp(min=0)
            reg.append(nhwc(d * STRIDES[lvl]))
        return AutoAssignHeadOutputs(tuple(cls), tuple(reg), tuple(obj))


class AutoAssign(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_output",
                        relu_before_extra_convs=True)
        self.bbox_head = AutoAssignHead(device, num_classes)
        self.center_prior_mean = nn.Parameter(
            torch.zeros(num_classes, 2, device=device))
        self.center_prior_sigma = nn.Parameter(
            torch.ones(num_classes, 2, device=device))

    def forward(self, images, img_hw) -> AutoAssignOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return AutoAssignOutputs(self.bbox_head(neck), neck,
                                 self.center_prior_mean,
                                 self.center_prior_sigma)


def autoassign_points(featmap_sizes, device):
    """The offset-0 grid points (N, 2) and their strides (N,), level-major
    (MlvlPointGenerator(offset=0))."""
    pts, strides = [], []
    for (h, w), s in zip(featmap_sizes, STRIDES):
        ys, xs = np.mgrid[:h, :w]
        pts.append(np.stack([xs * s, ys * s], -1).reshape(-1, 2))
        strides.append(np.full((h * w,), s, np.float32))
    return (torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(
        device), torch.from_numpy(np.concatenate(strides)).to(device))


class AutoAssignLossConfig(NamedTuple):
    num_classes: int = 80
    pos_loss_weight: float = 0.25
    neg_loss_weight: float = 0.75
    center_loss_weight: float = 0.75
    giou_weight: float = 5.0


def inside_gt(points, gt_bboxes, gt_valid) -> torch.Tensor:
    """(B, N, G): the points strictly inside each valid GT."""
    px, py = points[:, 0, None], points[:, 1, None]          # (N, 1)
    gb = gt_bboxes[:, None]                                  # (B, 1, G, 4)
    return ((px > gb[..., 0]) & (px < gb[..., 2]) & (py > gb[..., 1])
            & (py < gb[..., 3]) & gt_valid[:, None])


def last_inside_gt(inside: torch.Tensor, labels: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """(B, N, G) inside mask, (B, G) labels -> (B, N, C): 1 + the last GT
    of each class that holds each point, 0 where none does."""
    B, N, G = inside.shape
    key = inside * torch.arange(1, G + 1, device=inside.device)
    out = key.new_zeros(B, N, num_classes)
    return out.scatter_reduce(2, labels[:, None, :].expand(B, N, G), key,
                              "amax")


def negative_weights(ious, inside, labels, num_classes: int):
    """The negatives' weights (B, N, C) from the detached IoUs of the
    decoded boxes with the valid GTs (B, N, G, 0 for the others): each GT's
    inside points' 1 - min-max normalised 1 / (1 - the point's best IoU)
    in the GT's class column, the last GT winning, else 1."""
    ious = torch.where(inside, ious.amax(2, keepdim=True).expand_as(ious),
                       torch.zeros_like(ious))
    tw = 1.0 / (1.0 - ious).clamp(min=EPS)
    # per GT over its inside points; the guards leave a GT with none finite
    big = torch.full_like(tw, 1e12)
    tmin = torch.where(inside, tw, big).amin(1, keepdim=True)
    tmax = torch.where(inside, tw, -big).amax(1, keepdim=True)
    tw = (tw - tmin + EPS) / (tmax - tmin + EPS)
    last = last_inside_gt(inside, labels, num_classes)      # (B, N, C)
    upd = 1.0 - torch.gather(tw, 2, (last - 1).clamp(min=0))
    return torch.where(last > 0, upd, torch.ones_like(upd))


def autoassign_loss(out: AutoAssignHeadOutputs, prior_mean, prior_sigma,
                    gt_bboxes, gt_labels, gt_valid,
                    cfg: AutoAssignLossConfig) -> Dict[str, torch.Tensor]:
    C = cfg.num_classes
    cls_flat = cat_levels(out.cls_scores, C)                 # (B, N, C)
    dist = cat_levels(out.bbox_preds, 4)
    obj = cat_levels(out.objectness, 1)[..., 0]
    B, N, _ = cls_flat.shape
    G = gt_bboxes.shape[1]
    points, strides = autoassign_points(
        [c.shape[1:3] for c in out.cls_scores], cls_flat.device)
    safe_lbl = gt_labels.long().clamp(0, C - 1)
    inside = inside_gt(points, gt_bboxes, gt_valid)          # (B, N, G)
    px, py = points[:, 0, None], points[:, 1, None]          # (N, 1)
    # the learnable centre prior, per (point, GT), in stride units
    gcx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
    gcy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
    mu, sg = prior_mean[safe_lbl], prior_sigma[safe_lbl]     # (B, G, 2)
    s = strides[:, None]
    dx = ((px - gcx[:, None]) / s - mu[:, None, :, 0]) ** 2
    dy = ((py - gcy[:, None]) / s - mu[:, None, :, 1]) ** 2
    prior = (torch.exp(-dx / (2 * sg[:, None, :, 0] ** 2))
             * torch.exp(-dy / (2 * sg[:, None, :, 1] ** 2)))
    prior = torch.where(inside, prior, torch.zeros_like(prior))

    boxes = distance2bbox(points[None], dist)                # (B, N, 4)
    giou = 1 - bbox_overlaps(boxes, gt_bboxes, mode="giou")  # (B, N, G)
    p_loc = torch.exp(-cfg.giou_weight * giou)
    conf = torch.sigmoid(cls_flat) * torch.sigmoid(obj)[..., None]
    p_cls = torch.gather(conf, 2, safe_lbl[:, None, :].expand(B, N, G))
    p_pos = p_cls * p_loc

    cw = torch.exp(p_pos * 3) * prior
    w = cw / cw.sum(1, keepdim=True).clamp(min=EPS)
    rew = (p_pos * w).sum(1)                                 # (B, G)
    pos_bce = -torch.log(rew.clamp(min=EPS))
    pos_loss = torch.where(gt_valid, pos_bce,
                           torch.zeros_like(pos_bce)).sum(1) \
        * cfg.pos_loss_weight

    with torch.no_grad():
        ious = bbox_overlaps(boxes, gt_bboxes)
        ious = torch.where(gt_valid[:, None], ious, torch.zeros_like(ious))
        w_neg = negative_weights(ious, inside, safe_lbl, C)
    logits = conf * w_neg
    neg = (logits ** 2) * (-torch.log((1 - logits).clamp(min=EPS)))
    neg_loss = neg.sum((1, 2)) * cfg.neg_loss_weight

    prior_sum = prior.sum((1, 2))
    center = torch.where(
        inside.flatten(1).any(1),
        gt_valid.sum(1).to(torch.float32) / prior_sum.clamp(min=EPS),
        prior_sum * 0.0)
    num_gt = gt_valid.sum().to(torch.float32).clamp(min=1.0)
    return dict(
        loss_pos=pos_loss.sum() / num_gt,
        loss_neg=neg_loss.sum() / prior_sum.sum().clamp(min=1.0),
        loss_center=center.mean() * cfg.center_loss_weight)


def autoassign_get_bboxes(out: AutoAssignHeadOutputs, img_hw,
                          scale_factor=None, score_thr: float = 0.05,
                          nms_iou: float = 0.6, nms_pre: int = 1000,
                          max_per_img: int = 100, rescale: bool = False
                          ) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    point)."""
    C = out.cls_scores[0].shape[-1]
    points, _ = autoassign_points([c.shape[1:3] for c in out.cls_scores],
                                  out.cls_scores[0].device)
    probs = (torch.sigmoid(cat_levels(out.cls_scores, C))
             * torch.sigmoid(cat_levels(out.objectness, 1)))
    top = filter_scores_and_topk_mlvl(probs, score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    dist = torch.gather(cat_levels(out.bbox_preds, 4), 1,
                        idx[..., None].expand(-1, -1, 4))
    return nms_detections(distance2bbox(points[idx], dist), top, img_hw,
                          scale_factor, rescale, nms_iou, max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_autoassign(model_cfg, device="cuda") -> AutoAssign:
    m = model_cfg
    return AutoAssign(device, num_classes=m.num_classes, depth=m.depth,
                      frozen_stages=m.frozen_stages)


@torch.no_grad()
def init_autoassign(model: AutoAssign, seed: int = 0) -> None:
    """init_dense (normal(0.01) head convs, the class prior at 0.02), the
    regression bias 4 and the centre prior's mean 0 and sigma 1, JAX's
    initializers."""
    init_dense(model, seed, "conv_cls", CLS_PRIOR_BIAS)
    model.bbox_head.conv_reg.bias.fill_(REG_BIAS)
    model.center_prior_mean.zero_()
    model.center_prior_sigma.fill_(1.0)


def _register():
    from ..registry import register_family
    from ..utils.weights import autoassign_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = AutoAssignLossConfig(num_classes=cfg.model.num_classes)

        # JAX's AutoAssign losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            return autoassign_loss(out.head, out.prior_mean,
                                   out.prior_sigma, batch.gt_bboxes,
                                   batch.gt_labels, batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            return autoassign_get_bboxes(out.head, img_hw,
                                         scale_factor=scale_factors,
                                         score_thr=max(score_thr, 0.05),
                                         max_per_img=max_per_img,
                                         rescale=True)
        return step

    register_family("autoassign", build=build_autoassign,
                    init_weights=init_autoassign,
                    from_jax=autoassign_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
