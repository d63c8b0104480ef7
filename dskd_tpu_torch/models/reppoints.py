"""RepPoints, the moment variant (port of dskd_tpu/models/reppoints.py
``RepPointsHead``, ``RepPoints``, ``points2bbox``, ``reppoints_centers``,
``point_assign``, ``RepPointsLossConfig``, ``reppoints_loss``,
``reppoints_get_bboxes`` and its registry entry ``reppoints``).

ResNet -> FPN (C3-C5, P3-P7, extra convs on C5 with no ReLU) -> two
towers of 3 x (conv with bias, ReLU) shared across the levels. The point
tower -> ``reppoints_pts_init_conv`` -> ReLU -> ``reppoints_pts_init_out``
gives nine initial points, (dy, dx) in strides from the cell. Two 3x3
deformable convs take their taps on those points (0.1 x them + 0.9 x them
detached, less the regular grid): on the cls tower -> ReLU ->
``reppoints_cls_out`` (the logits), on the point tower -> ReLU ->
``reppoints_pts_refine_out``, residuals on the detached initial points.
A point set's box is its moment: mean +- std (ddof 1) x exp(the learnable
``moment_transfer``, 0.01 of its gradient). Assignment: the initial
stage by the point assigner (each GT on its log2 scale's level, the cell
nearest its centre in the GT's (w, h) metric, the nearer GT winning a
shared cell, the earlier GT an exact tie); the refined stage by max-IoU
at 0.5 / 0.4 (min_pos_iou 0) on the detached initial boxes, the [0.4,
0.5) band ignored by the focal loss. SmoothL1 (beta 0.11) on boxes in
units of 4 strides, over the positives' count; init weight 0.5, refine 1.
Cells sit at x * stride (offset 0). Decoding: sigmoid(cls), per-level
threshold and top-k, the refined boxes, clipped, class-aware NMS at IoU
0.5. Head outputs NHWC per level; ``neck_feats`` NCHW. Module names are
mmdet's ``reppoints_head.py`` (the point tower ``reg_convs``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.max_iou_assigner import max_iou_assign
from ..core.postprocess import filter_scores_and_topk_mlvl
from ..ops.deform_conv import DeformConv
from .atss import PRIOR_BIAS
from .fpn import FPN, ConvWrap
from .gfl import init_dense
from .gfl_head import cat_levels, level_sizes, nhwc
from .resnet import ResNet
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
NUM_POINTS = 9
BASE_SCALE = 4
GRADIENT_MUL = 0.1
MOMENT_MUL = 0.01


class RepPointsHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, C)
    pts_init: Tuple[torch.Tensor, ...]     # (B, H, W, 18) (dy, dx) pairs
    pts_refine: Tuple[torch.Tensor, ...]   # (B, H, W, 18)


class RepPointsOutputs(NamedTuple):
    head: RepPointsHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]
    moment: torch.Tensor                   # (2,) the moment transfer


class RepPointsHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 3,
                 feat_channels: int = 256, point_feat_channels: int = 256):
        super().__init__()
        C, P = feat_channels, point_feat_channels
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvWrap(C, C, 3, device) for _ in range(stacked_convs)))
        self.reppoints_pts_init_conv = nn.Conv2d(C, P, 3, padding=1,
                                                 device=device)
        self.reppoints_pts_init_out = nn.Conv2d(P, 2 * NUM_POINTS, 1,
                                                device=device)
        self.reppoints_cls_conv = DeformConv(C, C, device)
        self.reppoints_cls_out = nn.Conv2d(C, num_classes, 1, device=device)
        self.reppoints_pts_refine_conv = DeformConv(C, C, device)
        self.reppoints_pts_refine_out = nn.Conv2d(C, 2 * NUM_POINTS, 1,
                                                  device=device)
        # the regular 3x3 grid, (dy, dx) per tap, that the offsets leave
        grid = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], indexing="ij"),
                        -1).reshape(-1)
        self.register_buffer("grid", torch.tensor(grid, dtype=torch.float32,
                                                  device=device),
                             persistent=False)

    def forward(self, feats) -> RepPointsHeadOutputs:
        cls, inits, refines = [], [], []
        for f in feats:
            c = p = f
            for cc, pc in zip(self.cls_convs, self.reg_convs):
                c, p = F.relu(cc(c)), F.relu(pc(p))
            pi = nhwc(self.reppoints_pts_init_out(F.relu(
                self.reppoints_pts_init_conv(p))))
            off = (GRADIENT_MUL * pi + (1 - GRADIENT_MUL) * pi.detach()
                   - self.grid.to(pi.dtype))
            cls.append(nhwc(self.reppoints_cls_out(F.relu(
                self.reppoints_cls_conv(c, off)))))
            refines.append(nhwc(self.reppoints_pts_refine_out(F.relu(
                self.reppoints_pts_refine_conv(p, off)))) + pi.detach())
            inits.append(pi)
        return RepPointsHeadOutputs(tuple(cls), tuple(inits), tuple(refines))


class RepPoints(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_input",
                        relu_before_extra_convs=False)
        self.bbox_head = RepPointsHead(device, num_classes)
        # shared by every level's points2bbox
        self.moment_transfer = nn.Parameter(torch.zeros(2, device=device))

    def forward(self, images, img_hw) -> RepPointsOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return RepPointsOutputs(self.bbox_head(neck), neck,
                                self.moment_transfer)


def points2bbox(pts: torch.Tensor, moment: torch.Tensor) -> torch.Tensor:
    """(..., 18) (dy, dx) points -> (..., 4) moment boxes in the same
    frame: mean -/+ std (ddof 1) x exp(moment), moment = its value with
    0.01 of its gradient."""
    p = pts.reshape(*pts.shape[:-1], NUM_POINTS, 2)
    py, px = p[..., 0], p[..., 1]
    my, mx = py.mean(-1), px.mean(-1)
    sy, sx = py.std(-1), px.std(-1)
    m = moment * MOMENT_MUL + moment.detach() * (1 - MOMENT_MUL)
    hw, hh = sx * torch.exp(m[0]), sy * torch.exp(m[1])
    return torch.stack([mx - hw, my - hh, mx + hw, my + hh], -1)


def reppoints_centers(featmap_sizes, device):
    """Every level's cells at (x, y) x stride (offset 0, mmdet's
    ``MlvlPointGenerator(offset=0.)``) (N, 2), each cell's stride (N,)
    and the per-level counts."""
    pts, strides = [], []
    for (h, w), s in zip(featmap_sizes, STRIDES):
        ys, xs = np.mgrid[:h, :w]
        pts.append(np.stack([xs * s, ys * s], -1).reshape(-1, 2))
        strides.append(np.full((h * w,), s))
    return (torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(
        device), torch.from_numpy(np.concatenate(strides).astype(
            np.float32)).to(device),
        tuple(h * w for h, w in featmap_sizes))


def point_assign(centers, level_counts, gt_bboxes, gt_labels, gt_valid,
                 num_classes: int, scale: int = BASE_SCALE):
    """The point assigner over a batch: each valid GT on the level of
    floor(log2(sqrt(w h) / scale)) - 3 (clipped to the levels) claims its
    cell nearest, first index on ties, under ||(p - c) / (w, h)||; a cell
    claimed twice goes to the GT at the smaller distance, the earlier GT on
    an exact tie. Returns (the assigned GT index or -1 (B, N), positives,
    labels (num_classes where not positive))."""
    B, G = gt_bboxes.shape[:2]
    N = centers.shape[0]
    dev = centers.device
    gw = (gt_bboxes[..., 2] - gt_bboxes[..., 0]).clamp(min=1e-6)
    gh = (gt_bboxes[..., 3] - gt_bboxes[..., 1]).clamp(min=1e-6)
    lvl = (torch.floor(torch.log2(torch.sqrt(gw * gh) / scale)).long()
           - 3).clamp(0, len(level_counts) - 1)
    pl = torch.cat([torch.full((n,), i, device=dev)
                    for i, n in enumerate(level_counts)])
    gcx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
    gcy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
    d = torch.sqrt(((centers[:, 0] - gcx[..., None]) / gw[..., None]) ** 2
                   + ((centers[:, 1] - gcy[..., None]) / gh[..., None])
                   ** 2)                                      # (B, G, N)
    d = torch.where((pl == lvl[..., None]) & gt_valid[..., None], d,
                    torch.full_like(d, float("inf")))
    dmin, nearest = d.min(-1)                                 # first index
    ok = torch.isfinite(dmin) & gt_valid
    # rank GTs by (distance, index), scatter-min each claim's rank into its
    # cell (row N takes the unclaimed), map the winning rank back
    order = torch.sort(dmin, dim=1, stable=True).indices      # rank -> gt
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(G, device=dev).expand(B, G))   # gt -> rank
    best = torch.full((B, N + 1), G, dtype=torch.long, device=dev)
    best.scatter_reduce_(1, torch.where(ok, nearest, N), rank, "amin")
    best = best[:, :N]
    assigned = torch.where(best < G, torch.gather(order, 1, best.clamp(
        max=G - 1)), -1)
    pos = assigned >= 0
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1,
                                           assigned.clamp(min=0)),
                         num_classes)
    return assigned, pos, labels


class RepPointsLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_init_weight: float = 0.5
    loss_refine_weight: float = 1.0
    smooth_beta: float = 0.11
    refine_pos_iou: float = 0.5
    refine_neg_iou: float = 0.4


def _decoded_boxes(pts_flat, centers, strides, moment):
    """(B, N, 18) points in strides -> (B, N, 4) image boxes."""
    boxes = points2bbox(pts_flat * strides[None, :, None], moment)
    return boxes + torch.cat([centers, centers], -1)[None]


def reppoints_assign(out: RepPointsHeadOutputs, moment, gt_bboxes,
                     gt_labels, gt_valid, cfg: RepPointsLossConfig):
    """(the decoded initial and refined boxes, the point assignment
    (assigned, positives), the refined stage's max-IoU result)."""
    centers, strides, counts = reppoints_centers(
        [c.shape[1:3] for c in out.cls_scores], gt_bboxes.device)
    init_boxes = _decoded_boxes(cat_levels(out.pts_init, 2 * NUM_POINTS),
                                centers, strides, moment)
    refine_boxes = _decoded_boxes(cat_levels(out.pts_refine,
                                             2 * NUM_POINTS),
                                  centers, strides, moment)
    a_init, pos_i, _ = point_assign(centers, counts, gt_bboxes, gt_labels,
                                    gt_valid, cfg.num_classes)
    ref = max_iou_assign(init_boxes.detach(), gt_bboxes, gt_labels,
                         gt_valid, cfg.num_classes,
                         pos_iou_thr=cfg.refine_pos_iou,
                         neg_iou_thr=cfg.refine_neg_iou, min_pos_iou=0.0,
                         match_low_quality=True)
    return init_boxes, refine_boxes, strides, (a_init, pos_i), ref


def reppoints_loss(out: RepPointsHeadOutputs, moment, gt_bboxes, gt_labels,
                   gt_valid, cfg: RepPointsLossConfig
                   ) -> Dict[str, torch.Tensor]:
    C = cfg.num_classes
    G = gt_bboxes.shape[1]
    init_boxes, refine_boxes, strides, (a_init, pos_i), ref = \
        reppoints_assign(out, moment, gt_bboxes, gt_labels, gt_valid, cfg)
    norm = (BASE_SCALE * strides)[None, :, None]

    def box_loss(boxes, assigned, pos, weight):
        npos = pos.sum().float().clamp(min=1.0)   # f32, as JAX's
        tgt = torch.gather(gt_bboxes, 1, assigned.clamp(0, G - 1)[
            ..., None].expand(-1, -1, 4))
        w = pos.to(boxes.dtype)[..., None].expand(-1, -1, 4).reshape(-1, 4)
        # divided by the positives' count, not 4x it
        return weight * L.smooth_l1_loss(
            (boxes / norm).reshape(-1, 4), (tgt / norm).reshape(-1, 4),
            weight=w, avg_factor=npos, beta=cfg.smooth_beta)

    pos_r = ref.assigned_gt >= 0
    loss_init = box_loss(init_boxes, a_init, pos_i, cfg.loss_init_weight)
    loss_refine = box_loss(refine_boxes, ref.assigned_gt, pos_r,
                           cfg.loss_refine_weight)
    cls_flat = cat_levels(out.cls_scores, C)
    labels = torch.where(pos_r, torch.gather(
        gt_labels.long(), 1, ref.assigned_gt.clamp(0, G - 1)), C)
    onehot = F.one_hot(labels, C + 1)[..., :C].to(cls_flat.dtype)
    # the [neg, pos) IoU band is ignored
    lw = (ref.assigned_gt != -2).to(cls_flat.dtype)[..., None].expand(
        -1, -1, C).reshape(-1, C)
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot.reshape(-1, C), weight=lw,
        avg_factor=pos_r.sum().float().clamp(min=1.0),
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    return dict(loss_cls=loss_cls, loss_pts_init=loss_init,
                loss_pts_refine=loss_refine)


def reppoints_get_bboxes(out: RepPointsHeadOutputs, moment, img_hw,
                         scale_factor=None, score_thr: float = 0.05,
                         nms_iou: float = 0.5, nms_pre: int = 1000,
                         max_per_img: int = 100, rescale: bool = False
                         ) -> Detections:
    """The refined point sets' moment boxes scored by sigmoid(cls);
    fixed-size detections per image."""
    C = out.cls_scores[0].shape[-1]
    centers, strides, _ = reppoints_centers(
        [c.shape[1:3] for c in out.cls_scores], out.cls_scores[0].device)
    boxes = _decoded_boxes(cat_levels(out.pts_refine, 2 * NUM_POINTS),
                           centers, strides, moment)
    top = filter_scores_and_topk_mlvl(torch.sigmoid(cat_levels(
        out.cls_scores, C)), score_thr, nms_pre,
        level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    return nms_detections(torch.gather(boxes, 1, idx[..., None].expand(
        -1, -1, 4)), top, img_hw, scale_factor, rescale, nms_iou,
        max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_reppoints(model_cfg, device="cuda") -> RepPoints:
    m = model_cfg
    return RepPoints(device, num_classes=m.num_classes, depth=m.depth,
                     frozen_stages=m.frozen_stages)


@torch.no_grad()
def init_reppoints(model: RepPoints, seed: int = 0) -> None:
    """init_dense (normal(0.01) head convs with zero biases, the class
    prior), the two deformable kernels normal(0.01) and the moment
    transfer zero, JAX's scales."""
    init_dense(model, seed, "reppoints_cls_out", PRIOR_BIAS)
    g = torch.Generator().manual_seed(seed + 1)
    for mod in (model.bbox_head.reppoints_cls_conv,
                model.bbox_head.reppoints_pts_refine_conv):
        mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
            0, 0.01, generator=g))
    model.moment_transfer.zero_()


def _register():
    from ..registry import register_family
    from ..utils.weights import reppoints_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = RepPointsLossConfig(num_classes=cfg.model.num_classes)

        # JAX's RepPoints losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            return reppoints_loss(out.head, out.moment, batch.gt_bboxes,
                                  batch.gt_labels, batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            return reppoints_get_bboxes(out.head, out.moment, img_hw,
                                        scale_factor=scale_factors,
                                        score_thr=max(score_thr, 0.05),
                                        max_per_img=max_per_img,
                                        rescale=True)
        return step

    register_family("reppoints", build=build_reppoints,
                    init_weights=init_reppoints,
                    from_jax=reppoints_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
