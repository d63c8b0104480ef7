"""FSAF (port of dskd_tpu/models/fsaf.py ``FSAFHead``, ``FSAF``,
``_shrunk_mask``, ``FSAFLossConfig``, ``fsaf_loss``, ``fsaf_get_bboxes``
and its registry entry ``fsaf``).

The anchor-free branch of Feature-Selective Anchor-Free training: ResNet
-> FPN (C3-C5, P3-P7, the extra convs on the C5 input, no ReLU between
them) -> two towers of 4 x (3x3 conv with bias, ReLU) shared across the
levels -> ``conv_cls`` (C logits a position) and ``conv_reg`` (relu + 1e-4:
l, t, r, b in units of 4 strides from the cell centre). Online feature
selection: each valid GT goes to the one level whose candidate loss, the
mean over the cells of its 0.2-shrunk box of focal loss plus -log IoU on
the current predictions (detached), is least (a level without such a
cell: infinite; the first level among equal ones). There the shrunk box's
cells are its positives (the smaller GT index where two claim a cell), and
the 0.5-shrunk box's other cells are ignored on every level that carries
the GT. Loss: focal loss and -log IoU, each summed per level over all
images and divided by the summed positives. Decoding: sigmoid(cls),
per-level threshold and top-k, clipped, class-aware NMS at IoU 0.5.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.boxes import bbox_overlaps
from ..core.postprocess import filter_scores_and_topk_mlvl
from .atss import PRIOR_BIAS
from .fpn import FPN, ConvWrap
from .gfl import init_dense
from .gfl_head import cat_levels, level_sizes, nhwc
from .resnet import ResNet
from .yolof_head import Detections, nms_detections

STRIDES = (8, 16, 32, 64, 128)
EPS_EFF = 0.2     # the positives' shrink ratio
EPS_IGN = 0.5     # the ignored ring's shrink ratio


class FSAFHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]   # per level (B, H, W, 4)


class FSAFOutputs(NamedTuple):
    head: FSAFHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


class FSAFHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, stacked_convs: int = 4,
                 feat_channels: int = 256):
        super().__init__()
        C = feat_channels
        for prefix in ("cls", "reg"):
            self.add_module(f"{prefix}_convs", nn.ModuleList(
                ConvWrap(C, C, 3, device) for _ in range(stacked_convs)))
        self.conv_cls = nn.Conv2d(C, num_classes, 3, padding=1, device=device)
        self.conv_reg = nn.Conv2d(C, 4, 3, padding=1, device=device)

    def forward(self, feats) -> FSAFHeadOutputs:
        cls, reg = [], []
        for f in feats:
            c = r = f
            for cc, rc in zip(self.cls_convs, self.reg_convs):
                c, r = F.relu(cc(c)), F.relu(rc(r))
            cls.append(nhwc(self.conv_cls(c)))
            # relu + 1e-4 keeps the distances positive
            reg.append(nhwc(F.relu(self.conv_reg(r)) + 1e-4))
        return FSAFHeadOutputs(tuple(cls), tuple(reg))


class FSAF(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_input",
                        relu_before_extra_convs=False)
        self.bbox_head = FSAFHead(device, num_classes)

    def forward(self, images, img_hw) -> FSAFOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return FSAFOutputs(self.bbox_head(neck), neck)


def cell_centres(h: int, w: int, stride: int, like: torch.Tensor):
    """(ys (h,), xs (w,)) of the cell centres (i + 0.5) x stride, f32."""
    kw = dict(dtype=torch.float32, device=like.device)
    return ((torch.arange(h, **kw) + 0.5) * stride,
            (torch.arange(w, **kw) + 0.5) * stride)


def _shrunk_mask(h: int, w: int, stride: int, gt: torch.Tensor,
                 ratio: float) -> torch.Tensor:
    """(..., G, 4) GT -> (..., G, h, w) bool: the cell centres inside the
    ``ratio``-shrunk boxes."""
    ys, xs = cell_centres(h, w, stride, gt)
    cx = (gt[..., 0] + gt[..., 2]) / 2
    cy = (gt[..., 1] + gt[..., 3]) / 2
    gw = (gt[..., 2] - gt[..., 0]) * ratio / 2
    gh = (gt[..., 3] - gt[..., 1]) * ratio / 2
    inx = (xs >= (cx - gw)[..., None]) & (xs <= (cx + gw)[..., None])
    iny = (ys >= (cy - gh)[..., None]) & (ys <= (cy + gh)[..., None])
    return iny[..., :, None] & inx[..., None, :]


def level_boxes(reg: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, h, w, 4) predictions -> (B, h*w, 4) xyxy boxes: the distances
    are in units of 4 strides (TBLR's normalizer 4 on a stride-sized
    prior)."""
    B, h, w, _ = reg.shape
    ys, xs = cell_centres(h, w, stride, reg)
    px = xs[None, :].expand(h, w).reshape(-1)
    py = ys[:, None].expand(h, w).reshape(-1)
    d = reg.reshape(B, -1, 4) * (4.0 * stride)
    return torch.stack([px - d[..., 0], py - d[..., 1],
                        px + d[..., 2], py + d[..., 3]], dim=-1)


class FSAFLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0


def fsaf_select_levels(out: FSAFHeadOutputs, gt_bboxes, gt_labels,
                       gt_valid, cfg: FSAFLossConfig):
    """The online feature selection: (candidate losses (L, B, G), each
    GT's level (B, G), whether it has one (B, G), and per level (effective
    mask, ignore mask) each (B, G, h*w) and the boxes (B, h*w, 4))."""
    C = cfg.num_classes
    B, G = gt_bboxes.shape[:2]
    safe_lbl = gt_labels.long().clamp(0, C - 1)
    vmask = gt_valid[..., None]
    cand, levels = [], []
    for lvl, (cs, rs) in enumerate(zip(out.cls_scores, out.bbox_preds)):
        h, w = cs.shape[1:3]
        stride = STRIDES[lvl]
        eff = (_shrunk_mask(h, w, stride, gt_bboxes, EPS_EFF)
               .reshape(B, G, -1) & vmask)
        ign = (_shrunk_mask(h, w, stride, gt_bboxes, EPS_IGN)
               .reshape(B, G, -1) & vmask)
        boxes = level_boxes(rs, stride)
        with torch.no_grad():
            p = torch.sigmoid(cs.reshape(B, h * w, C))
            pg = torch.gather(p, 2, safe_lbl[:, None, :].expand(
                B, h * w, G)).transpose(1, 2)               # (B, G, hw)
            focal = (-cfg.focal_alpha * (1 - pg) ** cfg.focal_gamma
                     * torch.log(pg.clamp(min=1e-8)))
            ious = bbox_overlaps(boxes, gt_bboxes).transpose(1, 2)
            iou_l = -torch.log(ious.clamp(min=1e-8))
            n_eff = eff.sum(2).to(torch.float32).clamp(min=1.0)
            c = ((focal + iou_l) * eff).sum(2) / n_eff
            c = torch.where(eff.any(2), c, torch.full_like(c, float("inf")))
        cand.append(c)
        levels.append((eff, ign, boxes))
    cand = torch.stack(cand)                                 # (L, B, G)
    sel = cand.argmin(0)                                     # the first
    has_level = torch.isfinite(cand.amin(0)) & gt_valid
    return cand, sel, has_level, levels


def fsaf_loss(out: FSAFHeadOutputs, gt_bboxes, gt_labels, gt_valid,
              cfg: FSAFLossConfig) -> Dict[str, torch.Tensor]:
    C = cfg.num_classes
    B, G = gt_bboxes.shape[:2]
    safe_lbl = gt_labels.long().clamp(0, C - 1)
    _, sel, has_level, levels = fsaf_select_levels(out, gt_bboxes, gt_labels,
                                                   gt_valid, cfg)
    # the smaller GT index wins a cell that two claim
    rank = torch.arange(G, 0, -1, device=gt_bboxes.device)[:, None]
    loss_cls = loss_bbox = 0.0
    num_pos = 0.0
    for lvl, (cs, (eff, ign, boxes)) in enumerate(zip(out.cls_scores,
                                                      levels)):
        pos = eff & ((sel == lvl) & has_level)[..., None]    # (B, G, hw)
        pos_any = pos.any(1)
        best = (pos * rank).argmax(1)                        # (B, hw)
        lbl = torch.where(pos_any, torch.gather(safe_lbl, 1, best), C)
        ignore = ign.any(1) & ~pos_any
        wgt = (~ignore).to(cs.dtype)
        onehot = F.one_hot(lbl, C + 1)[..., :C].to(cs.dtype)
        loss_cls = loss_cls + L.sigmoid_focal_loss(
            cs.reshape(-1, C), onehot.reshape(-1, C),
            weight=wgt.reshape(-1, 1), avg_factor=1.0,
            gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
        tgt = torch.gather(gt_bboxes, 1, best[..., None].expand(-1, -1, 4))
        # -log IoU, the metric the selection takes
        loss_bbox = loss_bbox + L.iou_loss(
            boxes.reshape(-1, 4), tgt.reshape(-1, 4), linear=False,
            weight=pos_any.reshape(-1).to(boxes.dtype), avg_factor=1.0)
        num_pos = num_pos + pos_any.sum().to(torch.float32)
    denom = torch.as_tensor(num_pos).clamp(min=1.0)
    return dict(loss_cls=cfg.loss_cls_weight * loss_cls / denom,
                loss_bbox=cfg.loss_bbox_weight * loss_bbox / denom)


def fsaf_get_bboxes(out: FSAFHeadOutputs, img_hw, scale_factor=None,
                    score_thr: float = 0.05, nms_iou: float = 0.5,
                    nms_pre: int = 1000, max_per_img: int = 100,
                    rescale: bool = False) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    position)."""
    C = out.cls_scores[0].shape[-1]
    boxes = torch.cat([level_boxes(rs, STRIDES[lvl])
                       for lvl, rs in enumerate(out.bbox_preds)], 1)
    top = filter_scores_and_topk_mlvl(torch.sigmoid(cat_levels(
        out.cls_scores, C)), score_thr, nms_pre,
        level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    sel = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return nms_detections(sel, top, img_hw, scale_factor, rescale, nms_iou,
                          max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_fsaf(model_cfg, device="cuda") -> FSAF:
    m = model_cfg
    return FSAF(device, num_classes=m.num_classes, depth=m.depth,
                frozen_stages=m.frozen_stages)


def init_fsaf(model: FSAF, seed: int = 0) -> None:
    init_dense(model, seed, "conv_cls", PRIOR_BIAS)


def _register():
    from ..registry import register_family
    from ..utils.weights import fsaf_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = FSAFLossConfig(num_classes=cfg.model.num_classes)

        # JAX's FSAF losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            return fsaf_loss(out.head, batch.gt_bboxes, batch.gt_labels,
                             batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            return fsaf_get_bboxes(out.head, img_hw,
                                   scale_factor=scale_factors,
                                   score_thr=max(score_thr, 0.05),
                                   max_per_img=max_per_img, rescale=True)
        return step

    register_family("fsaf", build=build_fsaf, init_weights=init_fsaf,
                    from_jax=fsaf_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
