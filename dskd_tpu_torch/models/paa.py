"""PAA and LAD (port of dskd_tpu/models/paa.py ``PAAHead``, ``PAA``,
``paa_anchors``, ``gmm_split``, ``PAALossConfig``, ``paa_loss``,
``score_voting``, ``paa_get_bboxes`` and its registry entries ``paa`` and
``lad``).

ResNet -> FPN (C3-C5, P3-P7, extra convs on the output with a ReLU
between them) -> two towers of 4 x (conv, GroupNorm(32), ReLU) shared
across the levels; ``paa_cls`` on the cls tower, ``paa_reg`` (deltas,
times a per-level ``Scale``) and ``paa_iou`` on the reg tower. One square
anchor of 8 strides per position.

Probabilistic anchor assignment: each GT's candidates are the 9 anchors of
each level with the lowest detached loss (focal of its class + 1.3 x
(1 - GIoU)), anchors whose centre lies outside the GT scoring 1e8; a
two-component 1-D Gaussian mixture, fitted by 10 fixed EM iterations from
the candidates' lowest and highest loss, splits them, and every candidate
whose loss is at or below the loss of the foreground component's
likelihood peak becomes positive (scheme (c)). An anchor positive for
several GT goes to the last of them. Losses: focal over every anchor,
GIoU on the positives weighted by their detached IoU and normalised by its
sum, BCE of the IoU branch against that IoU. Decoding: sqrt(sigmoid(cls)
x sigmoid(iou)), per-level threshold and top-k, class-aware NMS at 0.6,
then score voting over the top-k candidates. LAD (``assign_out``) picks
the positives from a frozen teacher's head outputs and trains the student
on its own losses under them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.anchors import delta2bbox
from ..core.boxes import bbox_clip, bbox_overlaps
from ..core.postprocess import batched_nms, filter_scores_and_topk_mlvl
from .atss import DELTA_STDS, PRIOR_BIAS, atss_anchors
from .fpn import FPN
from .gfl import init_dense
from .gfl_head import ConvGN, Scale, cat_levels, level_sizes, nhwc, tower
from .resnet import ResNet
from .yolof_head import Detections

TOPK_PER_LEVEL = 9
EM_ITERS = 10


class PAAHeadOutputs(NamedTuple):
    cls_scores: Tuple[torch.Tensor, ...]   # per level (B, H, W, C)
    bbox_preds: Tuple[torch.Tensor, ...]   # per level (B, H, W, 4) deltas
    iou_preds: Tuple[torch.Tensor, ...]    # per level (B, H, W, 1)


class PAAOutputs(NamedTuple):
    head: PAAHeadOutputs
    neck_feats: Tuple[torch.Tensor, ...]


class PAAHead(nn.Module):
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

        self.paa_cls = conv(num_classes)
        self.paa_reg = conv(4)
        self.paa_iou = conv(1)
        self.scales = nn.ModuleList(Scale(device) for _ in range(num_levels))

    def forward(self, feats) -> PAAHeadOutputs:
        cls, reg, iou = [], [], []
        for lvl, f in enumerate(feats):
            c, r = tower(self.cls_convs, f), tower(self.reg_convs, f)
            cls.append(nhwc(self.paa_cls(c)))
            reg.append(nhwc(self.scales[lvl](self.paa_reg(r))))
            iou.append(nhwc(self.paa_iou(r)))
        return PAAHeadOutputs(tuple(cls), tuple(reg), tuple(iou))


class PAA(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(0, 1, 2, 3),
                               frozen_stages=frozen_stages)
        self.neck = FPN(self.backbone.out_channels, device, start_level=1,
                        add_extra_convs="on_output",
                        relu_before_extra_convs=True)
        self.bbox_head = PAAHead(device, num_classes)

    def forward(self, images, img_hw) -> PAAOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return PAAOutputs(self.bbox_head(neck), neck)


def paa_anchors(featmap_sizes, device):
    """One square anchor of 8 strides per position (ATSS's): (anchors
    (N, 4), per-level counts)."""
    return atss_anchors(featmap_sizes, device)


def _log_joint(s, mu, var, pi):
    """(..., K, 2) log pi_k N(s; mu_k, var_k)."""
    return (-0.5 * (s[..., None] - mu[..., None, :]) ** 2 / var[..., None, :]
            - 0.5 * torch.log(2 * torch.pi * var[..., None, :])
            + torch.log(pi[..., None, :].clamp(min=1e-8)))


def gmm_split(scores, valid, iters: int = EM_ITERS):
    """(..., K) candidate losses (lower is better) and their validity ->
    the (..., K) positive mask: a two-component Gaussian mixture fitted by
    ``iters`` EM iterations from means (min, max), variances 1 and equal
    weights; every valid candidate whose loss is at or below the loss of
    the low-mean component's member with the highest mixture likelihood
    (none if that component has no member)."""
    big = 1e8
    s = torch.where(valid, scores, torch.full_like(scores, big))
    smin = torch.where(valid, s, torch.full_like(s, big)).amin(-1)
    smax = torch.where(valid, s, torch.full_like(s, -big)).amax(-1)
    mu = torch.stack([smin, smax], -1)
    var = torch.ones_like(mu)
    pi = torch.full_like(mu, 0.5)
    for _ in range(iters):
        r = torch.softmax(_log_joint(s, mu, var, pi), -1)
        r = torch.where(valid[..., None], r, torch.zeros_like(r))
        nk = r.sum(-2).clamp(min=1e-6)
        mu = (r * s[..., None]).sum(-2) / nk
        var = ((r * (s[..., None] - mu[..., None, :]) ** 2).sum(-2)
               / nk).clamp(min=1e-4)
        pi = nk / nk.sum(-1, keepdim=True).clamp(min=1e-6)
    logp = _log_joint(s, mu, var, pi)
    comp = logp.argmax(-1)
    lo = mu.argmin(-1)
    fg = valid & (comp == lo[..., None])
    ll = torch.logsumexp(logp, -1)
    ll_fg = torch.where(fg, ll, torch.full_like(ll, -float("inf")))
    peak_loss = torch.gather(s, -1, ll_fg.argmax(-1, keepdim=True))
    return valid & fg.any(-1, keepdim=True) & (s <= peak_loss)


class PAALossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.3
    loss_iou_weight: float = 0.5


def paa_candidates(cls_flat, decoded, anchors, level_counts, gt_bboxes,
                   gt_labels, gt_valid, cfg: PAALossConfig):
    """Each GT's candidates from (B, N, C) logits and (B, N, 4) decoded
    boxes (both detached here): the (B, G, K) anchor indices, each level's
    9 lowest losses in ascending order, and their losses, 1e8 where the
    anchor's centre lies outside the GT (or the GT is padding)."""
    C = cfg.num_classes
    B, N = cls_flat.shape[:2]
    G = gt_bboxes.shape[1]
    safe_lbl = gt_labels.long().clamp(0, C - 1)
    p = torch.gather(torch.sigmoid(cls_flat.detach()), 2,
                     safe_lbl[:, None, :].expand(B, N, G))     # (B, N, G)
    focal = -cfg.focal_alpha * (1 - p) ** cfg.focal_gamma * torch.log(
        p.clamp(min=1e-8))
    giou = 1 - bbox_overlaps(decoded.detach(), gt_bboxes, mode="giou")
    score = focal + cfg.loss_bbox_weight * giou
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gb = gt_bboxes[:, None]                                   # (B, 1, G, 4)
    inside = ((acx[None, :, None] > gb[..., 0])
              & (acx[None, :, None] < gb[..., 2])
              & (acy[None, :, None] > gb[..., 1])
              & (acy[None, :, None] < gb[..., 3])) & gt_valid[:, None]
    score = torch.where(inside, score, torch.full_like(score, 1e8))

    # each level's 9 lowest per GT, ties to the lower index (lax.top_k's
    # order), by a stable sort
    cand_idx, cand_score = [], []
    start = 0
    for n in level_counts:
        kk = min(TOPK_PER_LEVEL, n)
        seg = score[:, start:start + n].transpose(1, 2)       # (B, G, n)
        vals, idx = torch.sort(seg, dim=-1, stable=True)
        cand_idx.append(idx[..., :kk] + start)
        cand_score.append(vals[..., :kk])
        start += n
    return torch.cat(cand_idx, -1), torch.cat(cand_score, -1)


def paa_assign(cls_flat, decoded, anchors, level_counts, gt_bboxes,
               gt_labels, gt_valid, cfg: PAALossConfig):
    """The GMM assignment of (B, N, C) logits and (B, N, 4) decoded boxes
    (both detached here): (assigned GT index or -1, positive mask,
    labels with background C), each (B, N)."""
    C = cfg.num_classes
    B, N = cls_flat.shape[:2]
    G = gt_bboxes.shape[1]
    cand_idx, cand_score = paa_candidates(cls_flat, decoded, anchors,
                                          level_counts, gt_bboxes, gt_labels,
                                          gt_valid, cfg)
    is_pos = gmm_split(cand_score, cand_score < 1e7)

    # anchor -> GT, the later GT winning (JAX's scatter order): a scatter-
    # max of the GT index; N is the drop slot
    flat_idx = torch.where(is_pos, cand_idx, torch.full_like(cand_idx, N))
    gt_of = torch.arange(G, device=cls_flat.device)[None, :, None].expand_as(
        cand_idx)
    assigned = torch.full((B, N + 1), -1, dtype=torch.long,
                          device=cls_flat.device).scatter_reduce(
        1, flat_idx.reshape(B, -1), gt_of.reshape(B, -1), reduce="amax")
    assigned = assigned[:, :N]
    pos = assigned >= 0
    safe_lbl = gt_labels.long().clamp(0, C - 1)
    labels = torch.where(pos, torch.gather(safe_lbl, 1, assigned.clamp(
        0, G - 1)), torch.full_like(assigned, C))
    return assigned, pos, labels


def paa_loss(out: PAAHeadOutputs, anchors, level_counts, gt_bboxes,
             gt_labels, gt_valid, cfg: PAALossConfig,
             assign_out: PAAHeadOutputs = None) -> Dict[str, torch.Tensor]:
    """Focal, GIoU and IoU-branch losses under the GMM assignment of the
    student's own outputs or, with ``assign_out``, a frozen teacher's
    (LAD)."""
    C = cfg.num_classes
    G = gt_bboxes.shape[1]
    cls_flat = cat_levels(out.cls_scores, C)
    reg_flat = cat_levels(out.bbox_preds, 4)
    iou_flat = cat_levels(out.iou_preds, 1)[..., 0]
    decoded = delta2bbox(anchors[None], reg_flat, stds=DELTA_STDS)
    if assign_out is None:
        a_cls, a_dec = cls_flat, decoded
    else:
        a_cls = cat_levels(assign_out.cls_scores, C)
        a_dec = delta2bbox(anchors[None], cat_levels(assign_out.bbox_preds,
                                                     4), stds=DELTA_STDS)
    assigned, pos, labels = paa_assign(a_cls, a_dec, anchors, level_counts,
                                       gt_bboxes, gt_labels, gt_valid, cfg)
    num_pos = pos.sum().to(cls_flat.dtype).clamp(min=1.0)
    tgt = torch.gather(gt_bboxes, 1, assigned.clamp(0, G - 1)[..., None]
                       .expand(-1, -1, 4))
    onehot = F.one_hot(labels, C + 1)[..., :C].to(cls_flat.dtype)
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot.reshape(-1, C), avg_factor=num_pos,
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    posf = pos.to(cls_flat.dtype)
    ious = bbox_overlaps(decoded.detach(), tgt, is_aligned=True)
    # GIoU weighted by each positive's detached IoU, over the IoU sum
    w_iou = (ious.clamp(min=1e-6) * posf).reshape(-1)
    loss_bbox = cfg.loss_bbox_weight * L.giou_loss(
        decoded.reshape(-1, 4), tgt.reshape(-1, 4), weight=w_iou,
        avg_factor=w_iou.sum().clamp(min=1e-6))
    loss_iou = cfg.loss_iou_weight * L.bce_loss(
        iou_flat.reshape(-1), torch.where(pos, ious, torch.zeros_like(ious))
        .reshape(-1), weight=posf.reshape(-1), avg_factor=num_pos)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_iou=loss_iou)


def score_voting(det_boxes, det_labels, cand_boxes, cand_probs,
                 score_thr: float = 0.05):
    """Each (B, R) detection's box becomes the exp(-(1 - IoU)^2 / 0.025)
    x score weighted mean of the (B, N) candidates of its class with IoU >
    0.01 and score > ``score_thr`` (kept as it is where none is);
    cand_probs (B, N, C)."""
    ious = bbox_overlaps(det_boxes, cand_boxes)                # (B, R, N)
    lab = det_labels.long().clamp(0, cand_probs.shape[-1] - 1)
    sc = torch.gather(cand_probs.transpose(1, 2), 1,
                      lab[..., None].expand(-1, -1, cand_probs.shape[1]))
    w = torch.exp(-((1.0 - ious) ** 2) / 0.025) * sc
    w = torch.where((ious > 0.01) & (sc > score_thr), w, torch.zeros_like(w))
    total = w.sum(-1, keepdim=True)
    voted = (w[..., None] * cand_boxes[:, None]).sum(2) / total.clamp(
        min=1e-12)
    return torch.where(total > 0, voted, det_boxes)


def paa_get_bboxes(out: PAAHeadOutputs, anchors, img_hw, scale_factor=None,
                   score_thr: float = 0.05, nms_iou: float = 0.6,
                   nms_pre: int = 1000, max_per_img: int = 100,
                   rescale: bool = False,
                   with_score_voting: bool = True) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    anchor), voted over the top-k candidates' clipped boxes."""
    C = out.cls_scores[0].shape[-1]
    probs = torch.sqrt((torch.sigmoid(cat_levels(out.cls_scores, C))
                        * torch.sigmoid(cat_levels(out.iou_preds, 1)))
                       .clamp(min=1e-12))
    top = filter_scores_and_topk_mlvl(probs, score_thr, nms_pre,
                                      level_sizes(out.cls_scores, C))
    idx = top.keep_idxs.long()
    deltas = torch.gather(cat_levels(out.bbox_preds, 4), 1,
                          idx[..., None].expand(-1, -1, 4))
    hw = img_hw.to(deltas.dtype)
    boxes = bbox_clip(delta2bbox(anchors[idx], deltas, stds=DELTA_STDS),
                      (hw[:, 0, None], hw[:, 1, None]))
    res = batched_nms(boxes, top.scores, top.labels, nms_iou, max_per_img,
                      valid=top.valid)
    bboxes = res.bboxes
    if with_score_voting:
        cand_probs = torch.gather(probs, 1, idx[..., None].expand(-1, -1, C))
        cand_probs = torch.where(top.valid[..., None], cand_probs,
                                 torch.zeros_like(cand_probs))
        bboxes = score_voting(bboxes, res.labels, boxes, cand_probs,
                              score_thr)
    if rescale and scale_factor is not None:
        bboxes = bboxes / scale_factor[:, None, :]
    qid = torch.gather(top.keep_idxs, 1, res.src_idx)
    return Detections(bboxes, res.scores, res.labels, res.keep, qid)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_paa(model_cfg, device="cuda") -> PAA:
    m = model_cfg
    return PAA(device, num_classes=m.num_classes, depth=m.depth,
               frozen_stages=m.frozen_stages)


def init_paa(model: PAA, seed: int = 0) -> None:
    init_dense(model, seed, "paa_cls", PRIOR_BIAS)


def paa_losses_fn(det_cfg: PAALossConfig, lad: bool):
    """``losses_fn(model, batch, teacher, generator)``: PAA's losses under
    the model's own assignment, or LAD's under the frozen ``teacher``'s
    (required)."""
    def losses_fn(model, batch, teacher, generator):
        out = model(batch.images, batch.img_hw)
        anchors, counts = paa_anchors(
            [c.shape[1:3] for c in out.head.cls_scores], batch.images.device)
        assign_out = None
        if lad:
            if teacher is None:
                raise ValueError("arch 'lad' needs a frozen teacher (an "
                                 "external teacher_ckpt for its first "
                                 "task)")
            with torch.no_grad():
                assign_out = teacher(batch.images, batch.img_hw).head
        return paa_loss(out.head, anchors, counts, batch.gt_bboxes,
                        batch.gt_labels, batch.gt_valid, det_cfg,
                        assign_out=assign_out)
    return losses_fn


def _register():
    from ..registry import register_family
    from ..utils.weights import paa_state_dict_from_jax

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors):
            out = model(images, img_hw)
            anchors, _ = paa_anchors(
                [c.shape[1:3] for c in out.head.cls_scores], images.device)
            return paa_get_bboxes(out.head, anchors, img_hw,
                                  scale_factor=scale_factors,
                                  score_thr=max(score_thr, 0.05),
                                  max_per_img=max_per_img, rescale=True)
        return step

    for name in ("paa", "lad"):
        def losses(model, cfg, *, num_prev, has_teacher, use_dropout,
                   _lad=name == "lad"):
            return paa_losses_fn(
                PAALossConfig(num_classes=cfg.model.num_classes), _lad)

        register_family(name, build=build_paa, init_weights=init_paa,
                        from_jax=paa_state_dict_from_jax, losses=losses,
                        eval_step=eval_step)


_register()
