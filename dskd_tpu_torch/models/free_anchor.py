"""FreeAnchor (port of dskd_tpu/models/free_anchor.py
``FreeAnchorLossConfig``, ``free_anchor_loss`` and its registry entry
``free_anchor``).

The RetinaNet trunk and head (``models/retinanet.py``), trained by
maximum-likelihood bag losses in place of a hard assignment:
  * the positive bag of each valid GT is its 50 anchors of highest IoU
    (the lower index first among equal IoUs, as JAX's ``top_k``); the
    bag's mean-max of P(class) x exp(-0.75 x smooth-L1 of the deltas) is
    trained towards 1 (alpha 0.5, over the valid GTs);
  * every (anchor, class) is also a negative, weighted by 1 - P(anchor in
    A+): that probability ramps the IoU of the anchor's decoded box
    (detached) with the GTs of that class from 0.6 to each GT's best IoU,
    and takes the largest over them (focal gamma 2, over the valid GTs x
    50).
The deltas decode and encode at stds (0.1, 0.1, 0.2, 0.2), the config's
coder. JAX forms P(anchor in A+) as a (G, N, C) broadcast and its max
over G (1.6e9 values an image at 100 GTs on 800x1344); the port scatters
each GT's ramp into its class column by max, which gives the same values.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core.anchors import bbox2delta, delta2bbox
from ..core.boxes import bbox_overlaps
from .gfl_head import cat_levels
from .retinanet import (build_retinanet, init_retinanet, retina_anchors,
                        retina_get_bboxes)

EPS = 1e-12
PRE_ANCHOR_TOPK = 50
BBOX_THR = 0.6
DELTA_STDS = (0.1, 0.1, 0.2, 0.2)


class FreeAnchorLossConfig(NamedTuple):
    num_classes: int = 80
    alpha: float = 0.5
    gamma: float = 2.0
    smooth_beta: float = 0.11
    reg_weight: float = 0.75


def box_prob(obp: torch.Tensor, labels: torch.Tensor,
             num_classes: int) -> torch.Tensor:
    """(B, G, N) ramps of each GT, (B, G) labels (the invalid GTs' ramps
    0) -> (B, N, C): for each class the largest ramp of its GTs, 0 where
    it has none."""
    B, G, N = obp.shape
    out = obp.new_zeros(B, N, num_classes)
    return out.scatter_reduce(2, labels[:, None, :].expand(B, N, G),
                              obp.transpose(1, 2), "amax")


@torch.no_grad()
def positive_probs(anchors, deltas, gt_bboxes, gt_labels, gt_valid,
                   num_classes: int) -> torch.Tensor:
    """P(anchor in A+) of each (anchor, class), (B, N, C), detached: the
    IoU of each decoded box with each valid GT ramped from BBOX_THR (0) to
    the GT's best IoU (1), the largest over the GTs of the class."""
    gv = gt_valid[..., None]
    pred_boxes = delta2bbox(anchors[None], deltas, stds=DELTA_STDS)
    obi = bbox_overlaps(gt_bboxes, pred_boxes)               # (B, G, N)
    obi = torch.where(gv, obi, torch.zeros_like(obi))
    # f32 rounds BBOX_THR + 1e-12 to 0.6, as JAX's does
    t2 = obi.amax(2, keepdim=True).clamp(min=BBOX_THR + 1e-12)
    obp = ((obi - BBOX_THR) / (t2 - BBOX_THR)).clamp(0.0, 1.0)
    obp = torch.where(gv, obp, torch.zeros_like(obp))
    return box_prob(obp, gt_labels.long().clamp(0, num_classes - 1),
                    num_classes)


def bag_quality(anchors, gt_bboxes, gt_valid) -> torch.Tensor:
    """(B, G, N): each valid GT's IoU with each anchor, -1 for the
    others."""
    B, N = gt_bboxes.shape[0], anchors.shape[0]
    q = bbox_overlaps(gt_bboxes, anchors[None].expand(B, N, 4))
    return torch.where(gt_valid[..., None], q, torch.full_like(q, -1.0))


def bag_anchors(quality: torch.Tensor, k: int) -> torch.Tensor:
    """(B, G, N) -> the k anchors of highest quality per GT, the lower
    index first among equal ones."""
    return torch.sort(quality, dim=2, descending=True,
                      stable=True)[1][..., :k]


def free_anchor_loss(out, anchors, gt_bboxes, gt_labels, gt_valid,
                     cfg: FreeAnchorLossConfig) -> Dict[str, torch.Tensor]:
    """out: RetinaHeadOutputs; anchors (N, 4); gt_* (B, G, ...) padded."""
    C = cfg.num_classes
    cls_flat = cat_levels(out.cls_scores, C)                 # (B, N, C)
    deltas = cat_levels(out.bbox_preds, 4)
    B, N, _ = cls_flat.shape
    G = gt_bboxes.shape[1]
    K = min(PRE_ANCHOR_TOPK, N)
    safe_lbl = gt_labels.long().clamp(0, C - 1)
    cls_prob = torch.sigmoid(cls_flat)
    prob = positive_probs(anchors, deltas, gt_bboxes, gt_labels, gt_valid,
                          C)

    # ---- positive bags ----
    matched = bag_anchors(bag_quality(anchors, gt_bboxes, gt_valid), K)
    m_cls = torch.gather(cls_prob.reshape(B, N * C), 1, (
        matched * C + safe_lbl[..., None]).reshape(B, G * K)).reshape(
        B, G, K)
    m_anchors = anchors[matched]                             # (B, G, K, 4)
    m_targets = bbox2delta(m_anchors, gt_bboxes[:, :, None].expand_as(
        m_anchors), stds=DELTA_STDS)
    m_preds = torch.gather(deltas, 1, matched.reshape(B, G * K, 1).expand(
        B, G * K, 4)).reshape(B, G, K, 4)
    diff = (m_preds - m_targets).abs()
    sl1 = torch.where(diff < cfg.smooth_beta,
                      0.5 * diff ** 2 / cfg.smooth_beta,
                      diff - 0.5 * cfg.smooth_beta)
    m_prob = m_cls * torch.exp(-cfg.reg_weight * sl1.sum(-1))
    w = 1.0 / (1.0 - m_prob).clamp(min=EPS)
    w = w / w.sum(2, keepdim=True)
    bag = (w * m_prob).sum(2).clamp(EPS, 1 - EPS)           # (B, G)
    pos = cfg.alpha * torch.where(gt_valid, -torch.log(bag),
                                  torch.zeros_like(bag))

    # ---- negatives ----
    nprob = (cls_prob * (1 - prob)).clamp(EPS, 1 - EPS)
    neg = ((1 - cfg.alpha) * (nprob ** cfg.gamma)
           * (-torch.log(1 - nprob)))
    num_pos = gt_valid.sum().to(torch.float32).clamp(min=1.0)
    return dict(positive_bag_loss=pos.sum() / num_pos,
                negative_bag_loss=neg.sum() / (num_pos * K))


# --- family registration (dskd_tpu_torch/registry.py) ----------------------

def _register():
    from ..registry import register_family
    from ..utils.weights import retinanet_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = FreeAnchorLossConfig(num_classes=cfg.model.num_classes)

        # JAX's FreeAnchor losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            out = model(batch.images, batch.img_hw)
            anchors = retina_anchors(
                [c.shape[1:3] for c in out.head.cls_scores],
                batch.images.device)
            return free_anchor_loss(out.head, anchors, batch.gt_bboxes,
                                    batch.gt_labels, batch.gt_valid, det_cfg)
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
                                     max_per_img=max_per_img, rescale=True,
                                     delta_stds=DELTA_STDS)
        return step

    register_family("free_anchor", build=build_retinanet,
                    init_weights=init_retinanet,
                    from_jax=retinanet_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
