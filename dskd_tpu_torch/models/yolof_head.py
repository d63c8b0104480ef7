"""YOLOF's head: forward, detection loss and box decoding (port of
dskd_tpu/models/yolof_head.py ``YOLOFHead``, ``yolof_anchors``,
``YOLOFLossConfig``, ``yolof_detection_loss`` and ``yolof_get_bboxes``).

Forward: a cls subnet (2 x conv + BN + ReLU) -> A*C scores and a reg subnet
(4 x conv + BN + ReLU) -> A*4 deltas and A implicit objectness logits; the
normalised score is cls + obj - log(1 + exp(cls) + exp(obj)), each exp
clamped at 1e8. Outputs are NHWC, as JAX's, so flattening to (B, HWA, C)
gives the anchors' row-major (y, x, anchor) order. Loss: uniform matching,
sigmoid focal loss over every anchor with ignore weights, GIoU on the
(2k x G) candidates. Decoding: score threshold, top-k, ``delta2bbox`` with
the centre clamp, boxes clipped to the image, class-aware NMS.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.anchors import base_anchors, delta2bbox, grid_anchors
from ..core.boxes import bbox_clip
from ..core.postprocess import batched_nms, filter_scores_and_topk
from ..core.uniform_assigner import uniform_assign
from .dilated_encoder import ConvModule

INF = 1e8


class YOLOFHeadOutputs(NamedTuple):
    cls_scores: torch.Tensor   # (B, H, W, A*C) normalised logits
    bbox_preds: torch.Tensor   # (B, H, W, A*4) deltas
    feat_hw: Tuple[int, int]


class Detections(NamedTuple):
    """Fixed-size detections of a dense head: (B, max_per_img) rows,
    ``keep_qid`` the flat position (anchor or prior) of each."""
    bboxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    keep_qid: torch.Tensor


class YOLOFHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, in_channels: int = 512,
                 num_cls_convs: int = 2, num_reg_convs: int = 4,
                 num_anchors: int = 5):
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, num_anchors
        self.cls_subnet = nn.ModuleList(
            ConvModule(in_channels, in_channels, 3, device)
            for _ in range(num_cls_convs))
        self.bbox_subnet = nn.ModuleList(
            ConvModule(in_channels, in_channels, 3, device)
            for _ in range(num_reg_convs))

        def conv(cout):
            return nn.Conv2d(in_channels, cout, 3, padding=1, device=device)

        self.cls_score = conv(num_anchors * num_classes)
        self.bbox_pred = conv(num_anchors * 4)
        self.object_pred = conv(num_anchors)

    def forward(self, feat: torch.Tensor) -> YOLOFHeadOutputs:
        A, C = self.num_anchors, self.num_classes
        x = feat
        for m in self.cls_subnet:
            x = m(x)
        y = feat
        for m in self.bbox_subnet:
            y = m(y)
        B, _, H, W = feat.shape
        cls = self.cls_score(x).permute(0, 2, 3, 1).reshape(B, H, W, A, C)
        obj = self.object_pred(y).permute(0, 2, 3, 1).reshape(B, H, W, A, 1)
        normalized = cls + obj - torch.log(
            1.0 + torch.exp(cls).clamp(max=INF) + torch.exp(obj).clamp(
                max=INF))
        return YOLOFHeadOutputs(normalized.reshape(B, H, W, A * C),
                                self.bbox_pred(y).permute(0, 2, 3, 1),
                                (H, W))


def yolof_anchors(feat_hw: Tuple[int, int], device, stride: int = 32,
                  scales=(1, 2, 4, 8, 16)) -> torch.Tensor:
    """(H*W*A, 4) anchors of the C5 map."""
    return grid_anchors(feat_hw, stride, base_anchors(stride, scales, (1.0,)),
                        device)


class YOLOFLossConfig(NamedTuple):
    num_classes: int = 80
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    match_times: int = 4
    pos_ignore_thr: float = 0.15
    neg_ignore_thr: float = 0.7
    ctr_clamp: float = 32.0


def yolof_detection_loss(out: YOLOFHeadOutputs, anchors, gt_bboxes,
                         gt_labels, gt_valid, cfg: YOLOFLossConfig):
    """Focal loss over every anchor and GIoU over the candidates ->
    (losses, the assignment). anchors (HWA, 4); gt_* (B, G, ...)."""
    B = out.cls_scores.shape[0]
    C = cfg.num_classes
    cls_flat = out.cls_scores.reshape(B, -1, C)
    decoded = delta2bbox(anchors[None], out.bbox_preds.reshape(B, -1, 4),
                         add_ctr_clamp=True, ctr_clamp=cfg.ctr_clamp)
    # the predicted boxes enter the matching cost only, as in the
    # reference, where the assigner is not differentiated
    assign = uniform_assign(decoded.detach(), anchors, gt_bboxes, gt_labels,
                            gt_valid, C, cfg.match_times, cfg.pos_ignore_thr,
                            cfg.neg_ignore_thr)
    # reference: num_total_pos = sum over images of max(pos_i, 1)
    num_total_pos = assign.num_pos.clamp(min=1).sum().float()
    num_total_samples = num_total_pos.clamp(min=1.0)

    onehot = F.one_hot(assign.labels.reshape(-1).clamp(0, C),
                       C + 1)[:, :C].to(cls_flat.dtype)
    loss_cls = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        cls_flat.reshape(-1, C), onehot,
        weight=assign.label_weights.reshape(-1, 1),
        avg_factor=num_total_samples, gamma=cfg.focal_gamma,
        alpha=cfg.focal_alpha)

    G = gt_bboxes.shape[1]
    cand_boxes = torch.gather(
        decoded, 1, assign.cand_anchor_idx[..., None].expand(-1, -1, 4))
    tgt_boxes = torch.gather(
        gt_bboxes, 1,
        assign.cand_gt_idx.clamp(0, G - 1)[..., None].expand(-1, -1, 4))
    loss_bbox = cfg.loss_bbox_weight * L.giou_loss(
        cand_boxes.reshape(-1, 4), tgt_boxes.reshape(-1, 4),
        weight=assign.cand_pos_mask.reshape(-1).to(decoded.dtype),
        avg_factor=num_total_samples)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox), assign


def nms_detections(boxes, top, img_hw, scale_factor, rescale,
                   nms_iou, max_per_img) -> Detections:
    """The top-k candidates (``top``, a TopkResult over flat positions) with
    their (B, k, 4) boxes: clipped to the image, class-aware NMS, rescaled
    if asked, and the positions of the survivors as ``keep_qid``."""
    hw = img_hw.to(boxes.dtype)
    boxes = bbox_clip(boxes, (hw[:, 0, None], hw[:, 1, None]))
    res = batched_nms(boxes, top.scores, top.labels, nms_iou, max_per_img,
                      valid=top.valid)
    bboxes = res.bboxes
    if rescale and scale_factor is not None:
        bboxes = bboxes / scale_factor[:, None, :]
    qid = torch.gather(top.keep_idxs, 1, res.src_idx)
    return Detections(bboxes, res.scores, res.labels, res.keep, qid)


def yolof_get_bboxes(out: YOLOFHeadOutputs, anchors, img_hw,
                     scale_factor=None, score_thr: float = 0.05,
                     nms_iou: float = 0.6, nms_pre: int = 1000,
                     max_per_img: int = 100, ctr_clamp: float = 32.0,
                     rescale: bool = False) -> Detections:
    """Fixed-size detections per image: sigmoid scores over every (anchor,
    class) pair, the ``nms_pre`` best above ``score_thr``, decoded with the
    centre clamp, clipped to the image, class-aware NMS; ``keep_qid`` is
    each survivor's anchor position (the teacher's keep-ids)."""
    B = out.cls_scores.shape[0]
    N = anchors.shape[0]
    cls_flat = out.cls_scores.reshape(B, N, -1)
    deltas = out.bbox_preds.reshape(B, N, 4)
    top = filter_scores_and_topk(torch.sigmoid(cls_flat), score_thr,
                                 nms_pre)
    idx = top.keep_idxs.long()
    sel_deltas = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    boxes = delta2bbox(anchors[idx], sel_deltas, add_ctr_clamp=True,
                       ctr_clamp=ctr_clamp)
    return nms_detections(boxes, top, img_hw, scale_factor,
                          rescale, nms_iou, max_per_img)
