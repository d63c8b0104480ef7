"""DSKD distillation losses (port of dskd_tpu/distill/losses.py
``DistillConfig``, ``_kd_kl_axis``, ``query_of_merged_gt``,
``_class_prototypes``, ``corr_loss``, ``distill_losses``,
``_box_feature_coords``, ``memory_fg_loss`` and
``semantic_guided_fg_loss``): the flagship family's whole option space.

Branches, each on the merged (teacher-first) GT's assignment:
  * corr: between-class L2 distance matrices of class prototypes, MSE;
  * soft: KL(T) between the student's logits at the query matched to
    teacher prediction k and the teacher's logits at its kept query k;
  * ld_bbox / ld_logit: SmoothL1 on the decoded cxcywh / KL(T) on the raw
    (2+4*(rm+1)) vectors, at the teacher's kept queries;
  * kldv: per neck level, KL with softmax over the channel axis;
  * memory: KL over the encoder memory with softmax over the token axis;
  * fg: decode_v1 / decode_v2 (semantic-guided boxes on the neck levels),
    sg_out / fg_only (teacher boxes on the encoder memory's level maps).

The reference's quirks stay as the JAX package keeps them by default:
corr selects student rows by the teacher's counts (the student division is
guarded); the fg KLs put the teacher-masked features on the pred side and
the student's on the detached target, so decode_v1's student gradient
comes only through the semantic mask and sg_out / fg_only give the student
none (``fix_fg_grad_direction=True`` swaps the two sides, as in JAX);
ld_logit's (N, 1) weight broadcasts against the (N,) per-row KL into an
(N, N) product before the sum, as JAX's does; and the class prototypes are
a one-hot matmul.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..core import losses as L
from ..models.gfl_detr_head import HeadOutputs, decode_boxes
from ..models.gfl_detr_loss import LayerTargets
from .teacher import TeacherInfo

_EPS = 1e-12


class DistillConfig(NamedTuple):
    """Typed encoding of the reference's substring-matched flag strings;
    JAX's fields, order and defaults (the flagship config's weights and
    temperatures)."""
    hard: bool = True            # 'hard' in cates_distill
    teacher_first: bool = True   # 'teacher-first' in cates_distill
    soft: bool = False           # 'soft' in cates_distill
    ld_bbox: bool = False        # 'bbox' in locat_distill
    ld_logit: bool = False       # 'logit' in locat_distill
    feats_kldv: bool = False     # 'kldv' in feats_distill
    memory: bool = False         # 'memory' in memory_distill
    corr: bool = True            # 'corr' in feats_distill
    fg_mode: str = "decode_v1"   # '', decode_v1, decode_v2, sg_out, fg_only
    num_prev: int = 40           # number of previous-task classes
    reg_max: int = 16
    kd_weight: float = 1.0
    kd_T: float = 2.0
    ld_bbox_weight: float = 10.0
    ld_logit_weight: float = 1.0
    ld_logit_T: float = 2.0
    fd_weight: float = 1.0
    fd_T: float = 2.0
    memory_weight: float = 2.0
    memory_T: float = 2.0
    fg_weight: float = 1.0
    fg_T: float = 2.0
    corr_weight: float = 1.0
    corr_reduction: str = "mean"
    # False: the reference's fg KL direction (teacher on the pred side);
    # True: the student on the pred side, the teacher detached
    fix_fg_grad_direction: bool = False

    @classmethod
    def from_flags(cls, cates_distill: str = "", locat_distill: str = "",
                   feats_distill: str = "", memory_distill: str = "",
                   **kw) -> "DistillConfig":
        """Bridge from the reference's flag-string option space; ``kw`` sets
        the other fields (the JAX registry passes ``num_prev``, ``reg_max``
        and ``fix_fg_grad_direction``)."""
        fg_mode = ""
        if "fg_info" in feats_distill and "bg_info" not in feats_distill:
            for mode in ("decode_v1", "decode_v2", "sg_out", "fg_only"):
                if mode in feats_distill:
                    fg_mode = mode
                    break
        return cls(hard="hard" in cates_distill,
                   teacher_first="teacher-first" in cates_distill,
                   soft="soft" in cates_distill,
                   ld_bbox="bbox" in locat_distill,
                   ld_logit="logit" in locat_distill,
                   feats_kldv="kldv" in feats_distill,
                   memory="memory" in memory_distill,
                   corr="corr" in feats_distill,
                   fg_mode=fg_mode, **kw)


def _kd_kl_axis(pred, soft, T, axis, detach_target=True):
    """Elementwise KL with softmax and mean over ``axis``, times T^2."""
    target = torch.softmax(soft / T, dim=axis)
    if detach_target:
        target = target.detach()
    logp = torch.log_softmax(pred / T, dim=axis)
    log_t = torch.where(target > 0, torch.log(target.clamp(min=_EPS)),
                        torch.zeros_like(target))
    return (target * (log_t - logp)).mean(dim=axis) * (T * T)


def query_of_merged_gt(assigned_gt: torch.Tensor, num_merged: int,
                       num_query: int) -> torch.Tensor:
    """Invert a one-to-one assignment: (B, Q) merged-GT index or -1 ->
    (B, num_merged) query index (0 where unmatched)."""
    B, Q = assigned_gt.shape
    safe = torch.where(assigned_gt >= 0, assigned_gt, num_merged).long()
    out = torch.zeros((B, num_merged + 1), dtype=torch.int64,
                      device=assigned_gt.device)
    q = torch.arange(Q, device=assigned_gt.device).expand(B, Q)
    return out.scatter(1, safe, q)[:, :num_merged]


def _class_prototypes(feats_flat, labels_flat, select_mask, num_classes):
    """Per-class feature sums and counts of the selected rows, as a one-hot
    matmul (the JAX package's form: a segment-sum's gather/scatter backward
    faulted on the TPU). Returns (sums (K, C), counts (K,))."""
    w = select_mask.to(feats_flat.dtype)
    safe = torch.where(select_mask, labels_flat.long(), num_classes)
    onehot = F.one_hot(safe, num_classes + 1).to(feats_flat.dtype)
    sums = (onehot.T @ (feats_flat * w[:, None]))[:num_classes]
    counts = (onehot.T @ w[:, None])[:num_classes, 0]
    return sums, counts


def corr_loss(student_hs_last, student_labels, teacher_hs_last, teacher_det,
              num_query: int, num_classes: int, cfg: DistillConfig):
    """Between-class L2-distance-matrix distillation (loss_corr).

    student_hs_last (B, Q, C); student_labels (B, Q) assignment labels
    (background == num_classes); teacher_hs_last (B, Q, C); teacher_det
    carries the teacher's kept (labels, keep_qid, valid).
    """
    B, Q, C = student_hs_last.shape
    prev = cfg.num_prev
    s_labels = student_labels.reshape(-1)
    s_sel = (s_labels >= 0) & (s_labels < prev)
    s_sum, s_cnt = _class_prototypes(student_hs_last.reshape(-1, C),
                                     s_labels, s_sel, num_classes)
    gidx = (teacher_det.keep_qid.long()
            + torch.arange(B, device=student_hs_last.device)[:, None] * Q)
    t_feats = teacher_hs_last.reshape(-1, C)[gidx.reshape(-1)]
    t_sum, t_cnt = _class_prototypes(t_feats, teacher_det.labels.reshape(-1),
                                     teacher_det.valid.reshape(-1),
                                     num_classes)
    t_has = t_cnt[:prev] > 0
    c_t = torch.where(t_has[:, None],
                      t_sum[:prev] / t_cnt[:prev, None].clamp(min=1.0),
                      t_sum[:prev])
    # reference quirk: student rows are selected by the TEACHER's counts;
    # the student division is guarded against 0/0
    c_s = torch.where(t_has[:, None],
                      s_sum[:prev] / s_cnt[:prev, None].clamp(min=1.0),
                      s_sum[:prev])

    def dist_mat(c):
        d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        return torch.sqrt(d2.clamp(min=1e-12))

    loss = L.mse_loss(dist_mat(c_t), dist_mat(c_s),
                      reduction=cfg.corr_reduction)
    return cfg.corr_weight * loss / prev


def semantic_guided_fg_loss(student: HeadOutputs,
                            student_neck: Sequence[torch.Tensor],
                            teacher: TeacherInfo, q_of_gt: torch.Tensor,
                            img_hw: torch.Tensor,
                            cfg: DistillConfig) -> torch.Tensor:
    """decode_v1 / decode_v2 semantic-guided foreground feature distill.

    Teacher boxes are rasterized onto each NHWC neck level (later boxes
    overwrite earlier ones); each covered pixel is weighted by the softmax
    of its box's semantic vector (v1: |teacher - student| decoder states of
    the matched query; v2: teacher states) and the two masked maps are
    compared by a KL with softmax over the H axis. Box bounds are exclusive
    here, where sg_out / fg_only take them inclusive.
    """
    det = teacher.det
    B, Kt = det.labels.shape
    C = student.hs.shape[-1]
    keep = det.keep_qid.long()[..., None].expand(-1, -1, C)
    t_hs = torch.gather(teacher.hs[-1], 1, keep)              # (B, K, C)
    if cfg.fg_mode == "decode_v1":
        s_hs = torch.gather(student.hs[-1], 1,
                            q_of_gt.long()[..., None].expand(-1, -1, C))
        sem = torch.softmax((t_hs - s_hs).abs(), dim=-1)
    else:
        sem = torch.softmax(t_hs, dim=-1)

    k_rank = torch.arange(1, Kt + 1, device=sem.device)[None, :, None, None]
    total = 0.0
    for sf, tf in zip(student_neck, teacher.neck_feats):
        _, H, W, _ = sf.shape
        cover = _box_cover(det.bboxes, det.valid, img_hw, H, W,
                           inclusive=False)                  # (B, K, H, W)
        best = torch.argmax(cover * k_rank, dim=1)            # (B, H, W)
        covered = cover.any(dim=1)
        mask = torch.gather(sem, 1, best.reshape(B, H * W, 1).expand(
            -1, -1, C)).reshape(B, H, W, C)
        mask = torch.where(covered[..., None], mask, torch.zeros_like(mask))
        if cfg.fix_fg_grad_direction:
            pred, target = sf * mask, (tf * mask).detach()
        else:
            pred, target = tf * mask, sf.detach() * mask
        kl = _kd_kl_axis(pred, target, cfg.fg_T, axis=1)      # (B, W, C)
        total = total + cfg.fg_weight * kl.sum()
    return total / B


def _box_feature_coords(boxes, img_hw, H, W):
    """Image-coordinate xyxy boxes (B, K, 4) scaled onto an (H, W) map:
    (x0, x1, y0, y1) with the reference's floor / ceil rounding."""
    hw = img_hw.to(torch.float32)
    h_img, w_img = hw[:, 0, None], hw[:, 1, None]
    x0 = torch.floor(boxes[..., 0] / w_img * W)
    x1 = torch.ceil(boxes[..., 2] / w_img * W)
    y0 = torch.floor(boxes[..., 1] / h_img * H)
    y1 = torch.ceil(boxes[..., 3] / h_img * H)
    return x0, x1, y0, y1


def _box_cover(boxes, valid, img_hw, H, W, inclusive=True):
    """(B, K, H, W) bool: pixel (y, x) lies in valid box k; ``inclusive``
    extends the upper bounds by one pixel (the memory fg modes)."""
    x0, x1, y0, y1 = _box_feature_coords(boxes, img_hw, H, W)
    if inclusive:
        x1, y1 = x1 + 1, y1 + 1
    ys = torch.arange(H, dtype=torch.float32, device=boxes.device)
    xs = torch.arange(W, dtype=torch.float32, device=boxes.device)
    in_y = (ys >= y0[..., None]) & (ys < y1[..., None])
    in_x = (xs >= x0[..., None]) & (xs < x1[..., None])
    return in_y[:, :, :, None] & in_x[:, :, None, :] & \
        valid[:, :, None, None]


def memory_fg_loss(student: HeadOutputs, student_neck, teacher: TeacherInfo,
                   img_hw, cfg: DistillConfig, gt_bboxes_original=None,
                   gt_valid_original=None) -> torch.Tensor:
    """sg_out / fg_only foreground distill on the encoder memory.

    Per level, both memories are sliced back into (B, H, W, C) maps and
    weighted by the square root of a mask rasterized from the teacher's
    boxes with inclusive bounds: sg_out's is binary, minus the pre-merge
    GT's regions; fg_only's is the largest 1 / area of the boxes covering
    the pixel. KL with softmax over the H axis, the teacher's map on the
    pred side and the student's detached (no student gradient) unless
    ``fix_fg_grad_direction``.
    """
    det = teacher.det
    B, _, C = student.memory.shape
    total = 0.0
    start = 0
    for f in student_neck:
        H, W = f.shape[1], f.shape[2]
        mem_s = student.memory[:, start:start + H * W].reshape(B, H, W, C)
        mem_t = teacher.memory[:, start:start + H * W].reshape(B, H, W, C)
        start += H * W
        cover = _box_cover(det.bboxes, det.valid, img_hw, H, W)
        if cfg.fg_mode == "sg_out":
            mask = cover.any(dim=1).to(torch.float32)
            if gt_bboxes_original is not None:
                gcover = _box_cover(gt_bboxes_original, gt_valid_original,
                                    img_hw, H, W)
                mask = torch.where(gcover.any(dim=1),
                                   torch.zeros_like(mask), mask)
        else:  # fg_only
            x0, x1, y0, y1 = _box_feature_coords(det.bboxes, img_hw, H, W)
            area = (y1 - y0 + 1) * (x1 - x0 + 1)               # (B, K)
            inv = torch.where(det.valid, 1.0 / area.clamp(min=1.0),
                              torch.zeros_like(area))
            mask = torch.where(cover, inv[:, :, None, None],
                               torch.zeros((), device=inv.device)).amax(1)
        m = torch.sqrt(mask)[..., None]
        if cfg.fix_fg_grad_direction:
            pred, target = mem_s * m, (mem_t * m).detach()
        else:
            pred, target = mem_t * m, (mem_s * m).detach()
        total = total + cfg.fg_weight * _kd_kl_axis(
            pred, target, cfg.fg_T, axis=1).sum()
    return total / B


def _kept_query_weight(det, B, Q):
    """(B, Q) 1.0 at the teacher's kept valid queries: a scatter-max, so a
    padded repeat of a kept query cannot clear it."""
    w = torch.zeros((B, Q), dtype=torch.float32, device=det.valid.device)
    return w.scatter_reduce(1, det.keep_qid.long(),
                            det.valid.to(torch.float32), "amax")


def distill_losses(student: HeadOutputs,
                   student_neck: Sequence[torch.Tensor],
                   teacher: TeacherInfo, targets: LayerTargets,
                   img_hw: torch.Tensor, num_classes: int,
                   cfg: DistillConfig, num_merged: int,
                   gt_bboxes_original=None, gt_valid_original=None
                   ) -> Dict[str, torch.Tensor]:
    """Every configured distill loss. ``targets`` come from the detection
    loss on the merged (teacher-first) GT, whose length is ``num_merged``;
    the pre-merge GT (``gt_*_original``) feeds sg_out's background
    carve-out."""
    losses: Dict[str, torch.Tensor] = {}
    _, B, Q, K = student.cls_scores.shape
    det = teacher.det
    Kt = det.labels.shape[1]
    num_keep = det.valid.sum().to(torch.float32).clamp(min=1.0)
    # the query matched to merged-GT row k (teacher predictions first)
    q_of_gt = query_of_merged_gt(targets.assigned_gt[-1], num_merged,
                                 Q)[:, :Kt]
    if cfg.ld_bbox or cfg.ld_logit:
        kept = _kept_query_weight(det, B, Q).reshape(-1, 1)

    if cfg.corr:
        losses["loss_corr"] = corr_loss(
            student.hs[-1], targets.labels[-1], teacher.hs[-1], det, Q,
            num_classes, cfg)
    if cfg.soft:
        t_logits = torch.gather(teacher.cls_scores[-1], 1, det.keep_qid.long()
                                [..., None].expand(-1, -1, K))
        s_logits = torch.gather(student.cls_scores[-1], 1,
                                q_of_gt[..., None].expand(-1, -1, K))
        losses["loss_kd"] = cfg.kd_weight * L.kd_kl_div_loss(
            s_logits.reshape(-1, K), t_logits.reshape(-1, K),
            weight=det.valid.to(torch.float32).reshape(-1),
            avg_factor=num_keep, T=cfg.kd_T)
    if cfg.ld_bbox:
        losses["loss_ld_bbox"] = cfg.ld_bbox_weight * L.smooth_l1_loss(
            decode_boxes(student.bbox_preds[-1], cfg.reg_max).reshape(-1, 4),
            decode_boxes(teacher.bbox_preds[-1], cfg.reg_max).reshape(-1, 4),
            weight=kept, avg_factor=num_keep)
    if cfg.ld_logit:
        R = student.bbox_preds.shape[-1]
        # the (N, 1) weight times the (N,) per-row KL is (N, N), as in JAX
        losses["loss_ld_logit"] = cfg.ld_logit_weight * L.kd_kl_div_loss(
            student.bbox_preds[-1].reshape(-1, R),
            teacher.bbox_preds[-1].reshape(-1, R),
            weight=kept, avg_factor=num_keep, T=cfg.ld_logit_T)
    if cfg.feats_kldv:
        total = 0.0
        for sf, tf in zip(student_neck, teacher.neck_feats):
            # NHWC: the reference's channel axis (dim 1 of NCHW) is the last
            kl = _kd_kl_axis(sf, tf, cfg.fd_T, axis=-1)
            total = total + cfg.fd_weight * kl.sum()
        losses["loss_fd"] = total / B
    if cfg.memory:
        # (B, S, C): the reference's softmax over dim 1 of each (C, S)
        # slice is over the token axis S
        kl = _kd_kl_axis(student.memory, teacher.memory, cfg.memory_T,
                         axis=1)
        losses["loss_memory"] = cfg.memory_weight * kl.sum() / B
    if cfg.fg_mode in ("decode_v1", "decode_v2"):
        losses["loss_fg_feature"] = semantic_guided_fg_loss(
            student, student_neck, teacher, q_of_gt, img_hw, cfg)
    elif cfg.fg_mode in ("sg_out", "fg_only"):
        losses["loss_fg_feature"] = memory_fg_loss(
            student, student_neck, teacher, img_hw, cfg,
            gt_bboxes_original=gt_bboxes_original,
            gt_valid_original=gt_valid_original)
    elif cfg.fg_mode:
        raise ValueError(f"unknown fg mode {cfg.fg_mode!r}")
    return losses
