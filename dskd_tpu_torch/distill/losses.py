"""DSKD distillation losses of the flagship recipe (port of
dskd_tpu/distill/losses.py ``DistillConfig``, ``_kd_kl_axis``,
``query_of_merged_gt``, ``_class_prototypes``, ``corr_loss``,
``semantic_guided_fg_loss`` and ``distill_losses``).

Ported branches: ``corr`` (between-class distance-matrix distill) and the
semantic-guided foreground distill ``decode_v1`` / ``decode_v2``, with the
reference's quirks kept as the JAX package keeps them by default: corr
selects student rows by the teacher's counts (the student division is
guarded), and the fg KL puts the teacher-masked features on the pred side
with the student's detached, so the student's gradient comes only through
the semantic mask (the JAX package's ``fix_fg_grad_direction=True`` is not
ported and raises).
The other branches (soft, ld_bbox, ld_logit, kldv, memory, sg_out, fg_only)
raise ``NotImplementedError`` (ROADMAP A5).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..core import losses as L
from ..models.gfl_detr_head import HeadOutputs
from ..models.gfl_detr_loss import LayerTargets
from .teacher import TeacherInfo

_EPS = 1e-12


class DistillConfig(NamedTuple):
    """Typed encoding of the reference's substring-matched flag strings.
    The weights and temperatures of the branches not ported yet come with
    them."""
    hard: bool = True
    soft: bool = False
    ld_bbox: bool = False
    ld_logit: bool = False
    feats_kldv: bool = False
    memory: bool = False
    corr: bool = True
    fg_mode: str = "decode_v1"   # '', 'decode_v1', 'decode_v2'
    num_prev: int = 40
    fg_weight: float = 1.0
    fg_T: float = 2.0
    corr_weight: float = 1.0
    reg_max: int = 16
    fix_fg_grad_direction: bool = False

    @classmethod
    def from_flags(cls, cates_distill: str = "", locat_distill: str = "",
                   feats_distill: str = "", memory_distill: str = "",
                   **kw) -> "DistillConfig":
        """Bridge from the reference's flag-string option space; ``kw`` sets
        the other fields (the JAX registry passes ``num_prev``, ``reg_max``
        and ``fix_fg_grad_direction``)."""
        if kw.get("fix_fg_grad_direction"):
            raise NotImplementedError("distill.fix_fg_grad_direction=True "
                                      "is not ported")
        fg_mode = ""
        if "fg_info" in feats_distill and "bg_info" not in feats_distill:
            for mode in ("decode_v1", "decode_v2", "sg_out", "fg_only"):
                if mode in feats_distill:
                    fg_mode = mode
                    break
        return cls(hard="hard" in cates_distill,
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

    loss = L.mse_loss(dist_mat(c_t), dist_mat(c_s))
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
    compared by a KL with softmax over the H axis.
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

    hw = img_hw.to(torch.float32)
    h_img, w_img = hw[:, 0, None], hw[:, 1, None]
    dev = sem.device
    k_rank = torch.arange(1, Kt + 1, device=dev)[None, :, None, None]
    total = 0.0
    for sf, tf in zip(student_neck, teacher.neck_feats):
        _, H, W, _ = sf.shape
        x0 = torch.floor(det.bboxes[..., 0] / w_img * W)
        x1 = torch.ceil(det.bboxes[..., 2] / w_img * W)
        y0 = torch.floor(det.bboxes[..., 1] / h_img * H)
        y1 = torch.ceil(det.bboxes[..., 3] / h_img * H)
        ys = torch.arange(H, dtype=torch.float32, device=dev)
        xs = torch.arange(W, dtype=torch.float32, device=dev)
        in_y = (ys >= y0[..., None]) & (ys < y1[..., None])    # (B, K, H)
        in_x = (xs >= x0[..., None]) & (xs < x1[..., None])    # (B, K, W)
        cover = (in_y[:, :, :, None] & in_x[:, :, None, :]
                 & det.valid[:, :, None, None])              # (B, K, H, W)
        best = torch.argmax(cover * k_rank, dim=1)            # (B, H, W)
        covered = cover.any(dim=1)
        mask = torch.gather(sem, 1, best.reshape(B, H * W, 1).expand(
            -1, -1, C)).reshape(B, H, W, C)
        mask = torch.where(covered[..., None], mask, torch.zeros_like(mask))
        pred, target = tf * mask, sf.detach() * mask
        kl = _kd_kl_axis(pred, target, cfg.fg_T, axis=1)      # (B, W, C)
        total = total + cfg.fg_weight * kl.sum()
    return total / B


_NOT_PORTED = ("soft", "ld_bbox", "ld_logit", "feats_kldv", "memory")


def distill_losses(student: HeadOutputs,
                   student_neck: Sequence[torch.Tensor],
                   teacher: TeacherInfo, targets: LayerTargets,
                   img_hw: torch.Tensor, num_classes: int,
                   cfg: DistillConfig, num_merged: int
                   ) -> Dict[str, torch.Tensor]:
    """The configured distill losses. ``targets`` come from the detection
    loss on the merged (teacher-first) GT, whose length is ``num_merged``."""
    for name in _NOT_PORTED:
        if getattr(cfg, name):
            raise NotImplementedError(f"distill branch {name!r} is not "
                                      "ported yet (ROADMAP A5)")
    if cfg.fg_mode not in ("", "decode_v1", "decode_v2"):
        raise NotImplementedError(f"fg mode {cfg.fg_mode!r} is not ported "
                                  "yet (ROADMAP A5)")
    losses: Dict[str, torch.Tensor] = {}
    Q = student.cls_scores.shape[2]
    Kt = teacher.det.labels.shape[1]
    q_of_gt = query_of_merged_gt(targets.assigned_gt[-1], num_merged,
                                 Q)[:, :Kt]
    if cfg.corr:
        losses["loss_corr"] = corr_loss(
            student.hs[-1], targets.labels[-1], teacher.hs[-1], teacher.det,
            Q, num_classes, cfg)
    if cfg.fg_mode:
        losses["loss_fg_feature"] = semantic_guided_fg_loss(
            student, student_neck, teacher, q_of_gt, img_hw, cfg)
    return losses
