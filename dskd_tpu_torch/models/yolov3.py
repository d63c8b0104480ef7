"""YOLOv3 (port of dskd_tpu/models/yolov3.py ``Darknet53``, ``_block5``,
``YOLOV3``, ``yolo_level_anchors``, ``YOLOV3LossConfig``, ``yolov3_loss``,
``yolov3_get_bboxes`` and its registry entry ``yolov3``).

Darknet-53 (conv + TrainableBatchNorm + LeakyReLU(0.1) bricks, residual
stages of 1, 2, 8, 8 and 4 blocks; C3-C5) or the MobileNetV2 recipe
(stages 2, 4 and 6, LeakyReLU, trained BatchNorm, 96-channel neck and
head) -> the three-scale neck (a five-conv block on C5; a 1x1 reduce,
nearest 2x upsampling and concatenation into C4, then C3) -> per level a
3x3 bridge conv and a 1x1 ``pred`` conv of 3 x (5 + C): (x, y) as
pre-sigmoid cell fractions, (w, h) as log sizes against the anchor,
objectness and class logits, at strides 32, 16 and 8. Anchors are
cell-major, anchor-minor. Assignment (mmdet's GridAssigner, 0.5 / 0.5):
anchors whose best IoU with any GT is at most 0.5 are negative; the
anchors of the cell holding a GT's centre at their level are responsible,
positive to their best GT above 0.5; each GT then claims its best
responsible anchor (a later GT over an earlier one). Losses are sums over
the batch: BCE on x, y (weight 2), MSE on w, h (weight 2), BCE objectness
on positives and negatives, BCE classes on positives. Decoding:
objectness gated at 0.005 times the class sigmoids, per-level threshold
and top-k, decoded, clipped, class-aware NMS at IoU 0.45. Images enter
NHWC; the predictions leave NHWC, ``neck_feats`` NCHW. Module names are
JAX's (``backbone.s0b0_1_conv``, ``neck5_0_bn``, ``pred0`` ...).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from ..core.boxes import bbox_overlaps
from ..core.coders import yolo_decode, yolo_encode
from ..core.postprocess import filter_scores_and_topk_mlvl
from .dilated_encoder import TrainableBatchNorm, init_conv_bn
from .mobilenet_v2 import MobileNetV2
from .yolof_head import Detections, nms_detections

# (w, h) anchor pairs per level, strides 32/16/8 (yolov3_d53 base config)
ANCHORS = (((116, 90), (156, 198), (373, 326)),
           ((30, 61), (62, 45), (59, 119)),
           ((10, 13), (16, 30), (33, 23)))
STRIDES = (32, 16, 8)


def add_cbl(module: nn.Module, name: str, cin: int, cout: int, k: int,
            stride: int, device) -> None:
    """``{name}_conv`` (k x k, no bias, padding (k - 1) // 2) and
    ``{name}_bn`` (TrainableBatchNorm) on ``module``."""
    module.add_module(f"{name}_conv", nn.Conv2d(
        cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=False,
        device=device))
    module.add_module(f"{name}_bn", TrainableBatchNorm(cout, device))


def cbl(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    """conv -> BatchNorm -> LeakyReLU(0.1) of ``add_cbl``'s pair."""
    x = getattr(module, f"{name}_bn")(getattr(module, f"{name}_conv")(x))
    return F.leaky_relu(x, 0.1)


class Darknet53(nn.Module):
    """Residual stages (1, 2, 8, 8, 4); returns C3, C4, C5."""
    STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))

    def __init__(self, device):
        super().__init__()
        add_cbl(self, "stem", 3, 32, 3, 1, device)
        cin = 32
        for si, (ch, n) in enumerate(self.STAGES):
            add_cbl(self, f"down{si}", cin, ch, 3, 2, device)
            for b in range(n):
                add_cbl(self, f"s{si}b{b}_1", ch, ch // 2, 1, 1, device)
                add_cbl(self, f"s{si}b{b}_2", ch // 2, ch, 3, 1, device)
            cin = ch
        self.out_channels = [256, 512, 1024]

    def forward(self, x) -> Tuple:
        x = cbl(self, "stem", x)
        outs = []
        for si, (_, n) in enumerate(self.STAGES):
            x = cbl(self, f"down{si}", x)
            for b in range(n):
                x = x + cbl(self, f"s{si}b{b}_2", cbl(self, f"s{si}b{b}_1", x))
            if si >= 2:
                outs.append(x)
        return tuple(outs)


_BLOCK5 = (1, 3, 1, 3, 1)


class YOLOV3Outputs(NamedTuple):
    preds: Tuple[torch.Tensor, ...]       # per level (B, H, W, 3 * (5 + C))
    neck_feats: Tuple[torch.Tensor, ...]  # per level (B, C, H, W)


class YOLOV3(nn.Module):
    """``backbone``: "" (Darknet-53) or "mobilenet_v2"."""

    def __init__(self, device, num_classes: int = 80, backbone: str = ""):
        super().__init__()
        if backbone == "mobilenet_v2":
            self.backbone = MobileNetV2(device, out_indices=(2, 4, 6),
                                        act="leaky", train_bn=True)
            widths, bridge = (96, 96, 96), (96, 96, 96)
        elif backbone == "":
            self.backbone = Darknet53(device)
            widths, bridge = (512, 256, 128), (1024, 512, 256)
        else:
            raise NotImplementedError(f"YOLOv3 backbone {backbone!r} is not "
                                      f"ported ('' and 'mobilenet_v2' are)")
        c3, c4, c5 = self.backbone.out_channels
        for name, cin, w in (("neck5", c5, widths[0]),
                             ("neck4", widths[1] + c4, widths[1]),
                             ("neck3", widths[2] + c3, widths[2])):
            for i, k in enumerate(_BLOCK5):
                cout = w if k == 1 else 2 * w
                add_cbl(self, f"{name}_{i}", cin, cout, k, 1, device)
                cin = cout
        add_cbl(self, "reduce4", widths[0], widths[1], 1, 1, device)
        add_cbl(self, "reduce3", widths[1], widths[2], 1, 1, device)
        for lvl, (w, ch) in enumerate(zip(widths, bridge)):
            add_cbl(self, f"head{lvl}", w, ch, 3, 1, device)
            self.add_module(f"pred{lvl}", nn.Conv2d(
                ch, 3 * (5 + num_classes), 1, device=device))

    def _block5(self, name, x):
        for i in range(len(_BLOCK5)):
            x = cbl(self, f"{name}_{i}", x)
        return x

    def forward(self, images, img_hw) -> YOLOV3Outputs:
        """images (B, H, W, 3) normalised NHWC, H and W multiples of 32;
        img_hw is unused by the forward."""
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2))

        def up(x):
            return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

        d5 = self._block5("neck5", c5)
        d4 = self._block5("neck4", torch.cat(
            [up(cbl(self, "reduce4", d5)), c4], 1))
        d3 = self._block5("neck3", torch.cat(
            [up(cbl(self, "reduce3", d4)), c3], 1))
        preds = tuple(getattr(self, f"pred{lvl}")(cbl(self, f"head{lvl}", d))
                      .permute(0, 2, 3, 1)
                      for lvl, d in enumerate((d5, d4, d3)))
        return YOLOV3Outputs(preds, (d5, d4, d3))


def yolo_level_anchors(featmap_size, level: int, device) -> torch.Tensor:
    """(H * W * 3, 4) f32 xyxy anchors centred on the cells of level
    ``level``, cell-major, anchor-minor."""
    h, w = featmap_size
    s = STRIDES[level]
    ys, xs = np.mgrid[:h, :w]
    cx, cy = (xs + 0.5) * s, (ys + 0.5) * s
    boxes = [np.stack([cx - aw / 2, cy - ah / 2, cx + aw / 2, cy + ah / 2],
                      -1).reshape(-1, 4) for aw, ah in ANCHORS[level]]
    return torch.from_numpy(np.stack(boxes, 1).reshape(-1, 4).astype(
        np.float32)).to(device)


def yolo_priors(sizes, device):
    """(anchors (N, 4), strides (N,), cell x and y (N,)) of every level's
    (H, W) in ``sizes``, level-major, cell-major, anchor-minor."""
    anchors = torch.cat([yolo_level_anchors(sz, i, device)
                         for i, sz in enumerate(sizes)])
    lvl = np.concatenate([np.full(h * w * 3, i) for i, (h, w) in
                          enumerate(sizes)])
    cells = [np.mgrid[:h, :w] for h, w in sizes]
    cell_y = np.concatenate([np.repeat(c[0].reshape(-1), 3) for c in cells])
    cell_x = np.concatenate([np.repeat(c[1].reshape(-1), 3) for c in cells])
    strides = torch.tensor(STRIDES, dtype=torch.float32,
                           device=device)[torch.from_numpy(lvl).to(device)]
    return (anchors, strides, torch.from_numpy(cell_x).to(device),
            torch.from_numpy(cell_y).to(device))


def _flat(out: YOLOV3Outputs, device):
    """(yolo_priors of the outputs' sizes, the predictions (B, N, 5 + C),
    rows per level)."""
    B = out.preds[0].shape[0]
    sizes = [tuple(p.shape[1:3]) for p in out.preds]
    preds = torch.cat([p.reshape(B, -1, p.shape[-1] // 3) for p in out.preds],
                      1)
    return (*yolo_priors(sizes, device), preds,
            [h * w * 3 for h, w in sizes])


class YOLOV3LossConfig(NamedTuple):
    num_classes: int = 80
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    obj_weight: float = 1.0
    cls_weight: float = 1.0
    xy_weight: float = 2.0
    wh_weight: float = 2.0


def grid_assign(anchors, strides, cell_x, cell_y, gt_bboxes, gt_valid,
                pos_iou_thr=0.5, neg_iou_thr=0.5):
    """The GridAssigner of every image: (assigned GT per anchor (B, N),
    -1 for none; negative mask (B, N))."""
    dt = gt_bboxes.dtype
    B, G = gt_valid.shape
    N = anchors.shape[0]
    gcx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
    gcy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
    s = strides.to(dt)[None, :, None]
    gx = torch.floor(gcx[:, None, :] / s).long()
    gy = torch.floor(gcy[:, None, :] / s).long()
    resp = ((cell_x[None, :, None] == gx) & (cell_y[None, :, None] == gy)
            & gt_valid[:, None, :])                          # (B, N, G)
    flags = resp.any(2)
    minus1 = torch.full((), -1.0, dtype=dt, device=gt_bboxes.device)
    ious = torch.where(gt_valid[:, None, :],
                       bbox_overlaps(anchors.to(dt)[None], gt_bboxes), minus1)
    max_all = ious.max(2).values
    neg = (max_all >= 0) & (max_all <= neg_iou_thr)
    masked = torch.where(flags[..., None], ious, minus1)
    assigned = torch.where(masked.max(2).values > pos_iou_thr,
                           masked.argmax(2), -1)
    # each GT claims its best responsible anchor; where two GTs claim one
    # anchor the later wins
    gt_best = masked.argmax(1)                               # (B, G)
    ok = gt_valid & (masked.max(1).values > 0) & flags.gather(1, gt_best)
    win = torch.full((B, N + 1), -1, dtype=torch.long,
                     device=gt_bboxes.device)
    win.scatter_reduce_(1, torch.where(ok, gt_best, N),
                        torch.arange(G, device=win.device).expand(B, G),
                        "amax")
    win = win[:, :N]
    return torch.where(win >= 0, win, assigned), neg


def yolov3_loss(out: YOLOV3Outputs, gt_bboxes, gt_labels, gt_valid,
                cfg: YOLOV3LossConfig) -> Dict[str, torch.Tensor]:
    """GridAssigner targets and the recipe's batch sums (no average
    factor): ``loss_xy``, ``loss_wh``, ``loss_conf``, ``loss_cls``."""
    C = cfg.num_classes
    device = gt_bboxes.device
    anchors, strides, cell_x, cell_y, preds, _ = _flat(out, device)
    dt = preds.dtype
    with torch.no_grad():
        assigned, neg = grid_assign(anchors, strides, cell_x, cell_y,
                                    gt_bboxes, gt_valid, cfg.pos_iou_thr,
                                    cfg.neg_iou_thr)
    G = gt_bboxes.shape[1]
    pos = assigned >= 0
    gt_of = assigned.clamp(0, G - 1)
    pw = pos.to(dt)
    conf_w = (pos | neg).to(dt)
    tgt = torch.gather(gt_bboxes, 1, gt_of[..., None].expand(-1, -1, 4))
    enc = yolo_encode(anchors.to(dt)[None], tgt.to(dt), strides.to(dt)[None])
    onehot = F.one_hot(torch.gather(gt_labels.long(), 1, gt_of), C).to(dt)
    return dict(
        loss_xy=cfg.xy_weight * L.bce_loss(
            preds[..., :2], enc[..., :2], weight=pw[..., None],
            reduction="sum"),
        loss_wh=cfg.wh_weight * L.mse_loss(
            preds[..., 2:4], enc[..., 2:], weight=pw[..., None],
            reduction="sum"),
        loss_conf=cfg.obj_weight * L.bce_loss(
            preds[..., 4], pw, weight=conf_w, reduction="sum"),
        loss_cls=cfg.cls_weight * L.bce_loss(
            preds[..., 5:], onehot, weight=pw[..., None], reduction="sum"))


def yolov3_get_bboxes(out: YOLOV3Outputs, img_hw, scale_factor=None,
                      score_thr: float = 0.05, nms_iou: float = 0.45,
                      nms_pre: int = 1000, max_per_img: int = 100,
                      rescale: bool = False) -> Detections:
    """Fixed-size detections per image (``keep_qid`` each survivor's
    anchor)."""
    anchors, strides, _, _, preds, rows = _flat(out, img_hw.device)
    obj = torch.sigmoid(preds[..., 4:5])
    obj = torch.where(obj >= 0.005, obj, torch.zeros_like(obj))
    probs = torch.sigmoid(preds[..., 5:]) * obj
    top = filter_scores_and_topk_mlvl(probs, score_thr, nms_pre, rows)
    idx = top.keep_idxs.long()
    sel = torch.gather(preds[..., :4], 1, idx[..., None].expand(-1, -1, 4))
    xywh = torch.cat([torch.sigmoid(sel[..., :2]), sel[..., 2:4]], -1)
    boxes = yolo_decode(anchors.to(preds.dtype)[idx], xywh,
                        strides.to(preds.dtype)[idx])
    return nms_detections(boxes, top, img_hw, scale_factor, rescale,
                          nms_iou, max_per_img)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_yolov3(model_cfg, device="cuda") -> YOLOV3:
    return YOLOV3(device, num_classes=model_cfg.num_classes,
                  backbone=model_cfg.backbone)


@torch.no_grad()
def init_yolov3(model: YOLOV3, seed: int = 0) -> None:
    """Seeded random weights at the scales of JAX's initializers:
    normal(0.01) ``pred`` convs, lecun-normal for the others, zero biases,
    identity BatchNorms."""
    init_conv_bn(model, torch.Generator().manual_seed(seed),
                 lambda name: "normal_001" if name.startswith("pred")
                 else "lecun")


def _register():
    from ..registry import register_family
    from ..utils.weights import yolov3_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = YOLOV3LossConfig(num_classes=cfg.model.num_classes)

        # JAX's YOLOv3 losses read no teacher; a training-mode model
        # normalises by the batch statistics and updates its running ones
        def losses_fn(model, batch, teacher, generator):
            return yolov3_loss(model(batch.images, batch.img_hw),
                               batch.gt_bboxes, batch.gt_labels,
                               batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors) -> Detections:
            return yolov3_get_bboxes(
                model(images, img_hw), img_hw, scale_factor=scale_factors,
                score_thr=max(score_thr, 0.05), max_per_img=max_per_img,
                rescale=True)
        return step

    register_family("yolov3", build=build_yolov3, init_weights=init_yolov3,
                    from_jax=yolov3_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
