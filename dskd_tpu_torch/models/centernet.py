"""CenterNet (port of dskd_tpu/models/centernet.py ``CTResNetNeck``,
``CenterNetHead``, ``CenterNet``, ``render_targets``,
``CenterNetLossConfig``, ``centernet_loss``, ``centernet_get_bboxes`` and
its registry entry ``centernet``).

ResNet (C5, frozen BatchNorm) -> three blocks of a 3x3 conv + BN + ReLU and
a 4x4 stride-2 transposed conv + BN + ReLU (256, 128, 64 channels: stride
4) -> three branches of a 3x3 conv + ReLU and a 1x1 conv: the per-class
centre heatmap (bias -2.19), the box size and the sub-pixel centre offset
(normal(0.001) convs). flax's ``ConvTranspose(4, strides=2,
padding="SAME")`` is ``nn.ConvTranspose2d(4, stride=2, padding=1)`` on
the spatially flipped kernel, which ``from_jax`` writes. Targets: per GT a
windowed gaussian at its centre cell (``cornernet.gaussian_radius`` at
overlap 0.3, ``gaussian_splat_max``), max-combined per class; size and
offset at the centre cell. Losses: the gaussian focal loss over the
heatmap's sigmoid, L1 on size (weight 0.1) and offset at the GT centres,
each over the GT count. Decoding, NMS-free: the heatmap's sigmoid where it
equals its 3x3 max-pool (within 1e-6, so plateaus keep every cell), the
``topk`` best (cell, class) pairs, ties to the lower flat index as
``lax.top_k`` orders them (a stable sort), boxes from the offset and size
at each, clipped and rescaled. Images enter NHWC; the head outputs leave
NHWC, ``neck_feats`` NCHW. Module names are JAX's (``neck.deconv0``,
``bbox_head.heatmap_out`` ...), the ResNet's torchvision's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses as L
from .cornernet import gaussian_radius, gaussian_splat_max
from .detector import put_
from .dilated_encoder import init_conv_bn
from .resnet import FrozenBatchNorm, ResNet
from .yolof_head import Detections

HEATMAP_BIAS = -2.19     # log(0.1 / 0.9)


class CenterNetOutputs(NamedTuple):
    heatmap: torch.Tensor     # (B, H, W, C) logits
    wh: torch.Tensor          # (B, H, W, 2)
    offset: torch.Tensor      # (B, H, W, 2)
    neck_feats: Tuple[torch.Tensor, ...]


class CTResNetNeck(nn.Module):
    def __init__(self, cin: int, device,
                 filters: Sequence[int] = (256, 128, 64)):
        super().__init__()
        self.n = len(filters)
        for i, f in enumerate(filters):
            self.add_module(f"conv{i}", nn.Conv2d(cin, f, 3, padding=1,
                                                  bias=False, device=device))
            self.add_module(f"conv_bn{i}", FrozenBatchNorm(f, device))
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(
                f, f, 4, stride=2, padding=1, bias=False, device=device))
            self.add_module(f"deconv_bn{i}", FrozenBatchNorm(f, device))
            cin = f

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"conv_bn{i}")(
                getattr(self, f"conv{i}")(x)))
            x = F.relu(getattr(self, f"deconv_bn{i}")(
                getattr(self, f"deconv{i}")(x)))
        return x


class CenterNetHead(nn.Module):
    def __init__(self, device, num_classes: int = 80, in_channels: int = 64,
                 feat_channels: int = 64):
        super().__init__()
        for name, cout in (("heatmap", num_classes), ("wh", 2),
                           ("offset", 2)):
            self.add_module(f"{name}_conv", nn.Conv2d(
                in_channels, feat_channels, 3, padding=1, device=device))
            self.add_module(f"{name}_out", nn.Conv2d(feat_channels, cout, 1,
                                                     device=device))

    def forward(self, feat):
        return tuple(getattr(self, f"{name}_out")(F.relu(getattr(
            self, f"{name}_conv")(feat))).permute(0, 2, 3, 1)
            for name in ("heatmap", "wh", "offset"))


class CenterNet(nn.Module):
    def __init__(self, device, num_classes: int = 80, depth: int = 18,
                 frozen_stages: int = -1):
        super().__init__()
        self.backbone = ResNet(depth, device, out_indices=(3,),
                               frozen_stages=frozen_stages)
        self.neck = CTResNetNeck(self.backbone.out_channels[3], device)
        self.bbox_head = CenterNetHead(device, num_classes)

    def forward(self, images, img_hw) -> CenterNetOutputs:
        """images (B, H, W, 3) normalised NHWC; img_hw is unused by the
        forward."""
        neck = self.neck(self.backbone(images.permute(0, 3, 1, 2))[-1])
        heatmap, wh, offset = self.bbox_head(neck)
        return CenterNetOutputs(heatmap, wh, offset, (neck,))


def render_targets(gt_bboxes, gt_labels, gt_valid, num_classes: int,
                   feat_hw, stride: int = 4):
    """Every image's targets, GT boxes in input pixels (B, G, 4): (heatmap
    (B, H, W, C), size (B, G, 2), offset (B, G, 2), centre cells (B, G, 2)
    as (y, x), valid (B, G))."""
    H, W = feat_hw
    cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2 / stride
    cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2 / stride
    w = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) / stride
    h = (gt_bboxes[..., 3] - gt_bboxes[..., 1]) / stride
    ix = torch.clamp(torch.floor(cx), 0, W - 1).long()
    iy = torch.clamp(torch.floor(cy), 0, H - 1).long()
    radius = torch.clamp(gaussian_radius(h, w), min=0)
    onehot = (F.one_hot(gt_labels.long(), num_classes).to(gt_bboxes.dtype)
              * gt_valid[..., None].to(gt_bboxes.dtype))
    heatmap = gaussian_splat_max(ix, iy, onehot, radius, (H, W))
    return (heatmap, torch.stack([w, h], -1),
            torch.stack([cx - ix, cy - iy], -1), torch.stack([iy, ix], -1),
            gt_valid)


class CenterNetLossConfig(NamedTuple):
    num_classes: int = 80
    loss_heatmap_weight: float = 1.0
    loss_wh_weight: float = 0.1
    loss_offset_weight: float = 1.0


def centernet_loss(out: CenterNetOutputs, gt_bboxes, gt_labels, gt_valid,
                   cfg: CenterNetLossConfig, stride: int = 4
                   ) -> Dict[str, torch.Tensor]:
    B, H, W, C = out.heatmap.shape
    with torch.no_grad():
        hm_t, wh_t, off_t, centers, valid = render_targets(
            gt_bboxes.to(out.heatmap.dtype), gt_labels, gt_valid, C, (H, W),
            stride)
    # an f32 count, as JAX's: the loss's eps vanishes in its rounding
    num_pos = valid.sum().float().clamp(min=1.0)
    loss_heatmap = cfg.loss_heatmap_weight * L.gaussian_focal_loss(
        torch.sigmoid(out.heatmap).reshape(-1), hm_t.reshape(-1),
        avg_factor=num_pos)
    flat = (centers[..., 0] * W + centers[..., 1])[..., None].expand(-1, -1,
                                                                      2)
    wh_pred = torch.gather(out.wh.reshape(B, H * W, 2), 1, flat)
    off_pred = torch.gather(out.offset.reshape(B, H * W, 2), 1, flat)
    w_ = valid.to(out.wh.dtype).reshape(-1, 1)
    return dict(
        loss_center_heatmap=loss_heatmap,
        loss_wh=cfg.loss_wh_weight * L.l1_loss(
            wh_pred.reshape(-1, 2), wh_t.reshape(-1, 2), weight=w_,
            avg_factor=2 * num_pos),
        loss_offset=cfg.loss_offset_weight * L.l1_loss(
            off_pred.reshape(-1, 2), off_t.reshape(-1, 2), weight=w_,
            avg_factor=2 * num_pos))


PLATEAU_TOL = 1e-6


def local_maxima(heat: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) scores where they equal their 3x3 max-pool (padded
    with -inf) within PLATEAU_TOL, else 0."""
    pooled = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, 1, 1).permute(
        0, 2, 3, 1)
    return torch.where((pooled - heat).abs() < PLATEAU_TOL, heat,
                       torch.zeros_like(heat))


def centernet_get_bboxes(out: CenterNetOutputs, img_hw, scale_factor=None,
                         topk: int = 100, stride: int = 4,
                         score_thr: float = 0.0,
                         rescale: bool = False) -> Detections:
    """The ``topk`` local maxima of the heatmap as boxes, NMS-free;
    ``keep_qid`` each one's flat (cell, class) index."""
    B, H, W, C = out.heatmap.shape
    heat = local_maxima(torch.sigmoid(out.heatmap)).reshape(B, -1)
    scores, idx = torch.sort(heat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :topk], idx[:, :topk]
    cls = (idx % C).to(torch.int32)
    pix = idx // C
    ys = (pix // W).to(scores.dtype)
    xs = (pix % W).to(scores.dtype)
    g = pix[..., None].expand(-1, -1, 2)
    o = torch.gather(out.offset.reshape(B, -1, 2), 1, g)
    s = torch.gather(out.wh.reshape(B, -1, 2), 1, g)
    cxs = (xs + o[..., 0]) * stride
    cys = (ys + o[..., 1]) * stride
    bw, bh = s[..., 0] * stride, s[..., 1] * stride
    boxes = torch.stack([cxs - bw / 2, cys - bh / 2, cxs + bw / 2,
                         cys + bh / 2], -1)
    hw = img_hw.to(boxes.dtype)
    h, w = hw[:, 0, None], hw[:, 1, None]
    boxes = torch.stack([boxes[..., 0].clamp(min=0).minimum(w),
                         boxes[..., 1].clamp(min=0).minimum(h),
                         boxes[..., 2].clamp(min=0).minimum(w),
                         boxes[..., 3].clamp(min=0).minimum(h)], -1)
    if rescale and scale_factor is not None:
        boxes = boxes / scale_factor[:, None, :]
    return Detections(boxes, scores, cls, scores > score_thr, idx)


# --- init and family registration (dskd_tpu_torch/registry.py) -------------

def build_centernet(model_cfg, device="cuda") -> CenterNet:
    m = model_cfg
    return CenterNet(device, num_classes=m.num_classes, depth=m.depth,
                     frozen_stages=m.frozen_stages)


@torch.no_grad()
def init_centernet(model: CenterNet, seed: int = 0) -> None:
    """Seeded random weights at the scales of JAX's initializers:
    lecun-normal convs and transposed convs (fan-in kh x kw x in), the size
    and offset branches normal(0.001), zero biases but the heatmap's
    -2.19, identity BatchNorms."""
    g = torch.Generator().manual_seed(seed)
    init_conv_bn(model, g, lambda name: "lecun")
    for mod in model.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            t = mod.weight                                # (in, out, kh, kw)
            put_(t, torch.empty(t.shape).normal_(
                0, (t.shape[0] * t.shape[2] * t.shape[3]) ** -0.5,
                generator=g))
    head = model.bbox_head
    for name in ("wh", "offset"):
        for part in ("conv", "out"):
            conv = getattr(head, f"{name}_{part}")
            put_(conv.weight, torch.empty(conv.weight.shape).normal_(
                0, 0.001, generator=g))
    head.heatmap_out.bias.fill_(HEATMAP_BIAS)


def _register():
    from ..registry import register_family
    from ..utils.weights import centernet_state_dict_from_jax

    def losses(model, cfg, *, num_prev, has_teacher, use_dropout):
        det_cfg = CenterNetLossConfig(num_classes=cfg.model.num_classes)

        # JAX's CenterNet losses read no teacher
        def losses_fn(model, batch, teacher, generator):
            return centernet_loss(model(batch.images, batch.img_hw),
                                  batch.gt_bboxes, batch.gt_labels,
                                  batch.gt_valid, det_cfg)
        return losses_fn

    def eval_step(model, *, score_thr, max_per_img, reg_max=None):
        @torch.inference_mode()
        def step(images, img_hw, scale_factors) -> Detections:
            return centernet_get_bboxes(
                model(images, img_hw), img_hw, scale_factor=scale_factors,
                score_thr=max(score_thr, 0.05), topk=max_per_img,
                rescale=True)
        return step

    register_family("centernet", build=build_centernet,
                    init_weights=init_centernet,
                    from_jax=centernet_state_dict_from_jax, losses=losses,
                    eval_step=eval_step)


_register()
