"""The DyHead neck (port of dskd_tpu/models/dyhead.py ``hard_sigmoid``,
``_upsample_align_corners``, ``DyReLU``, ``_DyDCN``, ``DyHeadBlock`` and
``DyHead``), ATSS-DyHead's attention blocks between the FPN and a head
without towers.

Each block, per level: one ``spatial_conv_offset`` (3x3, 27 channels: 18
offsets, then 9 mask logits; zero at the init), shared by the levels and
by the block's three modulated deformable 3x3 convs + GroupNorm(16): mid
on the level, low (stride 2) on the finer level, high on the coarser
level with the offsets and mask taken at every second position (JAX's
documented deviation from mmdet, which reads the full-size offsets) and
upsampled bilinearly, corners aligned, to the level's size. Each branch
is gated by hard_sigmoid(relu(1x1 conv of its global mean)), one
``scale_attn_module`` for all; their mean goes through DyReLU
(max(x a1 + b1, x a2 + b2), the four from a squeeze of the global mean).
NCHW in and out; the offsets and mask are NHWC, as JAX's. Module names
are mmdet's (``dyhead_blocks.i.spatial_conv_{high,mid,low}.conv/.norm``,
``scale_attn_module.1``, ``task_attn_module.conv{1,2}.conv``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import DeformConv


def hard_sigmoid(x, bias: float = 3.0, divisor: float = 6.0):
    return ((x + bias) / divisor).clamp(0.0, 1.0)


class HSigmoid(nn.Module):
    """``hard_sigmoid`` as a module (mmcv's HSigmoid). torch's own
    ``nn.Hardsigmoid`` multiplies by an f32 1/6 in every dtype, 3e-8 off
    in f64."""

    def forward(self, x):
        return hard_sigmoid(x)


def _upsample_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NCHW bilinear resize on the align_corners=True grid (JAX's
    hand-written one, mmdet's F.interpolate call)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


class _Conv(nn.Module):
    """A 1x1 conv under mmcv's ConvModule name ``conv``."""

    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, device=device)


class DyReLU(nn.Module):
    def __init__(self, channels: int, device, ratio: int = 4):
        super().__init__()
        self.channels = channels
        self.conv1 = _Conv(channels, channels // ratio, device)
        self.conv2 = _Conv(channels // ratio, 4 * channels, device)

    def forward(self, x):
        c = self.channels
        g = F.relu(self.conv1.conv(x.mean((2, 3), keepdim=True)))
        g = hard_sigmoid(self.conv2.conv(g)) - 0.5
        a1 = g[:, :c] * 2.0 + 1.0
        b1 = g[:, c:2 * c]
        a2 = g[:, 2 * c:3 * c] * 2.0
        b2 = g[:, 3 * c:]
        return torch.maximum(x * a1 + b1, x * a2 + b2)


class _DyDCN(nn.Module):
    """Modulated deformable 3x3 conv on external offsets, then
    GroupNorm(16)."""

    def __init__(self, cin: int, cout: int, device, stride: int = 1):
        super().__init__()
        self.conv = DeformConv(cin, cout, device, stride=stride)
        self.norm = nn.GroupNorm(16, cout, eps=1e-5, device=device)

    def forward(self, x, offsets, mask):
        return self.norm(self.conv(x, offsets, mask))


class DyHeadBlock(nn.Module):
    def __init__(self, channels: int, device):
        super().__init__()
        self.spatial_conv_high = _DyDCN(channels, channels, device)
        self.spatial_conv_mid = _DyDCN(channels, channels, device)
        self.spatial_conv_low = _DyDCN(channels, channels, device, stride=2)
        self.spatial_conv_offset = nn.Conv2d(channels, 27, 3, padding=1,
                                             device=device)
        self.scale_attn_module = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(channels, 1, 1, device=device),
            nn.ReLU(), HSigmoid())
        self.task_attn_module = DyReLU(channels, device)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        outs = []
        L = len(feats)
        for lvl in range(L):
            om = self.spatial_conv_offset(feats[lvl]).permute(0, 2, 3, 1)
            offsets, mask = om[..., :18], torch.sigmoid(om[..., 18:])
            mid = self.spatial_conv_mid(feats[lvl], offsets, mask)
            s = mid * self.scale_attn_module(mid)
            n = 1
            if lvl > 0:
                low = self.spatial_conv_low(feats[lvl - 1], offsets, mask)
                s = s + low * self.scale_attn_module(low)
                n += 1
            if lvl < L - 1:
                hi = self.spatial_conv_high(feats[lvl + 1],
                                            offsets[:, ::2, ::2],
                                            mask[:, ::2, ::2])
                hi = _upsample_align_corners(hi, mid.shape[2:])
                s = s + hi * self.scale_attn_module(hi)
                n += 1
            outs.append(self.task_attn_module(s / n))
        return tuple(outs)


class DyHead(nn.Module):
    def __init__(self, device, channels: int = 256, num_blocks: int = 6):
        super().__init__()
        self.dyhead_blocks = nn.Sequential(*(DyHeadBlock(channels, device)
                                             for _ in range(num_blocks)))

    def forward(self, feats) -> Tuple[torch.Tensor, ...]:
        for block in self.dyhead_blocks:
            feats = block(feats)
        return tuple(feats)


@torch.no_grad()
def init_dyhead(dyhead: DyHead, g: torch.Generator) -> None:
    """JAX's initializers, drawn on the CPU from ``g``: each deformable
    kernel uniform with variance 1/(3 fan_in) (mmcv's
    ModulatedDeformConv2d), the offset convs zero, the scale and task
    attention convs normal(0.01) with zero biases, GroupNorms identity."""
    from .detector import put_

    for name, mod in dyhead.named_modules():
        if isinstance(mod, DeformConv):
            bound = mod.weight[0].numel() ** -0.5
            put_(mod.weight, torch.empty(mod.weight.shape).uniform_(
                -bound, bound, generator=g))
        elif isinstance(mod, nn.Conv2d):
            if name.endswith("spatial_conv_offset"):
                mod.weight.zero_()
            else:
                put_(mod.weight, torch.empty(mod.weight.shape).normal_(
                    0, 0.01, generator=g))
            mod.bias.zero_()
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
