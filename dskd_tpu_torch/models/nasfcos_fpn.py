"""The NAS-FCOS searched neck (port of dskd_tpu/models/nasfcos_fpn.py
``_resize_bilinear``, ``ConcatCell``, ``CELLS`` and ``NASFCOSFPN``), the
neck of FCOS's ``nasfcos`` arch.

C3-C5 -> 1x1 adapt convs without bias + BatchNorm + ReLU give f0-f2; seven
concat cells append f3-f9, each: a 3x3 conv without bias + GroupNorm(32)
on both inputs, both resized to the larger, concatenated, then BatchNorm
-> ReLU -> a grouped 1x1 conv (C groups of 2: output c reads the concat's
channels 2c and 2c + 1, neighbours, as flax's ``feature_group_count``
groups them). P3-P5 are f9, f8, f7 plus f5 resized to them, resized to
C3-C5's sizes; P6, P7 are stride-2 3x3 convs, a ReLU before every one
but the first and no norm. Resizes are ``jax.image.resize``'s bilinear:
half-pixel centres, antialiased when shrinking (``F.interpolate`` with
``antialias=True``). The BatchNorms run on their running statistics in
training too, as JAX's FCOS runs this neck (``deterministic=True`` with a
ResNet backbone). NCHW. Module names follow mmdet's
``necks/nasfcos_fpn.py`` (``adapt_convs.i.conv/.bn``,
``fpn.<cell>.input{1,2}_conv.conv/.gn``, ``fpn.<cell>.out_conv.bn/.conv``,
``extra_downsamples.j.conv``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dilated_encoder import TrainableBatchNorm
from .fpn import ConvWrap
from .nas_fpn import ConvBN

# cell name -> (input index 1, input index 2); appended as f3-f9 in order
CELLS = (("c22_1", 2, 2), ("c22_2", 2, 2), ("c32", 3, 2), ("c02", 0, 2),
         ("c42", 4, 2), ("c36", 3, 6), ("c61", 6, 1))


def _resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW ``x`` at the size ``hw``: ``jax.image.resize(..., "bilinear")``
    (antialiased when it shrinks)."""
    hw = tuple(int(s) for s in hw)
    if tuple(x.shape[2:]) == hw:
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
                         antialias=True)


class _ConvGN(nn.Module):
    """3x3 conv without bias -> GroupNorm(32), no activation."""

    def __init__(self, channels: int, device):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, bias=False,
                              device=device)
        self.gn = nn.GroupNorm(32, channels, eps=1e-5, device=device)

    def forward(self, x):
        return self.gn(self.conv(x))


class _OutConv(nn.Module):
    """BatchNorm (running statistics) -> ReLU -> grouped 1x1 conv."""

    def __init__(self, channels: int, device):
        super().__init__()
        self.bn = TrainableBatchNorm(2 * channels, device)
        self.conv = nn.Conv2d(2 * channels, channels, 1, groups=channels,
                              bias=False, device=device)

    def forward(self, x):
        return self.conv(F.relu(self.bn(x, train=False)))


class ConcatCell(nn.Module):
    def __init__(self, channels: int, device):
        super().__init__()
        self.input1_conv = _ConvGN(channels, device)
        self.input2_conv = _ConvGN(channels, device)
        self.out_conv = _OutConv(channels, device)

    def forward(self, x1, x2):
        x1, x2 = self.input1_conv(x1), self.input2_conv(x2)
        hw = (max(x1.shape[2], x2.shape[2]), max(x1.shape[3], x2.shape[3]))
        return self.out_conv(torch.cat([_resize_bilinear(x1, hw),
                                        _resize_bilinear(x2, hw)], 1))


class NASFCOSFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], device,
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        C = out_channels
        self.adapt_convs = nn.ModuleList(ConvBN(c, C, 1, device)
                                         for c in in_channels)
        self.fpn = nn.ModuleDict({name: ConcatCell(C, device)
                                  for name, _, _ in CELLS})
        self.extra_downsamples = nn.ModuleList(
            ConvWrap(C, C, 3, device, stride=2)
            for _ in range(num_outs - len(in_channels)))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        feats = [F.relu(conv(x)) for conv, x in zip(self.adapt_convs, inputs)]
        for name, i1, i2 in CELLS:
            feats.append(self.fpn[name](feats[i1], feats[i2]))
        ret = []
        for idx, in_idx in zip((9, 8, 7), (0, 1, 2)):
            f1 = feats[idx]
            f2 = _resize_bilinear(feats[5], f1.shape[2:])
            ret.append(_resize_bilinear(f1 + f2, inputs[in_idx].shape[2:]))
        x = ret[-1]
        for j, conv in enumerate(self.extra_downsamples):
            if j > 0:
                x = F.relu(x)
            x = conv(x)
            ret.append(x)
        return tuple(ret)
