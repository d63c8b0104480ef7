"""MobileNetV2 backbone (port of dskd_tpu/models/mobilenet_v2.py
``InvertedResidual`` and ``MobileNetV2`` at width 1, the only width a
config uses).

Inverted residual blocks over the standard seven-stage table (expand
ratio, channels, blocks, first stride) after a 3x3/2 stem, with ReLU6 (or
the YOLOv3 recipe's LeakyReLU(0.1), ``act="leaky"``). ``train_bn``: the
BatchNorms train (``TrainableBatchNorm``, flax's rule, as the YOLOv3
recipe), else they are frozen (``FrozenBatchNorm``, ``norm_eval``).
``out_indices`` count the stages 0-6; the JAX module's eighth layer (the
1x1 conv to 1280 channels, index 7, SSDLite's) is not ported and raises.
``frozen_stages`` detaches after the stem (>= 0) and after each stage
``<= frozen_stages``. NCHW; parameter names are JAX's (``stem_conv``,
``stage{i}_block{b}.expand`` ...).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from .dilated_encoder import TrainableBatchNorm
from .resnet import FrozenBatchNorm

# (expand_ratio, out_channels, num_blocks, first_stride)
ARCH = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _act(x, act: str):
    return F.leaky_relu(x, 0.1) if act == "leaky" else F.relu6(x)


def _norm(channels, device, train_bn):
    return (TrainableBatchNorm(channels, device) if train_bn
            else FrozenBatchNorm(channels, device))


def _conv(cin, cout, k, stride, device, groups=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False, device=device)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, out_channels: int, stride: int,
                 expand_ratio: int, device, act: str = "relu6",
                 train_bn: bool = False):
        super().__init__()
        hidden = cin * expand_ratio
        self.act = act
        if expand_ratio != 1:
            self.expand = _conv(cin, hidden, 1, 1, device)
            self.expand_bn = _norm(hidden, device, train_bn)
        self.depthwise = _conv(hidden, hidden, 3, stride, device,
                               groups=hidden)
        self.depthwise_bn = _norm(hidden, device, train_bn)
        self.project = _conv(hidden, out_channels, 1, 1, device)
        self.project_bn = _norm(out_channels, device, train_bn)
        self.residual = stride == 1 and cin == out_channels

    def forward(self, x):
        y = x
        if hasattr(self, "expand"):
            y = _act(self.expand_bn(self.expand(y)), self.act)
        y = _act(self.depthwise_bn(self.depthwise(y)), self.act)
        y = self.project_bn(self.project(y))
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    def __init__(self, device, out_indices: Sequence[int] = (1, 2, 4, 6),
                 frozen_stages: int = -1, act: str = "relu6",
                 train_bn: bool = False):
        super().__init__()
        if 7 in out_indices:
            raise NotImplementedError("MobileNetV2's out index 7 (the 1x1 "
                                      "conv to 1280 channels) is not ported")
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.act = act
        c = 32
        self.stem_conv = _conv(3, c, 3, 2, device)
        self.stem_bn = _norm(c, device, train_bn)
        self.blocks = []
        widths = []
        for i, (t, ch, n, s) in enumerate(ARCH):
            for b in range(n):
                self.add_module(f"stage{i + 1}_block{b}", InvertedResidual(
                    c, ch, s if b == 0 else 1, t, device, act, train_bn))
                c = ch
            self.blocks.append(n)
            widths.append(ch)
        self.out_channels = [widths[i] for i in self.out_indices]

    def forward(self, x) -> Tuple:
        out = _act(self.stem_bn(self.stem_conv(x)), self.act)
        if self.frozen_stages >= 0:
            out = out.detach()
        outs = []
        for i, n in enumerate(self.blocks):
            for b in range(n):
                out = getattr(self, f"stage{i + 1}_block{b}")(out)
            if self.frozen_stages >= i + 1:
                out = out.detach()
            if i in self.out_indices:
                outs.append(out)
        return tuple(outs)
