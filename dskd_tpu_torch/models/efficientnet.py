"""EfficientNet backbone (port of dskd_tpu/models/efficientnet.py
``round_filters``, ``round_repeats``, ``swish``, ``_eff_bn``, ``MBConv``
and ``EfficientNet``).

MBConv inverted residuals with squeeze-excitation (0.25 of the block's
input channels) and swish, compound-scaled from the B0 table (widths by
``width_mult`` rounded to multiples of 8, repeats by ``depth_mult``
rounded up). Detection taps the stride-8/16/32 stages (``out_indices``
(2, 4, 6): 48, 136 and 384 channels for B3). The reference recipe trains
the BatchNorms: ``TrainableBatchNorm(momentum=0.99, eps=1e-3)``, flax's
update rule (torch momentum 0.01), on the batch in training and on the
running statistics in eval mode; ``norm_eval`` freezes them instead
(``FrozenBatchNorm(eps=1e-3)``). Stochastic depth: the residual branch of
block ``i`` of ``n`` is dropped per sample at rate ``drop_path_rate * i /
(n - 1)`` in training, the kept ones scaled by 1 / keep
(``backbones.drop_path``). ``frozen_stages``: 0 freezes nothing, 1 the
stem, 1 + k the stem and the first k stages. NCHW; parameter names are
JAX's (``stem_conv``, ``stage{s}_block{b}.expand_conv`` ...).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .backbones import drop_path
from .dilated_encoder import TrainableBatchNorm, swish
from .resnet import FrozenBatchNorm

# B0 rows: (expand_ratio, out_channels, repeats, kernel, stride)
B0_ARCH = (
    (1, 16, 1, 3, 1),
    (6, 24, 2, 3, 2),
    (6, 40, 2, 5, 2),
    (6, 80, 3, 3, 2),
    (6, 112, 3, 5, 1),
    (6, 192, 4, 5, 2),
    (6, 320, 1, 3, 1),
)
# (width_mult, depth_mult)
SCALES = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
          "b3": (1.2, 1.4), "b4": (1.4, 1.8), "b5": (1.6, 2.2)}
BN_MOMENTUM = 0.99       # flax's convention; torch's 0.01
BN_EPS = 1e-3


def round_filters(ch: float, width_mult: float, divisor: int = 8) -> int:
    ch = ch * width_mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return int(new)


def round_repeats(n: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * n))


def _eff_bn(channels: int, device, norm_eval: bool) -> nn.Module:
    if norm_eval:
        return FrozenBatchNorm(channels, device, eps=BN_EPS)
    return TrainableBatchNorm(channels, device, momentum=BN_MOMENTUM,
                              eps=BN_EPS)


def _conv(cin, cout, k, stride, device, groups=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=bias, device=device)


class MBConv(nn.Module):
    def __init__(self, cin: int, out_ch: int, expand_ratio: int, kernel: int,
                 stride: int, device, se_ratio: float = 0.25,
                 drop_path: float = 0.0, norm_eval: bool = False):
        super().__init__()
        mid = cin * expand_ratio
        if expand_ratio != 1:
            self.expand_conv = _conv(cin, mid, 1, 1, device)
            self.expand_bn = _eff_bn(mid, device, norm_eval)
        self.dw_conv = _conv(mid, mid, kernel, stride, device, groups=mid)
        self.dw_bn = _eff_bn(mid, device, norm_eval)
        se_ch = max(1, int(cin * se_ratio))
        self.se_reduce = _conv(mid, se_ch, 1, 1, device, bias=True)
        self.se_expand = _conv(se_ch, mid, 1, 1, device, bias=True)
        self.project_conv = _conv(mid, out_ch, 1, 1, device)
        self.project_bn = _eff_bn(out_ch, device, norm_eval)
        self.residual = stride == 1 and cin == out_ch
        self.drop_path = drop_path

    def forward(self, x, generator=None):
        y = x
        if hasattr(self, "expand_conv"):
            y = swish(self.expand_bn(self.expand_conv(y)))
        y = swish(self.dw_bn(self.dw_conv(y)))
        sq = swish(self.se_reduce(y.mean(dim=(2, 3), keepdim=True)))
        y = y * torch.sigmoid(self.se_expand(sq))
        y = self.project_bn(self.project_conv(y))
        if self.residual:
            y = drop_path(y, self.drop_path, generator, self.training) + x
        return y


class EfficientNet(nn.Module):
    def __init__(self, device, arch: str = "b3",
                 out_indices: Sequence[int] = (2, 4, 6),
                 frozen_stages: int = 0, drop_path_rate: float = 0.0,
                 norm_eval: bool = False):
        super().__init__()
        wm, dm = SCALES[arch]
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        stem_ch = round_filters(32, wm)
        self.stem_conv = _conv(3, stem_ch, 3, 2, device)
        self.stem_bn = _eff_bn(stem_ch, device, norm_eval)
        total = sum(round_repeats(n, dm) for _, _, n, _, _ in B0_ARCH)
        self.repeats = []
        cin, bi = stem_ch, 0
        for si, (er, ch, n, k, s) in enumerate(B0_ARCH):
            out_ch = round_filters(ch, wm)
            reps = round_repeats(n, dm)
            for b in range(reps):
                dpr = (drop_path_rate * bi / max(total - 1, 1)
                       if drop_path_rate > 0 else 0.0)
                self.add_module(f"stage{si}_block{b}", MBConv(
                    cin, out_ch, er, k, s if b == 0 else 1, device,
                    drop_path=dpr, norm_eval=norm_eval))
                cin = out_ch
                bi += 1
            self.repeats.append(reps)
        self.out_channels = [round_filters(B0_ARCH[i][1], wm)
                             for i in self.out_indices]

    def forward(self, x, generator=None) -> Tuple:
        y = swish(self.stem_bn(self.stem_conv(x)))
        if self.frozen_stages >= 1:
            y = y.detach()
        outs = []
        for si, reps in enumerate(self.repeats):
            for b in range(reps):
                y = getattr(self, f"stage{si}_block{b}")(y, generator)
            if si + 2 <= self.frozen_stages:
                y = y.detach()
            if si in self.out_indices:
                outs.append(y)
        return tuple(outs)
