"""RegNetX backbone (port of dskd_tpu/models/regnet.py ``generate_regnet``,
``adjust_width_group``, ``RegNetBlock`` and ``RegNet``).

Per-block widths follow the linear-log schedule (w0, wa, wm, depth),
quantized to multiples of 8 and grouped into four stages; each block is a
bottleneck of expansion 1 with a grouped 3x3 conv (the group width from
the arch table) and frozen BatchNorm. The stem is one 3x3/2 conv of 32
channels without max-pool, so stage 1 downsamples. NCHW. Parameter names
are JAX's (``stem_conv``, ``stem_bn``, ``layer{s}_block{b}.conv1`` ...),
so the optimizer freezes the stem, the stages up to ``frozen_stages`` and
every BatchNorm affine as JAX's labels do.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch.nn as nn
import torch.nn.functional as F

from .resnet import FrozenBatchNorm

# mmdet arch table (regnet.py arch_parameter presets)
ARCHS = {
    "regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22),
    "regnetx_800mf": dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16),
    "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18),
    "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25),
    "regnetx_4.0gf": dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23),
    "regnetx_6.4gf": dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17),
    "regnetx_8.0gf": dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23),
    "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19),
}


def generate_regnet(w0: float, wa: float, wm: float, depth: int,
                    q: int = 8) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-stage (widths, depths) of the linear-log parameterization."""
    ws_cont = w0 + wa * np.arange(depth)
    ks = np.round(np.log(ws_cont / w0) / np.log(wm))
    ws = np.round(w0 * np.power(wm, ks) / q) * q
    widths, depths = [], []
    for w in ws.astype(int):
        if not widths or w != widths[-1]:
            widths.append(int(w))
            depths.append(1)
        else:
            depths[-1] += 1
    if len(widths) != 4:
        raise ValueError(f"RegNet schedule gives {len(widths)} stages")
    return tuple(widths), tuple(depths)


def adjust_width_group(widths, group_w):
    """Widths rounded to multiples of their (possibly shrunk) group
    widths."""
    groups = [min(group_w, w) for w in widths]
    widths = [int(round(w / g) * g) for w, g in zip(widths, groups)]
    return tuple(widths), tuple(groups)


def stage_plan(arch: str):
    """(widths, depths, group widths) of ``arch``'s four stages."""
    cfg = ARCHS[arch]
    widths, depths = generate_regnet(cfg["w0"], cfg["wa"], cfg["wm"],
                                     cfg["depth"])
    widths, groups = adjust_width_group(widths, cfg["group_w"])
    return widths, depths, groups


def _conv(cin, cout, k, stride, device, groups=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False, device=device)


class RegNetBlock(nn.Module):
    """1x1 -> grouped 3x3 (stride) -> 1x1, expansion 1."""

    def __init__(self, cin: int, width: int, group_width: int, stride: int,
                 device):
        super().__init__()
        self.conv1 = _conv(cin, width, 1, 1, device)
        self.bn1 = FrozenBatchNorm(width, device)
        self.conv2 = _conv(width, width, 3, stride, device,
                           groups=width // group_width)
        self.bn2 = FrozenBatchNorm(width, device)
        self.conv3 = _conv(width, width, 1, 1, device)
        self.bn3 = FrozenBatchNorm(width, device)
        self.has_downsample = stride != 1 or cin != width
        if self.has_downsample:
            self.downsample_conv = _conv(cin, width, 1, stride, device)
            self.downsample_bn = FrozenBatchNorm(width, device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idn = (self.downsample_bn(self.downsample_conv(x))
               if self.has_downsample else x)
        return F.relu(y + idn)


class RegNet(nn.Module):
    """The stages in ``out_indices`` (0-based) as NCHW tensors; features
    are detached after the stem and after each stage ``<=
    frozen_stages``."""

    def __init__(self, device, arch: str = "regnetx_3.2gf",
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = 1):
        super().__init__()
        widths, depths, groups = stage_plan(arch)
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.depths = depths
        self.stem_conv = _conv(3, 32, 3, 2, device)
        self.stem_bn = FrozenBatchNorm(32, device)
        cin = 32
        for s, (w, d, g) in enumerate(zip(widths, depths, groups)):
            for b in range(d):
                self.add_module(f"layer{s + 1}_block{b}", RegNetBlock(
                    cin, w, g, 2 if b == 0 else 1, device))
                cin = w
        self.out_channels = list(widths)

    def forward(self, x) -> Tuple:
        y = F.relu(self.stem_bn(self.stem_conv(x)))
        if self.frozen_stages >= 0:
            y = y.detach()
        outs = []
        for s, d in enumerate(self.depths):
            for b in range(d):
                y = getattr(self, f"layer{s + 1}_block{b}")(y)
            if s + 1 <= self.frozen_stages:
                y = y.detach()
            if s in self.out_indices:
                outs.append(y)
        return tuple(outs)
