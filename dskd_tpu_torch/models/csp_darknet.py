"""CSPDarknet backbone (port of dskd_tpu/models/csp_darknet.py ``Focus``,
``SPPBottleneck`` and ``CSPDarknet``), on the port's own PAFPN bricks
(``yoloy_pafpn.conv_bn_swish`` and ``CSPLayer``: conv, TrainableBatchNorm
of momentum 0.97, swish).

YOLOX's backbone: a Focus stem (2x2 space-to-depth, then a 3x3 conv),
four stages of a 3x3/2 conv and a CSP layer, with an SPP bottleneck (max
pools of 5, 9 and 13, stride 1, padded with -inf) before the last CSP
layer. ``deepen_factor`` and ``widen_factor`` scale the blocks and widths
(YOLOX-s: 0.33 and 0.5). NCHW; module names are JAX's (``stem.conv``,
``stage{i}_down``, ``stage{i}_spp``, ``stage{i}_csp``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .yoloy_pafpn import CSPLayer, conv_bn_swish

# (out_channels, num_blocks, add_identity, use_spp) per stage (P5 arch)
ARCH = ((128, 3, True, False), (256, 9, True, False),
        (512, 9, True, False), (1024, 3, False, True))


def focus_patches(x: torch.Tensor) -> torch.Tensor:
    """NCHW space-to-depth in JAX's order of the four phases (row, column):
    (0, 0), (1, 0), (0, 1), (1, 1), each a block of the input's
    channels."""
    return torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                      x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], 1)


class Focus(nn.Module):
    def __init__(self, cin: int, out_channels: int, device):
        super().__init__()
        self.conv = conv_bn_swish(4 * cin, out_channels, 3, device)

    def forward(self, x):
        return self.conv(focus_patches(x))


class SPPBottleneck(nn.Module):
    def __init__(self, cin: int, out_channels: int, device,
                 kernel_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        mid = cin // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = conv_bn_swish(cin, mid, 1, device)
        self.conv2 = conv_bn_swish(mid * (len(kernel_sizes) + 1),
                                   out_channels, 1, device)

    def forward(self, x):
        y = self.conv1(x)
        pools = [y] + [F.max_pool2d(y, k, 1, k // 2)
                       for k in self.kernel_sizes]
        return self.conv2(torch.cat(pools, 1))


class CSPDarknet(nn.Module):
    """``out_indices`` are stage ids 1-4 ((2, 3, 4): strides 8-32);
    features are detached after the stem (``frozen_stages >= 0``) and after
    each stage ``<= frozen_stages``."""

    def __init__(self, device, deepen_factor: float = 1.0,
                 widen_factor: float = 1.0,
                 out_indices: Sequence[int] = (2, 3, 4),
                 frozen_stages: int = -1):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        cin = int(64 * widen_factor)
        self.stem = Focus(3, cin, device)
        self.spp = []
        self.out_channels = []
        for i, (ch, n, ident, spp) in enumerate(ARCH):
            ch = int(ch * widen_factor)
            n = max(round(n * deepen_factor), 1)
            self.add_module(f"stage{i + 1}_down",
                            conv_bn_swish(cin, ch, 3, device, stride=2))
            if spp:
                self.add_module(f"stage{i + 1}_spp",
                                SPPBottleneck(ch, ch, device))
            self.add_module(f"stage{i + 1}_csp", CSPLayer(
                ch, ch, device, num_blocks=n, add_identity=ident))
            self.spp.append(spp)
            if i + 1 in self.out_indices:
                self.out_channels.append(ch)
            cin = ch

    def forward(self, x) -> Tuple:
        out = self.stem(x)
        if self.frozen_stages >= 0:
            out = out.detach()
        outs = []
        for i, spp in enumerate(self.spp):
            out = getattr(self, f"stage{i + 1}_down")(out)
            if spp:
                out = getattr(self, f"stage{i + 1}_spp")(out)
            out = getattr(self, f"stage{i + 1}_csp")(out)
            if self.frozen_stages >= i + 1:
                out = out.detach()
            if i + 1 in self.out_indices:
                outs.append(out)
        return tuple(outs)
