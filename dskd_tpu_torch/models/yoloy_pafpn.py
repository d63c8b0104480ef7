"""YOLOY's PAFPN neck and CSP layer (port of
dskd_tpu/models/yoloy_pafpn.py ``swish``, ``ConvBNSwish``,
``DarknetBottleneck``, ``CSPLayer``, ``_upsample2x`` and ``YOLOYPAFPN``).

Top-down, then bottom-up path aggregation with CSP blocks, NCHW; every conv
is followed by a TrainableBatchNorm of momentum 0.97 and swish. The widths
are JAX's: each top-down and bottom-up block keeps the width of the level it
writes. Module names follow mmdet's YOLOXPAFPN (``reduce_layers``,
``top_down_blocks``, ``downsamples``, ``bottom_up_blocks``, ``out_convs``;
a CSP layer's ``main_conv``, ``short_conv``, ``blocks.j.conv1/2``,
``final_conv``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .dilated_encoder import ConvModule

BN_MOMENTUM = 0.97


def conv_bn_swish(cin: int, cout: int, k: int, device,
                  stride: int = 1) -> ConvModule:
    return ConvModule(cin, cout, k, device, stride=stride,
                      momentum=BN_MOMENTUM, act="swish")


class DarknetBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, device, expansion: float = 0.5,
                 add_identity: bool = True):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = conv_bn_swish(cin, hidden, 1, device)
        self.conv2 = conv_bn_swish(hidden, cout, 3, device)
        self.add_identity = add_identity and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add_identity else y


class CSPLayer(nn.Module):
    """main (1x1 -> bottlenecks) and short (1x1) branches, concatenated
    [main, short] -> 1x1."""

    def __init__(self, cin: int, cout: int, device, num_blocks: int = 1,
                 expand_ratio: float = 0.5, add_identity: bool = True):
        super().__init__()
        mid = int(cout * expand_ratio)
        self.main_conv = conv_bn_swish(cin, mid, 1, device)
        self.short_conv = conv_bn_swish(cin, mid, 1, device)
        self.blocks = nn.Sequential(*(
            DarknetBottleneck(mid, mid, device, 1.0, add_identity)
            for _ in range(num_blocks)))
        self.final_conv = conv_bn_swish(2 * mid, cout, 1, device)

    def forward(self, x):
        main = self.blocks(self.main_conv(x))
        return self.final_conv(torch.cat([main, self.short_conv(x)], 1))


def _upsample2x(x, hw):
    """Nearest 2x upsampling cropped to ``hw``."""
    up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return up[:, :, :hw[0], :hw[1]]


class YOLOYPAFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], device,
                 out_channels: int = 128, num_csp_blocks: int = 1):
        super().__init__()
        L = len(in_channels)
        inner = list(in_channels)
        self.reduce_layers = nn.ModuleList()
        self.top_down_blocks = nn.ModuleList()
        for i in range(L - 1, 0, -1):        # mmdet's order: the top first
            self.reduce_layers.append(conv_bn_swish(inner[i], inner[i - 1],
                                                    1, device))
            inner[i] = inner[i - 1]
            self.top_down_blocks.append(CSPLayer(
                2 * inner[i - 1], inner[i - 1], device, num_csp_blocks,
                add_identity=False))
        self.downsamples = nn.ModuleList()
        self.bottom_up_blocks = nn.ModuleList()
        outs = [inner[0]]
        for i in range(L - 1):
            self.downsamples.append(conv_bn_swish(outs[-1], outs[-1], 3,
                                                  device, stride=2))
            self.bottom_up_blocks.append(CSPLayer(
                outs[-1] + inner[i + 1], inner[i + 1], device,
                num_csp_blocks, add_identity=False))
            outs.append(inner[i + 1])
        self.out_convs = nn.ModuleList(
            conv_bn_swish(c, out_channels, 1, device) for c in outs)

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        L = len(inputs)
        inners = list(inputs)
        for j, i in enumerate(range(L - 1, 0, -1)):
            inners[i] = self.reduce_layers[j](inners[i])
            up = _upsample2x(inners[i], inners[i - 1].shape[2:])
            inners[i - 1] = self.top_down_blocks[j](
                torch.cat([up, inners[i - 1]], 1))
        outs = [inners[0]]
        for i in range(L - 1):
            down = self.downsamples[i](outs[-1])
            outs.append(self.bottom_up_blocks[i](
                torch.cat([down, inners[i + 1]], 1)))
        return tuple(conv(o) for conv, o in zip(self.out_convs, outs))
