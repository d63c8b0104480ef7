"""ChannelMapper neck (port of dskd_tpu/models/channel_mapper.py
``ChannelMapper``).

One 1x1 conv + GroupNorm(32) per input level, plus stride-2 3x3 conv + GN
extra levels, the first on the last input (C5), each next on the previous
extra level. Parameter names follow mmdet (``convs.i.conv/gn``,
``extra_convs.j.conv/gn``). NCHW in and out.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn


class ConvGN(nn.Module):
    def __init__(self, cin, cout, k, stride, num_groups, device):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                              device=device)
        self.gn = nn.GroupNorm(num_groups, cout, eps=1e-5, device=device)

    def forward(self, x):
        return self.gn(self.conv(x))


class ChannelMapper(nn.Module):
    def __init__(self, in_channels: Sequence[int], device,
                 out_channels: int = 256, num_outs: int = 4,
                 num_groups: int = 32):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvGN(c, out_channels, 1, 1, num_groups, device)
            for c in in_channels)
        n_extra = num_outs - len(in_channels)
        self.extra_convs = nn.ModuleList(
            ConvGN(in_channels[-1] if j == 0 else out_channels, out_channels,
                   3, 2, num_groups, device)
            for j in range(n_extra))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        outs = [conv(x) for conv, x in zip(self.convs, inputs)]
        x = inputs[-1]
        for conv in self.extra_convs:
            x = conv(x)
            outs.append(x)
        return tuple(outs)
