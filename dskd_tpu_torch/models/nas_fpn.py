"""NAS-FPN (port of dskd_tpu/models/nas_fpn.py ``_resize_to``,
``_MergeCell`` and ``NASFPN``), the neck of ``retinanet_nasfpn``.

Every input gets a 1x1 conv without bias and a BatchNorm
(``lateral_convs``); each level past the inputs is a 1x1 conv + BN of the
level below, max-pooled 2x (``extra_downsamples``). Seven stacks of the
searched merging DAG follow, each
    p4_1 = gp(p6, p4); p4_2 = sum(p4_1, p4); p3 = sum(p4_2, p3)
    p4 = sum(p3, p4_2); p5 = sum(p5, gp(p4, p3)); p7 = sum(p7, gp(p5, p4_2))
    p6 = gp(p7, p5)
where a cell resizes both inputs to its output's size (integer nearest
upsampling, or a max-pool of stride and kernel the ratio, no padding),
then sums them (``sum``) or gates the first by the sigmoid of the second's
global mean (``gp``: x2 + sigmoid(mean(x2)) x1), then, but in the two
inner gp cells, ReLU -> 3x3 conv without bias -> BN. The BatchNorms are
``TrainableBatchNorm``s that the neck runs as the JAX module runs inside
RetinaNet, which never passes it ``deterministic``: on their running
statistics, in training too, so that only their affine parameters train.
Module names follow mmdet's ``necks/nas_fpn.py``
(``fpn_stages.s.<cell>.out_conv.conv/.bn``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dilated_encoder import TrainableBatchNorm

# (cell, kind, out conv, inputs, output level): the searched DAG's order
CELLS = (("gp_64_4", "gp", True, ("p6", "p4"), "p4_1"),
         ("sum_44_4", "sum", True, ("p4_1", "p4"), "p4_2"),
         ("sum_43_3", "sum", True, ("p4_2", "p3"), "p3"),
         ("sum_34_4", "sum", True, ("p3", "p4_2"), "p4"),
         ("gp_43_5", "gp", False, ("p4", "p3"), "p5_t"),
         ("sum_55_5", "sum", True, ("p5", "p5_t"), "p5"),
         ("gp_54_7", "gp", False, ("p5", "p4_2"), "p7_t"),
         ("sum_77_7", "sum", True, ("p7", "p7_t"), "p7"),
         ("gp_75_6", "gp", True, ("p7", "p5"), "p6"))
# each output's size: that of the level it stands for
_SIZE_OF = {"p4_1": "p4", "p4_2": "p4", "p5_t": "p5", "p7_t": "p7"}


def resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW ``x`` at the size ``hw``: itself, repeated (h // H)x in both
    axes when smaller, or max-pooled with kernel and stride H // h when
    larger."""
    h, w = hw
    H, W = x.shape[2:]
    if (H, W) == (h, w):
        return x
    if H < h:
        f = h // H
        return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
    k = H // h
    return F.max_pool2d(x, k, stride=k)


class ConvBN(nn.Module):
    """conv (k x k, no bias) -> TrainableBatchNorm on its running
    statistics, mmdet's ConvModule names ``conv`` and ``bn``."""

    def __init__(self, cin: int, cout: int, k: int, device):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False,
                              device=device)
        self.bn = TrainableBatchNorm(cout, device)

    def forward(self, x):
        return self.bn(self.conv(x), train=False)


class MergeCell(nn.Module):
    def __init__(self, channels: int, kind: str, with_out_conv: bool,
                 device):
        super().__init__()
        self.kind = kind
        self.out_conv = (ConvBN(channels, channels, 3, device)
                         if with_out_conv else None)

    def forward(self, x1, x2, out_hw):
        x1, x2 = resize_to(x1, out_hw), resize_to(x2, out_hw)
        if self.kind == "sum":
            y = x1 + x2
        else:
            y = x2 + torch.sigmoid(x2.mean((2, 3), keepdim=True)) * x1
        if self.out_conv is not None:
            y = self.out_conv(F.relu(y))
        return y


class NASFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], device,
                 out_channels: int = 256, num_outs: int = 5,
                 stack_times: int = 7):
        super().__init__()
        C = out_channels
        self.lateral_convs = nn.ModuleList(
            ConvBN(c, C, 1, device) for c in in_channels)
        self.extra_downsamples = nn.ModuleList(
            ConvBN(C, C, 1, device)
            for _ in range(num_outs - len(in_channels)))
        self.fpn_stages = nn.ModuleList(
            nn.ModuleDict({name: MergeCell(C, kind, woc, device)
                           for name, kind, woc, _, _ in CELLS})
            for _ in range(stack_times))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        feats = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for conv in self.extra_downsamples:
            feats.append(F.max_pool2d(conv(feats[-1]), 2, stride=2))
        p = dict(zip(("p3", "p4", "p5", "p6", "p7"), feats))
        for stage in self.fpn_stages:
            for name, _, _, (a, b), dst in CELLS:
                hw = p[_SIZE_OF.get(dst, dst)].shape[2:]
                p[dst] = stage[name](p[a], p[b], hw)
        return tuple(p[k] for k in ("p3", "p4", "p5", "p6", "p7"))
