"""ResNet backbone with frozen BatchNorm (port of dskd_tpu/models/resnet.py
``FrozenBatchNorm``, ``BasicBlock``, ``Bottleneck``, ``ResNet``).

BN runs on its stored statistics in training too, as the flagship's
``norm_eval`` does; its affine parameters still get gradients, which the
optimizer leaves out (``train/optim.py``). ``frozen_stages`` detaches the
features after the stem and after each stage ``<= frozen_stages``, as the
JAX module's ``stop_gradient`` does, so those weights get no gradient.
Convolutions run NCHW; padding is symmetric ``k // 2`` like the JAX module's
explicit padding, and the stem max-pool pads with -inf. Parameter
names are torchvision's (``conv1``, ``bn1``, ``layerS.B.convC``,
``downsample.0/1``), the names the mmdet checkpoints use. The dcn, gcb,
gen_attn and gn variants are not ported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),        # the tests' tiny configuration
    50: ("bottleneck", (3, 4, 6, 3)),   # the flagship
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm on running statistics: (x - mean) * rsqrt(var + eps) *
    weight + bias, per channel of an NCHW tensor."""

    def __init__(self, channels: int, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


def _conv(cin, cout, k, stride, device):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False, device=device)


def _downsample(cin, cout, stride, device):
    return nn.Sequential(_conv(cin, cout, 1, stride, device),
                         FrozenBatchNorm(cout, device))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, downsample, device):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, device)
        self.bn1 = FrozenBatchNorm(planes, device)
        self.conv2 = _conv(planes, planes, 3, 1, device)
        self.bn2 = FrozenBatchNorm(planes, device)
        self.downsample = (_downsample(inplanes, planes, stride, device)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """Pytorch-style bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x4)."""
    expansion = 4

    def __init__(self, inplanes, planes, stride, downsample, device):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, 1, device)
        self.bn1 = FrozenBatchNorm(planes, device)
        self.conv2 = _conv(planes, planes, 3, stride, device)
        self.bn2 = FrozenBatchNorm(planes, device)
        self.conv3 = _conv(planes, planes * 4, 1, 1, device)
        self.bn3 = FrozenBatchNorm(planes * 4, device)
        self.downsample = (_downsample(inplanes, planes * 4, stride, device)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet returning the stages in ``out_indices`` (0-based; (1, 2, 3)
    gives C3, C4, C5) as NCHW tensors."""

    def __init__(self, depth: int, device, out_indices: Sequence[int] = (
            1, 2, 3), base_channels: int = 64, frozen_stages: int = 1):
        super().__init__()
        kind, stage_blocks = ARCH_SETTINGS[depth]
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.conv1 = _conv(3, base_channels, 7, 2, device)
        self.bn1 = FrozenBatchNorm(base_channels, device)
        inplanes = base_channels
        self.out_channels = []
        for i, n in enumerate(stage_blocks):
            planes = base_channels * 2 ** i
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(n):
                # projection shortcut iff stride != 1 or channels change
                # (torchvision rule; basic stage 1 has none)
                ds = b == 0 and (i > 0 or block is Bottleneck)
                blocks.append(block(inplanes, planes, stride if b == 0 else 1,
                                    ds, device))
                inplanes = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.out_channels.append(inplanes)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        if self.frozen_stages >= 0:
            x = x.detach()
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i in range(len(self.out_channels)):
            x = getattr(self, f"layer{i + 1}")(x)
            if self.frozen_stages >= i + 1:
                x = x.detach()
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
