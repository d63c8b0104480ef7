"""HRNet backbone and HRFPN neck (port of dskd_tpu/models/hrnet.py
``_nearest_up``, ``HRModule``, ``HRNet`` and ``HRFPN``).

HRNetV2p: a stride-4 stem of two 3x3/2 convs, one stage of four
bottlenecks, then parallel branches of widths (w, 2w, 4w, 8w) that
exchange features through fuse layers after every module (1, 4 and 3
modules in stages 2-4, four BasicBlocks per branch). Lower -> higher
resolution: 1x1 conv + BN + nearest upsampling (a reshape-broadcast);
higher -> lower: a chain of 3x3/2 convs (intermediate hops keep the source
width and a ReLU, the last projects without one); the fused sum is ReLU'd.
BatchNorm is frozen. HRFPN: every branch resized bilinearly (half-pixel
centres, ``jax.image.resize``) to the stride-4 map, concatenated, a 1x1
reduction, then ``num_outs`` outputs of average pooling by 2^i and a 3x3
conv. NCHW. Parameter names are JAX's (``stem_conv1``, ``layer1_block0``,
``transition1_b1``, ``stage2_module0.fuse0_1_conv`` ...); the blocks are
the port's ResNet blocks, whose projection is ``downsample.0/1``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nasfcos_fpn import _resize_bilinear
from .resnet import BasicBlock, Bottleneck, FrozenBatchNorm

# modules per stage 2/3/4: the standard HRNetV2p layout
STAGE_MODULES = (1, 4, 3)
BLOCKS_PER_BRANCH = 4


def _nearest_up(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Each pixel repeated ``factor`` x in H and W (NCHW)."""
    B, C, H, W = x.shape
    x = x[:, :, :, None, :, None].expand(B, C, H, factor, W, factor)
    return x.reshape(B, C, H * factor, W * factor)


def _conv(cin, cout, k, stride, device):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                     device=device)


class HRModule(nn.Module):
    """Parallel BasicBlock chains and full pairwise fusion."""

    def __init__(self, channels: Sequence[int], device):
        super().__init__()
        self.channels = tuple(channels)
        n = len(channels)
        for i, c in enumerate(channels):
            for b in range(BLOCKS_PER_BRANCH):
                self.add_module(f"branch{i}_block{b}",
                                BasicBlock(c, c, 1, False, device))
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"fuse{i}_{j}_conv",
                                    _conv(channels[j], channels[i], 1, 1,
                                          device))
                    self.add_module(f"fuse{i}_{j}_bn",
                                    FrozenBatchNorm(channels[i], device))
                elif j < i:
                    for k in range(i - j):
                        ch = channels[i] if k == i - j - 1 else channels[j]
                        self.add_module(f"fuse{i}_{j}_conv{k}",
                                        _conv(channels[j], ch, 3, 2, device))
                        self.add_module(f"fuse{i}_{j}_bn{k}",
                                        FrozenBatchNorm(ch, device))

    def forward(self, xs):
        n = len(self.channels)
        ys = []
        for i, x in enumerate(xs):
            for b in range(BLOCKS_PER_BRANCH):
                x = getattr(self, f"branch{i}_block{b}")(x)
            ys.append(x)
        outs = []
        for i in range(n):
            acc = None
            for j in range(n):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = getattr(self, f"fuse{i}_{j}_bn")(
                        getattr(self, f"fuse{i}_{j}_conv")(ys[j]))
                    t = _nearest_up(t, 2 ** (j - i))
                else:
                    t = ys[j]
                    for k in range(i - j):
                        t = getattr(self, f"fuse{i}_{j}_bn{k}")(
                            getattr(self, f"fuse{i}_{j}_conv{k}")(t))
                        if k != i - j - 1:
                            t = F.relu(t)
                acc = t if acc is None else acc + t
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    """The four branches (strides 4-32) as NCHW tensors; features are
    detached after the stem (``frozen_stages >= 0``) and after stage 1
    (``>= 1``)."""

    def __init__(self, device, width: int = 18, frozen_stages: int = 1):
        super().__init__()
        w = width
        chans = (w, 2 * w, 4 * w, 8 * w)
        self.frozen_stages = frozen_stages
        self.stem_conv1 = _conv(3, 64, 3, 2, device)
        self.stem_bn1 = FrozenBatchNorm(64, device)
        self.stem_conv2 = _conv(64, 64, 3, 2, device)
        self.stem_bn2 = FrozenBatchNorm(64, device)
        cin = 64
        for b in range(4):
            self.add_module(f"layer1_block{b}",
                            Bottleneck(cin, 64, 1, b == 0, device))
            cin = 256
        widths = [256]
        self.plan = []
        for si, n_modules in enumerate(STAGE_MODULES, start=2):
            cur = chans[:si]
            for i, c in enumerate(cur):
                name = f"transition{si - 1}_b{i}"
                if i < len(widths):
                    if widths[i] != c:
                        self.add_module(name, _conv(widths[i], c, 3, 1,
                                                    device))
                        self.add_module(name + "_bn",
                                        FrozenBatchNorm(c, device))
                else:
                    self.add_module(name, _conv(widths[-1], c, 3, 2, device))
                    self.add_module(name + "_bn", FrozenBatchNorm(c, device))
            widths = list(cur)
            for m in range(n_modules):
                self.add_module(f"stage{si}_module{m}", HRModule(cur, device))
            self.plan.append((si, len(cur), n_modules))
        self.out_channels = list(chans)

    def _transition(self, name, x):
        return F.relu(getattr(self, name + "_bn")(getattr(self, name)(x)))

    def forward(self, x) -> Tuple:
        y = F.relu(self.stem_bn1(self.stem_conv1(x)))
        y = F.relu(self.stem_bn2(self.stem_conv2(y)))
        if self.frozen_stages >= 0:
            y = y.detach()
        for b in range(4):
            y = getattr(self, f"layer1_block{b}")(y)
        if self.frozen_stages >= 1:
            y = y.detach()
        branches = [y]
        for si, n_branches, n_modules in self.plan:
            new = []
            for i in range(n_branches):
                name = f"transition{si - 1}_b{i}"
                src = branches[i] if i < len(branches) else branches[-1]
                new.append(self._transition(name, src) if hasattr(self, name)
                           else src)
            branches = new
            for m in range(n_modules):
                branches = getattr(self, f"stage{si}_module{m}")(branches)
        return tuple(branches)


class HRFPN(nn.Module):
    """Concatenated upsampled branches -> 1x1 reduction -> pooled 3x3
    outputs."""

    def __init__(self, in_channels: Sequence[int], device,
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.reduction_conv = nn.Conv2d(sum(in_channels), out_channels, 1,
                                        device=device)
        for i in range(num_outs):
            self.add_module(f"fpn_conv{i}", nn.Conv2d(
                out_channels, out_channels, 3, padding=1, device=device))

    def forward(self, inputs) -> Tuple:
        hw = inputs[0].shape[2:]
        y = torch.cat([inputs[0]] + [_resize_bilinear(f, hw)
                                     for f in inputs[1:]], 1)
        y = self.reduction_conv(y)
        outs = []
        for i in range(self.num_outs):
            t = y if i == 0 else F.avg_pool2d(y, 2 ** i, 2 ** i)
            outs.append(getattr(self, f"fpn_conv{i}")(t))
        return tuple(outs)
