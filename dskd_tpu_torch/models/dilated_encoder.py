"""YOLOF's DilatedEncoder neck and the port's train-mode BatchNorm (port of
dskd_tpu/models/dilated_encoder.py ``TrainableBatchNorm``, ``Bottleneck``
and ``DilatedEncoder``).

C5 -> 1x1 lateral conv + BN -> 3x3 fpn conv + BN -> four dilated residual
bottlenecks (dilations 2, 4, 6, 8; 512 channels, 128 in the middle), NCHW.
Module names are mmdet's (``lateral_conv``, ``lateral_norm``, ``fpn_conv``,
``fpn_norm``, ``dilated_encoder_blocks.i.convC.conv/.bn``), the keys
dskd_tpu/utils/torch_weights.py ``convert_mmdet_yolof`` reads.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class TrainableBatchNorm(nn.Module):
    """BatchNorm with flax ``nn.BatchNorm``'s semantics, per channel of an
    NCHW tensor.

    Training mode normalises by the batch statistics and updates the
    running ones as ``m * running + (1 - m) * batch`` with the biased batch
    variance (torch's own BatchNorm averages the unbiased one, and its
    momentum is 1 - m); eval mode normalises by the running statistics.
    The buffers are ``running_mean`` and ``running_var``, so ``state_dict``
    and the task checkpoints carry them."""

    def __init__(self, channels: int, device, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x, train=None):
        """``train`` overrides the module's mode (NAS-FPN's neck runs its
        BatchNorms on their running statistics in training too)."""
        if not (self.training if train is None else train):
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        if x.numel() == x.shape[1]:
            # one value per channel (a 1x1 map at B=1), which F.batch_norm
            # refuses: flax's rule gives variance 0, the output the bias
            return ((x - x) * torch.rsqrt(torch.full_like(x, self.eps))
                    * self.weight[:, None, None] + self.bias[:, None, None])
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def swish(x):
    return x * torch.sigmoid(x)


class ConvModule(nn.Module):
    """``conv`` (k x k, no bias, padding (k - 1) // 2 x dilation) ->
    ``bn`` (TrainableBatchNorm) -> ReLU or swish; mmdet's ConvModule
    names."""

    def __init__(self, cin: int, cout: int, k: int, device, stride: int = 1,
                 dilation: int = 1, momentum: float = 0.9, act: str = "relu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2 * dilation,
                              dilation=dilation, bias=False, device=device)
        self.bn = TrainableBatchNorm(cout, device, momentum)
        self.act = F.relu if act == "relu" else swish

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (dilated) -> 1x1, each with BN and ReLU, plus the
    input."""

    def __init__(self, channels: int, mid_channels: int, dilation: int,
                 device):
        super().__init__()
        self.conv1 = ConvModule(channels, mid_channels, 1, device)
        self.conv2 = ConvModule(mid_channels, mid_channels, 3, device,
                                dilation=dilation)
        self.conv3 = ConvModule(mid_channels, channels, 1, device)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x))) + x


class DilatedEncoder(nn.Module):
    def __init__(self, in_channels: int, device, out_channels: int = 512,
                 block_mid_channels: int = 128,
                 block_dilations: Sequence[int] = (2, 4, 6, 8)):
        super().__init__()
        self.lateral_conv = nn.Conv2d(in_channels, out_channels, 1,
                                      device=device)
        self.lateral_norm = TrainableBatchNorm(out_channels, device)
        self.fpn_conv = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                                  device=device)
        self.fpn_norm = TrainableBatchNorm(out_channels, device)
        self.dilated_encoder_blocks = nn.ModuleList(
            Bottleneck(out_channels, block_mid_channels, d, device)
            for d in block_dilations)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor]:
        """The last of ``feats`` (C5) -> (the encoded map,)."""
        x = self.fpn_norm(self.fpn_conv(self.lateral_norm(
            self.lateral_conv(feats[-1]))))
        for block in self.dilated_encoder_blocks:
            x = block(x)
        return (x,)


@torch.no_grad()
def init_conv_bn(model: nn.Module, g: torch.Generator, init_of) -> None:
    """Every conv's kernel from the initializer ``init_of(module name)``
    names ("lecun": normal(0, 1/fan_in), flax's default scale;
    "normal_001": normal(0, 0.01); "caffe2_xavier": uniform +-sqrt(3 /
    fan_in); "xavier": xavier-uniform), drawn on the CPU from ``g`` in
    module order, and a zero bias; every BatchNorm the identity with zero
    mean and unit variance, every GroupNorm the identity."""
    from .detector import lecun_, put_, xavier_
    from .resnet import FrozenBatchNorm

    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            t, kind = mod.weight, init_of(name)
            if kind == "lecun":
                lecun_(t, g)
            elif kind == "normal_001":
                put_(t, torch.empty(t.shape).normal_(0, 0.01, generator=g))
            elif kind == "caffe2_xavier":
                bound = (3.0 / t[0].numel()) ** 0.5
                put_(t, torch.empty(t.shape).uniform_(-bound, bound,
                                                      generator=g))
            elif kind == "xavier":
                xavier_(t, g)
            else:
                raise ValueError(f"initializer {kind!r} of {name}")
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (FrozenBatchNorm, TrainableBatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
