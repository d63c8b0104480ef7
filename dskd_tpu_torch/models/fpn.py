"""FPN neck (port of dskd_tpu/models/fpn.py ``FPN``).

The inputs from ``start_level`` on get a 1x1 lateral conv each; from the
top down, each lateral is repeated 2x in both axes, cropped to the next
lateral's size (for odd sizes) and added to it; a 3x3 conv then gives each
output. Extra levels up to ``num_outs``: with ``add_extra_convs`` ""
every one is the last output subsampled 2x (max-pool of kernel 1); with
"on_input" (the last used input) or "on_output" (the last output) a
stride-2 3x3 conv, a ReLU before every extra conv but the first when
``relu_before_extra_convs``. ``norm="bn"`` (the EfficientNet RetinaNet
recipe) puts a BatchNorm (flax's rule, momentum 0.9: on the batch in
training) after every output and extra conv, which then has no bias, and,
unless ``no_norm_on_lateral``, after every lateral conv. Convs are NCHW
and take their input widths from ``in_channels``. Module names are
mmdet's: ``lateral_convs.i.conv`` and ``fpn_convs.i.conv`` (``.bn``), the
extra convs continuing ``fpn_convs``. The JAX module's GroupNorm, ``ws``
and non-nearest ``upsample`` options are not ported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dilated_encoder import TrainableBatchNorm


class ConvWrap(nn.Module):
    """A conv under mmdet's ConvModule name ``conv``, no activation;
    ``bn``: a BatchNorm after it, under ``bn``, and no conv bias."""

    def __init__(self, cin: int, cout: int, k: int, device, stride: int = 1,
                 bias: bool = True, bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              bias=bias and not bn, device=device)
        if bn:
            self.bn = TrainableBatchNorm(cout, device)

    def forward(self, x):
        x = self.conv(x)
        return self.bn(x) if hasattr(self, "bn") else x


def upsample_nearest_2x(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Each pixel repeated 2x in H and W, cropped to ``hw``."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :hw[0], :hw[1]]


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], device,
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 1, add_extra_convs: str = "on_output",
                 relu_before_extra_convs: bool = True,
                 upsample: str = "nearest", norm: str = "",
                 ws: bool = False, no_norm_on_lateral: bool = False):
        super().__init__()
        for name, value, ported in (("upsample", upsample, ("nearest",)),
                                    ("norm", norm, ("", "bn")),
                                    ("ws", ws, (False,))):
            if value not in ported:
                raise NotImplementedError(f"FPN {name}={value!r} is not "
                                          f"ported")
        bn = norm == "bn"
        if add_extra_convs not in ("", "on_input", "on_output"):
            raise ValueError(f"FPN add_extra_convs={add_extra_convs!r}")
        used = list(in_channels[start_level:])
        self.start_level = start_level
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        self.lateral_convs = nn.ModuleList(
            ConvWrap(c, out_channels, 1, device,
                     bn=bn and not no_norm_on_lateral) for c in used)
        convs = [ConvWrap(out_channels, out_channels, 3, device, bn=bn)
                 for _ in used]
        if add_extra_convs:
            for j in range(num_outs - len(used)):
                cin = (used[-1] if j == 0 and add_extra_convs == "on_input"
                       else out_channels)
                convs.append(ConvWrap(cin, out_channels, 3, device, stride=2,
                                      bn=bn))
        self.fpn_convs = nn.ModuleList(convs)

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        used = list(inputs[self.start_level:])
        n = len(used)
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_2x(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [self.fpn_convs[i](x) for i, x in enumerate(laterals)]
        if not self.add_extra_convs:
            for _ in range(self.num_outs - n):
                outs.append(outs[-1][:, :, ::2, ::2])
            return tuple(outs)
        src = used[-1] if self.add_extra_convs == "on_input" else outs[-1]
        for j in range(self.num_outs - n):
            if j > 0 and self.relu_before_extra_convs:
                src = F.relu(src)
            src = self.fpn_convs[n + j](src)
            outs.append(src)
        return tuple(outs)
