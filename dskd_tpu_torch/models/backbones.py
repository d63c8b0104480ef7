"""Backbone specs (port of dskd_tpu/models/backbones.py
``build_backbone`` and ``apply_backbone``) and stochastic depth.

Specs and pyramid kinds: "" and "resnet" the ResNet of ``depth`` (kind
"c2345", strides 4-32), "regnetx_*" RegNetX ("c2345"), "effb0".."effb5"
EfficientNet's stride-8/16/32 stages ("c345"), "hrnet_w*" HRNet's four
branches ("hr", for HRFPN), "pvt_tiny" / "pvt_small" PVT v1 ("c2345") and
"mobilenet_v2" MobileNetV2's stages 1, 2, 4 and 6 ("c2345"; the JAX
module's spec table has no MobileNetV2, which its YOLOv3 builds itself).
"resnext", "swin*", "res2net*" and "resnest*" are not ported and raise
NotImplementedError, naming the spec.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

# backbones with stochastic depth: their forward takes the generator of
# the drop-path masks
STOCHASTIC = ("effb", "pvt")
_UNPORTED = ("resnext", "swin", "res2net", "resnest")


def drop_path(x: torch.Tensor, rate: float, generator, training: bool
              ) -> torch.Tensor:
    """mmcv's DropPath, flax's ``nn.Dropout(broadcast_dims=...)``: in
    training with a ``generator``, each sample's whole ``x`` is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed; the
    identity otherwise."""
    if rate == 0.0 or not training or generator is None:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                   device=x.device, dtype=x.dtype)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def build_backbone(spec: str, depth: int, device, frozen_stages: int = 1,
                   drop_path_rate: float = 0.0) -> Tuple[nn.Module, str]:
    """(backbone module, pyramid kind); its ``out_channels`` give the
    widths of its outputs. ``drop_path_rate`` reaches EfficientNet as it is
    and PVT as its rate where it is not 0 (else PVT's 0.1)."""
    if spec in ("", "resnet"):
        from .resnet import ResNet
        return (ResNet(depth, device, out_indices=(0, 1, 2, 3),
                       frozen_stages=frozen_stages), "c2345")
    if spec.startswith("regnetx"):
        from .regnet import RegNet
        return RegNet(device, spec, frozen_stages=frozen_stages), "c2345"
    if spec.startswith("effb"):
        from .efficientnet import EfficientNet
        return (EfficientNet(device, spec[3:], out_indices=(2, 4, 6),
                             frozen_stages=frozen_stages,
                             drop_path_rate=drop_path_rate), "c345")
    if spec.startswith("hrnet_w"):
        from .hrnet import HRNet
        return (HRNet(device, int(spec[len("hrnet_w"):]),
                      frozen_stages=frozen_stages), "hr")
    if spec.startswith("pvt"):
        from .pvt import PVT
        arch = spec.split("_", 1)[1] if "_" in spec else "tiny"
        return PVT(device, arch, drop_path_rate=drop_path_rate or 0.1), \
            "c2345"
    if spec == "mobilenet_v2":
        from .mobilenet_v2 import MobileNetV2
        return MobileNetV2(device, frozen_stages=frozen_stages), "c2345"
    if spec.startswith(_UNPORTED):
        raise NotImplementedError(f"backbone {spec!r} is not ported")
    raise ValueError(f"unknown backbone spec: {spec!r}")


def apply_backbone(backbone: nn.Module, spec: str, x: torch.Tensor,
                   generator=None):
    """The backbone's features of NCHW ``x``; the stochastic-depth
    backbones also get ``generator``."""
    if spec.startswith(STOCHASTIC):
        return backbone(x, generator)
    return backbone(x)


@torch.no_grad()
def init_backbone(backbone: nn.Module, seed: int) -> None:
    """The initializers of a backbone's own that ``init_conv_bn`` (lecun
    convs, identity BatchNorms) does not give, drawn on the CPU from
    ``seed``: PVT's linears and positional embeddings truncated-normal
    (0.02, cut at 2 sd) with zero biases, its convs normal(0, sqrt(2 /
    (k * k * out))), its LayerNorms the identity. Other backbones are
    left as they are."""
    from .detector import put_
    from .pvt import PVT

    if not isinstance(backbone, PVT):
        return
    g = torch.Generator().manual_seed(seed + 7919)

    def trunc(t, std=0.02):
        v = torch.empty(t.shape, dtype=torch.float64)
        nn.init.trunc_normal_(v, std=std, a=-2 * std, b=2 * std,
                              generator=g)
        put_(t, v)

    for mod in backbone.modules():
        if isinstance(mod, nn.Linear):
            trunc(mod.weight)
            mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d):
            k, out = mod.kernel_size[0], mod.out_channels
            put_(mod.weight, torch.empty(mod.weight.shape).normal_(
                0, (2.0 / (k * k * out)) ** 0.5, generator=g))
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for p in backbone.parameters(recurse=False):
        trunc(p)
