"""Backbone specs (port of dskd_tpu/models/backbones.py
``build_backbone``): "" and "resnet" build the ResNet of ``depth`` with all
four stages out (kind "c2345", strides 4-32). The other specs of the JAX
module are not ported and raise.
"""
from __future__ import annotations

from typing import Tuple

import torch.nn as nn

from .resnet import ResNet


def build_backbone(spec: str, depth: int, device, frozen_stages: int = 1
                   ) -> Tuple[nn.Module, str]:
    """(backbone module, pyramid kind); its ``out_channels`` give the
    widths of its outputs."""
    if spec in ("", "resnet"):
        return (ResNet(depth, device, out_indices=(0, 1, 2, 3),
                       frozen_stages=frozen_stages), "c2345")
    raise NotImplementedError(f"backbone {spec!r} is not ported (the port "
                              f"builds '' and 'resnet')")
