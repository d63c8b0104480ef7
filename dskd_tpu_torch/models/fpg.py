"""FPG, feature pyramid grids (port of dskd_tpu/models/fpg.py ``_Trans`` and
``FPG``), the neck of ``retinanet_fpg``.

Every input gets a 1x1 ``lateral_convs`` conv (with bias), and each level
past the inputs a stride-2 3x3 ``extra_downsamples`` conv of the level
below. Nine bottom-up stacks follow; in stack i a level listed in its
``SKIP_INDS`` row passes through, and any other level is the sum of its
transitions: ``same_up`` (k3 s2) of the level below in this stack,
``across_lateral`` (k1) of itself in the previous stack, ``across_down``
(2x nearest repeat, then k3) of the level above in the previous stack,
cropped to this level, and ``across_skip`` (k1) of itself before the
stacks. An ``output_transition`` (k3) gives each output. A transition is
ReLU -> conv without bias -> GroupNorm(32): the JAX module's GroupNorm in
place of mmdet's BatchNorm. Convs are NCHW; module names follow mmdet's
``necks/fpg.py``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

SKIP_INDS = ((0, 1, 2, 3), (0, 1, 2), (0, 1), (0,), ())


class Transition(nn.Module):
    """ReLU -> (2x nearest repeat when ``interp``) -> conv (k, stride, no
    bias) -> GroupNorm(min(32, channels))."""

    def __init__(self, channels: int, kernel: int, device, stride: int = 1,
                 interp: bool = False):
        super().__init__()
        self.interp = interp
        self.conv = nn.Conv2d(channels, channels, kernel, stride=stride,
                              padding=(kernel - 1) // 2, bias=False,
                              device=device)
        self.gn = nn.GroupNorm(min(32, channels), channels, eps=1e-5,
                               device=device)

    def forward(self, x):
        x = F.relu(x)
        if self.interp:
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.gn(self.conv(x))


class FPG(nn.Module):
    def __init__(self, in_channels: Sequence[int], device,
                 out_channels: int = 256, num_outs: int = 5,
                 stack_times: int = 9, skip_inds=SKIP_INDS):
        super().__init__()
        C = out_channels
        self.num_outs = num_outs
        self.stack_times = stack_times
        self.skip_inds = skip_inds
        self.lateral_convs = nn.ModuleList(
            nn.Conv2d(c, C, 1, device=device) for c in in_channels)
        self.extra_downsamples = nn.ModuleList(
            nn.Conv2d(C, C, 3, stride=2, padding=1, device=device)
            for _ in range(num_outs - len(in_channels)))
        stacks = []
        for i in range(stack_times):
            levels = []
            for lvl in range(num_outs):
                t = nn.ModuleDict()
                if i not in skip_inds[lvl]:
                    if lvl > 0:
                        t["same_up"] = Transition(C, 3, device, stride=2)
                    t["across_lateral"] = Transition(C, 1, device)
                    if lvl < num_outs - 1:
                        t["across_down"] = Transition(C, 3, device,
                                                      interp=True)
                    t["across_skip"] = Transition(C, 1, device)
                levels.append(t)
            stacks.append(nn.ModuleList(levels))
        self.fpn_transitions = nn.ModuleList(stacks)
        self.output_transition = nn.ModuleList(
            Transition(C, 3, device) for _ in range(num_outs))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        feats = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for conv in self.extra_downsamples:
            feats.append(conv(feats[-1]))
        stage0 = current = feats
        for stack in self.fpn_transitions:
            nxt = []
            for lvl, t in enumerate(stack):
                if not t:
                    nxt.append(current[lvl])
                    continue
                y = t["across_lateral"](current[lvl])
                if "same_up" in t:
                    y = t["same_up"](nxt[-1]) + y
                if "across_down" in t:
                    h, w = current[lvl].shape[2:]
                    y = y + t["across_down"](current[lvl + 1])[:, :, :h, :w]
                nxt.append(y + t["across_skip"](stage0[lvl]))
            current = nxt
        return tuple(t(x) for t, x in zip(self.output_transition, current))
