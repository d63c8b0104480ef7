"""Optimizer of the flagship recipe (port of dskd_tpu/train/optim.py
``default_param_labels`` and ``make_optimizer``).

AdamW (weight decay 1e-4 in the flagship recipe) over two groups, ``base``
at the scheduled learning rate and ``lr01`` at 0.1x of it; ``frozen``
parameters are not in the optimizer. Before the update every gradient is
clipped to a global norm (0.1 in the flagship recipe), as
``optax.clip_by_global_norm`` does ahead of the JAX package's
``multi_transform``: the norm runs over every parameter that has a gradient,
the frozen backbone BatchNorm affines of stages 2-4 included (only the stem
and layer1 are detached), and gradients are divided by the norm exactly,
``g / norm * max_norm`` when ``norm >= max_norm``, without the 1e-6 that
``clip_grad_norm_`` adds.
"""
from __future__ import annotations

import re
from typing import Callable, Dict

import torch
import torch.nn as nn

# a backbone BatchNorm's affine: torchvision's ``bn1``/``downsample.1`` and
# the names of the backbones that keep JAX's (``stem_bn``, ``expand_bn``,
# ``fuse0_1_bn2``, CSPDarknet's ``...conv.bn``)
_BACKBONE_BN = re.compile(r"\.(\w*bn\d*|downsample\.1)\.(weight|bias)$")


def default_param_labels(frozen_stages: int = 1) -> Callable[[str], str]:
    """Label each parameter name 'frozen' | 'lr01' (0.1x lr) | 'base'.

    frozen: the stem (``backbone.conv1``, ``backbone.bn1``, or
    ``backbone.stem_*`` where a backbone keeps JAX's names), the stages up
    to ``frozen_stages`` (``backbone.layer{s}.`` or ``layer{s}_``) and every
    backbone BatchNorm affine; lr01: the rest of the backbone,
    ``sampling_offsets`` and ``reference_points``; base: everything else.
    These are JAX's labels of the same parameters.
    """

    def label(name: str) -> str:
        if name.startswith("backbone."):
            if name.startswith(("backbone.conv1.", "backbone.bn1.",
                                "backbone.stem_")):
                return "frozen" if frozen_stages >= 0 else "lr01"
            for stage in range(1, frozen_stages + 1):
                if name.startswith((f"backbone.layer{stage}.",
                                    f"backbone.layer{stage}_")):
                    return "frozen"
            if _BACKBONE_BN.search(name):
                return "frozen"
            return "lr01"
        if "sampling_offsets" in name or "reference_points" in name:
            return "lr01"
        return "base"

    return label


class Optimizer:
    """Global-norm clip, then AdamW over the ``base`` and ``lr01`` groups at
    ``lr_schedule(count)`` times the group's multiplier."""

    MULTS = {"base": 1.0, "lr01": 0.1}

    def __init__(self, named_params: Dict[str, nn.Parameter],
                 lr_schedule: Callable[[int], float], weight_decay: float,
                 max_norm: float, label_fn: Callable[[str], str]):
        self.lr_schedule = lr_schedule
        self.max_norm = max_norm
        self.labels = {n: label_fn(n) for n in named_params}
        self.params = list(named_params.values())
        groups = [{"params": [p for n, p in named_params.items()
                              if self.labels[n] == g], "mult": m}
                  for g, m in self.MULTS.items()]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=lr_schedule(0),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip(self) -> torch.Tensor:
        """Clip every gradient in place to the global norm ``max_norm``;
        returns the norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.stack([g.float().pow(2).sum() for g in grads]).sum()
        norm = norm.sqrt()
        keep = norm < self.max_norm
        denom = torch.where(keep, torch.ones_like(norm), norm)
        mult = torch.where(keep, torch.ones_like(norm),
                           torch.full_like(norm, self.max_norm))
        for g in grads:
            g.div_(denom).mul_(mult)
        return norm

    def step(self, count: int) -> torch.Tensor:
        """Clip, then one AdamW update at the schedule's ``count``-th value
        (the number of updates made before this one). Returns the norm."""
        norm = self.clip()
        lr = self.lr_schedule(count)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["mult"]
            # optax sees a zero gradient where torch sees none, and still
            # decays the weight (the head's unused ``prototype``)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.adamw.step()
        return norm


def make_optimizer(model: nn.Module, lr_schedule: Callable[[int], float],
                   weight_decay: float = 1e-4, max_norm: float = 0.1,
                   frozen_stages: int = 1) -> Optimizer:
    """The flagship optimizer over ``model``'s parameters, with the JAX
    package's arguments: AdamW with ``weight_decay`` after a clip to global
    norm ``max_norm``, freezing the stem, the stages up to
    ``frozen_stages`` and the backbone's BatchNorm affines."""
    return Optimizer(dict(model.named_parameters()), lr_schedule,
                     weight_decay=weight_decay, max_norm=max_norm,
                     label_fn=default_param_labels(frozen_stages))
