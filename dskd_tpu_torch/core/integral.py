"""GFL distribution integrals (port of dskd_tpu/core/integral.py
``integral_average`` and ``integral``).

``integral_average`` (the flagship head's): the 4x(reg_max+1)
distribution, already sigmoided, is normalized by its raw sum (not a
softmax, as the reference does), integrated against bins
``linspace(0, reg_max) / reg_max / 2`` and pair-summed to (w, h).
``integral`` (the GFL head's): a softmax over the bins, then the
expectation against ``linspace(0, reg_max)``.
"""
from __future__ import annotations

import torch


def integral_average(x: torch.Tensor, reg_max: int = 16,
                     eps: float = 1e-12) -> torch.Tensor:
    """(..., 4*(reg_max+1)) sigmoided distributions -> (..., 2) = (w, h)."""
    lead = x.shape[:-1]
    n = reg_max + 1
    x = x.reshape(lead + (4, n))
    x = x / torch.clamp(x.sum(dim=-1, keepdim=True), min=eps)
    space = torch.linspace(0.0, reg_max, n, dtype=x.dtype,
                           device=x.device) / reg_max / 2.0
    dist = (x * space).sum(dim=-1)                   # (..., 4) in [0, 0.5]
    return dist.reshape(lead + (2, 2)).sum(dim=-1)   # (l+r, t+b)


def integral(x: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., 4*(reg_max+1)) logits -> (..., 4) distances."""
    lead = x.shape[:-1]
    n = reg_max + 1
    p = torch.softmax(x.reshape(lead + (4, n)), dim=-1)
    proj = torch.linspace(0.0, reg_max, n, dtype=x.dtype, device=x.device)
    return (p * proj).sum(dim=-1)
