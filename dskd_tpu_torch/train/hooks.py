"""Training-time checks and EMA (port of dskd_tpu/train/hooks.py
``check_invalid_loss``, ``assert_loss_keys_consistent`` and
``ema_update``).

  * check_invalid_loss: raise when a loss is not finite (the reference's
    CheckInvalidLossHook);
  * assert_loss_keys_consistent: the cross-process agreement on the loss
    keys; one process drives one card, so it is a no-op, as the JAX
    package's is in one process;
  * ema_update: ExpMomentumEMA over the model's floating tensors.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def check_invalid_loss(losses: Dict[str, float], step: int,
                       interval: int = 50):
    """Raise FloatingPointError if any loss is non-finite (host values)."""
    if interval and step % interval != 0:
        return
    for k, v in losses.items():
        v = float(v)
        if not math.isfinite(v):
            raise FloatingPointError(f"loss '{k}' became {v} at step {step}")


def assert_loss_keys_consistent(losses: Dict[str, torch.Tensor]):
    """Cross-process agreement on the loss keys: nothing to check in one
    process."""
    return


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               step: int, momentum: float = 0.0002, total_iter: int = 2000
               ) -> Dict[str, torch.Tensor]:
    """ExpMomentumEMA: ``ema <- (1 - m) * ema + m * params`` for floating
    tensors, with ``m = (1 - momentum) * exp(-(step + 1) / total_iter) +
    momentum`` computed in f32 as the JAX package does; other tensors are
    copied. Updates ``ema`` in place and returns it."""
    t = torch.tensor(step + 1.0, dtype=torch.float32)
    m = (1 - momentum) * torch.exp(-t / total_iter) + momentum
    for k, p in params.items():
        e = ema[k]
        if e.is_floating_point():
            mk = m.to(device=e.device, dtype=e.dtype)
            e.copy_(e * (1 - mk) + p * mk)
        else:
            e.copy_(p)
    return ema
