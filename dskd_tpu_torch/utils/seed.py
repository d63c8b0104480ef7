"""Random seeds (port of dskd_tpu/utils/seed.py ``init_random_seed`` and
``set_random_seed``).

One process drives one card, so there is no seed to agree on across
processes: ``init_random_seed`` draws one when none is given.
``set_random_seed`` seeds Python's ``random``, numpy's global state and
torch's, and returns a ``torch.Generator`` on the device, where the JAX
package returns a PRNG key.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch


def init_random_seed(seed: Optional[int] = None) -> int:
    """``seed``, or a random one when it is None."""
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    return seed


def set_random_seed(seed: int, device="cuda") -> torch.Generator:
    """Seed the host's RNGs and torch's; returns a generator on
    ``device`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
