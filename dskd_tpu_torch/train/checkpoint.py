"""Task-aware checkpoints (port of dskd_tpu/train/checkpoint.py
``save_checkpoint``, ``restore_checkpoint`` and ``find_latest_checkpoint``).

A checkpoint is one ``torch.save`` file, ``checkpoint.pth``, inside a
``task_{t}_epoch_{e}/`` directory under ``work_dir`` (the JAX package
writes an Orbax directory of that name). It holds the model's
``state_dict`` (the mmdet key layout ``utils/weights.py`` names), the
optimizer's state, the update count and the dropout generator's state.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

FILE = "checkpoint.pth"


def ckpt_dir(work_dir: str, task: int, epoch: int) -> str:
    return os.path.join(os.path.abspath(work_dir),
                        f"task_{task}_epoch_{epoch}")


def save_checkpoint(work_dir: str, task: int, epoch: int, state) -> str:
    """Write ``state`` (a ``train.state.TrainState``); returns the file."""
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.adamw.state_dict(),
               "step": state.step,
               "generator": state.generator.get_state()}
    path = ckpt_dir(work_dir, task, epoch)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, FILE))
    return os.path.join(path, FILE)


def load_weights(model, path: str) -> dict:
    """Load the weights of the checkpoint directory ``path``
    (``.../task_{t}_epoch_{e}``) into ``model`` (the reference's
    load_checkpoint) and return the payload, read onto the CPU. An mmdet
    ``.pth`` file raises NotImplementedError."""
    if path.endswith((".pth", ".pt")):
        raise NotImplementedError(f"loading an mmdet .pth checkpoint is not "
                                  f"ported: {path}")
    payload = torch.load(os.path.join(path, FILE), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return payload


def restore_checkpoint(work_dir: str, task: int, epoch: int, state) -> None:
    """Resume ``state`` (a ``train.state.TrainState``) from a task
    checkpoint: the weights, the optimizer, the update count and the
    generator (the reference's runner.resume)."""
    payload = load_weights(state.model, ckpt_dir(work_dir, task, epoch))
    state.optimizer.adamw.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"])


def find_latest_checkpoint(work_dir: str, task: Optional[int] = None):
    """Scan work_dir for task_{t}_epoch_{e} dirs; returns (t, e, path) of the
    latest, of ``task`` if given, or None."""
    if not os.path.isdir(work_dir):
        return None
    best = None
    pat = re.compile(r"task_(\d+)_epoch_(\d+)$")
    for name in os.listdir(work_dir):
        m = pat.match(name)
        if not m:
            continue
        t, e = int(m.group(1)), int(m.group(2))
        if task is not None and t != task:
            continue
        if best is None or (t, e) > best[:2]:
            best = (t, e, os.path.join(work_dir, name))
    return best
