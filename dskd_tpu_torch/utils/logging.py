"""Metrics logging (port of dskd_tpu/utils/logging.py ``MetricsLogger``,
``collect_env`` and ``dump_config``).

``MetricsLogger`` writes a line through the standard logger and one JSON
object per event to ``<work_dir>/<timestamp>.log.json``, with the JAX
package's keys and rounding: ``mode`` ("train" or "val"), ``epoch``,
``iter``, ``task``, ``lr`` (8 decimals) and every metric (5 decimals).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import platform
import time
from typing import Dict, Optional

import torch


class MetricsLogger:
    def __init__(self, work_dir: Optional[str] = None,
                 name: str = "dskd_tpu"):
        self.log = logging.getLogger(name)
        self.jsonl = None
        if work_dir:
            os.makedirs(work_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d_%H%M%S")
            self.jsonl = open(os.path.join(work_dir, f"{stamp}.log.json"),
                              "a", buffering=1)

    def log_metrics(self, mode: str, epoch: int, it: int, metrics: Dict,
                    task: Optional[int] = None, lr: Optional[float] = None):
        rec = dict(mode=mode, epoch=epoch, iter=it)
        if task is not None:
            rec["task"] = task
        if lr is not None:
            rec["lr"] = round(float(lr), 8)
        rec.update({k: round(float(v), 5) for k, v in metrics.items()})
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
        self.log.info(" ".join(f"{k}={v}" for k, v in rec.items()))

    def close(self):
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None


def collect_env() -> dict:
    """Environment fingerprint logged at the start of a run: Python, torch,
    its CUDA build, and the card's name and count (none on the CPU)."""
    cuda = torch.cuda.is_available()
    return dict(
        python=platform.python_version(), torch=torch.__version__,
        cuda=torch.version.cuda,
        device_kind=torch.cuda.get_device_name(0) if cuda else "none",
        device_count=torch.cuda.device_count() if cuda else 0,
        platform=platform.platform())


def dump_config(cfg, work_dir: str) -> None:
    """Write the resolved experiment config to ``work_dir/config.json``."""
    if not work_dir:
        return
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
