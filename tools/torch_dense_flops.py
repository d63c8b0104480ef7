#!/usr/bin/env python3
"""Forward operations of the dense families' configs, counted from shapes.

    python3 tools/torch_dense_flops.py [CONFIG ...]

Builds each config's model (default: the configs of ``chip_smoke.py``'s
phases 14 and 15) on PyTorch's meta device, runs one forward of a B=1
image of the config's canvas (``data.bucket``) under
``torch.utils.flop_counter.FlopCounterMode`` and prints its GFLOP (two per
multiply-add; convolutions and matmuls), and the teacher's where
``model.teacher_depth`` names another depth. Nothing is allocated or
computed: the counts come from the shapes alone, on any machine.
"""
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from dskd_tpu_torch.registry import get_family  # noqa: E402
from dskd_tpu_torch.train.incremental import build_teacher_model  # noqa
from dskd_tpu_torch.utils.config import load_config  # noqa: E402

CONFIGS = ("gfl_r50_1x", "retinanet_r50_1x", "atss_r50_1x", "fcos_r50_1x",
           "ld_r18_gflv1_r101_1x", "paa_r50_1x", "lad_r50_paa_r101_1x",
           "pisa_retinanet_r50_1x", "retinanet_ghm_r50_1x",
           "retinanet_r50_fpg_50e", "retinanet_r50_nasfpn_50e")


def forward_gflop(model, hw) -> float:
    images = torch.empty(1, *hw, 3, device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(images, torch.empty(1, 2, dtype=torch.int32, device="meta"))
    return counter.get_total_flops() / 1e9


def main(names) -> int:
    for name in names:
        cfg = load_config(os.path.join(ROOT, "configs", f"{name}.py"))
        hw = tuple(cfg.data.bucket)
        model = get_family(cfg.model.arch)["build"](cfg.model, "meta")
        line = (f"{name}: arch {cfg.model.arch}, {hw[0]}x{hw[1]}, B="
                f"{cfg.data.samples_per_device} in the config; forward "
                f"{forward_gflop(model, hw):.1f} GFLOP an image")
        if cfg.model.teacher_depth:
            teacher = build_teacher_model(cfg, "meta")
            line += (f"; its ResNet-{cfg.model.teacher_depth} teacher "
                     f"{forward_gflop(teacher, hw):.1f}")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or CONFIGS))
