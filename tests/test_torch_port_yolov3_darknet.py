"""YOLOv3 on Darknet-53 (``models/yolov3.py Darknet53``, full depth)
against dskd_tpu on the CPU, 10 classes, B=2 on 64x64
(tests/torch_port_zoo.py):

- Darknet-53's outputs (C3-C5) in f64 (1e-8 relative, L2);
- one family step's losses and named gradients in f64 (1e-8), and the
  trained BatchNorms' running statistics (1e-8);
- the registry's eval step (f32: labels and valid exactly, scores 1e-5,
  boxes 1e-4).
"""
import torch

import torch_port_zoo as Z
from dskd_tpu_torch.models import yolov3 as PY

torch.set_num_threads(1)

ARCH = "yolov3"
GRAD_NAMES = ("pred0.weight", "pred2.weight", "head1_conv.weight",
              "neck4_2_conv.weight", "reduce3_conv.weight",
              "backbone.s4b3_2_conv.weight", "backbone.stem_conv.weight")


def test_darknet53_outputs_match_jax_in_f64():
    from dskd_tpu.models.yolov3 import Darknet53 as JDark
    images, img_hw = Z.canvas(64, 96)
    outs = Z.check_backbone_f64(ARCH, "", images, img_hw, JDark,
                                lambda: PY.Darknet53("cpu"))
    assert [o.shape[1] for o in outs] == [256, 512, 1024]


def test_family_step_matches_jax_grad_in_f64():
    Z.check_family_step_f64(ARCH, "", GRAD_NAMES)


def test_eval_step_matches_jax():
    Z.check_eval_step(ARCH)
