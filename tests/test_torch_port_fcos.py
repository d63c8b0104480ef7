"""The FCOS family on the port against dskd_tpu.models.fcos on the CPU,
at the tiny configuration of tests/torch_port_dense.py: the forward (head
outputs, exp(Scale x reg) and the centerness from the cls tower, and FPN
levels, 1e-4), ``fcos_detection_loss`` on JAX's head outputs in f64
(1e-6), one generic family step in f64 against ``jax.value_and_grad``
(losses 1e-6, named gradients 1e-5 relative L2, every gradient finite),
``fcos_get_bboxes`` with and without a binding per-level top-k (labels and
valid exactly, boxes 1e-5), and the seeded init's scales; ``from_jax``
loads strictly in every test."""
import numpy as np
import pytest
import torch

import torch_port_dense as D

torch.set_num_threads(1)

ARCH = "fcos"
GRAD_NAMES = ("bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "bbox_head.conv_cls.weight", "bbox_head.conv_reg.weight",
              "bbox_head.conv_centerness.weight",
              "neck.lateral_convs.0.conv.weight", "bbox_head.scales.0.scale")


def test_forward_matches_jax():
    D.assert_forward_matches(ARCH, D.jax_variables(ARCH),
                             D.batch_arrays()[0])


def test_losses_match_jax_in_f64():
    D.check_losses_f64(ARCH)


def test_family_step_matches_jax_grad_in_f64():
    D.check_family_step_f64(ARCH, GRAD_NAMES)


@pytest.mark.parametrize("nms_pre", [1000, 50])
def test_get_bboxes_matches_jax(nms_pre):
    D.check_get_bboxes(ARCH, nms_pre)


def test_gradients_finite_with_far_negatives():
    """Regression outputs 10^4 wide at the negatives: -log IoU stays
    finite under its clamp, so the zero weight meets no inf and every
    gradient of the step is finite."""
    from dskd_tpu_torch.models.fcos import FCOSLossConfig, \
        fcos_detection_loss, fcos_points

    v = D.jax_variables(ARCH)
    model = D.port_model(ARCH, v)
    with torch.no_grad():
        model.bbox_head.conv_reg.bias.fill_(9.0)
    images, img_hw, gt, labels, valid = (torch.from_numpy(np.asarray(a))
                                         for a in D.batch_arrays(4))
    out = model(images, img_hw)
    points, meta = fcos_points([c.shape[1:3] for c in out.head.cls_scores],
                               "cpu")
    losses = fcos_detection_loss(out.head, points, meta, gt, labels, valid,
                                 FCOSLossConfig(num_classes=D.NC))
    sum(losses.values()).backward()
    assert all(bool(torch.isfinite(x)) for x in losses.values())
    for n, p in model.named_parameters():
        if p.grad is not None:
            assert bool(torch.isfinite(p.grad).all()), n


def test_init_weights_scales_and_seed():
    D.check_init_weights(ARCH, ("bbox_head.cls_convs.0.conv.weight",
                                "bbox_head.conv_reg.weight"),
                         "bbox_head.conv_cls", -np.log(99))
