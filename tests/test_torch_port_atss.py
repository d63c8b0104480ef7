"""The ATSS family on the port against dskd_tpu.models.atss on the CPU,
at the tiny configuration of tests/torch_port_dense.py: the forward (head
outputs, the centerness from the reg tower, and FPN levels, 1e-4),
``atss_detection_loss`` on JAX's head outputs in f64 (1e-6), one generic
family step in f64 against ``jax.value_and_grad`` (losses 1e-6, named
gradients 1e-5 relative L2), ``atss_get_bboxes`` with and without a
binding per-level top-k (labels and valid exactly, boxes 1e-5), and the
seeded init's scales; ``from_jax`` loads strictly in every test."""
import numpy as np
import pytest
import torch

import torch_port_dense as D

torch.set_num_threads(1)

ARCH = "atss"
GRAD_NAMES = ("bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "bbox_head.atss_cls.weight", "bbox_head.atss_reg.weight",
              "bbox_head.atss_centerness.weight",
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


def test_centerness_target_matches_jax():
    from dskd_tpu.models.atss import _centerness_target as jct
    from dskd_tpu_torch.models.atss import _centerness_target

    rng = np.random.RandomState(5)
    anchors = (rng.rand(40, 4) * 60).astype(np.float32)
    anchors[:, 2:] += anchors[:, :2]
    gts = anchors + (rng.randn(40, 4) * 20).astype(np.float32)
    np.testing.assert_allclose(
        _centerness_target(torch.from_numpy(anchors),
                           torch.from_numpy(gts)).numpy(),
        np.asarray(jct(anchors, gts)), rtol=1e-6, atol=1e-7)


def test_init_weights_scales_and_seed():
    D.check_init_weights(ARCH, ("bbox_head.cls_convs.0.conv.weight",
                                "bbox_head.atss_centerness.weight"),
                         "bbox_head.atss_cls", -np.log(99))
