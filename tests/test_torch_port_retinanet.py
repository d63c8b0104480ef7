"""The RetinaNet family on the port against dskd_tpu.models.retinanet on
the CPU, at the tiny configuration of tests/torch_port_dense.py (9
anchors per position): the forward (head outputs and FPN levels, with the
extra convs on the C5 input, 1e-4), ``retina_detection_loss`` on JAX's
head outputs in f64 (1e-6), one generic family step in f64 against
``jax.value_and_grad`` (losses 1e-6, named gradients 1e-5 relative L2),
``retina_get_bboxes`` with and without a binding per-level top-k (labels
and valid exactly, boxes 1e-5), the port's state dict through JAX's
``convert_mmdet_retinanet`` back to the JAX variables exactly, and the
seeded init's scales."""
import numpy as np
import pytest
import torch

import torch_port_dense as D
from dskd_tpu_torch import registry

torch.set_num_threads(1)

ARCH = "retinanet"
GRAD_NAMES = ("bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "bbox_head.retina_cls.weight", "bbox_head.retina_reg.weight",
              "neck.lateral_convs.0.conv.weight",
              "neck.fpn_convs.3.conv.weight")


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


def test_state_dict_round_trips_through_jax_converter():
    """from_jax, then JAX's own mmdet converter: the JAX variables back,
    every leaf, so the port's names are mmdet's."""
    from dskd_tpu.utils.torch_weights import convert_mmdet_retinanet

    v = D.jax_variables(ARCH)
    sd = registry.get_family(ARCH)["from_jax"](v)
    params, stats = convert_mmdet_retinanet(sd, depth=18)
    D.assert_trees_equal({"params": params, "batch_stats": stats}, v)


def test_init_weights_scales_and_seed():
    D.check_init_weights(ARCH, ("bbox_head.cls_convs.0.conv.weight",
                                "bbox_head.retina_reg.weight"),
                         "bbox_head.retina_cls", -np.log(99))
