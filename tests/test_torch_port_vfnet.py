"""VFNet on the port (``models/vfnet.py``) against dskd_tpu.models.vfnet on
the CPU, on the same numpy-seeded inputs and weights, at the tiny
configuration of tests/torch_port_dcn.py: ``star_dcn_offsets`` and its
0.1 gradient share (f64, 1e-12), ``vfnet_points`` (exactly), the forward
(1e-4 relative / 1e-5 absolute; at the init's spread many star taps fall
outside the maps), ATSS's assignment on the anchors (exactly, f64), the
losses in f64 (1e-8), one family step in f64 (losses and named gradients,
the two deformable kernels' and the refine scales' among them, 1e-8),
the decode with and without a binding per-level top-k, the registry's
eval step, and the seeded init's scales."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dcn as X
import torch_port_dense as D
from dskd_tpu_torch.models import vfnet as P

torch.set_num_threads(1)

FAM = "vfnet"
F64_TOL = dict(rtol=1e-12, atol=1e-12)
GRAD_NAMES = ("bbox_head.vfnet_reg_refine_dconv.weight",
              "bbox_head.vfnet_cls_dconv.weight", "bbox_head.vfnet_reg.weight",
              "bbox_head.vfnet_reg_refine.weight", "bbox_head.vfnet_cls.weight",
              "bbox_head.vfnet_reg_conv.conv.weight",
              "bbox_head.scales.0.scale", "bbox_head.scales_refine.0.scale",
              "bbox_head.reg_convs.2.conv.weight",
              "bbox_head.cls_convs.0.conv.weight",
              "neck.lateral_convs.0.conv.weight")


@pytest.mark.parametrize("stride", [8, 32])
def test_star_dcn_offsets_match_jax(stride):
    """The offsets and d sum(offsets x cot) / d ltrb: 0.1 of the full
    derivative passes."""
    from dskd_tpu.models.vfnet import star_dcn_offsets as jstar

    rng = np.random.RandomState(stride)
    ltrb = np.exp(rng.randn(2, 5, 6, 4)) * stride * 8
    cot = rng.randn(2, 5, 6, 18)
    with jax.enable_x64(True):
        want, vjp = jax.vjp(lambda d: jstar(d, stride), jnp.asarray(ltrb))
        want_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    t = torch.from_numpy(ltrb).requires_grad_()
    got = P.star_dcn_offsets(t, stride)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F64_TOL)
    np.testing.assert_allclose(t.grad.numpy(), want_grad, **F64_TOL)
    # the top-left tap sits on the box's top-left corner
    np.testing.assert_allclose(got.detach().numpy()[..., 0],
                               -ltrb[..., 1] / stride + 1, **F64_TOL)


def test_points_match_jax():
    from dskd_tpu.models.vfnet import vfnet_points as jpoints

    sizes = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
    want = jpoints(sizes)
    got = P.vfnet_points(sizes, "cpu")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2] == want[2]


def test_forward_matches_jax():
    want = X.assert_forward_matches(FAM, X.jax_variables(FAM),
                                    D.batch_arrays()[0])
    # the star taps reach beyond the maps at this spread
    d = np.asarray(want.head.bbox_preds[0]) / 8
    assert (d.max(-1) > 11).any()


def test_assignment_matches_jax_exactly():
    from dskd_tpu.core.atss import atss_assign as jassign
    from dskd_tpu.models.vfnet import vfnet_points as jpoints
    from dskd_tpu_torch.core.atss import atss_assign

    sizes = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
    _, gt, labels, valid = D.batch_arrays(1)[1:]
    gt = gt.astype(np.float64)
    _, anchors, counts = P.vfnet_points(sizes, "cpu")
    got = atss_assign(anchors.double(), counts, torch.from_numpy(gt),
                      torch.from_numpy(labels), torch.from_numpy(valid), 10)
    with jax.enable_x64(True):
        _, ja, jc = jpoints(sizes)
        want = jax.vmap(lambda b, l, v: jassign(
            jnp.asarray(ja, jnp.float64), jc, b, l, v, 10))(gt, labels, valid)
    np.testing.assert_array_equal(got.assigned_gt.numpy(),
                                  np.asarray(want.assigned_gt))
    np.testing.assert_array_equal(got.pos_mask.numpy(),
                                  np.asarray(want.pos_mask))
    assert got.pos_mask.sum() > 0


def test_losses_match_jax_in_f64():
    X.check_losses_f64(FAM)


def test_family_step_matches_jax_grad_in_f64():
    X.check_family_step_f64(FAM, GRAD_NAMES)


@pytest.mark.parametrize("nms_pre", [1000, 50])
def test_get_bboxes_matches_jax(nms_pre):
    X.check_get_bboxes(FAM, nms_pre)


def test_eval_step_matches_jax():
    X.check_eval_step(FAM)


def test_init_weights_scales_and_seed():
    D.check_init_weights(FAM, ("bbox_head.cls_convs.0.conv.weight",
                               "bbox_head.vfnet_reg.weight",
                               "bbox_head.vfnet_reg_refine_dconv.weight",
                               "bbox_head.vfnet_cls_dconv.weight"),
                         "bbox_head.vfnet_cls", -np.log(99))
