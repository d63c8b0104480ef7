"""RepPoints on the port (``models/reppoints.py``) against
dskd_tpu.models.reppoints on the CPU, on the same numpy-seeded inputs and
weights: ``points2bbox`` with its gradients (the moment's 0.01 share; f64,
1e-12), ``reppoints_centers`` (offset 0, exactly), ``point_assign``
exactly on random GTs, on a constructed exact tie (two GTs at one
distance from one cell: the earlier wins) and with a GT whose level has
no cell; then at the tiny configuration of tests/torch_port_dcn.py: the
forward (1e-4 relative / 1e-5 absolute), both stages' assignments of the
model's points exactly in f64, the losses in f64 (1e-8), one family step
in f64 (losses and named gradients, the moment transfer's and the two
deformable kernels' among them, 1e-8), the decode with and without a
binding per-level top-k, the registry's eval step, and the seeded init's
scales."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dcn as X
import torch_port_dense as D
from dskd_tpu_torch.models import reppoints as P

torch.set_num_threads(1)

FAM = "reppoints"
NC = X.NC
F64_TOL = dict(rtol=1e-12, atol=1e-12)
GRAD_NAMES = ("moment_transfer", "bbox_head.reppoints_cls_conv.weight",
              "bbox_head.reppoints_pts_refine_conv.weight",
              "bbox_head.reppoints_pts_init_conv.weight",
              "bbox_head.reppoints_pts_init_out.weight",
              "bbox_head.reppoints_pts_refine_out.weight",
              "bbox_head.reppoints_cls_out.weight",
              "bbox_head.reg_convs.2.conv.weight",
              "bbox_head.cls_convs.0.conv.bias",
              "neck.fpn_convs.3.conv.weight")


def test_points2bbox_matches_jax():
    from dskd_tpu.models.reppoints import points2bbox as jp2b

    rng = np.random.RandomState(0)
    pts = rng.randn(3, 7, 18) * 4
    moment = rng.randn(2) * 0.3
    cot = rng.randn(3, 7, 4)
    with jax.enable_x64(True):
        want, vjp = jax.vjp(jp2b, jnp.asarray(pts), jnp.asarray(moment))
        wg_pts, wg_m = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    tp = torch.from_numpy(pts).requires_grad_()
    tm = torch.from_numpy(moment).requires_grad_()
    got = P.points2bbox(tp, tm)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F64_TOL)
    np.testing.assert_allclose(tp.grad.numpy(), wg_pts, **F64_TOL)
    np.testing.assert_allclose(tm.grad.numpy(), wg_m, **F64_TOL)


def test_centers_match_jax():
    from dskd_tpu.models.reppoints import reppoints_centers as jcenters

    sizes = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
    want = jcenters(sizes)
    got = P.reppoints_centers(sizes, "cpu")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2] == want[2]
    assert got[0][1].tolist() == [8.0, 0.0]        # offset 0: x * stride


def _point_assign_both(sizes, gt, labels, valid):
    from dskd_tpu.models.reppoints import point_assign as jassign
    from dskd_tpu.models.reppoints import reppoints_centers as jcenters

    centers, strides, counts = P.reppoints_centers(sizes, "cpu")
    got = P.point_assign(centers.double(), counts, torch.from_numpy(gt),
                         torch.from_numpy(labels), torch.from_numpy(valid),
                         NC)
    with jax.enable_x64(True):
        jc, js, jn = jcenters(sizes)
        jc = jnp.asarray(jc, jnp.float64)
        want = jax.vmap(lambda b, l, v: jassign(jc, js, jn, b, l, v, NC))(
            gt, labels, valid)
    for g, w, name in zip(got, want, ("assigned", "pos", "labels")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return got


def test_point_assign_matches_jax():
    _, gt, labels, valid = D.batch_arrays(4)[1:]
    assigned, pos, _ = _point_assign_both(
        [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)], gt.astype(np.float64),
        labels, valid)
    assert int(pos.sum()) >= 3


def test_point_assign_exact_tie_and_empty_level():
    """Image 0: GTs 0 and 2 are one box, at one distance from one cell:
    the earlier (0) holds it, 2 gets nothing; GT 1 is a box on a level
    with no cell (level 1 is 0x0) and gets nothing. Image 1: a GT that
    only padding follows."""
    sizes = [(4, 5), (0, 0), (2, 2)]
    gt = np.array([[[10., 6., 22., 14.], [0., 0., 80., 80.],
                    [10., 6., 22., 14.]],
                   [[3., 3., 9., 9.], [0., 0., 0., 0.], [0., 0., 0., 0.]]])
    labels = np.array([[1, 2, 3], [4, 0, 0]], np.int32)
    valid = np.array([[True, True, True], [True, False, False]])
    assigned, pos, lab = _point_assign_both(sizes, gt, labels, valid)
    a = assigned.numpy()
    assert sorted(a[0][a[0] >= 0].tolist()) == [0]
    assert int((a[1] >= 0).sum()) == 1 and lab.numpy()[1][a[1] >= 0] == 4


def test_forward_matches_jax():
    X.assert_forward_matches(FAM, X.jax_variables(FAM), D.batch_arrays()[0])


def test_stage_assignments_match_jax_exactly_in_f64():
    """The point assignment and the refined stage's max-IoU (0.5 / 0.4,
    min_pos_iou 0) on the decoded initial boxes of the JAX model's points,
    f64 in both packages: every index, positive and ignored flag."""
    from dskd_tpu.core.max_iou_assigner import max_iou_assign as jmax
    from dskd_tpu.models import reppoints as J

    v = X.jax_variables(FAM)
    images, img_hw, gt, labels, valid = D.batch_arrays(1)
    jout = X.jax_apply(FAM)(v, jnp.asarray(images), jnp.asarray(img_hw))
    head, moment = D.f64(jout.head), np.asarray(jout.moment, np.float64)
    gt = gt.astype(np.float64)
    sizes = [c.shape[1:3] for c in head.cls_scores]
    with jax.enable_x64(True):
        c, s, n = J.reppoints_centers(sizes)
        c, s = jnp.asarray(c, jnp.float64), jnp.asarray(s, jnp.float64)
        pi = jnp.concatenate([p.reshape(2, -1, 18) for p in head.pts_init],
                             1)
        boxes = J._decoded_boxes(pi, c, s, moment)
        w_init = jax.vmap(lambda b, l, vd: J.point_assign(
            c, s, n, b, l, vd, NC))(gt, labels, valid)
        w_ref = jax.vmap(lambda bx, b, l, vd: jmax(
            bx, b, l, vd, NC, pos_iou_thr=0.5, neg_iou_thr=0.4,
            min_pos_iou=0.0, match_low_quality=True))(boxes, gt, labels,
                                                      valid)
    _, _, _, (a_init, pos_i), ref = P.reppoints_assign(
        X.port_head(FAM, head), torch.from_numpy(moment),
        torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(valid), P.RepPointsLossConfig(num_classes=NC))
    np.testing.assert_array_equal(a_init.numpy(), np.asarray(w_init[0]))
    np.testing.assert_array_equal(pos_i.numpy(), np.asarray(w_init[1]))
    np.testing.assert_array_equal(ref.assigned_gt.numpy(),
                                  np.asarray(w_ref.assigned_gt))
    assert int(pos_i.sum()) > 0 and int((ref.assigned_gt >= 0).sum()) > 0


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
                               "bbox_head.reppoints_pts_init_out.weight",
                               "bbox_head.reppoints_cls_conv.weight",
                               "bbox_head.reppoints_pts_refine_conv.weight"),
                         "bbox_head.reppoints_cls_out", -np.log(99))
    from dskd_tpu_torch import registry
    from dskd_tpu_torch.utils import config as pconfig
    m = registry.get_family(FAM)["build"](X.model_cfg(pconfig, FAM), "cpu")
    registry.get_family(FAM)["init_weights"](m, 0)
    assert not m.moment_transfer.any()
