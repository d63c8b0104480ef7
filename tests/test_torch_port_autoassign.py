"""AutoAssign on the port (``models/autoassign.py``) against
dskd_tpu.models.autoassign on the CPU, at the tiny configuration of
tests/torch_port_dense.py: the offset-0 points (exactly); the negative
weights of one pass (the last inside GT of each (point, class) by a max
scatter) against JAX's loop over the padded GTs, in which later GTs
overwrite (its lines re-run on its functions, f64, 1e-12), on the model's
outputs and on a batch with two overlapping GTs of one class, a GT that
holds no point (the 1e12 guards, the NaN sentinel) and a padded one; the
losses of that batch and of the tiny batch in f64 (1e-8); the forward
(1e-4); one family step's named gradients in f64 (1e-8), the detector's
centre prior's among them; the decode with and without a binding
per-level top-k; the registry's eval step; the seeded init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch.models import autoassign as P

torch.set_num_threads(1)

ARCH = "autoassign"
SIZES = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
GRAD_NAMES = ("center_prior_mean", "center_prior_sigma",
              "bbox_head.conv_cls.weight", "bbox_head.conv_reg.weight",
              "bbox_head.conv_objectness.weight", "bbox_head.scales.0.scale",
              "bbox_head.scales.1.scale", "bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.gn.weight",
              "neck.lateral_convs.0.conv.weight")
# two overlapping GTs of class 3 (the second inside the first), one of
# class 4 over the first, one that holds no grid point (between P3's points
# 0 and 8), one padded
EDGE_GT = np.array([[[10.0, 10.0, 60.0, 60.0], [30.0, 26.0, 50.0, 52.0],
                     [5.0, 30.0, 40.0, 65.0], [1.0, 1.0, 7.0, 7.0],
                     [0.0, 0.0, 0.0, 0.0]],
                    [[30.0, 5.0, 80.0, 50.0], [33.0, 9.0, 75.0, 66.0],
                     [2.0, 2.0, 6.0, 5.0], [0.0, 0.0, 0.0, 0.0],
                     [0.0, 0.0, 0.0, 0.0]]])
EDGE_LABELS = np.array([[3, 3, 4, 5, 1], [7, 7, 2, 0, 0]])
EDGE_VALID = np.array([[True] * 4 + [False], [True] * 3 + [False] * 2])


def _jax_negative_weights(boxes, gt, labels, valid):
    """JAX's negative weights (autoassign.py's per_image lines: the inside
    mask, the per-GT min-max normalisation with the 1e12 guards, the loop
    over the GTs with the NaN sentinel), re-run on its own functions."""
    from dskd_tpu.core.boxes import bbox_overlaps
    from dskd_tpu.models.autoassign import EPS, autoassign_points

    points = autoassign_points(SIZES)[0]

    def per_image(bx, gb, gl, gv):
        N, G = bx.shape[0], gb.shape[0]
        safe_lbl = jnp.clip(gl, 0, D.NC - 1)
        inside = ((points[:, 0][:, None] > gb[None, :, 0])
                  & (points[:, 0][:, None] < gb[None, :, 2])
                  & (points[:, 1][:, None] > gb[None, :, 1])
                  & (points[:, 1][:, None] < gb[None, :, 3]) & gv[None])
        ious = jnp.where(gv[None], bbox_overlaps(bx, gb), 0.0)
        ious = jnp.where(inside, jnp.broadcast_to(
            ious.max(1, keepdims=True), (N, G)), 0.0)
        tw = 1.0 / jnp.clip(1.0 - ious, EPS)
        tmin = jnp.where(inside, tw, 1e12).min(0)
        tmax = jnp.where(inside, tw, -1e12).max(0)
        tw = (tw - tmin[None] + EPS) / (tmax[None] - tmin[None] + EPS)
        w_neg = jnp.ones((N, D.NC))
        for g in range(G):
            colmask = jax.nn.one_hot(safe_lbl[g], D.NC)[None]
            upd = jnp.where(inside[:, g], 1.0 - tw[:, g], jnp.nan)
            w_neg = jnp.where((colmask > 0) & ~jnp.isnan(upd)[:, None],
                              upd[:, None], w_neg)
        return w_neg, inside

    with jax.enable_x64(True):
        return [np.asarray(x) for x in jax.vmap(per_image)(
            boxes, gt, labels, valid)]


def _port_negative_weights(boxes, gt, labels, valid):
    from dskd_tpu_torch.core.boxes import bbox_overlaps
    points = P.autoassign_points(SIZES, "cpu")[0].double()
    gt, labels, valid = (torch.from_numpy(a) for a in (gt, labels, valid))
    inside = P.inside_gt(points, gt, valid)
    ious = bbox_overlaps(torch.from_numpy(boxes), gt)
    ious = torch.where(valid[:, None], ious, torch.zeros_like(ious))
    return (P.negative_weights(ious, inside, labels.long().clamp(
        0, D.NC - 1), D.NC).numpy(), inside.numpy())


def _jax_boxes(gt):
    """The decoded boxes of the JAX model's f64 head outputs on the tiny
    batch's images."""
    images, img_hw = D.batch_arrays(1)[:2]
    head = M.jax_head_f64(ARCH, M.jax_variables(ARCH), images, img_hw)
    dist = np.concatenate([np.asarray(r).reshape(2, -1, 4)
                           for r in head.bbox_preds], 1)
    pts = P.autoassign_points(SIZES, "cpu")[0].double().numpy()
    return np.concatenate([pts - dist[..., :2], pts + dist[..., 2:]], -1)


@pytest.mark.parametrize("case", ["tiny_batch", "edge_cases"])
def test_negative_weights_match_jax_loop(case):
    if case == "tiny_batch":
        gt, labels, valid = D.batch_arrays(1)[2:]
        gt = gt.astype(np.float64)
    else:
        gt, labels, valid = EDGE_GT, EDGE_LABELS, EDGE_VALID
    boxes = _jax_boxes(gt)
    want, want_inside = _jax_negative_weights(boxes, gt, labels, valid)
    got, inside = _port_negative_weights(boxes, gt, labels, valid)
    np.testing.assert_array_equal(inside, want_inside)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert (got < 1).any()
    if case == "edge_cases":
        # a GT that holds no point, the padded ones: no inside point
        assert not inside[0, :, 3:].any() and not inside[1, :, 2:].any()
        # where both class-3 GTs hold a point, the later one writes: each
        # normalises over its own points, so their order shows
        both = inside[0, :, 0] & inside[0, :, 1]
        order = [1, 0, 2, 3, 4]
        swapped = _port_negative_weights(boxes, gt[:, order],
                                         labels[:, order], valid[:, order])[0]
        assert both.any()
        assert not np.allclose(swapped[0, both, 3], got[0, both, 3])


def test_last_inside_gt_is_the_largest_index():
    rng = np.random.RandomState(2)
    inside = torch.from_numpy(rng.rand(2, 30, 7) < 0.4)
    labels = torch.from_numpy(rng.randint(0, 4, (2, 7)))
    got = P.last_inside_gt(inside, labels, 4).numpy()
    want = np.zeros((2, 30, 4), np.int64)
    for b in range(2):
        for g in range(7):
            for n in range(30):
                if inside[b, n, g]:
                    want[b, n, labels[b, g]] = g + 1
    np.testing.assert_array_equal(got, want)


def test_edge_case_losses_match_jax_in_f64():
    """The losses with the overlapping GTs, the GT holding no point and the
    padded ones."""
    images, img_hw = D.batch_arrays(1)[:2]
    v = M.jax_variables(ARCH)
    head = M.jax_head_f64(ARCH, v, images, img_hw)
    priors = tuple(np.asarray(v["params"][k], np.float64)
                   for k in ("center_prior_mean", "center_prior_sigma"))
    with jax.enable_x64(True):
        want = jax.jit(lambda h, p: M.head_losses(
            "dskd_tpu", ARCH, h, EDGE_GT, EDGE_LABELS, EDGE_VALID, p))(
            head, priors)
        want = {k: float(x) for k, x in want.items()}
    got = M.head_losses("dskd_tpu_torch", ARCH, M.port_head(ARCH, head),
                        *(torch.from_numpy(a) for a in (
                            EDGE_GT, EDGE_LABELS, EDGE_VALID)),
                        tuple(torch.from_numpy(a) for a in priors))
    for k, x in want.items():
        assert np.isfinite(x) and x != 0, k
        np.testing.assert_allclose(float(got[k]), x, rtol=M.F64_RTOL, atol=0,
                                   err_msg=k)


def test_points_match_jax():
    from dskd_tpu.models.autoassign import autoassign_points
    want = autoassign_points(SIZES)
    got = P.autoassign_points(SIZES, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_forward_matches_jax():
    M.assert_forward_matches(ARCH, M.jax_variables(ARCH),
                             *M.batch_arrays(ARCH)[:2])


def test_losses_match_jax_in_f64():
    M.check_losses_f64(ARCH, rtol=M.F64_RTOL)


def test_family_step_matches_jax_grad_in_f64():
    M.check_family_step_f64(ARCH, GRAD_NAMES, rtol=M.F64_RTOL)


@pytest.mark.parametrize("nms_pre", [1000, 50])
def test_get_bboxes_matches_jax(nms_pre):
    M.check_get_bboxes(ARCH, nms_pre)


def test_eval_step_matches_jax():
    assert M.check_eval_step(ARCH).valid.any()


def test_init_weights_scales_and_seed():
    D.check_init_weights(ARCH, ("bbox_head.cls_convs.0.conv.weight",
                                "bbox_head.conv_objectness.weight"),
                         "bbox_head.conv_cls", -np.log(49),
                         {"bbox_head.conv_reg.bias": 4.0})
    from dskd_tpu_torch.utils.config import ModelConfig
    model = P.build_autoassign(ModelConfig(arch=ARCH, num_classes=D.NC,
                                           depth=18), "cpu")
    P.init_autoassign(model, 0)
    assert not model.center_prior_mean.detach().any()
    assert (model.center_prior_sigma.detach() == 1).all()
    assert set(dict(model.named_parameters())) >= {"center_prior_mean",
                                                   "center_prior_sigma"}
