"""TOOD on the port (``models/tood.py``) against dskd_tpu.models.tood on
the CPU, at the tiny configuration of tests/torch_port_dense.py:
``_sample_sides`` and its gradients in f64 (1e-12) at the init's offsets
(within 2e-3 of integers, so ``floor`` picks the neighbour) and at wide
ones (corners outside the map); ``tood_points`` (exactly); the
task-aligned assignment on the model's outputs (exactly, f64) and at a
tie of the k-th alignment, which admits more than 13 positives; the
forward (1e-4); the losses in f64 (1e-8), TAL's and the first epochs'
ATSS path; one family step's named gradients in f64 (1e-8); the decode
with and without a binding per-level top-k; the registry's eval step;
the seeded init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch.models import tood as P

torch.set_num_threads(1)

ARCH = "tood"
SIZES = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
GRAD_NAMES = ("bbox_head.tood_cls.weight", "bbox_head.tood_reg.weight",
              "bbox_head.cls_prob_module.2.weight",
              "bbox_head.cls_prob_module.0.weight",
              "bbox_head.reg_offset_module.2.weight",
              "bbox_head.reg_offset_module.0.weight",
              "bbox_head.cls_decomp.layer_attention.0.weight",
              "bbox_head.reg_decomp.layer_attention.2.weight",
              "bbox_head.reg_decomp.reduction_conv.conv.weight",
              "bbox_head.cls_decomp.reduction_conv.gn.weight",
              "bbox_head.inter_convs.5.conv.weight",
              "bbox_head.inter_convs.0.gn.bias", "bbox_head.scales.0.scale",
              "neck.lateral_convs.0.conv.weight")


@pytest.mark.parametrize("spread", ["init", "wide"])
def test_sample_sides_and_gradients_match_jax_in_f64(spread):
    from dskd_tpu.models.tood import _sample_sides as jsample

    rng = np.random.RandomState(0 if spread == "init" else 1)
    dist = rng.randn(2, 7, 9, 4) * 5 + 20
    if spread == "init":
        off = (rng.randint(-2, 3, (2, 7, 9, 8))
               + (rng.rand(2, 7, 9, 8) * 2 - 1) * 2e-3)
    else:
        off = rng.randn(2, 7, 9, 8) * 6
    cot = rng.randn(2, 7, 9, 4)
    with jax.enable_x64(True):
        want, vjp = jax.vjp(jsample, jnp.asarray(dist), jnp.asarray(off))
        wd, wo = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    d = torch.from_numpy(dist).requires_grad_()
    o = torch.from_numpy(off).requires_grad_()
    got = P._sample_sides(d, o)
    (got * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(d.grad.numpy(), wd, **tol)
    np.testing.assert_allclose(o.grad.numpy(), wo, **tol)
    ys = np.arange(7)[:, None, None] + off[..., 0::2]
    xs = np.arange(9)[None, :, None] + off[..., 1::2]
    assert ((ys < 0) | (ys > 6) | (xs < 0) | (xs > 8)).any()
    if spread == "init":
        # offsets just below an integer: floor takes the lower neighbour
        assert (np.floor(off) != np.round(off)).any()


def test_points_match_jax():
    from dskd_tpu.models.tood import tood_points as jpoints
    want = jpoints(SIZES)
    got = P.tood_points(SIZES, "cpu")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2] == want[2]


def _jax_assign(scores, boxes, points, gt, labels, valid, k=13):
    from dskd_tpu.models.tood import task_aligned_assign
    with jax.enable_x64(True):
        return [np.asarray(x) for x in jax.vmap(
            lambda s, b, g, lb, v: task_aligned_assign(
                s, b, jnp.asarray(points), g, lb, v, D.NC, k))(
            scores, boxes, gt, labels, valid)]


def test_task_aligned_assignment_matches_jax_exactly():
    v = M.jax_variables(ARCH)
    images, img_hw, gt, labels, valid = D.batch_arrays(1)
    head = M.jax_head_f64(ARCH, v, images, img_hw)
    B = images.shape[0]
    scores = np.concatenate([np.asarray(c).reshape(B, -1, D.NC)
                             for c in head.cls_scores], 1)
    boxes = np.concatenate([np.asarray(c).reshape(B, -1, 4)
                            for c in head.bbox_preds], 1)
    points = P.tood_points(SIZES, "cpu")[0].double()
    gt = gt.astype(np.float64)
    want = _jax_assign(scores, boxes, points.numpy(), gt, labels, valid)
    got = P.task_aligned_assign(*(torch.from_numpy(a) for a in (
        scores, boxes)), points, *(torch.from_numpy(a) for a in (
            gt, labels, valid)), D.NC)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got.pos.sum() > 0


def test_kth_tie_admits_more_than_topk():
    """Twenty points inside one GT with equal alignment: all reach the
    13th value; a second GT's points sit on the first's, so the conflict
    goes to the larger IoU (the first GT where equal)."""
    N, k = 40, 13
    points = torch.stack([torch.arange(N, dtype=torch.float64) * 2 + 1,
                          torch.full((N,), 10.0, dtype=torch.float64)], -1)
    gt = torch.tensor([[[0.0, 0.0, 41.0, 20.0], [0.0, 0.0, 41.0, 20.0],
                        [50.0, 50.0, 60.0, 60.0]]], dtype=torch.float64)
    labels = torch.tensor([[3, 5, 1]])
    valid = torch.tensor([[True, True, False]])
    boxes = gt[:, :1].expand(1, N, 4).clone()
    boxes[0, 20:, 2] = 30.0                  # a lower IoU for the last 20
    scores = torch.full((1, N, D.NC), 0.5, dtype=torch.float64)
    want = _jax_assign(scores.numpy(), boxes.numpy(), points.numpy(),
                       gt.numpy(), labels.numpy(), valid.numpy(), k)
    got = P.task_aligned_assign(scores, boxes, points, gt, labels, valid,
                                D.NC, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got.pos.sum()) == 20 > k
    assert (got.assigned_gt[0, :20] == 0).all() and (got.labels[0, :20]
                                                     == 3).all()


def test_forward_matches_jax():
    M.assert_forward_matches(ARCH, M.jax_variables(ARCH),
                             *M.batch_arrays(ARCH)[:2])


def test_losses_match_jax_in_f64():
    M.check_losses_f64(ARCH, rtol=M.F64_RTOL)


def test_initial_epochs_losses_match_jax_in_f64():
    """use_tal=False: ATSS's assignment, activated focal loss, GIoU weighted
    by the centerness."""
    images, img_hw, gt, labels, valid = D.batch_arrays(1)
    head = M.jax_head_f64(ARCH, M.jax_variables(ARCH), images, img_hw)
    gt = gt.astype(np.float64)
    with jax.enable_x64(True):
        want = jax.jit(lambda h, g: M.head_losses(
            "dskd_tpu", ARCH, h, g, labels, valid, use_tal=False))(head, gt)
        want = {k: float(x) for k, x in want.items()}
    got = M.head_losses("dskd_tpu_torch", ARCH, M.port_head(ARCH, head),
                        torch.from_numpy(gt), torch.from_numpy(labels),
                        torch.from_numpy(valid), use_tal=False)
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert np.isfinite(x) and x != 0, k
        np.testing.assert_allclose(float(got[k]), x, rtol=M.F64_RTOL, atol=0,
                                   err_msg=k)


def test_family_step_matches_jax_grad_in_f64():
    M.check_family_step_f64(ARCH, GRAD_NAMES, rtol=M.F64_RTOL)


@pytest.mark.parametrize("nms_pre", [1000, 50])
def test_get_bboxes_matches_jax(nms_pre):
    M.check_get_bboxes(ARCH, nms_pre)


def test_eval_step_matches_jax():
    assert M.check_eval_step(ARCH).valid.any()


def test_init_weights_scales_and_seed():
    D.check_init_weights(ARCH, ("bbox_head.inter_convs.0.conv.weight",
                                "bbox_head.tood_reg.weight",
                                "bbox_head.cls_prob_module.0.weight"),
                         "bbox_head.tood_cls", -np.log(99),
                         {"bbox_head.cls_prob_module.2.bias": -np.log(99)})
    from dskd_tpu_torch.utils.config import ModelConfig
    model = P.build_tood(ModelConfig(arch=ARCH, num_classes=D.NC, depth=18),
                         "cpu")
    P.init_tood(model, 0)
    head = model.bbox_head
    for conv in (head.cls_decomp.layer_attention[0],
                 head.reg_offset_module[2]):
        assert abs(float(conv.weight.detach().std()) - 0.001) < 2e-4
