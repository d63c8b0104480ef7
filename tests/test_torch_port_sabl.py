"""SABL-RetinaNet and its bucketing coder on the port
(``core/coders.py``, ``models/sabl_retina.py``) against dskd_tpu on the
CPU, at the tiny configuration of tests/torch_port_dense.py: ``bbox2bucket``
and ``bucket2bbox`` on random boxes in f64 (1e-12) and at ties (a GT side
halfway between two bucket centres; two equal best buckets, adjacent or
not), where the lower index goes first as JAX's ``top_k`` takes it; the
square and approx anchors (exactly); the approx-max-IoU assignment and the
bucket targets (exactly, f64); the forward (1e-4); the losses and one
family step's named gradients in f64 (1e-8, the anchors in f64 on both
sides: ``torch_port_dense_more.f64_anchors``); the decode with and without
a binding per-level top-k; the registry's eval step; the seeded init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch.core import coders as PC
from dskd_tpu_torch.models import sabl_retina as P

torch.set_num_threads(1)

ARCH = "sabl_retina"
SIZES = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
GRAD_NAMES = ("bbox_head.retina_cls.weight",
              "bbox_head.retina_bbox_cls.weight",
              "bbox_head.retina_bbox_reg.weight",
              "bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "neck.lateral_convs.0.conv.weight",
              "neck.fpn_convs.3.conv.weight")


def _boxes(rng, n, lo=0.0, span=200.0):
    xy = rng.rand(n, 2) * span + lo
    wh = rng.rand(n, 2) * 80 + 4
    return np.concatenate([xy, xy + wh], -1)


def _jax_bbox2bucket(proposals, gt):
    from dskd_tpu.core.coders import bbox2bucket
    with jax.enable_x64(True):
        return [np.asarray(x) for x in bbox2bucket(
            jnp.asarray(proposals), jnp.asarray(gt), 14, 3.0)]


def _jax_bucket2bbox(proposals, cls, off):
    from dskd_tpu.core.coders import bucket2bbox
    with jax.enable_x64(True):
        return [np.asarray(x) for x in bucket2bbox(
            jnp.asarray(proposals), jnp.asarray(cls), jnp.asarray(off), 14,
            3.0)]


def test_bbox2bucket_matches_jax_in_f64():
    rng = np.random.RandomState(0)
    proposals = _boxes(rng, 64)
    gt = proposals + rng.randn(64, 4) * 20
    want = _jax_bbox2bucket(proposals, gt)
    got = PC.bbox2bucket(torch.from_numpy(proposals), torch.from_numpy(gt),
                         14, 3.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
    # each side's label one-hot, its nearest bucket weighted 1
    assert (got[2].reshape(64, 4, 7).sum(-1) == 1).all()
    assert (got[1].reshape(64, 4, 7).max(-1).values == 1).all()


def test_bbox2bucket_tie_takes_the_lower_bucket():
    """A GT left side halfway between the first two bucket centres: both
    offsets are 0.5 exactly; the label, and the first offset weight, go
    to bucket 0, the second (0.5 < 1) is weighted too."""
    # rescaled by 3 about the centre: x from -14 to 28, buckets 3 wide,
    # the left side's centres -12.5, -9.5, ...
    proposals = np.array([[0.0, 0.0, 14.0, 14.0]])
    gt = np.array([[-11.0, -11.0, 25.0, 26.0]])
    want = _jax_bbox2bucket(proposals, gt)
    got = [t.numpy() for t in PC.bbox2bucket(torch.from_numpy(proposals),
                                             torch.from_numpy(gt), 14, 3.0)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    left = slice(0, 7)
    np.testing.assert_array_equal(got[0][0, :2], [-0.5, 0.5])
    np.testing.assert_array_equal(got[2][0, left], np.eye(7)[0])
    np.testing.assert_array_equal(got[1][0, left], [1, 1, 0, 0, 0, 0, 0])
    # the neighbour within one bucket is the label's, so nothing ignored
    # but the buckets that are neither label nor within one bucket width
    np.testing.assert_array_equal(got[3][0, left], [1, 0, 1, 1, 1, 1, 1])


def test_bucket2bbox_matches_jax_in_f64():
    rng = np.random.RandomState(1)
    proposals = _boxes(rng, 64)
    cls = rng.randn(64, 28) * 2
    off = rng.randn(64, 28) * 0.3
    want = _jax_bucket2bbox(proposals, cls, off)
    got = PC.bucket2bbox(torch.from_numpy(proposals), torch.from_numpy(cls),
                         torch.from_numpy(off), 14, 3.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pair,adjacent", [((2, 4), False), ((3, 4), True)])
def test_bucket2bbox_ties_take_the_lower_bucket(pair, adjacent):
    """Two equal best buckets: the lower one decodes; the confidence adds
    the second score only when the two are adjacent."""
    proposals = np.array([[10.0, 20.0, 50.0, 70.0]])
    cls = np.zeros((1, 28))
    cls[0, list(pair)] = 3.0
    off = np.linspace(-0.5, 0.5, 28)[None]
    want = _jax_bucket2bbox(proposals, cls, off)
    got = [t.numpy() for t in PC.bucket2bbox(
        torch.from_numpy(proposals), torch.from_numpy(cls),
        torch.from_numpy(off), 14, 3.0)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    p = 1.0 / (2 + 5 * np.exp(-3.0))          # each of the two best
    # the other three sides: seven equal buckets, the best two 0 and 1
    rest = 2.0 / 7
    side0 = 2 * p if adjacent else p
    np.testing.assert_allclose(got[1], (side0 + 3 * rest) / 4, rtol=1e-12)
    # the left side decodes from the lower bucket's centre and offset
    bw = 40 * 3.0 / 14
    x1 = 30 - 60 + (0.5 + pair[0]) * bw - off[0, pair[0]] * bw
    np.testing.assert_allclose(got[0][0, 0], x1, rtol=1e-12)


def test_anchors_match_jax():
    from dskd_tpu.models.sabl_retina import sabl_anchors
    want = sabl_anchors(SIZES)
    got = P.sabl_anchors(SIZES, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_assignment_and_bucket_targets_match_jax_exactly():
    from dskd_tpu.core.coders import bbox2bucket
    from dskd_tpu.models import sabl_retina as J

    _, gt, labels, valid = D.batch_arrays(1)[1:]
    gt = gt.astype(np.float64)
    with jax.enable_x64(True):
        squares, approxs = (jnp.asarray(a, jnp.float64)
                            for a in J.sabl_anchors(SIZES))
        a, pos, lbl = jax.vmap(lambda g, lb, v: J.approx_max_iou_assign(
            approxs, g, lb, v, D.NC))(gt, labels, valid)
        tgt = jnp.take_along_axis(jnp.asarray(gt), jnp.clip(a, 0, 5)[
            ..., None], 1)
        want = [np.asarray(x) for x in (a, pos, lbl)] + [
            np.asarray(x) for x in jax.vmap(lambda t: bbox2bucket(
                squares, t, 14, 3.0))(tgt)]
    sq, ap = (t.double() for t in P.sabl_anchors(SIZES, "cpu"))
    ga, gpos, glbl, buckets = P.sabl_targets(
        sq, ap, torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(valid), D.NC)
    for g, w in zip([ga, gpos, glbl, *buckets], want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert gpos.sum() > 0 and (ga == -2).sum() > 0


def test_forward_matches_jax():
    M.assert_forward_matches(ARCH, M.jax_variables(ARCH),
                             *M.batch_arrays(ARCH)[:2])


def test_losses_match_jax_in_f64():
    with M.f64_anchors():
        M.check_losses_f64(ARCH, rtol=M.F64_RTOL)


def test_family_step_matches_jax_grad_in_f64():
    with M.f64_anchors():
        M.check_family_step_f64(ARCH, GRAD_NAMES, rtol=M.F64_RTOL)


@pytest.mark.parametrize("nms_pre", [1000, 50])
def test_get_bboxes_matches_jax(nms_pre):
    M.check_get_bboxes(ARCH, nms_pre)


def test_eval_step_matches_jax():
    assert M.check_eval_step(ARCH).valid.any()


def test_init_weights_scales_and_seed():
    D.check_init_weights(ARCH, ("bbox_head.cls_convs.0.conv.weight",
                                "bbox_head.retina_bbox_cls.weight",
                                "bbox_head.retina_bbox_reg.weight"),
                         "bbox_head.retina_cls", -np.log(99))
