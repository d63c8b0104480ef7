"""FreeAnchor on the port (``models/free_anchor.py``, the RetinaNet trunk)
against dskd_tpu.models.free_anchor on the CPU, at the tiny configuration
of tests/torch_port_dense.py: P(anchor in A+) by a per-class max scatter
against JAX's (G, N, C) broadcast and max (exactly, f64); the 50-anchor
bags against ``jax.lax.top_k`` at ties (equal qualities, invalid GTs at
-1, small GTs on many 0-IoU anchors), where the lower index goes first;
``retina_get_bboxes`` at the config's stds (0.1, 0.1, 0.2, 0.2); the
forward (1e-4); the losses and one family step's named gradients in f64
(1e-8); the decode with and without a binding per-level top-k; the
registry's eval step; the seeded init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch.models import free_anchor as P
from dskd_tpu_torch.models.retinanet import retina_anchors

torch.set_num_threads(1)

ARCH = "free_anchor"
SIZES = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
GRAD_NAMES = ("bbox_head.retina_cls.weight", "bbox_head.retina_reg.weight",
              "bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "neck.lateral_convs.0.conv.weight",
              "neck.fpn_convs.3.conv.weight")


def test_box_prob_matches_the_broadcast_form():
    """Two GTs of one class (their ramps' max), a class of none (0), an
    invalid GT (its ramp 0 whatever its label)."""
    rng = np.random.RandomState(0)
    B, G, N, C = 2, 7, 50, 6
    obp = np.clip(rng.rand(B, G, N) * 2 - 0.8, 0, 1)
    labels = rng.randint(0, C - 1, (B, G))
    labels[:, 1] = labels[:, 0]
    valid = np.ones((B, G), bool)
    valid[1, 3] = False
    obp = np.where(valid[..., None], obp, 0.0)
    onehot = np.eye(C)[labels] * valid[..., None]
    want = np.max(np.where(onehot[:, :, None, :] > 0, obp[..., None], 0.0),
                  axis=1)
    got = P.box_prob(torch.from_numpy(obp), torch.from_numpy(labels), C)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[..., C - 1] == 0).all() and want.max() > 0


def test_bags_take_jax_top_k_order_at_ties():
    """Quality with ties: quantised values, an invalid GT at -1 and a small
    GT whose IoU is 0 on most anchors; the bag's indices in JAX's order."""
    rng = np.random.RandomState(1)
    q = np.round(rng.rand(2, 5, 300) * 4) / 4
    q[0, 2] = -1.0
    q[1, 4, :] = 0.0
    q[1, 4, [17, 203]] = 0.3
    want = np.asarray(jax.lax.top_k(jnp.asarray(q), 50)[1])
    got = P.bag_anchors(torch.from_numpy(q), 50)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1, 4, :4].numpy(), [17, 203, 0, 1])


def test_bags_on_the_anchors_match_jax():
    """The bags of the tiny batch's GT on its 1,287 anchors: small GTs
    meet most anchors at IoU 0, padded GTs are -1."""
    anchors = retina_anchors(SIZES, "cpu")
    _, gt, _, valid = D.batch_arrays(1)[1:]
    q = P.bag_quality(anchors, torch.from_numpy(gt), torch.from_numpy(valid))
    want = np.asarray(jax.lax.top_k(jnp.asarray(q.numpy()), 50)[1])
    np.testing.assert_array_equal(P.bag_anchors(q, 50).numpy(), want)
    assert (q == 0).sum() > 0 and (q == -1).sum() > 0


def test_positive_probs_match_jax_in_f64():
    """P(anchor in A+) of the JAX model's deltas, the loss's own part
    (JAX's lines re-run here on its functions) against the port's."""
    from dskd_tpu.core.anchors import delta2bbox
    from dskd_tpu.core.boxes import bbox_overlaps
    from dskd_tpu.models import free_anchor as J

    images, img_hw, gt, labels, valid = D.batch_arrays(1)
    head = M.jax_head_f64(ARCH, M.jax_variables(ARCH), images, img_hw)
    deltas = np.concatenate([np.asarray(r).reshape(2, -1, 4)
                             for r in head.bbox_preds], 1)
    anchors = retina_anchors(SIZES, "cpu").double()
    # a GT made of an anchor's decoded box: ramps above 0
    gt = gt.astype(np.float64)
    with jax.enable_x64(True):
        gt[0, 0] = delta2bbox(jnp.asarray(anchors.numpy()[40]),
                              jnp.asarray(deltas[0, 40]), stds=J.DELTA_STDS)

        def one(d, gb, gl, gv):
            pred = delta2bbox(jnp.asarray(anchors.numpy()), d,
                              stds=J.DELTA_STDS)
            obi = jnp.where(gv[:, None], bbox_overlaps(gb, pred), 0.0)
            t2 = jnp.clip(obi.max(1, keepdims=True), J.BBOX_THR + 1e-12)
            obp = jnp.clip((obi - J.BBOX_THR) / (t2 - J.BBOX_THR), 0.0, 1.0)
            obp = jnp.where(gv[:, None], obp, 0.0)
            onehot = jax.nn.one_hot(jnp.clip(gl, 0, D.NC - 1), D.NC) \
                * gv[:, None]
            return jnp.max(jnp.where(onehot[:, None, :] > 0,
                                     obp[:, :, None], 0.0), axis=0)
        want = np.asarray(jax.vmap(one)(deltas, gt, labels, valid))
    got = P.positive_probs(anchors, torch.from_numpy(deltas),
                           torch.from_numpy(gt), torch.from_numpy(labels),
                           torch.from_numpy(valid), D.NC)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert want.max() == 1.0


def test_retina_get_bboxes_with_delta_stds_matches_jax():
    M.check_get_bboxes(ARCH, 1000)


def test_forward_matches_jax():
    M.assert_forward_matches(ARCH, M.jax_variables(ARCH),
                             *M.batch_arrays(ARCH)[:2])


def test_losses_match_jax_in_f64():
    M.check_losses_f64(ARCH, rtol=M.F64_RTOL)


def test_family_step_matches_jax_grad_in_f64():
    M.check_family_step_f64(ARCH, GRAD_NAMES, rtol=M.F64_RTOL)


@pytest.mark.parametrize("nms_pre", [50])
def test_get_bboxes_matches_jax(nms_pre):
    M.check_get_bboxes(ARCH, nms_pre)


def test_eval_step_matches_jax():
    assert M.check_eval_step(ARCH).valid.any()


def test_init_weights_scales_and_seed():
    D.check_init_weights(ARCH, ("bbox_head.cls_convs.0.conv.weight",
                                "bbox_head.retina_reg.weight"),
                         "bbox_head.retina_cls", -np.log(99))
