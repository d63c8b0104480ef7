"""FSAF on the port (``models/fsaf.py``) against dskd_tpu.models.fsaf on
the CPU, at the tiny configuration of tests/torch_port_dense.py: the
shrunk masks (exactly); the online level selection on the model's outputs
against JAX's candidate losses (its lines re-run on its functions: the
losses 1e-12, the infinite ones, each GT's level and whether it has one
exactly, f64); the forward (1e-4); the losses and one family step's
named gradients in f64 (1e-8); the decode with and without a binding
per-level top-k; the registry's eval step; the seeded init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch.models import fsaf as PF

torch.set_num_threads(1)

ARCH = "fsaf"
SIZES = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
GRAD_NAMES = ("bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "bbox_head.cls_convs.0.conv.weight",
              "bbox_head.conv_cls.weight", "bbox_head.conv_reg.weight",
              "neck.lateral_convs.0.conv.weight",
              "neck.fpn_convs.4.conv.weight")


@pytest.mark.parametrize("ratio", [0.2, 0.5])
def test_shrunk_mask_matches_jax(ratio):
    from dskd_tpu.models.fsaf import _shrunk_mask
    gt = D.batch_arrays(1)[2][0]
    for lvl, (h, w) in enumerate(SIZES[:3]):
        want = np.asarray(_shrunk_mask(h, w, PF.STRIDES[lvl],
                                       jnp.asarray(gt), ratio))
        got = PF._shrunk_mask(h, w, PF.STRIDES[lvl], torch.from_numpy(gt),
                              ratio)
        np.testing.assert_array_equal(got.numpy(), want)


def _jax_selection(head, gt, labels, valid):
    """JAX's candidate losses, levels and has_level (fsaf.py's per_image
    lines, re-run on its own functions)."""
    from dskd_tpu.core.boxes import bbox_overlaps
    from dskd_tpu.models.fsaf import FSAFLossConfig, STRIDES, _shrunk_mask

    cfg = FSAFLossConfig(num_classes=D.NC)

    def per_image(cls_maps, reg_maps, g, lb, v):
        cands = []
        for lvl, (cs, rs) in enumerate(zip(cls_maps, reg_maps)):
            h, w = cs.shape[:2]
            s = STRIDES[lvl]
            eff = _shrunk_mask(h, w, s, g, 0.2) & v[:, None, None]
            ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) * s
            xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) * s
            px, py = jnp.tile(xs[None], (h, 1)), jnp.tile(ys[:, None], (1, w))
            d = rs * (4.0 * s)
            boxes = jnp.stack([px - d[..., 0], py - d[..., 1],
                               px + d[..., 2], py + d[..., 3]], -1)
            p = jax.nn.sigmoid(cs)
            pg = p[..., jnp.clip(lb, 0, D.NC - 1)].transpose(2, 0, 1)
            focal = -cfg.focal_alpha * (1 - pg) ** cfg.focal_gamma \
                * jnp.log(jnp.clip(pg, 1e-8))
            ious = bbox_overlaps(boxes.reshape(-1, 4), g).reshape(
                h, w, -1).transpose(2, 0, 1)
            iou_l = -jnp.log(jnp.clip(ious, 1e-8))
            n_eff = jnp.clip(eff.sum((1, 2)).astype(jnp.float32), 1.0)
            c = ((focal + iou_l) * eff).sum((1, 2)) / n_eff
            cands.append(jnp.where(eff.any((1, 2)), c, jnp.inf))
        cand = jnp.stack(cands, 0)
        return cand, jnp.argmin(cand, 0), jnp.isfinite(cand.min(0)) & v

    with jax.enable_x64(True):
        cand, sel, has = jax.vmap(per_image)(
            list(head.cls_scores), list(head.bbox_preds), gt, labels, valid)
        return np.asarray(cand).transpose(1, 0, 2), np.asarray(sel), \
            np.asarray(has)


def test_fsaf_level_selection_matches_jax():
    images, img_hw, gt, labels, valid = D.batch_arrays(1)
    head = M.jax_head_f64("fsaf", M.jax_variables("fsaf"), images, img_hw)
    gt = gt.astype(np.float64)
    cand, sel, has = _jax_selection(head, gt, labels, valid)
    got = PF.fsaf_select_levels(M.port_head("fsaf", head),
                                *(torch.from_numpy(a) for a in (
                                    gt, labels, valid)),
                                PF.FSAFLossConfig(num_classes=D.NC))
    fin = np.isfinite(cand)
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()), fin)
    np.testing.assert_allclose(got[0].numpy()[fin], cand[fin], rtol=1e-12)
    np.testing.assert_array_equal(got[1].numpy(), sel)
    np.testing.assert_array_equal(got[2].numpy(), has)
    # more than one level carries an effective cell for some GT
    assert (fin.sum(0) > 1).any() and has.sum() > 0


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
                                "bbox_head.conv_reg.weight"),
                         "bbox_head.conv_cls", -np.log(99))
