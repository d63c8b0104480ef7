"""The dense single-stage families' shared modules on the port against the
JAX package on the CPU: ``bbox_clip``, ``distance2bbox``,
``bbox2distance``, ``integral`` and ``bce_loss`` (f64, 1e-6 relative);
``filter_scores_and_topk_mlvl`` on quantised scores (every field
exactly); ``max_iou_assign`` with IoUs exactly at the thresholds,
duplicate anchors, duplicate GTs and two GTs sharing a best anchor;
``atss_assign`` with GT centres equidistant from grid anchor centres and
duplicate GTs; FCOS's targets with GTs of equal area (every output
exactly); the FPN in each extra-conv mode on odd input sizes (1e-4); and
the options and archs the port does not build, each raising with its
name.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch import registry
from dskd_tpu_torch.core import boxes as PB
from dskd_tpu_torch.core import losses as PL
from dskd_tpu_torch.core.atss import atss_assign
from dskd_tpu_torch.core.integral import integral
from dskd_tpu_torch.core.max_iou_assigner import max_iou_assign
from dskd_tpu_torch.core.postprocess import filter_scores_and_topk_mlvl
from dskd_tpu_torch.models.fcos import _fcos_targets, fcos_points
from dskd_tpu_torch.models.fpn import FPN
from dskd_tpu_torch.models.gfl_head import gfl_anchors

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(got, want):
    for name in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name)


def test_box_transforms_match_jax():
    from dskd_tpu.core import boxes as JB

    rng = np.random.RandomState(0)
    pts = rng.rand(2, 30, 2) * 80
    dist = rng.randn(2, 30, 4) * 30
    bx = np.concatenate([pts - 20, pts + 25], -1) + rng.randn(2, 30, 4) * 5
    with jax.enable_x64(True):
        for hw in ((60, 80), None):
            np.testing.assert_allclose(
                PB.distance2bbox(_t(pts), _t(dist), hw).numpy(),
                np.asarray(JB.distance2bbox(jnp.asarray(pts),
                                            jnp.asarray(dist), hw)),
                rtol=1e-12)
        np.testing.assert_array_equal(
            PB.bbox_clip(_t(bx), (60, 80)).numpy(),
            np.asarray(JB.bbox_clip(jnp.asarray(bx), (60, 80))))
        for max_dis in (None, 16):
            np.testing.assert_allclose(
                PB.bbox2distance(_t(pts), _t(bx), max_dis).numpy(),
                np.asarray(JB.bbox2distance(jnp.asarray(pts), jnp.asarray(bx),
                                            max_dis)), rtol=1e-12)


def test_integral_and_bce_loss_match_jax_in_f64():
    from dskd_tpu.core import losses as JL
    from dskd_tpu.core.integral import integral as jintegral

    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 4 * 17) * 3
    pred, target = rng.randn(50) * 2, rng.rand(50)
    w = (rng.rand(50) > 0.4).astype(np.float64)
    with jax.enable_x64(True):
        np.testing.assert_allclose(integral(_t(x), 16).numpy(),
                                   np.asarray(jintegral(jnp.asarray(x), 16)),
                                   rtol=1e-12)
        want = JL.bce_loss(jnp.asarray(pred), jnp.asarray(target),
                           weight=jnp.asarray(w), avg_factor=7.0)
    got = PL.bce_loss(_t(pred), _t(target), weight=_t(w), avg_factor=7.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("topk", [40, 300])
def test_filter_scores_and_topk_mlvl_matches_jax(topk):
    """Scores on a 0.05 grid (ties everywhere), three levels of which the
    last holds fewer than ``topk`` pairs."""
    from dskd_tpu.core.postprocess import filter_scores_and_topk_mlvl as jf

    rng = np.random.RandomState(2)
    sizes = (50, 20, 3)
    scores = np.round(rng.rand(2, sum(sizes), 6) * 20) / 20
    scores = scores.astype(np.float32)
    want = jax.vmap(lambda s: jf(s, 0.3, topk, sizes))(jnp.asarray(scores))
    got = filter_scores_and_topk_mlvl(_t(scores), 0.3, topk, sizes)
    _equal(got, want)
    assert got.scores.shape[-1] == sum(min(topk, n * 6) for n in sizes)


def _jax_vmapped(fn, *args):
    return jax.jit(jax.vmap(fn))(*(jnp.asarray(a) for a in args))


def test_max_iou_assign_ties_match_jax():
    """Anchors 0-3: IoU exactly 0.5 and 0.4 with GT 0, a duplicate pair;
    GTs 1 and 2 identical (the first wins each anchor), GTs 3 and 4 share
    their best anchor (the later wins); a padded GT on the same box.
    Both RetinaNet's thresholds and the defaults."""
    from dskd_tpu.core.max_iou_assigner import max_iou_assign as jassign

    rng = np.random.RandomState(3)
    anchors = np.concatenate([
        np.array([[0, 0, 10, 20], [0, 0, 10, 25], [40, 40, 60, 60],
                  [40, 40, 60, 60]], np.float32),
        (rng.rand(60, 2) * 80).repeat(2, 1) + np.array([0, 0, 12, 16])
    ]).astype(np.float32)
    gt = np.array([[[0, 0, 10, 10], [38, 38, 62, 62], [38, 38, 62, 62],
                    [100, 100, 130, 120], [102, 101, 131, 121],
                    [0, 0, 10, 10]]], np.float32).repeat(2, 0)
    gt[1, 3:5] = [[5, 60, 30, 90], [6, 61, 29, 88]]
    labels = np.arange(12, dtype=np.int32).reshape(2, 6) % 7
    valid = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 1]], bool)
    for kw in (dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
               dict()):
        want = _jax_vmapped(lambda b, l, v: jassign(
            jnp.asarray(anchors), b, l, v, 7, **kw), gt, labels, valid)
        got = max_iou_assign(_t(anchors), _t(gt), _t(labels), _t(valid), 7,
                             **kw)
        _equal(got, want)
    a = got.assigned_gt.numpy()
    assert (a == -2).any() and (a == -1).any()


def test_atss_assign_ties_match_jax():
    """GFL's anchors of two levels (8x8 at stride 8, 4x4 at 16); GT
    centres on grid midpoints, so that 4 or 2 anchor centres lie at one
    distance; two identical GTs; a padded GT."""
    from dskd_tpu.core.atss import atss_assign as jassign

    per_level = gfl_anchors(((8, 8), (4, 4)), "cpu", strides=(8, 16))
    counts = [a.shape[0] for a in per_level]
    anchors = torch.cat(per_level)
    gt = np.array([[[4, 4, 36, 36], [12, 0, 28, 40], [20, 8, 60, 50],
                    [20, 8, 60, 50], [0, 30, 64, 64]],
                   [[30, 30, 50, 50], [8, 8, 24, 24], [1, 1, 63, 63],
                    [16, 40, 48, 60], [44, 4, 60, 28]]], np.float32)
    labels = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 0]], np.int32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], bool)
    for topk, n_pos in ((9, 4), (3, 0)):
        want = _jax_vmapped(lambda b, l, v: jassign(
            jnp.asarray(anchors.numpy()), counts, b, l, v, 10, topk),
            gt, labels, valid)
        got = atss_assign(anchors, counts, _t(gt), _t(labels), _t(valid),
                          10, topk)
        _equal(got, want)
        assert got.pos_mask.sum() > n_pos


def test_fcos_targets_match_jax():
    """Two GTs of equal area overlapping (the first wins), a duplicate GT,
    GTs across the first two regress ranges, a padded GT."""
    from dskd_tpu.models.fcos import _fcos_targets as jtargets
    from dskd_tpu.models.fcos import fcos_points as jpoints

    sizes = ((12, 14), (6, 7), (3, 4), (2, 2), (1, 1))
    points, meta = fcos_points(sizes, "cpu")
    jp, jm = jpoints(sizes)
    np.testing.assert_array_equal(points.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(meta.numpy(), np.asarray(jm))
    gt = np.array([[[0, 0, 40, 30], [10, 10, 50, 40], [10, 10, 50, 40],
                    [2, 2, 100, 90], [60, 5, 110, 45], [0, 0, 8, 8]],
                   [[20, 20, 44, 44], [32, 32, 56, 56], [5, 50, 100, 95],
                    [70, 0, 90, 30], [0, 0, 110, 95], [1, 1, 9, 9]]],
                  np.float32)
    labels = np.arange(12, dtype=np.int32).reshape(2, 6)
    valid = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 1]], bool)
    want = _jax_vmapped(lambda b, l, v: jtargets(jp, jm, b, l, v, 12),
                        gt, labels, valid)
    got = _fcos_targets(points, meta, _t(gt), _t(labels), _t(valid), 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].sum() > 20


# --- the FPN ------------------------------------------------------------------

FPN_IN = ((8, 18, 22), (16, 9, 11), (24, 5, 6), (32, 3, 3))


@functools.lru_cache(maxsize=None)
def _jax_fpn(start_level, extra, relu):
    from dskd_tpu.models.fpn import FPN as JFPN

    rng = np.random.RandomState(4)
    feats = [rng.randn(2, h, w, c).astype(np.float32) for c, h, w in FPN_IN]
    model = JFPN(out_channels=32, num_outs=5, start_level=start_level,
                 add_extra_convs=extra, relu_before_extra_convs=relu)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), feats)
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.3).astype(
        np.float32), shapes)
    return feats, params, jax.jit(model.apply)(params, feats)


@pytest.mark.parametrize("start_level,extra,relu", [
    (1, "on_input", False), (1, "on_output", True), (0, "on_output", False),
    (1, "", False)])
def test_fpn_matches_jax(start_level, extra, relu):
    """Odd C3-C5 sizes (the 2x repeat is cropped), each extra-conv mode."""
    from dskd_tpu_torch.utils.weights import _fpn, _Writer

    feats, params, want = _jax_fpn(start_level, extra, relu)
    w = _Writer()
    _fpn(w, params["params"])
    fpn = FPN([c for c, _, _ in FPN_IN], "cpu", out_channels=32,
              start_level=start_level, add_extra_convs=extra,
              relu_before_extra_convs=relu)
    fpn.load_state_dict({k[len("neck."):]: v for k, v in w.out.items()},
                        strict=True)
    got = fpn([_t(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want) == 5
    for lvl, (g, x) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(x), rtol=1e-4, atol=1e-4,
                                   err_msg=str(lvl))


# --- what the port does not build ---------------------------------------------

@pytest.mark.parametrize("kw,name", [
    (dict(norm="gn"), "norm"), (dict(ws=True), "ws"),
    (dict(upsample="bilinear"), "upsample"),
    (dict(upsample="carafe"), "upsample")])
def test_fpn_options_not_ported_raise(kw, name):
    with pytest.raises(NotImplementedError, match=name):
        FPN([8, 16, 32], "cpu", **kw)


def test_unported_options_raise_with_their_names():
    from dskd_tpu_torch.models.backbones import build_backbone
    from dskd_tpu_torch.models.fcos import FCOS
    from dskd_tpu_torch.models.retinanet import RetinaNet

    for spec in ("resnext", "regnetx_3.2gf", "effb3", "hrnet_w18",
                 "swin_tiny"):
        if spec in ("resnext", "swin_tiny"):
            with pytest.raises(NotImplementedError, match=repr(spec)):
                build_backbone(spec, 50, "cpu")
            with pytest.raises(NotImplementedError, match=repr(spec)):
                RetinaNet("cpu", depth=18, backbone=spec)
            continue
        # ported: each builds, alone and under RetinaNet
        assert build_backbone(spec, 50, "meta")[0].out_channels
        RetinaNet("meta", depth=18, backbone=spec)
    with pytest.raises(ValueError, match="hrfpn"):
        RetinaNet("cpu", depth=18, neck="hrfpn")
    for spec in ("hrnet_w18", "swin_tiny"):
        if spec == "swin_tiny":
            # NAS-FCOS (ported) on a backbone that is not
            with pytest.raises(NotImplementedError, match=repr(spec)):
                FCOS("cpu", depth=18, backbone=spec, nas_fpn=True)
            continue
        # HRNet's branches go through HRFPN, with NAS-FCOS too (JAX's)
        assert type(FCOS("meta", backbone=spec, nas_fpn=True).neck
                    ).__name__ == "HRFPN"
    # one-stage archs the JAX package registers: SSD is not ported yet
    for arch in ("ssd", "yolov3", "centernet", "yolox"):
        if arch == "ssd":
            with pytest.raises(ValueError, match=repr(arch)):
                registry.get_family(arch)
            continue
        assert set(registry.get_family(arch)) >= {"build", "from_jax",
                                                  "losses", "eval_step"}
