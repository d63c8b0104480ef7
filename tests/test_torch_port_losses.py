"""The port's detection and distill losses against dskd_tpu.core.losses,
dskd_tpu.core.boxes and dskd_tpu.distill.losses, values and gradients, on
the same numpy inputs. f32 on the CPU: the two frameworks sum in other
orders, so values agree to 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.core import losses as TL
from dskd_tpu_torch.core.boxes import bbox_overlaps, bbox_xyxy_to_cxcywh

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _boxes(rng, *lead, scale=50.0):
    xy = rng.rand(*lead, 2) * scale
    wh = rng.rand(*lead, 2) * scale * 0.6 + 1.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["iou", "giou", "iof"])
@pytest.mark.parametrize("aligned", [False, True])
def test_bbox_overlaps_matches_jax(mode, aligned):
    from dskd_tpu.core.boxes import bbox_overlaps as jax_overlaps

    rng = np.random.RandomState(0)
    a = _boxes(rng, 2, 7)
    b = _boxes(rng, 2, 7 if aligned else 5)
    b[0, 0] = b[0, 0, [2, 3, 0, 1]]            # a degenerate (inverted) box
    want = jax_overlaps(jnp.asarray(a), jnp.asarray(b), mode=mode,
                        is_aligned=aligned)
    got = bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b), mode=mode,
                        is_aligned=aligned)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    from dskd_tpu.core.boxes import bbox_xyxy_to_cxcywh as jax_cxcywh
    np.testing.assert_allclose(
        bbox_xyxy_to_cxcywh(torch.from_numpy(a)).numpy(),
        np.asarray(jax_cxcywh(jnp.asarray(a))), **TOL)


def _loss_cases(rng):
    """name -> (pred, target, weight, avg_factor) numpy inputs."""
    N, K, nb = 24, 6, 17
    labels = rng.randint(0, K + 1, N).astype(np.int32)   # K = background
    score = rng.rand(N).astype(np.float32)
    return {
        "l1_loss": (rng.randn(N, 4), rng.randn(N, 4), rng.rand(N, 4), 7.0),
        "mse_loss": (rng.randn(N, 4), rng.randn(N, 4), None, None),
        "giou_loss": (_boxes(rng, N), _boxes(rng, N), rng.rand(N), 5.0),
        "quality_focal_loss": (rng.randn(N, K) * 2, (labels, score),
                               np.ones(N), 9.0),
        "distribution_focal_loss": (rng.rand(N, nb),
                                    rng.rand(N) * 0.5, rng.rand(N), 4.0),
    }


@pytest.mark.parametrize("name", ["l1_loss", "mse_loss", "giou_loss",
                                  "quality_focal_loss",
                                  "distribution_focal_loss"])
def test_loss_and_grad_match_jax(name):
    from dskd_tpu.core import losses as JL

    pred, target, weight, avg = _loss_cases(np.random.RandomState(1))[name]
    pred = np.asarray(pred, np.float32)
    is_pair = isinstance(target, tuple)
    kw = {} if avg is None else {"avg_factor": avg}

    def jtarget():
        return (tuple(jnp.asarray(t) for t in target) if is_pair
                else jnp.asarray(target, jnp.float32))

    def ttarget():
        return (tuple(torch.from_numpy(np.asarray(t)) for t in target)
                if is_pair else torch.from_numpy(np.asarray(target,
                                                            np.float32)))

    jw = None if weight is None else jnp.asarray(weight, jnp.float32)
    tw = None if weight is None else torch.from_numpy(
        np.asarray(weight, np.float32))
    want, want_g = jax.value_and_grad(lambda p: getattr(JL, name)(
        p, jtarget(), weight=jw, **kw))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = getattr(TL, name)(tp, ttarget(), weight=tw, **kw)
    (got_g,) = torch.autograd.grad(got, [tp])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-6)


def test_weight_reduce_loss_contract():
    from dskd_tpu.core.losses import weight_reduce_loss as jax_wrl

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    w = np.array([[1, 0, 1], [0.5, 1, 2]], np.float32)
    for kw in ({"reduction": "mean"}, {"reduction": "sum"},
               {"reduction": "none"}, {"avg_factor": 4.0},
               {"avg_factor": 4.0, "reduction": "none"}):
        want = jax_wrl(jnp.asarray(x), jnp.asarray(w), **kw)
        got = TL.weight_reduce_loss(torch.from_numpy(x), torch.from_numpy(w),
                                    **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="avg_factor"):
        TL.weight_reduce_loss(torch.from_numpy(x), avg_factor=2.0,
                              reduction="sum")
    bce_x = np.linspace(-30, 30, 13).astype(np.float32)
    from dskd_tpu.core.losses import binary_cross_entropy_with_logits as jb
    np.testing.assert_allclose(
        TL.binary_cross_entropy_with_logits(
            torch.from_numpy(bce_x), torch.full((13,), 0.3)).numpy(),
        np.asarray(jb(jnp.asarray(bce_x), 0.3)), **TOL)


# --- distill losses ---------------------------------------------------------

B, Q, C, K, KT = 2, 12, 16, 10, 6
LEVELS = [(8, 8), (4, 4)]


def _distill_inputs(seed):
    rng = np.random.RandomState(seed)
    img_hw = np.array([[64, 64], [56, 60]], np.int32)
    det_boxes = _boxes(rng, B, KT, scale=40.0)
    return dict(
        s_hs=rng.randn(B, Q, C).astype(np.float32),
        t_hs=rng.randn(B, Q, C).astype(np.float32),
        s_labels=rng.randint(0, K + 1, (B, Q)).astype(np.int32),
        det_boxes=det_boxes,
        det_labels=rng.randint(0, K, (B, KT)).astype(np.int32),
        det_keep=rng.randint(0, Q, (B, KT)).astype(np.int32),
        det_valid=rng.rand(B, KT) > 0.3,
        q_of_gt=rng.randint(0, Q, (B, KT)).astype(np.int32),
        s_neck=[rng.randn(B, h, w, C).astype(np.float32) for h, w in LEVELS],
        t_neck=[rng.randn(B, h, w, C).astype(np.float32) for h, w in LEVELS],
        img_hw=img_hw)


def _jax_structs(x, s_hs, s_neck):
    from dskd_tpu.distill.teacher import TeacherInfo
    from dskd_tpu.models.gfl_detr_head import DetResults, HeadOutputs

    det = DetResults(jnp.asarray(x["det_boxes"]), jnp.zeros((B, KT)),
                     jnp.asarray(x["det_labels"]), jnp.zeros((B, KT, K)),
                     jnp.asarray(x["det_keep"]), jnp.asarray(x["det_valid"]))
    t_hs = jnp.asarray(x["t_hs"])[None]
    teacher = TeacherInfo(tuple(jnp.asarray(f) for f in x["t_neck"]), None,
                          None, None, t_hs, det)
    student = HeadOutputs(None, None, None, s_hs[None], None)
    return student, s_neck, teacher, det


def _torch_structs(x, s_hs, s_neck):
    from dskd_tpu_torch.distill.teacher import TeacherInfo
    from dskd_tpu_torch.models.gfl_detr_head import DetResults, HeadOutputs

    t = torch.from_numpy
    det = DetResults(t(x["det_boxes"]), torch.zeros(B, KT),
                     t(x["det_labels"]), torch.zeros(B, KT, K),
                     t(x["det_keep"]), t(x["det_valid"]))
    teacher = TeacherInfo(tuple(t(f) for f in x["t_neck"]), None, None,
                          None, t(x["t_hs"])[None], det)
    student = HeadOutputs(None, None, None, s_hs[None], None)
    return student, s_neck, teacher, det


def test_corr_loss_and_grad_match_jax():
    from dskd_tpu.distill import losses as JD

    from dskd_tpu_torch.distill import losses as TD

    x = _distill_inputs(2)
    jcfg = JD.DistillConfig(num_prev=5)
    tcfg = TD.DistillConfig(num_prev=5)

    def jloss(s_hs):
        _, _, teacher, det = _jax_structs(x, s_hs, None)
        return JD.corr_loss(s_hs, jnp.asarray(x["s_labels"]),
                            teacher.hs[-1], det, Q, K, jcfg)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(x["s_hs"]))
    s_hs = torch.from_numpy(x["s_hs"]).requires_grad_(True)
    _, _, teacher, det = _torch_structs(x, s_hs, None)
    got = TD.corr_loss(s_hs, torch.from_numpy(x["s_labels"]),
                       teacher.hs[-1], det, Q, K, tcfg)
    (got_g,) = torch.autograd.grad(got, [s_hs])
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("mode", ["decode_v1", "decode_v2"])
def test_semantic_guided_fg_loss_and_grad_match_jax(mode):
    from dskd_tpu.distill import losses as JD

    from dskd_tpu_torch.distill import losses as TD

    x = _distill_inputs(3)

    def jloss(s_hs, s0, s1):
        student, neck, teacher, _ = _jax_structs(x, s_hs, (s0, s1))
        return JD.semantic_guided_fg_loss(
            student, neck, teacher, jnp.asarray(x["q_of_gt"]),
            jnp.asarray(x["img_hw"]), JD.DistillConfig(fg_mode=mode))

    args = [x["s_hs"]] + x["s_neck"]
    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    student, neck, teacher, _ = _torch_structs(x, targs[0], targs[1:])
    got = TD.semantic_guided_fg_loss(
        student, neck, teacher, torch.from_numpy(x["q_of_gt"]),
        torch.from_numpy(x["img_hw"]), TD.DistillConfig(fg_mode=mode))
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    # decode_v2's mask is the teacher's alone: no student gradient at all
    grads = (torch.autograd.grad(got, targs, allow_unused=True)
             if got.requires_grad else [None] * len(targs))
    for g, wnt in zip(grads, want_g):
        g = np.zeros_like(np.asarray(wnt)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(wnt), rtol=1e-4, atol=1e-7)


def test_query_of_merged_gt_and_unported_branches_raise():
    from dskd_tpu.distill.losses import query_of_merged_gt as jq

    from dskd_tpu_torch.distill import losses as TD

    a = np.array([[-1, 3, 0, -1, 5], [2, -1, -1, 1, 0]], np.int32)
    np.testing.assert_array_equal(
        TD.query_of_merged_gt(torch.from_numpy(a), 6, 5).numpy(),
        np.asarray(jq(jnp.asarray(a), 6, 5)))
    cfg = TD.DistillConfig.from_flags(cates_distill="hard + soft",
                                      feats_distill="corr")
    assert cfg.soft and cfg.hard and cfg.corr and cfg.fg_mode == ""
    # every branch of the menu is ported (test_torch_port_distill_menu.py
    # holds each against JAX); an fg mode outside the menu raises
    from dskd_tpu_torch.distill.teacher import TeacherInfo
    from dskd_tpu_torch.models.gfl_detr_head import DetResults, HeadOutputs
    from dskd_tpu_torch.models.gfl_detr_loss import LayerTargets

    idx = torch.zeros(B, KT, dtype=torch.int64)
    det = DetResults(torch.zeros(B, KT, 4), torch.zeros(B, KT), idx, None,
                     idx, torch.ones(B, KT, dtype=torch.bool))
    student = HeadOutputs(torch.zeros(1, B, Q, K), None, None, None, None)
    targets = LayerTargets(None, None, None,
                           torch.full((1, B, Q), -1, dtype=torch.int64))
    with pytest.raises(ValueError, match="fg mode"):
        TD.distill_losses(student, None, TeacherInfo(*[None] * 5, det),
                          targets, None, K, cfg._replace(
                              soft=False, corr=False, fg_mode="bg_only"),
                          KT)
