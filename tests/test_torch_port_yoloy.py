"""The YOLOY-IL family on the port against dskd_tpu.models.yoloy on the CPU.

The tiny YOLOY of tests/test_yoloy.py: ResNet-18 (C3-C5), the PAFPN and
head at 64 channels, 8 classes, a 64x64 canvas (84 priors over strides 8,
16 and 32) and B=2, one image of 48x60 valid pixels; weights are a JAX
init carried to the port by the registry's ``from_jax``. The two-task run
builds through the registry, at the config's 128 neck channels.

- ``yoloy_priors`` and ``yoloy_decode``; ``sim_ota_assign`` (every output
  equal, on GT whose top-10 IoU sums lie away from integers);
- the forward in eval and train mode (``FWD_TOL``) and every BatchNorm
  running buffer after the train-mode forward (1e-5);
- ``yoloy_detection_loss`` with DIoU, and with square IoU and the L1
  branch, and ``yoloy_compute_losses`` with a teacher ("hard + soft",
  "kldv"), in f64 (1e-6 relative);
- ``yoloy_get_bboxes`` against JAX's tiled and scan NMS paths;
- one family step (losses, gradients, running buffers against JAX's
  ``new_batch_stats``), the seeded init's scales, and a two-task
  ``run_incremental`` against JAX's ``train_one_task`` row by row.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch import registry
from dskd_tpu_torch.core.sim_ota import sim_ota_assign
from dskd_tpu_torch.models import yoloy as PY
from dskd_tpu_torch.models.yoloy_head import (YOLOYHeadOutputs,
                                              YOLOYLossConfig,
                                              yoloy_decode,
                                              yoloy_detection_loss,
                                              yoloy_get_bboxes, yoloy_priors)
from dskd_tpu_torch.utils import config as pconfig

from test_torch_port_yolof import (FWD_TOL, HW, IMG_HW, _np, _f64,
                                   assert_buffers_match, batch_arrays,
                                   check_family_step, jax_batch,
                                   run_two_tasks_against_jax, torch_batch)

torch.set_num_threads(1)

TINY = dict(num_classes=8, depth=18)
NECK = 64


def jax_model(neck=NECK):
    from dskd_tpu.models.yoloy import YOLOY
    return YOLOY(neck_channels=neck, **TINY)


@functools.lru_cache(maxsize=None)
def jax_apply(train):
    model = jax_model()
    if train:
        return jax.jit(lambda v, x, hw: model.apply(
            v, x, hw, deterministic=False, mutable=["batch_stats"]))
    return jax.jit(model.apply)


@functools.lru_cache(maxsize=None)
def _jax_init(seed, neck=NECK):
    return jax.tree.map(np.asarray, jax.jit(jax_model(neck).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3)),
        jnp.asarray(IMG_HW[:1])))


def jax_variables(seed, teacher=False, neck=NECK):
    """A JAX init of the tiny YOLOY. ``teacher`` widens the class kernels
    300-fold (the init's logits spread by ~0.01) and sets the class and
    objectness biases to -4 and 1, so that about 20 of an image's 672
    (prior, class) pairs survive NMS above the teacher threshold 0.3."""
    v = jax.tree.map(np.copy, _jax_init(seed, neck))
    if teacher:
        head = v["params"]["bbox_head"]
        for lvl in range(3):
            cls, obj = head[f"conv_cls{lvl}"], head[f"conv_obj{lvl}"]
            cls["kernel"] = cls["kernel"] * 300.0
            cls["bias"] = cls["bias"] * 0 - 4.0
            obj["bias"] = obj["bias"] * 0 + 1.0
    return v


def port_model(variables, neck=NECK):
    model = PY.YOLOY("cpu", neck_channels=neck, **TINY)
    model.load_state_dict(registry.get_family("yoloy")["from_jax"](
        variables), strict=True)
    return model


def _tiny_cfg(mod, **train):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(arch="yoloy", **TINY),
        train=mod.TrainConfig(**train),
        distill=mod.DistillFlags(cates_distill="hard + soft",
                                 locat_distill="", feats_distill="kldv",
                                 teacher_score_thr=0.3,
                                 teacher_max_per_img=30))


def test_priors_and_decode_match_jax():
    from dskd_tpu.models import yoloy_head as JH

    sizes = [(8, 6), (4, 3), (2, 2)]
    priors = yoloy_priors(sizes, "cpu")
    np.testing.assert_array_equal(priors.numpy(),
                                  np.asarray(JH.yoloy_priors(sizes)))
    preds = (np.random.RandomState(0).randn(2, priors.shape[0], 4)
             ).astype(np.float32)
    np.testing.assert_allclose(
        yoloy_decode(priors[None], torch.from_numpy(preds)).numpy(),
        np.asarray(JH.yoloy_decode(jnp.asarray(priors.numpy())[None],
                                   jnp.asarray(preds))), rtol=1e-6, atol=1e-5)


def test_sim_ota_assign_matches_jax():
    """Three images of 84 priors and 6 GT slots with padding, near-priors
    decoded boxes: every output of JAX's per-image assigner."""
    from dskd_tpu.core.sim_ota import sim_ota_assign as jassign

    rng = np.random.RandomState(3)
    p = yoloy_priors([(8, 8), (4, 4), (2, 2)], "cpu").numpy()
    priors = np.concatenate([p[:, :2] + p[:, 2:] / 2, p[:, 2:]], -1)
    nb, N, G, C = 3, p.shape[0], 6, 8
    centre = (priors[None, :, :2]
              + rng.randn(nb, N, 2) * priors[None, :, 2:] / 4)
    size = priors[None, :, 2:] * np.exp(rng.randn(nb, N, 2) * 0.4) * 1.5
    decoded = np.concatenate([centre - size / 2, centre + size / 2],
                             -1).astype(np.float32)
    scores = rng.rand(nb, N, C).astype(np.float32) * 0.9
    xy = rng.rand(nb, G, 2) * 44
    wh = rng.rand(nb, G, 2) * 24 + 6
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, C, (nb, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array([[3], [6], [5]])
    arrays = (scores, decoded, gt, labels, valid)
    want = jax.jit(jax.vmap(lambda s, d, b, lb, v: jassign(
        s, jnp.asarray(priors), d, b, lb, v, C)))(
        *(jnp.asarray(a) for a in arrays))
    t = [torch.from_numpy(a) for a in arrays]
    got = sim_ota_assign(t[0], torch.from_numpy(priors), *t[1:], C)
    for name in want._fields:
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.num_pos > 3).all()
    # dynamic_k truncates a sum: none of these lies near an integer
    from dskd_tpu.core.boxes import bbox_overlaps as jiou
    ious = np.asarray(jax.vmap(jiou)(jnp.asarray(decoded), jnp.asarray(gt)))
    sums = -np.sort(-ious, axis=1)[:, :10].sum(1)
    frac = np.abs(sums - np.round(sums))[valid]
    assert frac.min() > 1e-3, frac.min()


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(train):
    v = jax_variables(0)
    images = batch_arrays()[0]
    out = jax_apply(train)(v, jnp.asarray(images), jnp.asarray(IMG_HW))
    want, mutated = out if train else (out, None)
    model = port_model(v).train(train)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = model(torch.from_numpy(images), torch.from_numpy(IMG_HW))
    for field in YOLOYHeadOutputs._fields:
        for lvl, (g, w) in enumerate(zip(getattr(got.head, field),
                                         getattr(want.head, field))):
            np.testing.assert_allclose(_np(g), np.asarray(w),
                                       err_msg=f"{field} {lvl}", **FWD_TOL)
    for lvl, (g, w) in enumerate(zip(got.neck_feats, want.neck_feats)):
        np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)), np.asarray(w),
                                   err_msg=f"neck {lvl}", **FWD_TOL)
    if train:
        assert_buffers_match(model, "yoloy", {
            "params": v["params"], "batch_stats": mutated["batch_stats"]},
            moved_from=before)
    else:
        for k, t in model.state_dict().items():
            assert torch.equal(t, before[k]), k


def _outputs_f64(seed=2):
    images = jnp.asarray(batch_arrays(seed=seed, num_classes=8)[0])
    return [_f64((tuple(o.head), tuple(o.neck_feats))) for o in (
        jax_apply(False)(v, images, jnp.asarray(IMG_HW)) for v in (
            jax_variables(0), jax_variables(1, teacher=True)))]


def _port_out(o):
    head, neck = o
    return PY.YOLOYOutputs(
        YOLOYHeadOutputs(*(tuple(torch.from_numpy(a) for a in ts)
                           for ts in head)),
        tuple(torch.from_numpy(a).permute(0, 3, 1, 2) for a in neck))


@pytest.mark.parametrize("with_teacher,det_kw", [
    (False, {}),
    (False, dict(use_l1=True, bbox_loss="square_iou")),
    (True, {})])
def test_losses_match_jax_in_f64(with_teacher, det_kw):
    """The detection loss (DIoU; square IoU with the L1 branch) alone, and
    ``yoloy_compute_losses`` with "hard + soft" + "kldv", on the JAX
    model's outputs, in f64 in both packages."""
    from dskd_tpu.models import yoloy as JY
    from dskd_tpu.models.yoloy_head import YOLOYHeadOutputs as JHead

    s_out, t_out = _outputs_f64()
    arrays = list(batch_arrays(seed=2, num_classes=8))
    arrays[2] = arrays[2].astype(np.float64)
    dcfg = dict(cates_distill="hard + soft", feats_distill="kldv")
    thr = dict(teacher_score_thr=0.3, teacher_max_per_img=30)

    def jout(o):
        head, neck = o
        return JY.YOLOYOutputs(JHead(*head), tuple(neck))

    with jax.enable_x64(True):
        jdet = JY.YOLOYLossConfig(num_classes=8, **det_kw)

        def losses(s, t, b):
            if not with_teacher:
                return JY.yoloy_detection_loss(jout(s).head, b.gt_bboxes,
                                               b.gt_labels, b.gt_valid, jdet)
            return JY.yoloy_compute_losses(
                jout(s), b, jdet, teacher_out=jout(t),
                distill_cfg=JY.YOLOYDistillConfig.from_flags(**dcfg), **thr)
        want = jax.jit(losses)(s_out, t_out, jax_batch(arrays))
        want = {k: float(v) for k, v in want.items()}
    det = YOLOYLossConfig(num_classes=8, **det_kw)
    b = torch_batch(arrays)
    if with_teacher:
        t = _port_out(t_out)
        got = PY.yoloy_compute_losses(
            _port_out(s_out), b, det, teacher_out=t,
            distill_cfg=PY.YOLOYDistillConfig.from_flags(**dcfg), **thr)
        kept = yoloy_get_bboxes(t.head, b.img_hw, score_thr=0.3,
                                max_per_img=30).valid
        assert 0 < int(kept.sum()) < kept.numel()
        assert {"loss_kd", "loss_fd"} <= set(got)
    else:
        got = yoloy_detection_loss(_port_out(s_out).head, b.gt_bboxes,
                                   b.gt_labels, b.gt_valid, det)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-6, atol=0,
                                   err_msg=k)


# JAX's tiled NMS, then its scan
@pytest.mark.parametrize("nms_pre", [2000, 100])
def test_get_bboxes_matches_jax(nms_pre):
    from dskd_tpu.models.yoloy_head import YOLOYHeadOutputs as JHead
    from dskd_tpu.models.yoloy_head import yoloy_get_bboxes as jget

    images = jnp.asarray(batch_arrays(seed=3)[0])
    out = jax_apply(False)(jax_variables(1, teacher=True), images,
                           jnp.asarray(IMG_HW))
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [2.0, 1.5, 2.0, 1.5]], np.float32)
    kw = dict(score_thr=0.3, max_per_img=30, nms_pre=nms_pre, rescale=True)
    want = jax.jit(lambda head, img_hw, sf: jget(
        JHead(*head), img_hw, scale_factor=sf, **kw))(
        tuple(out.head), jnp.asarray(IMG_HW), jnp.asarray(sf))
    got = yoloy_get_bboxes(
        YOLOYHeadOutputs(*(tuple(torch.from_numpy(np.array(a)) for a in ts)
                           for ts in out.head)),
        torch.from_numpy(IMG_HW), scale_factor=torch.from_numpy(sf), **kw)
    assert set(got._fields) == set(want)
    for k in ("labels", "valid", "keep_qid"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want["scores"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want["bboxes"]),
                               rtol=1e-5, atol=1e-5)
    assert 0 < int(got.valid.sum()) < got.valid.numel()


GRAD_NAMES = ("neck.reduce_layers.0.conv.weight",
              "neck.bottom_up_blocks.1.final_conv.conv.weight",
              "bbox_head.multi_level_conv_cls.0.weight",
              "bbox_head.multi_level_reg_convs.2.1.bn.weight")


def test_family_step_matches_jax():
    check_family_step("yoloy", jax_model, port_model, _tiny_cfg,
                      jax_variables(0), jax_variables(1, teacher=True),
                      batch_arrays(seed=4, num_classes=8), GRAD_NAMES,
                      ("loss_cls", "loss_bbox", "loss_obj", "loss_kd",
                       "loss_fd"))


def test_init_weights_scales_and_seed():
    spec = registry.get_family("yoloy")
    mcfg = pconfig.ModelConfig(arch="yoloy", **TINY)
    a, b = (spec["build"](mcfg, "cpu") for _ in range(2))
    spec["init_weights"](a, 3)
    spec["init_weights"](b, 3)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    sd = a.state_dict()
    w = sd["neck.top_down_blocks.0.main_conv.conv.weight"]    # 1x1, 512 in
    assert abs(float(w.std()) * 512 ** 0.5 - 1) < 0.05
    for lvl in range(3):
        for k in ("cls", "obj"):
            assert torch.equal(
                sd[f"bbox_head.multi_level_conv_{k}.{lvl}.bias"],
                torch.full_like(sd[f"bbox_head.multi_level_conv_{k}.{lvl}"
                                   ".bias"], -4.595))
        assert not sd[f"bbox_head.multi_level_conv_reg.{lvl}.bias"].any()
    assert torch.equal(sd["neck.out_convs.2.bn.running_mean"],
                       torch.zeros(128))


def test_two_task_run_matches_jax_train_one_task(tmp_path):
    run_two_tasks_against_jax(str(tmp_path), _tiny_cfg,
                              jax_variables(5, neck=128), check_buffers=True)
