"""The YOLOF-IL family on the port against dskd_tpu.models.yolof on the CPU.

The tiny YOLOF of tests/test_yolof.py: ResNet-18 (C5 of 512 channels), the
full DilatedEncoder and head, 10 classes, a 64x64 canvas (a 2x2 map, 20
anchors) and B=2, one image of 48x60 valid pixels; weights are a JAX init
carried to the port by the registry's ``from_jax``.

- ``base_anchors``, ``grid_anchors``, ``delta2bbox`` (with and without the
  centre clamp) and ``bbox2delta``; ``uniform_assign`` (every output
  exactly); a caffe-style bottleneck ResNet forward (1e-4);
- the forward in eval and train mode (``FWD_TOL``), and after the
  train-mode forward every BatchNorm running buffer against JAX's mutated
  ``batch_stats`` (1e-5);
- ``yolof_compute_losses`` without and with a teacher ("hard + soft",
  "bbox", "kldv") in f64 (1e-6 relative); the closed-form ``loss_kd``
  against the literal (N, N) product (1e-6, gradients too);
- ``yolof_get_bboxes`` against JAX's tiled and scan NMS paths (boxes 1e-5,
  labels, valid and ``keep_qid`` exactly);
- one family step's losses, four named gradients (1e-3 relative L2) and
  the running buffers after it against JAX's ``new_batch_stats`` (1e-5);
- the seeded init's scales; a two-task ``run_incremental`` against JAX's
  ``train_one_task`` row by row.
"""
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch import registry
from dskd_tpu_torch.core import anchors as PA
from dskd_tpu_torch.core import losses as PL
from dskd_tpu_torch.core.uniform_assigner import uniform_assign
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.models import yolof as PY
from dskd_tpu_torch.models.yolof_head import (YOLOFHeadOutputs,
                                              YOLOFLossConfig, yolof_anchors,
                                              yolof_get_bboxes)
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState, frozen_copy
from dskd_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

TINY = dict(num_classes=10, depth=18)
B, HW = 2, 64
IMG_HW = np.array([[64, 64], [48, 60]], np.int32)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
BN_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def batch_arrays(seed=0, G=6, n_valid=(3, 4), num_classes=10):
    """numpy (images, img_hw, gt_bboxes, gt_labels, gt_valid)."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(B, HW, HW, 3) * 0.5).astype(np.float32)
    xy = rng.rand(B, G, 2) * 30
    wh = rng.rand(B, G, 2) * 25 + 8
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, num_classes, (B, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array(n_valid)[:, None]
    return images, IMG_HW, gt, labels, valid


def jax_batch(arrays):
    from dskd_tpu.data.batch import Batch as JBatch
    return JBatch(*(jnp.asarray(a) for a in arrays))


def torch_batch(arrays):
    return Batch(*(torch.from_numpy(np.asarray(a)) for a in arrays))


def running_buffers(state_dict):
    return {k: v for k, v in state_dict.items()
            if k.endswith(("running_mean", "running_var"))}


def assert_buffers_match(model, arch, variables, moved_from=None):
    """Every BatchNorm buffer of ``model`` against JAX's ``variables``
    (BN_TOL); with ``moved_from`` (a state_dict), the trainable ones must
    have moved from it and the backbone's must not."""
    want = running_buffers(registry.get_family(arch)["from_jax"](variables))
    got = running_buffers(model.state_dict())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                   **BN_TOL)
    if moved_from is not None:
        for k, v in got.items():
            moved = not torch.equal(v, moved_from[k])
            assert moved != k.startswith("backbone."), k


# --- the tiny YOLOF -------------------------------------------------------

def jax_model():
    from dskd_tpu.models.yolof import YOLOF
    return YOLOF(**TINY)


@functools.lru_cache(maxsize=None)
def jax_apply(train):
    model = jax_model()
    if train:
        return jax.jit(lambda v, x, hw: model.apply(
            v, x, hw, deterministic=False, mutable=["batch_stats"]))
    return jax.jit(model.apply)


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    return jax.tree.map(np.asarray, jax.jit(jax_model().init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3)),
        jnp.asarray(IMG_HW[:1])))


def jax_variables(seed, teacher=False):
    """A JAX init of the tiny YOLOF. ``teacher`` widens the class kernels
    and sets the class bias to -1, so that about 20 of an image's 200
    (anchor, class) pairs survive NMS above the teacher threshold 0.3, with
    a top-k order the two frameworks share."""
    v = jax.tree.map(np.copy, _jax_init(seed))
    if teacher:
        head = v["params"]["bbox_head"]
        head["cls_score"]["kernel"] = head["cls_score"]["kernel"] * 100.0
        head["cls_score"]["bias"] = head["cls_score"]["bias"] * 0 - 1.0
    return v


def port_model(variables):
    model = PY.YOLOF("cpu", **TINY)
    model.load_state_dict(registry.get_family("yolof")["from_jax"](
        variables), strict=True)
    return model


def _tiny_cfg(mod, **train):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(arch="yolof", **TINY),
        train=mod.TrainConfig(**train),
        distill=mod.DistillFlags(cates_distill="hard + soft",
                                 locat_distill="bbox", feats_distill="kldv",
                                 teacher_score_thr=0.3,
                                 teacher_max_per_img=30))


# --- anchors, coder, assigner, backbone -------------------------------------

def test_anchors_and_delta_coder_match_jax():
    from dskd_tpu.core import anchors as JA
    from dskd_tpu.models.yolof_head import yolof_anchors as janchors

    base = PA.base_anchors(32, (1, 2, 4, 8, 16), (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(base, JA.base_anchors(
        32, (1, 2, 4, 8, 16), (0.5, 1.0, 2.0)))
    np.testing.assert_array_equal(
        PA.grid_anchors((3, 4), 32, base, "cpu").numpy(),
        np.asarray(JA.grid_anchors((3, 4), 32, base)))
    np.testing.assert_array_equal(yolof_anchors((3, 4), "cpu").numpy(),
                                  np.asarray(janchors((3, 4))))
    rng = np.random.RandomState(0)
    anchors = rng.rand(60, 4).astype(np.float32) * 100
    anchors[:, 2:] += anchors[:, :2] + 10
    deltas = (rng.randn(60, 4) * 2).astype(np.float32)
    deltas[:5] *= 20                 # past both clamps
    for kw in (dict(), dict(add_ctr_clamp=True, ctr_clamp=32.0)):
        np.testing.assert_allclose(
            PA.delta2bbox(torch.from_numpy(anchors), torch.from_numpy(deltas),
                          **kw).numpy(),
            np.asarray(JA.delta2bbox(jnp.asarray(anchors),
                                     jnp.asarray(deltas), **kw)),
            rtol=1e-6, atol=1e-4, err_msg=str(kw))
    gt = anchors + rng.randn(60, 4).astype(np.float32) * 3
    np.testing.assert_allclose(
        PA.bbox2delta(torch.from_numpy(anchors), torch.from_numpy(gt)).numpy(),
        np.asarray(JA.bbox2delta(jnp.asarray(anchors), jnp.asarray(gt))),
        rtol=1e-5, atol=1e-6)


def test_uniform_assign_matches_jax():
    """Three images, 80 anchors, 5 GT slots with padding: every output
    equal, ignored candidates and neg-ignored anchors included."""
    from dskd_tpu.core.uniform_assigner import uniform_assign as jassign

    rng = np.random.RandomState(1)
    anchors = yolof_anchors((4, 4), "cpu").numpy() * 0.25 + 40
    nb, G = 3, 5
    preds = anchors[None] + rng.randn(nb, 80, 4).astype(np.float32) * 6
    xy = rng.rand(nb, G, 2) * 60 + 10
    wh = rng.rand(nb, G, 2) * 40 + 6
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, 10, (nb, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array([[2], [5], [4]])
    want = jax.jit(jax.vmap(lambda p, b, lb, v: jassign(
        p, jnp.asarray(anchors), b, lb, v, 10)))(
        *(jnp.asarray(a) for a in (preds, gt, labels, valid)))
    got = uniform_assign(torch.from_numpy(preds), torch.from_numpy(anchors),
                         torch.from_numpy(gt), torch.from_numpy(labels),
                         torch.from_numpy(valid), 10)
    for name in want._fields:
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    w = got.label_weights.numpy()
    assert (got.num_pos > 0).all() and (w == 0).any()
    assert (~got.cand_pos_mask & torch.from_numpy(valid).gather(
        1, got.cand_gt_idx)).any()          # a pos-ignored candidate


def test_caffe_style_resnet_matches_jax():
    """A bottleneck ResNet-50 (16 base channels) in caffe style against
    JAX's: the stride sits on conv1, and the pytorch style differs."""
    from dskd_tpu.models.resnet import ResNet as JResNet
    from dskd_tpu_torch.models.resnet import ResNet
    from dskd_tpu_torch.utils.weights import _Writer

    jmodel = JResNet(depth=50, base_channels=16, style="caffe")
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    v = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                                      x))
    want = jax.jit(jmodel.apply)(v, jnp.asarray(x))
    w = _Writer()
    w.backbone(v["params"], v["batch_stats"])
    sd = {k[len("backbone."):]: t for k, t in w.out.items()}
    outs = {}
    for style in ("caffe", "pytorch"):
        model = ResNet(50, "cpu", base_channels=16, style=style)
        model.load_state_dict(sd, strict=True)
        outs[style] = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, wt in zip(outs["caffe"], want):
        np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)),
                                   np.asarray(wt), **FWD_TOL)
    assert not torch.allclose(outs["caffe"][-1], outs["pytorch"][-1])
    assert ResNet(50, "cpu").layer2[0].conv2.stride == (2, 2)
    assert ResNet(50, "cpu", style="caffe").layer2[0].conv1.stride == (2, 2)


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(train):
    """Head outputs and the neck map (FWD_TOL); in train mode the batch
    statistics normalise and every trainable running buffer moves as JAX's
    mutated batch_stats (BN_TOL), the backbone's stays."""
    v = jax_variables(0)
    images = batch_arrays()[0]
    out = jax_apply(train)(v, jnp.asarray(images), jnp.asarray(IMG_HW))
    want, mutated = out if train else (out, None)
    model = port_model(v).train(train)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = model(torch.from_numpy(images), torch.from_numpy(IMG_HW))
    for name, g, w in (
            ("cls_scores", got.head.cls_scores, want.head.cls_scores),
            ("bbox_preds", got.head.bbox_preds, want.head.bbox_preds),
            ("neck_feat", got.neck_feat.permute(0, 2, 3, 1),
             want.neck_feat)):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name,
                                   **FWD_TOL)
    assert got.head.feat_hw == _hw(want.head.feat_hw)
    if train:
        assert_buffers_match(model, "yolof", {
            "params": v["params"], "batch_stats": mutated["batch_stats"]},
            moved_from=before)
    else:
        for k, t in model.state_dict().items():
            assert torch.equal(t, before[k]), k


def _hw(feat_hw):
    """JAX's jitted feat_hw (traced ints) as Python ints."""
    return tuple(int(x) for x in feat_hw)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a), tree)


def _outputs_f64():
    """The JAX model's student (seed 0) and teacher (seed 1) outputs on
    batch 2, in f64."""
    images = jnp.asarray(batch_arrays(seed=2)[0])
    s = jax_apply(False)(jax_variables(0), images, jnp.asarray(IMG_HW))
    t = jax_apply(False)(jax_variables(1, teacher=True), images,
                         jnp.asarray(IMG_HW))
    return [(_f64(tuple(o.head[:2])), _hw(o.head.feat_hw),
             _f64(o.neck_feat)) for o in (s, t)]


def _port_out(o):
    (cls, box), hw, neck = o
    return PY.YOLOFOutputs(
        YOLOFHeadOutputs(torch.from_numpy(cls), torch.from_numpy(box), hw),
        torch.from_numpy(neck).permute(0, 3, 1, 2))


@pytest.mark.parametrize("with_teacher", [False, True])
def test_compute_losses_matches_jax_in_f64(with_teacher):
    """Detection losses alone, then with the config's distills (hard +
    soft, bbox, kldv) on the JAX model's outputs, in f64 in both
    packages."""
    from dskd_tpu.models import yolof as JY
    from dskd_tpu.models.yolof_head import YOLOFHeadOutputs as JHead
    from dskd_tpu.models.yolof_head import yolof_anchors as janchors

    s_out, t_out = _outputs_f64()
    arrays = list(batch_arrays(seed=2))
    arrays[2] = arrays[2].astype(np.float64)
    flags = dict(cates_distill="hard + soft", locat_distill="bbox",
                 feats_distill="kldv")
    thr = dict(teacher_score_thr=0.3, teacher_max_per_img=30)

    def jout(o):
        (cls, box), _, neck = o
        return JY.YOLOFOutputs(JHead(cls, box, s_out[1]), neck)

    dcfg = JY.YOLOFDistillConfig.from_flags(**flags)
    with jax.enable_x64(True):
        def losses(s, t, b):
            kw = dict(teacher_out=jout(t), distill_cfg=dcfg,
                      **thr) if with_teacher else {}
            return JY.yolof_compute_losses(
                jout(s), janchors(s_out[1]), b,
                JY.YOLOFLossConfig(num_classes=10), **kw)
        want = jax.jit(losses)(s_out, t_out, jax_batch(arrays))
        want = {k: float(v) for k, v in want.items()}
    kw = dict(teacher_out=_port_out(t_out), distill_cfg=PY.YOLOFDistillConfig
              .from_flags(**flags), **thr) if with_teacher else {}
    got = PY.yolof_compute_losses(
        _port_out(s_out), yolof_anchors(s_out[1], "cpu"),
        torch_batch(arrays), YOLOFLossConfig(num_classes=10), **kw)
    assert sorted(got) == sorted(want)
    if with_teacher:
        assert {"loss_kd", "loss_ld_bbox", "loss_fd"} <= set(got)
        kept = yolof_get_bboxes(_port_out(t_out).head,
                                yolof_anchors(s_out[1], "cpu"),
                                torch.from_numpy(IMG_HW), score_thr=0.3,
                                max_per_img=30).valid
        assert 0 < int(kept.sum()) < kept.numel()
    for k, v in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-6, atol=0,
                                   err_msg=k)


def test_loss_kd_closed_form_equals_literal_product():
    """``kd_kl_div_loss_outer`` against ``kd_kl_div_loss`` with the (N, 1)
    weight, which builds the (N, N) product, in f64 (values and gradients
    1e-10 relative), and against JAX's literal product in f32 (1e-6)."""
    from dskd_tpu.core.losses import kd_kl_div_loss as jkd

    rng = np.random.RandomState(4)
    N, C = 60, 7
    pred, soft = (rng.randn(2, N, C) * 2).astype(np.float32)
    w = np.zeros(N, np.float32)
    w[rng.choice(N, 9, replace=False)] = 1.0
    avg = float(w.sum())

    def port(fn, dtype, **kw):
        p = torch.from_numpy(pred).to(dtype).requires_grad_()
        loss = fn(p, torch.from_numpy(soft).to(dtype), avg_factor=avg, T=2.0,
                  **kw)
        loss.backward()
        return loss.detach(), p.grad

    weight = torch.from_numpy(w).double()
    literal = port(PL.kd_kl_div_loss, torch.float64, weight=weight[:, None])
    closed = port(PL.kd_kl_div_loss_outer, torch.float64, weight=weight)
    for a, b in zip(closed, literal):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-14)
    want = jkd(jnp.asarray(pred), jnp.asarray(soft),
               weight=jnp.asarray(w)[:, None], avg_factor=avg, T=2.0)
    got = port(PL.kd_kl_div_loss_outer, torch.float32,
               weight=torch.from_numpy(w))[0]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# JAX's tiled NMS, then its scan
@pytest.mark.parametrize("nms_pre", [1000, 50])
def test_get_bboxes_matches_jax(nms_pre):
    from dskd_tpu.models.yolof_head import YOLOFHeadOutputs as JHead
    from dskd_tpu.models.yolof_head import yolof_anchors as janchors
    from dskd_tpu.models.yolof_head import yolof_get_bboxes as jget

    images = jnp.asarray(batch_arrays(seed=3)[0])
    out = jax_apply(False)(jax_variables(1, teacher=True), images,
                           jnp.asarray(IMG_HW))
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [2.0, 1.5, 2.0, 1.5]], np.float32)
    kw = dict(score_thr=0.3, max_per_img=30, nms_pre=nms_pre, rescale=True)
    hw = _hw(out.head.feat_hw)
    want = jax.jit(lambda cls, box, img_hw, sf: jget(
        JHead(cls, box, hw), janchors(hw), img_hw, scale_factor=sf, **kw))(
        out.head.cls_scores, out.head.bbox_preds, jnp.asarray(IMG_HW),
        jnp.asarray(sf))
    got = yolof_get_bboxes(
        YOLOFHeadOutputs(torch.from_numpy(np.array(out.head.cls_scores)),
                         torch.from_numpy(np.array(out.head.bbox_preds)),
                         hw),
        yolof_anchors(hw, "cpu"),
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


GRAD_NAMES = ("neck.lateral_conv.weight",
              "neck.dilated_encoder_blocks.1.conv2.conv.weight",
              "bbox_head.cls_score.weight",
              "bbox_head.bbox_subnet.3.bn.weight")


def check_family_step(arch, jax_model_, port_model_, cfg_fn, v, tv, arrays,
                      grad_names, keys):
    """One generic step of ``arch`` with a teacher against JAX's losses_fn:
    its losses (1e-3 relative), the gradients it clips of ``grad_names``
    (1e-3 relative L2) and every running buffer after it against JAX's
    ``new_batch_stats`` (BN_TOL); the teacher's buffers stay."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu.train.step import parse_losses as jparse
    from dskd_tpu.utils import config as jconfig

    losses_fn = jget(arch)["losses"](jax_model_(), cfg_fn(jconfig),
                                     has_teacher=True, use_dropout=False)
    jb = jax_batch(arrays)

    def total(params):
        losses, new_bs = losses_fn({"params": params,
                                    "batch_stats": v["batch_stats"]}, jb, tv,
                                   jax.random.PRNGKey(0))
        return jparse(losses), (losses, new_bs)

    (_, (want, new_bs)), jgrads = jax.jit(jax.value_and_grad(
        total, has_aux=True))(v["params"])
    jgrads = registry.get_family(arch)["from_jax"](
        {"params": jgrads, "batch_stats": v["batch_stats"]})

    model = port_model_(v)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    seen = {}
    clip = state.optimizer.clip

    def recording_clip():
        seen.update({n: p.grad.clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None})
        return clip()

    state.optimizer.clip = recording_clip
    teacher = frozen_copy(port_model_(tv))
    t_before = {k: t.clone() for k, t in teacher.state_dict().items()}
    before = {k: t.clone() for k, t in model.state_dict().items()}
    step = make_family_train_step(arch, model, cfg_fn(pconfig), num_prev=5,
                                  has_teacher=True, use_dropout=False)
    state, got = step(state, torch_batch(arrays), teacher)
    assert state.step == 1
    assert set(got) == set(want) | {"loss"}
    assert set(keys) <= set(got)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    for n in grad_names:
        ref = jgrads[n]
        rel = float((seen[n] - ref).norm() / ref.norm())
        assert rel <= 1e-3, (n, rel)
    assert_buffers_match(model, arch, {"params": v["params"],
                                       "batch_stats": new_bs},
                         moved_from=before)
    for k, t in teacher.state_dict().items():
        assert torch.equal(t, t_before[k]), k


def test_family_step_matches_jax():
    check_family_step("yolof", jax_model, port_model, _tiny_cfg,
                      jax_variables(0), jax_variables(1, teacher=True),
                      batch_arrays(seed=4), GRAD_NAMES,
                      ("loss_cls", "loss_bbox", "loss_kd", "loss_ld_bbox",
                       "loss_fd"))


def test_init_weights_scales_and_seed():
    """init_weights at JAX's scales: normal(0.01) head and block convs,
    caffe2-Xavier lateral conv, lecun backbone, the cls prior bias,
    identity BNs; a seed gives the same weights."""
    spec = registry.get_family("yolof")
    mcfg = pconfig.ModelConfig(arch="yolof", **TINY)
    a, b = (spec["build"](mcfg, "cpu") for _ in range(2))
    spec["init_weights"](a, 3)
    spec["init_weights"](b, 3)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    sd = a.state_dict()
    for k in ("bbox_head.cls_subnet.0.conv.weight",
              "neck.dilated_encoder_blocks.2.conv2.conv.weight"):
        assert abs(float(sd[k].std()) - 0.01) < 1e-3, k
    lat = sd["neck.lateral_conv.weight"]
    assert float(lat.abs().max()) <= (3 / 512) ** 0.5
    assert abs(float(lat.std()) * 512 ** 0.5 - 1) < 0.05
    stem = sd["backbone.conv1.weight"]
    assert abs(float(stem.std()) * 147 ** 0.5 - 1) < 0.1
    np.testing.assert_allclose(sd["bbox_head.cls_score.bias"].numpy(),
                               -np.log(99), rtol=1e-6)
    assert not sd["bbox_head.bbox_pred.bias"].any()
    assert torch.equal(sd["neck.lateral_norm.running_var"], torch.ones(512))


# --- a two-task run ----------------------------------------------------------

def _rows(work):
    rows = {}
    for path in glob.glob(os.path.join(work, "*.log.json")):
        for line in open(path):
            r = json.loads(line)
            rows[(r["mode"], r["task"], r["epoch"], r["iter"])] = r
    return rows


def run_two_tasks_against_jax(root, cfg_fn, v, check_buffers, iters=2):
    """``run_incremental`` of the tiny config (two tasks of ``iters`` steps,
    B=2,
    eval and checkpoints after each, lr 1e-5) against JAX's
    ``train_one_task`` on a one-device mesh, from the same weights: train
    rows (1e-4 relative on a task's first step, 1e-3 after an update) and
    val mAP; the final running buffers against JAX's (``check_buffers``);
    then ``init_detector`` restores the task-2 checkpoint, buffers included,
    to the run's final detections bit for bit."""
    import chip_smoke
    from dskd_tpu.data.coco import COCO_CLASSES_ALPHA_ORDER
    from dskd_tpu.parallel.mesh import make_mesh
    from dskd_tpu.train.incremental import build_model, train_one_task
    from dskd_tpu.utils import config as jconfig
    from dskd_tpu_torch.apis.inference import init_detector
    from dskd_tpu_torch.eval.evaluator import make_eval_step
    from dskd_tpu_torch.train.incremental import run_incremental

    def run_cfg(mod, work, num_workers):
        cfg = cfg_fn(mod, base_lr=1e-5, warmup_iters=2, step_epochs=(10,),
                     max_iters_per_task=iters, eval_interval=1,
                     ckpt_interval=1,
                     log_interval=1, use_dropout=False, seed=0,
                     work_dir=work)
        n = cfg.model.num_classes
        cfg.data = mod.DataConfig(
            train_ann=os.path.join(root, "train.json"),
            val_ann=os.path.join(root, "val.json"),
            train_img_prefix=os.path.join(root, "train"),
            val_img_prefix=os.path.join(root, "val"),
            catsplit=(n // 2, n - n // 2), samples_per_device=2,
            num_workers=num_workers, max_gt=8, bucket=(64, 64),
            img_scale=(64, 64))
        return cfg

    pwork = os.path.join(root, "port")
    pcfg = run_cfg(pconfig, pwork, 0)
    cats = [cid for _, cid in COCO_CLASSES_ALPHA_ORDER[
        :pcfg.model.num_classes]]
    shapes = ((48, 64), (64, 48))
    chip_smoke.write_coco(root, "train", shapes * 6, cats, seed=0)
    chip_smoke.write_coco(root, "val", shapes * 2, cats, seed=1)
    final = run_incremental(pcfg, variables=v, device="cpu")

    jwork = os.path.join(root, "jax")
    jcfg = run_cfg(jconfig, jwork, 1)
    mesh = make_mesh(jax.devices()[:1])
    jmodel = build_model(jcfg)
    jv = train_one_task(jmodel, jcfg, 1, 2, v, None, mesh)
    jv = train_one_task(jmodel, jcfg, 2, 2, jv, jax.tree.map(jnp.copy, jv),
                        mesh)

    want, got = _rows(jwork), _rows(pwork)
    assert sorted(got) == sorted(want)
    assert sorted(k[:2] for k in want if k[0] == "val") == [("val", 1),
                                                             ("val", 2)]
    for key, w in want.items():
        g = got[key]
        if key[0] == "val":
            assert abs(g["bbox_mAP"] - w["bbox_mAP"]) <= 1e-3, key
            continue
        timing = {"img_s", "time"}
        assert set(g) - timing == set(w) - timing, key
        for k in set(w) - timing - {"mode", "task", "epoch", "iter"}:
            rtol = 1e-4 if key[3] == 1 else 1e-3
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"{key} {k}")
    if check_buffers:
        want_bn = running_buffers(registry.get_family(
            pcfg.model.arch)["from_jax"](jax.tree.map(np.asarray, jv)))
        for k, t in running_buffers(final.state_dict()).items():
            np.testing.assert_allclose(t.numpy(), want_bn[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)

    restored, _ = init_detector(pcfg, os.path.join(pwork, "task_2_epoch_1"),
                                device="cpu")
    for k, t in running_buffers(final.state_dict()).items():
        assert torch.equal(restored.state_dict()[k], t), k
    images, img_hw = batch_arrays(seed=6)[:2]
    args = (torch.from_numpy(images), torch.from_numpy(img_hw),
            torch.ones(B, 4))
    a = make_eval_step(final.eval(), arch=pcfg.model.arch)(*args)
    b = make_eval_step(restored, arch=pcfg.model.arch)(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    return want


def test_two_task_run_matches_jax_train_one_task(tmp_path):
    rows = run_two_tasks_against_jax(str(tmp_path), _tiny_cfg,
                                     jax_variables(5), check_buffers=True)
    assert rows[("train", 2, 1, 1)]["loss_kd"] >= 0
