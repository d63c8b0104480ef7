"""Shared fixtures of the CPU tests of the DCN families (ATSS-DyHead,
NAS-FCOS, VFNet, RepPoints) on the port against dskd_tpu.models.

The tiny configuration is tests/torch_port_dense.py's: ResNet-18, the
full 256-wide necks and heads, 10 classes, B=2 on a 72x88 canvas (C3
9x11, C4 5x6, C5 3x3, P6 2x2, P7 1x1: odd sizes, so DyHead's stride-2 and
``::2`` maps and NAS-FCOS's resizes meet them), one image of 60x80 valid
pixels; ATSS-DyHead with one block unless a test asks for more. Weights:
a JAX variables tree of the family's module (shapes by
``jax.eval_shape``, values drawn with numpy from a seed at lecun-like
scales, so that DyHead's offsets put samples between and beyond pixels),
carried to the port by the registry's ``from_jax``; ``zero_offsets``
zeroes DyHead's offset convs, their init.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_dense as D
from dskd_tpu_torch import registry

NC = D.NC
FWD_TOL = dict(rtol=1e-4, atol=1e-5)    # f32 forwards
F64_RTOL = 1e-8                         # f64 losses and gradients
ARCH = {"atss_dyhead": "atss", "nasfcos": "nasfcos", "vfnet": "vfnet",
        "reppoints": "reppoints"}


def jax_model(fam, blocks=1):
    from dskd_tpu.models.atss import ATSS
    from dskd_tpu.models.fcos import FCOS
    from dskd_tpu.models.reppoints import RepPoints
    from dskd_tpu.models.vfnet import VFNet
    if fam == "atss_dyhead":
        return ATSS(num_classes=NC, depth=18, dyhead_blocks=blocks,
                    head_stacked_convs=0)
    if fam == "nasfcos":
        return FCOS(num_classes=NC, depth=18, nas_fpn=True)
    return {"vfnet": VFNet, "reppoints": RepPoints}[fam](num_classes=NC,
                                                         depth=18)


def model_cfg(mod, fam, blocks=1):
    return mod.ModelConfig(arch=ARCH[fam], num_classes=NC, depth=18,
                           dyhead_blocks=blocks if fam == "atss_dyhead"
                           else 0)


@functools.lru_cache(maxsize=None)
def jax_apply(fam, blocks=1):
    return jax.jit(jax_model(fam, blocks).apply)


def _fill(path, shape, rng):
    leaf = str(getattr(path[-1], "key", path[-1]))
    if leaf.endswith("_kernel"):          # the deformable kernels
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if leaf == "moment_transfer":
        return 0.2 * rng.randn(*shape)
    return D._fill(path, shape, rng)


@functools.lru_cache(maxsize=None)
def _variables(fam, seed, blocks):
    shapes = jax.eval_shape(jax_model(fam, blocks).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, D.H, D.W, 3)),
                            jnp.asarray(D.IMG_HW[:1]))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_fill(p, s.shape, rng), np.float32), shapes)


def jax_variables(fam, seed=0, blocks=1, zero_offsets=False):
    v = jax.tree.map(np.copy, _variables(fam, seed, blocks))
    if zero_offsets:
        for blk in v["params"]["dyhead"].values():
            for p in blk["spatial_conv_offset"].values():
                p[...] = 0.0
    return v


def port_model(fam, variables, dtype=torch.float32, blocks=1):
    from dskd_tpu_torch.utils import config as pconfig
    spec = registry.get_family(ARCH[fam])
    model = spec["build"](model_cfg(pconfig, fam, blocks), "cpu")
    model.load_state_dict(spec["from_jax"](variables), strict=True)
    return model.to(dtype)


def port_head(fam, jhead):
    """JAX head outputs (arrays) -> the port's head NamedTuple."""
    from dskd_tpu_torch.models import atss, fcos, reppoints, vfnet
    cls = {"atss_dyhead": atss.ATSSHeadOutputs,
           "nasfcos": fcos.FCOSHeadOutputs,
           "vfnet": vfnet.VFNetHeadOutputs,
           "reppoints": reppoints.RepPointsHeadOutputs}[fam]
    return cls(*(tuple(torch.from_numpy(np.array(x)) for x in field)
                 for field in jhead))


def assert_forward_matches(fam, v, images, blocks=1):
    """Every head output and neck level of the port against JAX's
    (FWD_TOL); returns JAX's outputs."""
    want = jax_apply(fam, blocks)(v, jnp.asarray(images),
                                  jnp.asarray(D.IMG_HW))
    got = port_model(fam, v, blocks=blocks)(torch.from_numpy(images),
                                            torch.from_numpy(D.IMG_HW))
    for field in want.head._fields:
        for lvl, (g, w) in enumerate(zip(getattr(got.head, field),
                                         getattr(want.head, field))):
            assert tuple(g.shape) == tuple(w.shape), (field, lvl)
            np.testing.assert_allclose(D._np(g), np.asarray(w),
                                       err_msg=f"{field} {lvl}", **FWD_TOL)
    for lvl, (g, w) in enumerate(zip(got.neck_feats, want.neck_feats)):
        assert tuple(g.permute(0, 2, 3, 1).shape) == tuple(w.shape)
        np.testing.assert_allclose(D._np(g.permute(0, 2, 3, 1)),
                                   np.asarray(w), err_msg=f"neck {lvl}",
                                   **FWD_TOL)
    if fam == "reppoints":
        np.testing.assert_array_equal(D._np(got.moment),
                                      np.asarray(want.moment))
    return want


def _sizes(head):
    return [tuple(int(s) for s in c.shape[1:3]) for c in head.cls_scores]


def jax_losses(fam, head, gt, labels, valid, moment=None):
    sizes = _sizes(head)
    if fam == "atss_dyhead":
        return D.jax_losses("atss", head, gt, labels, valid)
    if fam == "nasfcos":
        return D.jax_losses("fcos", head, gt, labels, valid)
    if fam == "vfnet":
        from dskd_tpu.models import vfnet as J
        points, anchors, counts = J.vfnet_points(sizes)
        return J.vfnet_loss(head, points, anchors, counts, gt, labels, valid,
                            J.VFNetLossConfig(num_classes=NC))
    from dskd_tpu.models import reppoints as J
    return J.reppoints_loss(head, moment, gt, labels, valid,
                            J.RepPointsLossConfig(num_classes=NC))


def port_losses(fam, head, gt, labels, valid, moment=None):
    sizes = _sizes(head)
    if fam == "atss_dyhead":
        return D.port_losses("atss", head, gt, labels, valid)
    if fam == "nasfcos":
        return D.port_losses("fcos", head, gt, labels, valid)
    if fam == "vfnet":
        from dskd_tpu_torch.models import vfnet as P
        points, anchors, counts = P.vfnet_points(sizes, "cpu")
        return P.vfnet_loss(head, points, anchors, counts, gt, labels, valid,
                            P.VFNetLossConfig(num_classes=NC))
    from dskd_tpu_torch.models import reppoints as P
    return P.reppoints_loss(head, moment, gt, labels, valid,
                            P.RepPointsLossConfig(num_classes=NC))


def check_losses_f64(fam, seed=1):
    """The losses of the JAX model's head outputs on batch ``seed`` in f64
    in both packages (F64_RTOL); every loss finite and not 0."""
    v = jax_variables(fam)
    images, img_hw, gt, labels, valid = D.batch_arrays(seed)
    jout = jax_apply(fam)(v, jnp.asarray(images), jnp.asarray(img_hw))
    jhead = D.f64(jout.head)
    moment = (np.asarray(jout.moment, np.float64) if fam == "reppoints"
              else None)
    gt = gt.astype(np.float64)
    with jax.enable_x64(True):
        want = jax.jit(lambda h, m, g, lb, vd: jax_losses(
            fam, h, g, lb, vd, m))(jhead, moment, gt, labels, valid)
        want = {k: float(x) for k, x in want.items()}
    got = port_losses(fam, port_head(fam, jhead), *(
        torch.from_numpy(a) for a in (gt, labels, valid)),
        None if moment is None else torch.from_numpy(moment))
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert got[k].dtype == torch.float64, k
        assert np.isfinite(x) and x != 0, (k, x)
        np.testing.assert_allclose(float(got[k]), x, rtol=F64_RTOL, atol=0,
                                   err_msg=k)
    return got


def check_family_step_f64(fam, grad_names, seed=2, blocks=1,
                          zero_offsets=False):
    """One generic step of the port's family in f64 (weights from
    ``from_jax``) against ``jax.value_and_grad`` of JAX's registry
    losses_fn in f64: every loss, and the gradients of ``grad_names`` that
    the step's clip sees in relative L2, within F64_RTOL. Returns (the
    model after the step, its state_dict before, JAX's new batch_stats
    or None)."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu.train.step import parse_losses as jparse
    from dskd_tpu.utils import config as jconfig
    from dskd_tpu_torch.train.family import make_family_train_step
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState
    from dskd_tpu_torch.utils import config as pconfig

    def cfg(mod):
        return mod.ExperimentConfig(model=model_cfg(mod, fam, blocks))

    v = jax_variables(fam, blocks=blocks, zero_offsets=zero_offsets)
    arrays = list(D.batch_arrays(seed))
    arrays[0] = arrays[0].astype(np.float64)
    arrays[2] = arrays[2].astype(np.float64)
    losses_fn = jget(ARCH[fam])["losses"](jax_model(fam, blocks), cfg(jconfig),
                                          has_teacher=False,
                                          use_dropout=False)
    with jax.enable_x64(True):
        v64 = D.f64(v)
        jb = D.jax_batch(arrays)

        def total(params):
            losses, stats = losses_fn({"params": params,
                                       "batch_stats": v64["batch_stats"]},
                                      jb, None, jax.random.PRNGKey(0))
            return jparse(losses), (losses, stats)

        (_, (want, new_bs)), jgrads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(v64["params"])
        want = {k: float(x) for k, x in want.items()}
        jgrads = jax.tree.map(np.asarray, jgrads)
        new_bs = None if new_bs is None else jax.tree.map(np.asarray, new_bs)
    jgrads = registry.get_family(ARCH[fam])["from_jax"](
        {"params": jgrads, "batch_stats": v["batch_stats"]})

    model = port_model(fam, v, torch.float64, blocks)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    seen = {}
    clip = state.optimizer.clip

    def recording_clip():
        seen.update({n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None})
        return clip()

    state.optimizer.clip = recording_clip
    step = make_family_train_step(ARCH[fam], model, cfg(pconfig),
                                  num_prev=0, has_teacher=False,
                                  use_dropout=False)
    state, got = step(state, D.torch_batch(arrays))
    assert state.step == 1
    assert set(got) == set(want) | {"loss"}
    for k, x in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(float(got[k]), x, rtol=F64_RTOL, atol=0,
                                   err_msg=k)
    for n in grad_names:
        ref = jgrads[n].double()
        assert float(ref.norm()) > 0, n
        rel = float((seen[n] - ref).norm() / ref.norm())
        assert rel <= F64_RTOL, (n, rel)
    return model, before, new_bs


def jax_get_bboxes(fam, head, img_hw, moment=None, **kw):
    sizes = _sizes(head)
    if fam == "atss_dyhead":
        return D.jax_get_bboxes("atss", head, img_hw, **kw)
    if fam == "nasfcos":
        return D.jax_get_bboxes("fcos", head, img_hw, **kw)
    if fam == "vfnet":
        from dskd_tpu.models import vfnet as J
        return J.vfnet_get_bboxes(head, J.vfnet_points(sizes)[0], img_hw,
                                  **kw)
    from dskd_tpu.models import reppoints as J
    return J.reppoints_get_bboxes(head, moment, img_hw, **kw)


def port_get_bboxes(fam, head, img_hw, moment=None, **kw):
    sizes = _sizes(head)
    if fam == "atss_dyhead":
        return D.port_get_bboxes("atss", head, img_hw, **kw)
    if fam == "nasfcos":
        return D.port_get_bboxes("fcos", head, img_hw, **kw)
    if fam == "vfnet":
        from dskd_tpu_torch.models import vfnet as P
        return P.vfnet_get_bboxes(head, P.vfnet_points(sizes, "cpu")[0],
                                  img_hw, **kw)
    from dskd_tpu_torch.models import reppoints as P
    return P.reppoints_get_bboxes(head, moment, img_hw, **kw)


def check_get_bboxes(fam, nms_pre=1000, seed=3):
    """The decode of the JAX model's head outputs (f32) in both packages,
    rescaled: labels and valid exactly, scores 1e-6, boxes 1e-5; each image
    keeps detections. Returns the port's detections."""
    v = jax_variables(fam)
    images = D.batch_arrays(seed)[0]
    jout = jax_apply(fam)(v, jnp.asarray(images), jnp.asarray(D.IMG_HW))
    jhead = jax.tree.map(np.asarray, jout.head)
    moment = np.array(jout.moment) if fam == "reppoints" else None
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [2.0, 1.5, 2.0, 1.5]], np.float32)
    kw = dict(score_thr=0.05, max_per_img=100, nms_pre=nms_pre,
              rescale=True)
    want = jax.jit(lambda h, m, hw, s: jax_get_bboxes(
        fam, h, hw, m, scale_factor=s, **kw))(jhead, moment,
                                              jnp.asarray(D.IMG_HW),
                                              jnp.asarray(sf))
    got = port_get_bboxes(fam, port_head(fam, jhead),
                          torch.from_numpy(D.IMG_HW),
                          None if moment is None else torch.from_numpy(
                              moment),
                          scale_factor=torch.from_numpy(sf), **kw)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(D._np(getattr(got, k)),
                                      np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want["scores"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want["bboxes"]),
                               rtol=1e-5, atol=1e-5)
    assert bool((got.valid.sum(1) > 0).all())
    return got


def check_eval_step(fam, blocks=1):
    """The registry's eval step of the port on the JAX weights against
    JAX's registry eval step: labels and valid exactly, scores 1e-5,
    boxes 1e-4."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu_torch.eval.evaluator import make_eval_step

    images, img_hw = D.batch_arrays(5)[:2]
    v = jax_variables(fam, blocks=blocks)
    sf = np.array([[1.0] * 4, [1.25] * 4], np.float32)
    want = jget(ARCH[fam])["eval_step"](jax_model(fam, blocks),
                                        score_thr=0.05, max_per_img=100,
                                        reg_max=16)(
        v, jnp.asarray(images), jnp.asarray(img_hw), jnp.asarray(sf))
    got = make_eval_step(port_model(fam, v, blocks=blocks).eval(), 16, 0.05,
                         100, ARCH[fam])(torch.from_numpy(images),
                                         torch.from_numpy(img_hw),
                                         torch.from_numpy(sf))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=1e-4, atol=1e-3)
    assert bool(got.valid.any())
    return got
