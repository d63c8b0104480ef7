"""Shared fixtures of the dense single-stage families' CPU tests
(RetinaNet, ATSS, GFL, FCOS on the port against dskd_tpu.models).

The tiny configuration: ResNet-18 (C2-C5 of 64-512 channels), FPN-256 on
C3-C5 with P6-P7, the full 4-conv towers at width 256, 10 classes, B=2 on
a 72x88 canvas (C3 9x11, C4 5x6 and C5 3x3: odd sizes, so the top-down
path crops), one image of 60x80 valid pixels. Weights: a JAX variables
tree of the family's module (shapes by ``jax.eval_shape`` of its init,
values drawn with numpy from a seed at lecun-like scales, so that the
outputs spread), carried to the port by the registry's ``from_jax``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dskd_tpu_torch import registry
from dskd_tpu_torch.data.batch import Batch

NC = 10
B, H, W = 2, 72, 88
IMG_HW = np.array([[72, 88], [60, 80]], np.int32)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("retinanet", "atss", "gfl", "fcos")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def batch_arrays(seed=0, G=6, n_valid=(4, 6)):
    """numpy (images, img_hw, gt_bboxes, gt_labels, gt_valid): boxes of
    8-70 pixels inside each image's valid region, so that every FCOS range
    up to P4's holds a GT."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(B, H, W, 3) * 0.5).astype(np.float32)
    wh = rng.rand(B, G, 2) * 62 + 8
    wh = np.minimum(wh, IMG_HW[:, None, ::-1] - 2)
    xy = rng.rand(B, G, 2) * (IMG_HW[:, None, ::-1] - wh)
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, NC, (B, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array(n_valid)[:, None]
    return images, IMG_HW, gt, labels, valid


def jax_batch(arrays):
    from dskd_tpu.data.batch import Batch as JBatch
    return JBatch(*(jnp.asarray(a) for a in arrays))


def torch_batch(arrays):
    return Batch(*(torch.from_numpy(np.asarray(a)) for a in arrays))


def jax_model(arch, num_classes=NC):
    from dskd_tpu.models.atss import ATSS
    from dskd_tpu.models.fcos import FCOS
    from dskd_tpu.models.gfl import GFL
    from dskd_tpu.models.retinanet import RetinaNet
    cls = {"retinanet": RetinaNet, "atss": ATSS, "gfl": GFL,
           "fcos": FCOS}[arch]
    return cls(num_classes=num_classes, depth=18)


@functools.lru_cache(maxsize=None)
def jax_apply(arch):
    return jax.jit(jax_model(arch).apply)


def _fill(path, shape, rng):
    name = "/".join(str(getattr(k, "key", k)) for k in path)
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.randn(*shape) / np.sqrt(fan_in)
    if leaf == "var":
        return 1.0 + 0.2 * rng.rand(*shape)
    if leaf in ("mean", "bias"):
        return 0.1 * rng.randn(*shape)
    if leaf == "scale":          # norms, and the heads' Scale
        return 1.0 + 0.1 * rng.randn(*shape)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _variables(arch, seed, num_classes):
    shapes = jax.eval_shape(jax_model(arch, num_classes).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, H, W, 3)),
                            jnp.asarray(IMG_HW[:1]))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_fill(p, s.shape, rng), np.float32), shapes)


def jax_variables(arch, seed=0, num_classes=NC):
    return jax.tree.map(np.copy, _variables(arch, seed, num_classes))


def port_model(arch, variables, dtype=torch.float32):
    spec = registry.get_family(arch)
    model = spec["build"](_model_cfg(arch), "cpu")
    model.load_state_dict(spec["from_jax"](variables), strict=True)
    return model.to(dtype)


def _model_cfg(arch):
    from dskd_tpu_torch.utils.config import ModelConfig
    return ModelConfig(arch=arch, num_classes=NC, depth=18)


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a), tree)


def assert_forward_matches(arch, v, images):
    """Every head output and neck level of the port against JAX's
    (FWD_TOL); returns JAX's outputs."""
    want = jax_apply(arch)(v, jnp.asarray(images), jnp.asarray(IMG_HW))
    got = port_model(arch, v)(torch.from_numpy(images),
                              torch.from_numpy(IMG_HW))
    for field in want.head._fields:
        for lvl, (g, w) in enumerate(zip(getattr(got.head, field),
                                         getattr(want.head, field))):
            assert tuple(g.shape) == tuple(w.shape), (field, lvl)
            np.testing.assert_allclose(_np(g), np.asarray(w),
                                       err_msg=f"{field} {lvl}", **FWD_TOL)
    for lvl, (g, w) in enumerate(zip(got.neck_feats, want.neck_feats)):
        np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)), np.asarray(w),
                                   err_msg=f"neck {lvl}", **FWD_TOL)
    return want


# --- per-family losses and decodes on given head outputs -------------------

def _featmaps(head):
    return [tuple(int(s) for s in c.shape[1:3]) for c in head.cls_scores]


def jax_losses(arch, head, gt, labels, valid):
    """The JAX family's detection losses of ``head`` (its head outputs)."""
    sizes = _featmaps(head)
    if arch == "retinanet":
        from dskd_tpu.models import retinanet as J
        return J.retina_detection_loss(head, J.retina_anchors(sizes), gt,
                                       labels, valid,
                                       J.RetinaLossConfig(num_classes=NC))
    if arch == "atss":
        from dskd_tpu.models import atss as J
        anchors, counts = J.atss_anchors(sizes)
        return J.atss_detection_loss(head, anchors, counts, gt, labels,
                                     valid, J.ATSSLossConfig(num_classes=NC))
    if arch == "gfl":
        from dskd_tpu.models import gfl_head as J
        return J.gfl_detection_loss(head, gt, labels, valid,
                                    J.GFLLossConfig(num_classes=NC))
    from dskd_tpu.models import fcos as J
    points, meta = J.fcos_points(sizes)
    return J.fcos_detection_loss(head, points, meta, gt, labels, valid,
                                 J.FCOSLossConfig(num_classes=NC))


def port_losses(arch, head, gt, labels, valid):
    sizes = _featmaps(head)
    if arch == "retinanet":
        from dskd_tpu_torch.models import retinanet as P
        return P.retina_detection_loss(head, P.retina_anchors(sizes, "cpu"),
                                       gt, labels, valid,
                                       P.RetinaLossConfig(num_classes=NC))
    if arch == "atss":
        from dskd_tpu_torch.models import atss as P
        anchors, counts = P.atss_anchors(sizes, "cpu")
        return P.atss_detection_loss(head, anchors, counts, gt, labels,
                                     valid, P.ATSSLossConfig(num_classes=NC))
    if arch == "gfl":
        from dskd_tpu_torch.models import gfl_head as P
        return P.gfl_detection_loss(head, gt, labels, valid,
                                    P.GFLLossConfig(num_classes=NC))
    from dskd_tpu_torch.models import fcos as P
    points, meta = P.fcos_points(sizes, "cpu")
    return P.fcos_detection_loss(head, points, meta, gt, labels, valid,
                                 P.FCOSLossConfig(num_classes=NC))


def jax_get_bboxes(arch, head, img_hw, **kw):
    sizes = _featmaps(head)
    if arch == "retinanet":
        from dskd_tpu.models import retinanet as J
        return J.retina_get_bboxes(head, J.retina_anchors(sizes), img_hw,
                                   **kw)
    if arch == "atss":
        from dskd_tpu.models import atss as J
        return J.atss_get_bboxes(head, J.atss_anchors(sizes)[0], img_hw,
                                 **kw)
    if arch == "gfl":
        from dskd_tpu.models import gfl_head as J
        return J.gfl_get_bboxes(head, img_hw, **kw)
    from dskd_tpu.models import fcos as J
    return J.fcos_get_bboxes(head, J.fcos_points(sizes)[0], img_hw, **kw)


def port_get_bboxes(arch, head, img_hw, **kw):
    sizes = _featmaps(head)
    if arch == "retinanet":
        from dskd_tpu_torch.models import retinanet as P
        return P.retina_get_bboxes(head, P.retina_anchors(sizes, "cpu"),
                                   img_hw, **kw)
    if arch == "atss":
        from dskd_tpu_torch.models import atss as P
        return P.atss_get_bboxes(head, P.atss_anchors(sizes, "cpu")[0],
                                 img_hw, **kw)
    if arch == "gfl":
        from dskd_tpu_torch.models import gfl_head as P
        return P.gfl_get_bboxes(head, img_hw, **kw)
    from dskd_tpu_torch.models import fcos as P
    return P.fcos_get_bboxes(head, P.fcos_points(sizes, "cpu")[0], img_hw,
                             **kw)


def port_head(arch, jhead):
    """JAX head outputs (arrays) -> the port's head NamedTuple (tensors)."""
    from dskd_tpu_torch.models import atss, fcos, gfl_head, retinanet
    cls = {"retinanet": retinanet.RetinaHeadOutputs,
           "atss": atss.ATSSHeadOutputs, "gfl": gfl_head.GFLHeadOutputs,
           "fcos": fcos.FCOSHeadOutputs}[arch]
    return cls(*(tuple(torch.from_numpy(np.array(x)) for x in field)
                 for field in jhead))


# --- the family-level checks each family's test file runs -------------------

def check_losses_f64(arch, seed=1):
    """The detection losses of the JAX model's head outputs on batch
    ``seed``, in f64 in both packages (1e-6 relative); positives exist."""
    v = jax_variables(arch)
    images, img_hw, gt, labels, valid = batch_arrays(seed)
    jhead = f64(jax_apply(arch)(v, jnp.asarray(images),
                                jnp.asarray(img_hw)).head)
    gt = gt.astype(np.float64)
    with jax.enable_x64(True):
        want = jax.jit(lambda h, g, lb, vd: jax_losses(arch, h, g, lb, vd))(
            jhead, gt, labels, valid)
        want = {k: float(x) for k, x in want.items()}
    got = port_losses(arch, port_head(arch, jhead), *(
        torch.from_numpy(a) for a in (gt, labels, valid)))
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert got[k].dtype == torch.float64, k
        assert np.isfinite(x) and x != 0, (k, x)
        np.testing.assert_allclose(float(got[k]), x, rtol=1e-6, atol=0,
                                   err_msg=k)


def check_family_step_f64(arch, grad_names, seed=2):
    """One generic step of the port's family in f64 (weights from
    ``from_jax``) against ``jax.value_and_grad`` of JAX's registry
    losses_fn in f64: every loss (1e-6 relative) and the gradients of
    ``grad_names`` that the step's clip sees (1e-5 relative L2)."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu.train.step import parse_losses as jparse
    from dskd_tpu.utils import config as jconfig
    from dskd_tpu_torch.train.family import make_family_train_step
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState
    from dskd_tpu_torch.utils import config as pconfig

    def cfg(mod):
        return mod.ExperimentConfig(model=mod.ModelConfig(
            arch=arch, num_classes=NC, depth=18))

    v = jax_variables(arch)
    arrays = list(batch_arrays(seed))
    arrays[0] = arrays[0].astype(np.float64)
    arrays[2] = arrays[2].astype(np.float64)
    losses_fn = jget(arch)["losses"](jax_model(arch), cfg(jconfig),
                                     has_teacher=False, use_dropout=False)
    with jax.enable_x64(True):
        v64 = f64(v)
        jb = jax_batch(arrays)

        def total(params):
            losses, _ = losses_fn({"params": params,
                                   "batch_stats": v64["batch_stats"]}, jb,
                                  None, jax.random.PRNGKey(0))
            return jparse(losses), losses

        (_, want), jgrads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(v64["params"])
        want = {k: float(x) for k, x in want.items()}
        jgrads = jax.tree.map(np.asarray, jgrads)
    jgrads = registry.get_family(arch)["from_jax"](
        {"params": jgrads, "batch_stats": v["batch_stats"]})

    model = port_model(arch, v, torch.float64)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    seen = {}
    clip = state.optimizer.clip

    def recording_clip():
        seen.update({n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None})
        return clip()

    state.optimizer.clip = recording_clip
    step = make_family_train_step(arch, model, cfg(pconfig), num_prev=0,
                                  has_teacher=False, use_dropout=False)
    state, got = step(state, torch_batch(arrays))
    assert state.step == 1
    assert set(got) == set(want) | {"loss"}
    for k, x in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(float(got[k]), x, rtol=1e-6, atol=0,
                                   err_msg=k)
    for n in grad_names:
        ref = jgrads[n].double()
        rel = float((seen[n] - ref).norm() / ref.norm())
        assert rel <= 1e-5, (n, rel)


def check_get_bboxes(arch, nms_pre, seed=3):
    """The decode of the JAX model's head outputs (f32) in both packages,
    rescaled: labels and valid exactly (and GFL's keep_qid), scores 1e-6,
    boxes 1e-5; each image keeps detections (GFL's 10 of its 100 slots,
    the others fill them)."""
    v = jax_variables(arch)
    images = batch_arrays(seed)[0]
    jhead = jax_apply(arch)(v, jnp.asarray(images), jnp.asarray(IMG_HW)).head
    jhead = jax.tree.map(np.asarray, jhead)
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [2.0, 1.5, 2.0, 1.5]], np.float32)
    kw = dict(score_thr=0.05, max_per_img=100, nms_pre=nms_pre,
              rescale=True)
    want = jax.jit(lambda h, hw, s: jax_get_bboxes(
        arch, h, hw, scale_factor=s, **kw))(jhead, jnp.asarray(IMG_HW),
                                            jnp.asarray(sf))
    got = port_get_bboxes(arch, port_head(arch, jhead),
                          torch.from_numpy(IMG_HW),
                          scale_factor=torch.from_numpy(sf), **kw)
    keys = ["labels", "valid"] + (["keep_qid"] if "keep_qid" in want else [])
    for k in keys:
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want["scores"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want["bboxes"]),
                               rtol=1e-5, atol=1e-5)
    assert bool((got.valid.sum(1) > 0).all())
    return got


def check_init_weights(arch, head_convs, prior_conv, prior_bias,
                       other_biases=None):
    """init_weights at JAX's scales: normal(0.01) head convs, xavier FPN,
    lecun backbone, the class prior bias, the family's ``other_biases``
    ({bias key: value}), identity norms, unit scales, every other bias 0;
    a seed gives the same weights."""
    from dskd_tpu_torch.utils.config import ModelConfig

    spec = registry.get_family(arch)
    mcfg = ModelConfig(arch=arch, num_classes=NC, depth=18)
    a, b = (spec["build"](mcfg, "cpu") for _ in range(2))
    spec["init_weights"](a, 3)
    spec["init_weights"](b, 3)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    sd = a.state_dict()
    for k in head_convs:
        assert abs(float(sd[k].std()) - 0.01) < 1e-3, k
    lat = sd["neck.lateral_convs.2.conv.weight"]          # 512 -> 256, 1x1
    assert float(lat.abs().max()) <= (6 / (512 + 256)) ** 0.5
    assert abs(float(lat.std()) - (2 / (512 + 256)) ** 0.5) < 2e-3
    stem = sd["backbone.conv1.weight"]
    assert abs(float(stem.std()) * 147 ** 0.5 - 1) < 0.1
    np.testing.assert_allclose(sd[prior_conv + ".bias"].numpy(), prior_bias,
                               rtol=1e-6)
    other_biases = other_biases or {}
    for k, v in other_biases.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-6, err_msg=k)
    for k, t in sd.items():
        if k in other_biases:
            continue
        if k.endswith(".gn.weight") or k.endswith(".scale"):
            assert torch.equal(t, torch.ones_like(t)), k
        if k.endswith(".gn.bias") or (k.endswith(".bias") and k.startswith(
                ("neck.", "bbox_head.")) and not k.startswith(prior_conv)):
            assert not t.any(), k


def assert_trees_equal(got, want, path=""):
    """Two nested dicts of arrays: the same keys and equal leaves."""
    assert sorted(got) == sorted(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            assert_trees_equal(got[k], w, f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=f"{path}/{k}")
