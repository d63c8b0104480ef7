"""Shared fixtures of the CPU tests of the RegNetX, EfficientNet, PVT,
HRNet (+ HRFPN) and MobileNetV2 backbones and the YOLOX, YOLOv3 and
CenterNet families on the port against dskd_tpu.models.

Both packages are cut the same way while ``cut()`` runs (the JAX package
through its module attributes, which its modules read at call time, the
port through its own): RegNetX ``regnetx_tiny`` (w0 16, wa 16, wm 2,
depth 8: stages of 16, 32, 64 and 128 channels, 1, 1, 3 and 3 blocks,
group width 8); EfficientNet ``effbt`` (width and depth 0.25: seven blocks
of 8-80 channels); PVT ``pvt_micro`` (dims 16, 32, 40, 64, depths 2, 1,
1, 1, MLP ratio 2); HRNet ``hrnet_w8`` with one module a stage and one
block a branch; MobileNetV2 with one block a stage at 8-32 channels. JAX's
EfficientNet and PVT are built with stochastic depth 0 (the step
comparisons run the deterministic path; the port's step runs without
dropout). Darknet-53, CSPDarknet (YOLOX-s) and CenterNet's ResNet-18 run
at full depth. 10 classes, B=2 on a 64x64 canvas (one image of 48x60
valid pixels). Weights: a JAX variables tree of the family's module
(shapes by ``jax.eval_shape``, values drawn with numpy from a seed),
carried to the port by the registry's ``from_jax``.
"""
import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch import registry

NC = 10
B = 2
IMG_HW = M.IMG_HW_64
F64_RTOL = 1e-8          # f64 outputs, losses and gradients
BACKBONES = {"regnet": "regnetx_tiny", "effb": "effbt", "pvt": "pvt_micro",
             "hrnet": "hrnet_w8"}

# the named gradients of each backbone's family step
_RETINA = ("bbox_head.retina_cls.weight", "bbox_head.retina_reg.weight",
           "bbox_head.cls_convs.3.conv.weight")
GRAD_NAMES = {
    "regnetx_tiny": _RETINA + ("neck.lateral_convs.0.conv.weight",
                               "backbone.layer2_block0.conv2.weight",
                               "backbone.layer4_block2.conv3.weight"),
    "effbt": _RETINA + ("neck.fpn_convs.4.conv.weight",
                        "neck.lateral_convs.0.conv.weight",
                        "backbone.stem_conv.weight",
                        "backbone.stage3_block0.se_reduce.weight",
                        "backbone.stage6_block0.dw_conv.weight"),
    "pvt_micro": _RETINA + ("backbone.pos_embed0",
                            "backbone.stage0_block1.attn.sr.weight",
                            "backbone.stage2_block0.attn.kv.weight",
                            "backbone.stage3_block0.fc1.weight"),
    "hrnet_w8": ("bbox_head.conv_cls.weight", "bbox_head.conv_reg.weight",
                 "neck.reduction_conv.weight", "neck.fpn_conv4.weight",
                 "backbone.transition1_b0.weight",
                 "backbone.stage4_module0.fuse3_0_conv2.weight",
                 "backbone.stage4_module0.fuse0_3_conv.weight")}


_CUTS = (
    ("regnet", "ARCHS", "regnetx_tiny",
     dict(w0=16, wa=16.0, wm=2.0, group_w=8, depth=8)),
    ("efficientnet", "SCALES", "bt", (0.25, 0.25)),
    ("pvt", "ARCHS", "micro",
     dict(dims=(16, 32, 40, 64), depths=(2, 1, 1, 1), heads=(1, 2, 5, 8),
          sr=(8, 4, 2, 1), mlp=(2, 2, 2, 2))))
_CONSTANTS = (
    ("hrnet", "STAGE_MODULES", (1, 1, 1)),
    ("hrnet", "BLOCKS_PER_BRANCH", 1),
    ("mobilenet_v2", "ARCH", ((1, 8, 1, 1), (6, 8, 1, 2), (6, 16, 1, 2),
                              (6, 16, 1, 2), (6, 24, 1, 1), (6, 24, 1, 2),
                              (6, 32, 1, 1))))
# JAX modules built with stochastic depth 0
_NO_DROP_PATH = (("efficientnet", "EfficientNet"), ("pvt", "PVT"))


def _without_drop_path(cls):
    def build(*args, **kw):
        return cls(*args, **{**kw, "drop_path_rate": 0.0})
    return build


def _mods(name):
    return (importlib.import_module(f"dskd_tpu.models.{name}"),
            importlib.import_module(f"dskd_tpu_torch.models.{name}"))


@contextlib.contextmanager
def cut():
    """The cut architectures in both packages while the block runs."""
    saved = []
    for name, table, key, value in _CUTS:
        for mod in _mods(name):
            getattr(mod, table)[key] = value
    for name, attr, value in _CONSTANTS:
        for mod in _mods(name):
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, value)
    for name, cls in _NO_DROP_PATH:
        mod = _mods(name)[0]
        orig = getattr(mod, cls)
        saved.append((mod, cls, orig))
        setattr(mod, cls, _without_drop_path(orig))
    try:
        yield
    finally:
        for mod, attr, value in reversed(saved):
            setattr(mod, attr, value)


def jax_model(arch, backbone=""):
    if arch in ("retinanet", "fcos"):
        cls = getattr(importlib.import_module(f"dskd_tpu.models.{arch}"),
                      "RetinaNet" if arch == "retinanet" else "FCOS")
        return cls(num_classes=NC, depth=18, backbone=backbone)
    if arch == "yolox":
        from dskd_tpu.models.yolox import YOLOX
        return YOLOX(num_classes=NC)
    if arch == "yolov3":
        from dskd_tpu.models.yolov3 import YOLOV3
        return YOLOV3(num_classes=NC, backbone=backbone)
    from dskd_tpu.models.centernet import CenterNet
    return CenterNet(num_classes=NC, depth=18, frozen_stages=-1)


def model_cfg(mod, arch, backbone=""):
    return mod.ModelConfig(arch=arch, num_classes=NC, depth=18,
                           backbone=backbone,
                           frozen_stages=-1 if arch == "centernet" else 1)


def _fill(path, shape, rng):
    leaf = str(getattr(path[-1], "key", path[-1]))
    if leaf.startswith("pos_embed"):
        return 0.5 * rng.randn(*shape)
    return D._fill(path, shape, rng)


@functools.lru_cache(maxsize=None)
def _variables(arch, backbone, seed):
    shapes = jax.eval_shape(jax_model(arch, backbone).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray(IMG_HW[:1]))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_fill(p, s.shape, rng), np.float32), shapes)


def jax_variables(arch, backbone="", seed=0):
    return jax.tree.map(np.copy, _variables(arch, backbone, seed))


def port_model(arch, variables, backbone="", dtype=torch.float32):
    from dskd_tpu_torch.utils import config as pconfig
    spec = registry.get_family(arch)
    model = spec["build"](model_cfg(pconfig, arch, backbone), "cpu")
    model.load_state_dict(spec["from_jax"](variables), strict=True)
    return model.to(dtype)


def batch_arrays(seed=0):
    """64x64 images, 6 GT of 8-46 pixels (4 and 6 valid)."""
    return M.batch_arrays("retinanet_nasfpn", seed)


def f64_inputs(seed=0):
    arrays = list(batch_arrays(seed))
    arrays[0] = arrays[0].astype(np.float64)
    arrays[2] = arrays[2].astype(np.float64)
    return arrays


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| of two arrays."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_close_f64(got, want, what, rtol=F64_RTOL):
    """An f64 tensor against JAX's: the same shape, not all zero, and
    within ``rtol`` relative (L2 over the tensor)."""
    want = np.asarray(want)
    got = D._np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == np.float64, what
    assert np.abs(want).max() > 0, what
    err = rel_err(got, want)
    assert err <= rtol, (what, err)


def check_forward_f64(arch, backbone="", seed=0, images=None,
                      img_hw=None):
    """The eval-mode forward in f64 in both packages: every output the
    port's NamedTuple and JAX's share, per level (F64_RTOL); the port's
    ``neck_feats`` are NCHW, its head outputs NHWC as JAX's. Returns JAX's
    outputs."""
    v = jax_variables(arch, backbone)
    if images is None:
        images, img_hw = batch_arrays(seed)[:2]
    images = np.asarray(images, np.float64)
    with jax.enable_x64(True):
        want = jax.jit(jax_model(arch, backbone).apply)(
            D.f64(v), jnp.asarray(images), jnp.asarray(img_hw))
        want = jax.tree.map(np.asarray, want)
    got = port_model(arch, v, backbone, torch.float64).eval()(
        torch.from_numpy(images), torch.from_numpy(img_hw))
    for field in want._fields:
        w, g = getattr(want, field), getattr(got, field)
        if field == "neck_feats":
            g = tuple(t.permute(0, 2, 3, 1) for t in g)
        if hasattr(w, "_fields"):           # a head NamedTuple
            for sub in w._fields:
                for lvl, (a, b) in enumerate(zip(getattr(g, sub),
                                                 getattr(w, sub))):
                    assert_close_f64(a, b, f"{field}.{sub} {lvl}")
        elif isinstance(w, (tuple, list)):
            assert len(g) == len(w), field
            for lvl, (a, b) in enumerate(zip(g, w)):
                assert_close_f64(a, b, f"{field} {lvl}")
        else:
            assert_close_f64(g, w, field)
    return want


def check_backbone_f64(arch, backbone, images, img_hw, jax_backbone,
                       port_backbone):
    """The backbone's outputs alone in f64 (F64_RTOL): ``jax_backbone`` and
    ``port_backbone`` build the two modules; the port's carries the
    family's ``from_jax`` weights of its ``backbone.*``."""
    v = jax_variables(arch, backbone)
    images = np.asarray(images, np.float64)
    jm = jax_backbone()
    bv = {k: v[k]["backbone"] for k in v if "backbone" in v[k]}
    with jax.enable_x64(True):
        want = jax.jit(jm.apply)(D.f64(bv), jnp.asarray(images))
        want = [np.asarray(w) for w in want]
    sd = registry.get_family(arch)["from_jax"](v)
    pm = port_backbone()
    pm.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()
                        if k.startswith("backbone.")}, strict=True)
    got = pm.double().eval()(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert len(got) == len(want)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert_close_f64(g.permute(0, 2, 3, 1), w, f"{backbone} out {lvl}")
    return got


def check_family_step_f64(arch, backbone, grad_names, seed=2, rtol=F64_RTOL,
                          jax_kw=None, port_kw=None):
    """One generic step of the port's family in f64 (weights from
    ``from_jax``, no dropout) against ``jax.value_and_grad`` of JAX's
    registry losses_fn in f64: every loss and the gradients of
    ``grad_names`` that the step's clip sees within ``rtol`` (relative,
    L2 for the gradients, each not 0), and the running statistics of
    every trained BatchNorm against JAX's new ``batch_stats``. ``jax_kw``
    and ``port_kw`` reach the two losses builders (YOLOX's ``use_l1``).
    Returns the port's losses."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu.train.step import parse_losses as jparse
    from dskd_tpu.utils import config as jconfig
    from dskd_tpu_torch.train.family import make_family_train_step
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState
    from dskd_tpu_torch.utils import config as pconfig

    def cfg(mod):
        return mod.ExperimentConfig(model=model_cfg(mod, arch, backbone))

    v = jax_variables(arch, backbone)
    arrays = f64_inputs(seed)
    losses_fn = jget(arch)["losses"](jax_model(arch, backbone), cfg(jconfig),
                                     has_teacher=False, use_dropout=False,
                                     **(jax_kw or {}))
    with jax.enable_x64(True):
        v64 = D.f64(v)
        jb = D.jax_batch(arrays)

        def total(params):
            losses, stats = losses_fn({"params": params,
                                       "batch_stats": v64.get(
                                           "batch_stats", {})},
                                      jb, None, jax.random.PRNGKey(0))
            return jparse(losses), (losses, stats)

        (_, (want, new_bs)), jgrads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(v64["params"])
        want = {k: float(x) for k, x in want.items()}
        jgrads = jax.tree.map(np.asarray, jgrads)
        new_bs = None if new_bs is None else jax.tree.map(np.asarray, new_bs)
    jgrads = registry.get_family(arch)["from_jax"](
        {"params": jgrads, "batch_stats": v.get("batch_stats", {})})

    model = port_model(arch, v, backbone, torch.float64)
    before = {k: t.clone()
              for k, t in M.running_buffers(model.state_dict()).items()}
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
                                  has_teacher=False, use_dropout=False,
                                  **(port_kw or {}))
    state, got = step(state, D.torch_batch(arrays))
    assert set(got) == set(want) | {"loss"}
    for k, x in want.items():
        assert got[k].dtype == torch.float64, k
        assert np.isfinite(x) and x != 0, (k, x)
        np.testing.assert_allclose(float(got[k]), x, rtol=rtol, atol=0,
                                   err_msg=k)
    for n in grad_names:
        ref = jgrads[n].double()
        assert float(ref.norm()) > 0, n
        rel = float((seen[n] - ref).norm() / ref.norm())
        assert rel <= rtol, (n, rel)
    if new_bs:
        want_bufs = M.running_buffers(registry.get_family(arch)["from_jax"](
            {"params": v["params"], "batch_stats": new_bs}))
        got_bufs = M.running_buffers(model.state_dict())
        assert sorted(got_bufs) == sorted(want_bufs)
        moved = 0
        for k, t in got_bufs.items():
            w = want_bufs[k].double()
            np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=rtol,
                                       atol=rtol, err_msg=k)
            moved += int(not torch.equal(t, before[k]))
        assert moved > 0
    return got


def check_eval_step(arch, backbone="", seed=5):
    """The registry's eval step of the port on the JAX weights against
    JAX's registry eval step (f32): labels and valid exactly, scores 1e-5,
    boxes 1e-4; some detection kept."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu_torch.eval.evaluator import make_eval_step

    images, img_hw = batch_arrays(seed)[:2]
    v = jax_variables(arch, backbone)
    sf = np.array([[1.0] * 4, [1.25] * 4], np.float32)
    want = jget(arch)["eval_step"](jax_model(arch, backbone), score_thr=0.05,
                                   max_per_img=100, reg_max=16)(
        v, jnp.asarray(images), jnp.asarray(img_hw), jnp.asarray(sf))
    got = make_eval_step(port_model(arch, v, backbone).eval(), 16, 0.05, 100,
                         arch)(torch.from_numpy(images),
                               torch.from_numpy(img_hw), torch.from_numpy(sf))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=1e-4, atol=1e-3)
    assert bool(got.valid.any())
    return got


def check_init_weights(arch, backbone=""):
    """init_weights: a seed gives the same weights, another seed others;
    every BatchNorm the identity; every value finite."""
    from dskd_tpu_torch.utils import config as pconfig
    spec = registry.get_family(arch)
    mcfg = model_cfg(pconfig, arch, backbone)
    a, b, c = (spec["build"](mcfg, "cpu") for _ in range(3))
    spec["init_weights"](a, 3)
    spec["init_weights"](b, 3)
    spec["init_weights"](c, 4)
    differ = 0
    for (n, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), n
        assert bool(torch.isfinite(x).all()), n
        differ += int(not torch.equal(x, z))
        if n.endswith("running_var"):
            assert torch.equal(x, torch.ones_like(x)), n
        if n.endswith("running_mean"):
            assert not x.any(), n
    assert differ > 0
    return a.state_dict()


def jax_backbone(spec):
    if spec.startswith("regnetx"):
        from dskd_tpu.models.regnet import RegNet
        return lambda: RegNet(arch=spec)
    if spec.startswith("effb"):
        from dskd_tpu.models.efficientnet import EfficientNet
        return lambda: EfficientNet(arch=spec[3:], frozen_stages=0)
    if spec.startswith("pvt"):
        from dskd_tpu.models.pvt import PVT
        return lambda: PVT(arch=spec.split("_", 1)[1])
    if spec.startswith("hrnet"):
        from dskd_tpu.models.hrnet import HRNet
        return lambda: HRNet(width=int(spec[len("hrnet_w"):]))
    from dskd_tpu.models.mobilenet_v2 import MobileNetV2
    return lambda: MobileNetV2(out_indices=(2, 4, 6), act="leaky",
                               train_bn=True)


def port_backbone(spec):
    from dskd_tpu_torch.models.backbones import build_backbone
    from dskd_tpu_torch.models.mobilenet_v2 import MobileNetV2
    if spec == "mobilenet_v2":
        return lambda: MobileNetV2("cpu", out_indices=(2, 4, 6), act="leaky",
                                   train_bn=True)
    return lambda: build_backbone(spec, 18, "cpu",
                                  0 if spec.startswith("effb") else 1)[0]


def canvas(h, w, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, h, w, 3) * 0.5, np.array([[h, w]] * B, np.int32)
