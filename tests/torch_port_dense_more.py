"""Shared fixtures of the CPU tests of LD, PAA, LAD, the RetinaNet
variants (PISA, GHM, FPG, NAS-FPN) and the dense heads TOOD, FSAF,
FoveaBox, AutoAssign, FreeAnchor and SABL (``HEAD_FAMILIES``) on the port
against dskd_tpu.models.

The tiny configuration is tests/torch_port_dense.py's: ResNet-18, the
full 256-wide necks and 4-conv towers, 10 classes, B=2 on 72x88 (one image
of 60x80 valid pixels); NAS-FPN, whose nearest upsampling needs sizes that
divide, runs on 64x64 (one image of 48x60). Teachers of another depth are
ResNet-101. Weights: a JAX variables tree of the family's module (shapes
by ``jax.eval_shape``, values drawn with numpy from a seed, GHM's EMAs
included), carried to the port by the registry's ``from_jax``.
"""
import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_dense as D
from dskd_tpu_torch import registry

NC = D.NC
B = D.B
IMG_HW_64 = np.array([[64, 64], [48, 60]], np.int32)


def batch_arrays(arch, seed=0):
    """``D.batch_arrays`` on 72x88, or boxes of 8-46 pixels on 64x64 for
    NAS-FPN."""
    if arch != "retinanet_nasfpn":
        return D.batch_arrays(seed)
    rng = np.random.RandomState(seed)
    G = 6
    images = (rng.randn(B, 64, 64, 3) * 0.5).astype(np.float32)
    wh = np.minimum(rng.rand(B, G, 2) * 38 + 8, IMG_HW_64[:, None, ::-1] - 2)
    xy = rng.rand(B, G, 2) * (IMG_HW_64[:, None, ::-1] - wh)
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, NC, (B, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array([4, 6])[:, None]
    return images, IMG_HW_64, gt, labels, valid


# arch -> (module name in both packages, JAX module class, port head
# outputs class); FreeAnchor is JAX's RetinaNet
HEAD_FAMILIES = {
    "tood": ("tood", "TOOD", "TOODHeadOutputs"),
    "fsaf": ("fsaf", "FSAF", "FSAFHeadOutputs"),
    "foveabox": ("foveabox", "FoveaBox", "FoveaHeadOutputs"),
    "autoassign": ("autoassign", "AutoAssign", "AutoAssignHeadOutputs"),
    "free_anchor": ("free_anchor", None, None),
    "sabl_retina": ("sabl_retina", "SABLRetinaNet", "SABLHeadOutputs")}
F64_RTOL = 1e-8          # the head families' f64 losses and gradients


def head_module(pkg, arch):
    """The family's module of ``pkg`` ("dskd_tpu" or "dskd_tpu_torch")."""
    return importlib.import_module(f"{pkg}.models.{HEAD_FAMILIES[arch][0]}")


def jax_model(arch, depth=18):
    from dskd_tpu.models.gfl import GFL
    from dskd_tpu.models.paa import PAA
    from dskd_tpu.models.retinanet import RetinaNet
    if arch in HEAD_FAMILIES and HEAD_FAMILIES[arch][1]:
        return getattr(head_module("dskd_tpu", arch),
                       HEAD_FAMILIES[arch][1])(num_classes=NC, depth=depth)
    if arch == "ld":
        return GFL(num_classes=NC, depth=depth)
    if arch in ("paa", "lad"):
        return PAA(num_classes=NC, depth=depth)
    neck = {"retinanet_fpg": "fpg", "retinanet_nasfpn": "nasfpn"}.get(arch,
                                                                      "fpn")
    return RetinaNet(num_classes=NC, depth=depth, neck=neck,
                     ghm=arch == "retinanet_ghm")


@contextlib.contextmanager
def cut_stacks(fpg=3, nasfpn=2):
    """FPG and NAS-FPN with ``fpg`` and ``nasfpn`` stacks in both packages'
    RetinaNet (the JAX tests cut them so, tests/test_fpg.py and
    tests/test_nas_fpn.py), while the block runs."""
    import dskd_tpu.models.fpg as jfpg
    import dskd_tpu.models.nas_fpn as jnas
    from dskd_tpu_torch.models import retinanet as pret

    def forced(cls, n):
        # JAX's RetinaNet passes NAS-FPN's stack_times itself
        return lambda *a, **kw: cls(*a, **{**kw, "stack_times": n})

    saved = (jfpg.FPG, jnas.NASFPN, pret.FPG, pret.NASFPN)
    jfpg.FPG, pret.FPG = forced(saved[0], fpg), forced(saved[2], fpg)
    jnas.NASFPN = forced(saved[1], nasfpn)
    pret.NASFPN = forced(saved[3], nasfpn)
    _CUT.append((fpg, nasfpn))
    try:
        yield
    finally:
        _CUT.pop()
        jfpg.FPG, jnas.NASFPN, pret.FPG, pret.NASFPN = saved


_CUT = []


def jax_apply(arch, depth=18, train=False):
    """The jitted apply; ``train``: NAS-FPN's train-mode forward, which
    returns (outputs, mutated batch_stats)."""
    return _jax_apply(arch, depth, train, tuple(_CUT))


@functools.lru_cache(maxsize=None)
def _jax_apply(arch, depth, train, cut):
    model = jax_model(arch, depth)
    if train:
        return jax.jit(lambda v, x, hw: model.apply(
            v, x, hw, deterministic=False, mutable=["batch_stats"]))
    return jax.jit(model.apply)


def _fill(path, shape, rng):
    leaf = str(getattr(path[-1], "key", path[-1]))
    if leaf.startswith("ghm_acc"):
        return rng.rand(*shape) * 50.0
    if leaf == "center_prior_mean":          # AutoAssign's, stride units
        return 0.3 * rng.randn(*shape)
    if leaf == "center_prior_sigma":
        return 1.0 + 0.2 * rng.rand(*shape)
    return D._fill(path, shape, rng)


def _variables(arch, depth, seed):
    return _variables_cut(arch, depth, seed, tuple(_CUT))


@functools.lru_cache(maxsize=None)
def _variables_cut(arch, depth, seed, cut):
    shapes = jax.eval_shape(jax_model(arch, depth).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray(IMG_HW_64[:1]))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_fill(p, s.shape, rng), np.float32), shapes)


def jax_variables(arch, depth=18, seed=0):
    return jax.tree.map(np.copy, _variables(arch, depth, seed))


def model_cfg(mod, arch, depth=18, teacher_depth=None):
    return mod.ModelConfig(arch=arch, num_classes=NC, depth=depth,
                           teacher_depth=teacher_depth)


def port_model(arch, variables, depth=18, dtype=torch.float32):
    from dskd_tpu_torch.utils import config as pconfig
    spec = registry.get_family(arch)
    model = spec["build"](model_cfg(pconfig, arch, depth), "cpu")
    model.load_state_dict(spec["from_jax"](variables), strict=True)
    return model.to(dtype)


def assert_forward_matches(arch, v, images, img_hw, depth=18):
    """Every head output and neck level of the port (eval mode) against
    JAX's (D.FWD_TOL); returns JAX's outputs."""
    want = jax_apply(arch, depth)(v, jnp.asarray(images), jnp.asarray(img_hw))
    got = port_model(arch, v, depth).eval()(torch.from_numpy(images),
                                            torch.from_numpy(img_hw))
    for field in want.head._fields:
        for lvl, (g, w) in enumerate(zip(getattr(got.head, field),
                                         getattr(want.head, field))):
            assert tuple(g.shape) == tuple(w.shape), (field, lvl)
            np.testing.assert_allclose(D._np(g), np.asarray(w),
                                       err_msg=f"{field} {lvl}", **D.FWD_TOL)
    for lvl, (g, w) in enumerate(zip(got.neck_feats, want.neck_feats)):
        np.testing.assert_allclose(D._np(g.permute(0, 2, 3, 1)),
                                   np.asarray(w), err_msg=f"neck {lvl}",
                                   **D.FWD_TOL)
    return want


def port_head(arch, jhead):
    """JAX head outputs (arrays) -> the port's head NamedTuple."""
    from dskd_tpu_torch.models import gfl_head, paa, retinanet
    if arch in HEAD_FAMILIES and HEAD_FAMILIES[arch][2]:
        cls = getattr(head_module("dskd_tpu_torch", arch),
                      HEAD_FAMILIES[arch][2])
        return cls(*(tuple(torch.from_numpy(np.array(x)) for x in field)
                     for field in jhead))
    cls = (gfl_head.GFLHeadOutputs if arch == "ld" else
           paa.PAAHeadOutputs if arch in ("paa", "lad") else
           retinanet.RetinaHeadOutputs)
    return cls(*(tuple(torch.from_numpy(np.array(x)) for x in field)
                 for field in jhead))


def _sizes(head):
    return [tuple(int(s) for s in c.shape[1:3]) for c in head.cls_scores]


def head_losses(pkg, arch, head, gt, labels, valid, priors=None,
                use_tal=True):
    """The losses of a head family of ``pkg`` on head outputs ``head``
    (AutoAssign's with its centre ``priors`` (mean, sigma); TOOD's TAL
    or, ``use_tal=False``, the first epochs' ATSS path)."""
    M = head_module(pkg, arch)
    dev = () if pkg == "dskd_tpu" else ("cpu",)
    sizes = _sizes(head)
    if arch == "tood":
        points, anchors, counts = M.tood_points(sizes, *dev)
        return M.tood_loss(head, points, anchors, counts, gt, labels, valid,
                           M.TOODLossConfig(num_classes=NC), use_tal=use_tal)
    if arch == "fsaf":
        return M.fsaf_loss(head, gt, labels, valid,
                           M.FSAFLossConfig(num_classes=NC))
    if arch == "foveabox":
        return M.fovea_loss(head, gt, labels, valid,
                            M.FoveaLossConfig(num_classes=NC))
    if arch == "autoassign":
        return M.autoassign_loss(head, *priors, gt, labels, valid,
                                 M.AutoAssignLossConfig(num_classes=NC))
    if arch == "free_anchor":
        return M.free_anchor_loss(head, M.retina_anchors(sizes, *dev), gt,
                                  labels, valid,
                                  M.FreeAnchorLossConfig(num_classes=NC))
    squares, approxs = M.sabl_anchors(sizes, *dev)
    return M.sabl_loss(head, squares, approxs, gt, labels, valid,
                       M.SABLLossConfig(num_classes=NC))


def head_get_bboxes(pkg, arch, head, img_hw, **kw):
    """The decode of a head family of ``pkg`` on head outputs ``head``."""
    M = head_module(pkg, arch)
    dev = () if pkg == "dskd_tpu" else ("cpu",)
    sizes = _sizes(head)
    if arch == "tood":
        # JAX's takes the points and reads none of them
        points = (M.tood_points(sizes)[0],) if pkg == "dskd_tpu" else ()
        return M.tood_get_bboxes(head, *points, img_hw, **kw)
    if arch == "fsaf":
        return M.fsaf_get_bboxes(head, img_hw, **kw)
    if arch == "foveabox":
        return M.fovea_get_bboxes(head, img_hw, **kw)
    if arch == "autoassign":
        return M.autoassign_get_bboxes(head, img_hw, **kw)
    if arch == "free_anchor":
        return M.retina_get_bboxes(head, M.retina_anchors(sizes, *dev),
                                   img_hw, delta_stds=M.DELTA_STDS, **kw)
    return M.sabl_get_bboxes(head, M.sabl_anchors(sizes, *dev)[0], img_hw,
                             **kw)


@contextlib.contextmanager
def f64_anchors():
    """SABL's square and approx anchors in f64 in both packages while the
    block runs, for the f64 comparisons: from f32 anchors the bucket
    centres (side + (i + 0.5) x bucket width) that XLA computes in one
    fused kernel part from eager torch's by an f32 rounding (6e-8 of
    loss_bbox_reg)."""
    mods = [head_module(pkg, "sabl_retina")
            for pkg in ("dskd_tpu", "dskd_tpu_torch")]
    saved = [m.sabl_anchors for m in mods]

    def f64(fn):
        return lambda *a: tuple(x.astype(np.float64) if isinstance(
            x, jnp.ndarray) else x.double() for x in fn(*a))

    for m, fn in zip(mods, saved):
        m.sabl_anchors = f64(fn)
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.sabl_anchors = fn


def jax_losses(arch, head, gt, labels, valid, teacher_head=None,
               ghm_state=None):
    """JAX's losses of head outputs ``head`` (LD's and LAD's with the
    teacher's ``teacher_head``; GHM's -> (losses, new state); a head
    family's with ``teacher_head`` its extra inputs, AutoAssign's
    priors)."""
    if arch in HEAD_FAMILIES:
        return head_losses("dskd_tpu", arch, head, gt, labels, valid,
                           teacher_head)
    if arch == "ld":
        from dskd_tpu.models import ld
        from dskd_tpu.models.gfl_head import GFLLossConfig
        return ld.ld_loss(head, teacher_head, gt, labels, valid,
                          ld.LDLossConfig(GFLLossConfig(num_classes=NC)))
    if arch in ("paa", "lad"):
        from dskd_tpu.models import paa
        anchors, counts = paa.paa_anchors(_sizes(head))
        return paa.paa_loss(head, anchors, counts, gt, labels, valid,
                            paa.PAALossConfig(num_classes=NC),
                            assign_out=teacher_head)
    from dskd_tpu.models import retinanet as J
    ghm = arch == "retinanet_ghm"
    cfg = J.RetinaLossConfig(num_classes=NC, ghm=ghm,
                             loss_bbox_weight=10.0 if ghm else 1.0)
    return J.retina_detection_loss(
        head, J.retina_anchors(_sizes(head)), gt, labels, valid, cfg,
        pisa=arch == "pisa_retinanet", ghm_state=ghm_state)


def port_losses(arch, head, gt, labels, valid, teacher_head=None,
                ghm_state=None):
    if arch in HEAD_FAMILIES:
        return head_losses("dskd_tpu_torch", arch, head, gt, labels, valid,
                           teacher_head)
    if arch == "ld":
        from dskd_tpu_torch.models import ld
        from dskd_tpu_torch.models.gfl_head import GFLLossConfig
        return ld.ld_loss(head, teacher_head, gt, labels, valid,
                          ld.LDLossConfig(GFLLossConfig(num_classes=NC)))
    if arch in ("paa", "lad"):
        from dskd_tpu_torch.models import paa
        anchors, counts = paa.paa_anchors(_sizes(head), "cpu")
        return paa.paa_loss(head, anchors, counts, gt, labels, valid,
                            paa.PAALossConfig(num_classes=NC),
                            assign_out=teacher_head)
    from dskd_tpu_torch.models import retinanet as P
    ghm = arch == "retinanet_ghm"
    cfg = P.RetinaLossConfig(num_classes=NC, ghm=ghm,
                             loss_bbox_weight=10.0 if ghm else 1.0)
    return P.retina_detection_loss(
        head, P.retina_anchors(_sizes(head), "cpu"), gt, labels, valid, cfg,
        pisa=arch == "pisa_retinanet", ghm_state=ghm_state)


def jax_head_f64(arch, v, images, img_hw, depth=18):
    return D.f64(jax_apply(arch, depth)(v, jnp.asarray(images),
                                        jnp.asarray(img_hw)).head)


def check_losses_f64(arch, seed=1, teacher_depth=None, rtol=1e-6):
    """The losses of the JAX model's head outputs on batch ``seed`` in f64
    in both packages (``rtol`` relative; LD and LAD with a teacher of
    ``teacher_depth``, GHM with its EMAs, which must match too, AutoAssign
    with its centre priors); every loss finite and not 0. Returns the
    losses."""
    images, img_hw, gt, labels, valid = batch_arrays(arch, seed)
    v = jax_variables(arch)
    jhead = jax_head_f64(arch, v, images, img_hw)
    thead = pthead = None
    if teacher_depth:
        tv = jax_variables(arch, teacher_depth, seed=1)
        thead = jax_head_f64(arch, tv, images, img_hw, teacher_depth)
        pthead = port_head(arch, thead)
    if arch == "autoassign":
        p = v["params"]
        thead = tuple(np.asarray(p[k], np.float64) for k in (
            "center_prior_mean", "center_prior_sigma"))
        pthead = tuple(torch.from_numpy(a) for a in thead)
    ghm = None
    if arch == "retinanet_ghm":
        ghm = {k: np.asarray(v["batch_stats"][f"ghm_{k}"], np.float64)
               for k in ("acc_c", "acc_r")}
    gt = gt.astype(np.float64)
    with jax.enable_x64(True):
        want = jax.jit(lambda h, t, g, lb, vd, s: jax_losses(
            arch, h, g, lb, vd, t, s))(jhead, thead, gt, labels, valid, ghm)
        want = jax.tree.map(np.asarray, want)
    got = port_losses(
        arch, port_head(arch, jhead), *(torch.from_numpy(a) for a in (
            gt, labels, valid)), pthead,
        None if ghm is None else {k: torch.from_numpy(a)
                                  for k, a in ghm.items()})
    if ghm is not None:
        (want, want_state), (got, got_state) = want, got
        for k in ("acc_c", "acc_r"):
            np.testing.assert_allclose(got_state[k].numpy(), want_state[k],
                                       rtol=1e-6, atol=0, err_msg=k)
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert got[k].dtype == torch.float64, k
        assert np.isfinite(x) and x != 0, (k, x)
        np.testing.assert_allclose(float(got[k]), float(x), rtol=rtol,
                                   atol=0, err_msg=k)
    return got


def check_family_step_f64(arch, grad_names, seed=2, teacher_depth=None,
                          rtol=None):
    """One generic step of the port's family in f64 (weights from
    ``from_jax``; LD and LAD with a frozen teacher of ``teacher_depth``)
    against ``jax.value_and_grad`` of JAX's registry losses_fn in f64:
    every loss (1e-6 relative) and the gradients of ``grad_names`` that the
    step's clip sees (1e-5 relative L2), or both within ``rtol`` where it
    is given, each gradient not 0. Returns (the port's model after
    the step, its state_dict before, JAX's new batch_stats or None)."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu.train.step import parse_losses as jparse
    from dskd_tpu.utils import config as jconfig
    from dskd_tpu_torch.train.family import make_family_train_step
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState, frozen_copy
    from dskd_tpu_torch.utils import config as pconfig

    def cfg(mod):
        return mod.ExperimentConfig(model=model_cfg(
            mod, arch, teacher_depth=teacher_depth))

    v = jax_variables(arch)
    tv = None if not teacher_depth else jax_variables(arch, teacher_depth, 1)
    arrays = list(batch_arrays(arch, seed))
    arrays[0] = arrays[0].astype(np.float64)
    arrays[2] = arrays[2].astype(np.float64)
    losses_fn = jget(arch)["losses"](jax_model(arch), cfg(jconfig),
                                     has_teacher=tv is not None,
                                     use_dropout=False)
    with jax.enable_x64(True):
        v64 = D.f64(v)
        tv64 = None if tv is None else D.f64(tv)
        jb = D.jax_batch(arrays)

        def total(params):
            losses, stats = losses_fn({"params": params,
                                       "batch_stats": v64["batch_stats"]},
                                      jb, tv64, jax.random.PRNGKey(0))
            return jparse(losses), (losses, stats)

        (_, (want, new_bs)), jgrads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(v64["params"])
        want = {k: float(x) for k, x in want.items()}
        jgrads = jax.tree.map(np.asarray, jgrads)
        new_bs = None if new_bs is None else jax.tree.map(np.asarray, new_bs)
    jgrads = registry.get_family(arch)["from_jax"](
        {"params": jgrads, "batch_stats": v["batch_stats"]})

    model = port_model(arch, v, dtype=torch.float64)
    teacher = None if tv is None else frozen_copy(
        port_model(arch, tv, teacher_depth, torch.float64))
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
    step = make_family_train_step(arch, model, cfg(pconfig), num_prev=0,
                                  has_teacher=tv is not None,
                                  use_dropout=False)
    state, got = step(state, D.torch_batch(arrays), teacher)
    assert state.step == 1
    assert set(got) == set(want) | {"loss"}
    for k, x in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(float(got[k]), x, rtol=rtol or 1e-6,
                                   atol=0, err_msg=k)
    for n in grad_names:
        ref = jgrads[n].double()
        assert rtol is None or float(ref.norm()) > 0, n
        rel = float((seen[n] - ref).norm() / ref.norm())
        assert rel <= (rtol or 1e-5), (n, rel)
    return model, before, new_bs


def check_get_bboxes(arch, nms_pre=1000, seed=3):
    """The decode of the JAX model's head outputs (f32) in both packages
    through the registry's eval-step decode, rescaled: labels and valid
    exactly, scores 1e-6, boxes 1e-5; each image keeps detections.
    Returns the port's detections."""
    images, img_hw = batch_arrays(arch, seed)[:2]
    v = jax_variables(arch)
    jhead = jax.tree.map(np.asarray, jax_apply(arch)(
        v, jnp.asarray(images), jnp.asarray(img_hw)).head)
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [2.0, 1.5, 2.0, 1.5]], np.float32)
    kw = dict(score_thr=0.05, max_per_img=100, nms_pre=nms_pre,
              rescale=True)
    sizes = _sizes(jhead)
    if arch in HEAD_FAMILIES:
        want = jax.jit(lambda h, hw, s: head_get_bboxes(
            "dskd_tpu", arch, h, hw, scale_factor=s, **kw))(jhead, img_hw,
                                                             sf)
        got = head_get_bboxes("dskd_tpu_torch", arch, port_head(arch, jhead),
                              torch.from_numpy(img_hw),
                              scale_factor=torch.from_numpy(sf), **kw)
    elif arch == "ld":
        from dskd_tpu.models import gfl_head as J
        from dskd_tpu_torch.models import gfl_head as P
        want = jax.jit(lambda h, hw, s: J.gfl_get_bboxes(
            h, hw, scale_factor=s, **kw))(jhead, img_hw, sf)
        got = P.gfl_get_bboxes(port_head(arch, jhead),
                               torch.from_numpy(img_hw),
                               scale_factor=torch.from_numpy(sf), **kw)
    elif arch in ("paa", "lad"):
        from dskd_tpu.models import paa as J
        from dskd_tpu_torch.models import paa as P
        want = jax.jit(lambda h, hw, s: J.paa_get_bboxes(
            h, J.paa_anchors(sizes)[0], hw, scale_factor=s, **kw))(
            jhead, img_hw, sf)
        got = P.paa_get_bboxes(port_head(arch, jhead),
                               P.paa_anchors(sizes, "cpu")[0],
                               torch.from_numpy(img_hw),
                               scale_factor=torch.from_numpy(sf), **kw)
    else:
        from dskd_tpu.models import retinanet as J
        from dskd_tpu_torch.models import retinanet as P
        want = jax.jit(lambda h, hw, s: J.retina_get_bboxes(
            h, J.retina_anchors(sizes), hw, scale_factor=s, **kw))(
            jhead, img_hw, sf)
        got = P.retina_get_bboxes(port_head(arch, jhead),
                                  P.retina_anchors(sizes, "cpu"),
                                  torch.from_numpy(img_hw),
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


def check_eval_step(arch, depth=18):
    """The registry's eval step of the port on the JAX weights against
    JAX's registry eval step: labels and valid exactly, scores 1e-5,
    boxes 1e-4."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu_torch.eval.evaluator import make_eval_step

    images, img_hw = batch_arrays(arch, 5)[:2]
    v = jax_variables(arch, depth)
    sf = np.array([[1.0] * 4, [1.25] * 4], np.float32)
    want = jget(arch)["eval_step"](jax_model(arch, depth), score_thr=0.05,
                                   max_per_img=100, reg_max=16)(
        v, jnp.asarray(images), jnp.asarray(img_hw), jnp.asarray(sf))
    got = make_eval_step(port_model(arch, v, depth).eval(), 16, 0.05, 100,
                         arch)(torch.from_numpy(images),
                               torch.from_numpy(img_hw), torch.from_numpy(sf))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=1e-4, atol=1e-3)
    return got


def running_buffers(state_dict):
    return {k: t for k, t in state_dict.items()
            if k.endswith(("running_mean", "running_var"))
            or k.startswith("ghm_acc_")}


def assert_buffers_match(model, arch, variables, tol=1e-5):
    """The port model's running buffers (BatchNorm and GHM) against those
    of the JAX ``variables`` through ``from_jax``."""
    want = running_buffers(registry.get_family(arch)["from_jax"](variables))
    got = running_buffers(model.state_dict())
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        np.testing.assert_allclose(t.detach().double().numpy(),
                                   want[k].double().numpy(), rtol=tol,
                                   atol=tol, err_msg=k)
