"""The rest of the flagship's distillation menu on the port against the JAX
package, on the CPU.

- Every ``core/losses.py`` loss this slice ports (smooth L1, IoU, DIoU,
  CIoU, KD KL, sigmoid focal, gaussian focal, varifocal) against
  dskd_tpu.core.losses: values to test_torch_port_losses' TOL, gradients
  to rtol 1e-4 / atol 1e-6.
- Each distill branch and mode of ``distill_losses``, with each
  ``fix_fg_grad_direction`` value and ``corr_reduction="sum"``, against
  dskd_tpu.distill.losses on the tiny model of test_torch_port_tiny: the
  JAX model's student and teacher outputs, its teacher detections and its
  merged-GT assignment feed both functions (one assignment), and each loss
  and its gradients in the student's head outputs and neck features are
  compared (loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6). The
  comparison runs in f64: the fg, memory and ld_logit KLs of two untrained
  models' near-equal maps are ~1e-5 sums of terms of order 1, where f32
  cancellation alone moves them by up to 0.3%; the f32 path is held to
  JAX's by the train-step tests and the few-step forgetting A/B.
- ``DistillConfig.from_flags`` field by field against JAX's for the flag
  strings of every ``configs/*_il.py`` and of the forgetting A/B.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.core import losses as TL
from dskd_tpu_torch.distill.losses import DistillConfig, distill_losses
from dskd_tpu_torch.distill.teacher import TeacherInfo
from dskd_tpu_torch.models.gfl_detr_head import DetResults, HeadOutputs
from dskd_tpu_torch.models.gfl_detr_loss import LayerTargets

from test_torch_port_losses import TOL, _boxes
from test_torch_port_tiny import TINY, tiny_batch, tiny_variables

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- core losses ------------------------------------------------------------

def _loss_cases():
    """name -> (loss, pred, target, weight, avg_factor, kwargs)."""
    rng = np.random.RandomState(2)
    N, K = 24, 6
    onehot = np.eye(K, dtype=np.float32)[rng.randint(0, K, N)]
    heat = rng.rand(N, K).astype(np.float32) * 0.9
    heat[rng.rand(N, K) < 0.2] = 1.0                  # exact-1 positives
    quality = rng.rand(N, K).astype(np.float32)
    quality[rng.rand(N, K) < 0.6] = 0.0               # negatives
    sig = 1 / (1 + np.exp(-rng.randn(N, K)))
    return {
        "smooth_l1": ("smooth_l1_loss", rng.randn(N, 4) * 2,
                      rng.randn(N, 4) * 2, rng.rand(N, 4), 7.0, {}),
        "smooth_l1_beta": ("smooth_l1_loss", rng.randn(N, 4),
                           rng.randn(N, 4), None, None, {"beta": 0.5}),
        "iou": ("iou_loss", _boxes(rng, N), _boxes(rng, N), rng.rand(N),
                5.0, {}),
        "iou_log": ("iou_loss", _boxes(rng, N), _boxes(rng, N), None, None,
                    {"linear": False}),
        "diou": ("diou_loss", _boxes(rng, N), _boxes(rng, N), rng.rand(N),
                 5.0, {}),
        "ciou": ("ciou_loss", _boxes(rng, N), _boxes(rng, N), rng.rand(N),
                 5.0, {}),
        "kd_kl": ("kd_kl_div_loss", rng.randn(N, K) * 2, rng.randn(N, K) * 2,
                  rng.rand(N), 3.0, {"T": 2.0}),
        "sigmoid_focal": ("sigmoid_focal_loss", rng.randn(N, K) * 2, onehot,
                          None, None, {}),
        "gaussian_focal": ("gaussian_focal_loss", sig, heat, None, 4.0, {}),
        "varifocal": ("varifocal_loss", rng.randn(N, K) * 2, quality,
                      rng.rand(N, K), 6.0, {}),
        "varifocal_unweighted": ("varifocal_loss", rng.randn(N, K),
                                 quality, None, None,
                                 {"iou_weighted": False}),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_core_loss_and_grad_match_jax(case):
    from dskd_tpu.core import losses as JL

    name, pred, target, weight, avg, kw = _loss_cases()[case]
    pred = np.asarray(pred, np.float32)
    target = np.asarray(target, np.float32)
    if avg is not None:
        kw = dict(kw, avg_factor=avg)
    jw = None if weight is None else jnp.asarray(weight, jnp.float32)
    tw = None if weight is None else torch.from_numpy(
        np.asarray(weight, np.float32))
    want, want_g = jax.value_and_grad(lambda p: getattr(JL, name)(
        p, jnp.asarray(target), weight=jw, **kw))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = getattr(TL, name)(tp, torch.from_numpy(target), weight=tw, **kw)
    (got_g,) = torch.autograd.grad(got, [tp])
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **GRAD_TOL)
    elem = getattr(TL, name)(tp.detach(), torch.from_numpy(target),
                             reduction="none", **{k: v for k, v in kw.items()
                                                  if k != "avg_factor"})
    want_elem = getattr(JL, name)(jnp.asarray(pred), jnp.asarray(target),
                                  reduction="none",
                                  **{k: v for k, v in kw.items()
                                     if k != "avg_factor"})
    np.testing.assert_allclose(elem.numpy(), np.asarray(want_elem), **TOL)


# --- distill branches on the tiny model --------------------------------------

SCORE_THR, MAX_PER_IMG, NUM_PREV = 0.3, 20, 5

# case -> DistillConfig fields (every other branch off)
BRANCHES = {
    "soft": dict(soft=True),
    "ld_bbox": dict(ld_bbox=True),
    "ld_logit": dict(ld_logit=True),
    "kldv": dict(feats_kldv=True),
    "memory": dict(memory=True),
    "corr_mean": dict(corr=True),
    "corr_sum": dict(corr=True, corr_reduction="sum"),
    "decode_v1": dict(fg_mode="decode_v1"),
    "decode_v1_fix": dict(fg_mode="decode_v1", fix_fg_grad_direction=True),
    "decode_v2": dict(fg_mode="decode_v2"),
    "decode_v2_fix": dict(fg_mode="decode_v2", fix_fg_grad_direction=True),
    "sg_out": dict(fg_mode="sg_out"),
    "sg_out_fix": dict(fg_mode="sg_out", fix_fg_grad_direction=True),
    "sg_out_no_gt": dict(fg_mode="sg_out", fix_fg_grad_direction=True),
    "fg_only": dict(fg_mode="fg_only"),
    "fg_only_fix": dict(fg_mode="fg_only", fix_fg_grad_direction=True),
    "all": dict(soft=True, ld_bbox=True, ld_logit=True, feats_kldv=True,
                memory=True, corr=True, fg_mode="decode_v1"),
}
# the student outputs the distills differentiate in
DIFF = ("cls_scores", "bbox_preds", "memory", "hs")


@pytest.fixture(scope="module")
def tiny_outputs():
    """The JAX tiny model's student and teacher products on tiny_batch(),
    and the merged-GT detection targets: the inputs both distill_losses
    read."""
    from dskd_tpu.distill.teacher import merge_teacher_gt
    from dskd_tpu.models.detector import GFLDeformableDETR as JaxDETR
    from dskd_tpu.models.gfl_detr_loss import DetLossConfig as JDet
    from dskd_tpu.models.gfl_detr_loss import detection_loss
    from dskd_tpu.train.step import Batch as JBatch
    from dskd_tpu.train.step import teacher_info

    model = JaxDETR(**TINY, remat=False)
    student = tiny_variables(seed=11)
    teacher = tiny_variables(seed=12, cls_scale=4.0)
    batch = JBatch(*(jnp.asarray(a) for a in tiny_batch()))
    out = model.apply(student, batch.images, batch.img_hw,
                      deterministic=True)
    det_cfg = JDet(num_classes=TINY["num_classes"])
    tinfo = teacher_info(model, teacher, batch, det_cfg, SCORE_THR,
                         MAX_PER_IMG)
    merged = merge_teacher_gt(tinfo.det, batch.gt_bboxes, batch.gt_labels,
                              batch.gt_valid)
    _, targets = detection_loss(out.head.cls_scores, out.head.bbox_preds,
                                *merged, batch.img_hw, det_cfg)
    assert int(tinfo.det.valid.sum()) > 0
    return jax.tree_util.tree_map(_f64, dict(
        head=out.head, neck=tuple(out.neck_feats), tinfo=tinfo,
        targets=targets, batch=batch)), int(merged[0].shape[1])


def _f64(x):
    x = np.asarray(x)
    return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) \
        else x


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_teacher(tinfo):
    return TeacherInfo(tuple(_t(f) for f in tinfo.neck_feats),
                       _t(tinfo.cls_scores), _t(tinfo.bbox_preds),
                       _t(tinfo.memory), _t(tinfo.hs),
                       DetResults(*(_t(a) for a in tinfo.det)))


@pytest.mark.parametrize("case", sorted(BRANCHES))
def test_distill_branch_matches_jax(tiny_outputs, case):
    from dskd_tpu.distill.losses import DistillConfig as JDistill
    from dskd_tpu.distill.losses import distill_losses as jdistill

    o, num_merged = tiny_outputs
    fields = dict(dict(corr=False, fg_mode="", num_prev=NUM_PREV),
                  **BRANCHES[case])
    jcfg, tcfg = JDistill(**fields), DistillConfig(**fields)
    assert tuple(tcfg) == tuple(jcfg)
    batch = o["batch"]
    gt_kw = {} if case == "sg_out_no_gt" else dict(
        gt_bboxes_original=batch.gt_bboxes,
        gt_valid_original=batch.gt_valid)

    with jax.enable_x64(True):
        jo = jax.tree_util.tree_map(jnp.asarray, (o, gt_kw))[0]
        jgt = {k: jnp.asarray(v) for k, v in gt_kw.items()}

        def jax_total(diff, neck):
            head = jo["head"]._replace(**diff)
            losses = jdistill(head, neck, jo["tinfo"], jo["targets"],
                              jo["batch"].img_hw, TINY["num_classes"],
                              jcfg, num_merged, **jgt)
            return sum(losses.values()), losses

        diff = {k: getattr(jo["head"], k) for k in DIFF}
        (_, want), (want_g, want_gn) = jax.value_and_grad(
            jax_total, argnums=(0, 1), has_aux=True)(diff, jo["neck"])
        want = {k: float(v) for k, v in want.items()}
        want_g = {k: np.asarray(v) for k, v in want_g.items()}
        want_gn = [np.asarray(v) for v in want_gn]

    tdiff = {k: _t(getattr(o["head"], k)).requires_grad_(True)
             for k in DIFF}
    tneck = tuple(_t(f).requires_grad_(True) for f in o["neck"])
    head = HeadOutputs(mask_flat=_t(o["head"].mask_flat), **tdiff)
    targets = LayerTargets(*(_t(a) for a in o["targets"]))
    tgt_kw = {k: _t(v) for k, v in gt_kw.items()}
    got = distill_losses(head, tneck, _port_teacher(o["tinfo"]), targets,
                         _t(batch.img_hw), TINY["num_classes"], tcfg,
                         num_merged, **tgt_kw)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(float(got[k].detach()), v, rtol=1e-5,
                                   err_msg=k)
    leaves = list(tdiff.values()) + list(tneck)
    total = sum(got.values())
    grads = torch.autograd.grad(total, leaves, allow_unused=True) \
        if total.requires_grad else [None] * len(leaves)
    refs = [want_g[k] for k in tdiff] + list(want_gn)
    names = list(tdiff) + [f"neck{i}" for i in range(len(tneck))]
    for name, g, ref, x in zip(names, grads, refs, leaves):
        ref = np.asarray(ref)
        got_g = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got_g, ref, **GRAD_TOL, err_msg=name)
    if case in ("sg_out", "fg_only", "decode_v2"):
        # the reference's direction gives the student no gradient (decode_v1
        # keeps one through its semantic mask)
        assert all(not np.asarray(r).any() for r in refs)
        assert all(g is None or not g.any() for g in grads)
    if case.endswith("_fix"):
        # the swapped direction does reach the student
        assert any(np.asarray(r).any() for r in refs)


def test_kept_query_weight_is_a_scatter_max():
    """ld_bbox / ld_logit weight the teacher's kept queries as JAX's
    ``.at[b, keep_qid].max(valid)`` does: a padded (invalid) entry that
    repeats a kept query must not clear it, as an overwrite would."""
    from dskd_tpu_torch.distill.losses import _kept_query_weight

    keep = np.array([[3, 5, 3, 3], [0, 1, 2, 0]], np.int32)
    valid = np.array([[True, True, False, False], [False, True, True,
                                                   False]])
    want = jnp.zeros((2, 7)).at[jnp.arange(2)[:, None], keep].max(
        jnp.asarray(valid, jnp.float32))
    det = DetResults(None, None, None, None, torch.from_numpy(keep),
                     torch.from_numpy(valid))
    got = _kept_query_weight(det, 2, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 3] == 1 and got[1, 0] == 0


# --- from_flags --------------------------------------------------------------

# the forgetting A/B's flag strings (tools/ab_forgetting.py,
# tests/test_forgetting_ab.py)
AB_FLAGS = [dict(cates_distill="hard + teacher-first + soft",
                 feats_distill="corr + fg_info + decode_v1"),
            dict(cates_distill="hard + teacher-first",
                 feats_distill="corr + fg_info + decode_v1")]


def _il_flags():
    from dskd_tpu.utils.config import load_config

    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*_il.py"))):
        cfg = load_config(path)
        d = cfg.distill
        out[os.path.basename(path)] = (dict(
            cates_distill=d.cates_distill, locat_distill=d.locat_distill,
            feats_distill=d.feats_distill,
            memory_distill=d.memory_distill), dict(
            num_prev=cfg.data.catsplit[0], reg_max=cfg.model.reg_max,
            fix_fg_grad_direction=d.fix_fg_grad_direction))
    for i, flags in enumerate(AB_FLAGS):
        out[f"ab_forgetting_{i}"] = (flags, dict(num_prev=2))
    return out


def test_from_flags_matches_jax_on_every_il_config():
    from dskd_tpu.distill.losses import DistillConfig as JDistill

    cases = _il_flags()
    assert len(cases) == 7 + len(AB_FLAGS)
    assert DistillConfig._fields == JDistill._fields
    assert DistillConfig._field_defaults == JDistill._field_defaults
    for name, (flags, kw) in cases.items():
        want = JDistill.from_flags(**flags, **kw)
        got = DistillConfig.from_flags(**flags, **kw)
        assert got._asdict() == want._asdict(), name
    for fix in (False, True):
        flags = dict(cates_distill="hard + teacher-first + soft",
                     locat_distill="bbox + logit", feats_distill="kldv + "
                     "corr + fg_info + sg_out", memory_distill="memory")
        assert DistillConfig.from_flags(
            **flags, fix_fg_grad_direction=fix)._asdict() == \
            JDistill.from_flags(**flags, fix_fg_grad_direction=fix)._asdict()
