"""PAA and LAD on the port against dskd_tpu.models.paa on the CPU, at the
tiny configuration of tests/torch_port_dense_more.py: the forward (1e-4),
``gmm_split`` on seeded candidate sets, all-invalid sets, a single valid
candidate and built ties (the mask exactly), ``paa_loss`` without and with
``assign_out`` in f64 (1e-6 relative), the per-level top-9 on a teacher
whose candidates all tie, ``score_voting`` (1e-5) and ``paa_get_bboxes``
with and without a binding per-level top-k, one family step of each arch
in f64 (LAD's teacher a frozen ResNet-18 of other weights; losses 1e-6,
named gradients 1e-5 relative L2), the registry's eval step and the
seeded init's scales. A teacher of another depth is held in
tests/test_torch_port_ld.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch.models import paa as P

torch.set_num_threads(1)

GRAD_NAMES = ("bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "bbox_head.paa_cls.weight", "bbox_head.paa_reg.weight",
              "bbox_head.paa_iou.weight", "bbox_head.scales.0.scale",
              "neck.lateral_convs.0.conv.weight")


def test_forward_matches_jax():
    images, img_hw = M.batch_arrays("paa")[:2]
    M.assert_forward_matches("paa", M.jax_variables("paa"), images, img_hw)


def _candidate_sets(seed):
    """(G, K) f32 candidate losses and validity: seeded sets with some
    invalid candidates, one all invalid, one with a single valid
    candidate, one of two exact ties, one all equal."""
    rng = np.random.RandomState(seed)
    G, K = 10, 45
    scores = (rng.rand(G, K) * 3).astype(np.float32)
    scores[:3] = np.sort(scores[:3], axis=1) ** 2        # bimodal-ish rows
    valid = rng.rand(G, K) > 0.2
    valid[4] = False                                     # all invalid
    valid[5] = False
    valid[5, 7] = True                                   # one valid
    scores[6] = np.where(np.arange(K) % 2 == 0, 0.25, 2.5)  # two values
    valid[6] = True
    scores[7] = 1.0                                      # all equal
    valid[7] = True
    scores[8, :20] = scores[8, 20:40]                    # paired ties
    return scores, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gmm_split_matches_jax(seed):
    from dskd_tpu.models import paa as J

    scores, valid = _candidate_sets(seed)
    want = np.asarray(jax.jit(jax.vmap(J.gmm_split))(jnp.asarray(scores),
                                                     jnp.asarray(valid)))
    got = P.gmm_split(torch.from_numpy(scores), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[4].any() and want[5].sum() == 1
    assert want.sum() > 10


@pytest.mark.parametrize("arch", ["paa", "lad"])
def test_paa_loss_matches_jax_in_f64(arch):
    M.check_losses_f64(arch, teacher_depth=18 if arch == "lad" else None)


def test_per_level_topk_ties_follow_jax():
    """A teacher whose class logits are one constant and whose deltas are
    0, and a GT 0 around the whole canvas: every level-0 anchor box lies in
    it, so all have the same candidate loss bit for bit and each level's
    top-9 is decided by index alone; the student's losses under that
    assignment (its own outputs spread) match JAX's in f64."""
    images, img_hw, gt, labels, valid = M.batch_arrays("paa", 4)
    gt = gt.astype(np.float64)
    gt[:, 0] = [-100.0, -100.0, 300.0, 300.0]
    valid[:, 0] = True
    jhead = M.jax_head_f64("paa", M.jax_variables("paa"), images, img_hw)
    flat = jhead._replace(
        cls_scores=tuple(np.full_like(a, 0.5) for a in jhead.cls_scores),
        bbox_preds=tuple(np.zeros_like(a) for a in jhead.bbox_preds))
    with jax.enable_x64(True):
        want = jax.jit(lambda h, t, g, lb, vd: M.jax_losses(
            "lad", h, g, lb, vd, t))(jhead, flat, gt, labels, valid)
    got = M.port_losses("lad", M.port_head("lad", jhead),
                        *(torch.from_numpy(a) for a in (gt, labels, valid)),
                        M.port_head("lad", flat))
    for k, x in want.items():
        np.testing.assert_allclose(float(got[k]), float(x), rtol=1e-6,
                                   err_msg=k)
    # the ties are real: every level-0 box of the teacher has one GIoU
    # with GT 0
    from dskd_tpu_torch.core.boxes import bbox_overlaps
    sizes = [tuple(c.shape[1:3]) for c in flat.cls_scores]
    anchors, counts = P.paa_anchors(sizes, "cpu")
    a0 = anchors[:counts[0]].double()
    boxes = P.delta2bbox(a0, torch.zeros_like(a0), stds=P.DELTA_STDS)
    giou = bbox_overlaps(boxes, torch.from_numpy(gt[0, :1]), mode="giou")
    assert counts[0] > 9 and bool((giou == giou[0]).all())


def test_score_voting_matches_jax():
    from dskd_tpu.models import paa as J

    rng = np.random.RandomState(6)
    R, N, C = 12, 40, 5
    B = 2
    xy = rng.rand(B, N, 2) * 50
    cand = np.concatenate([xy, xy + 10 + rng.rand(B, N, 2) * 20], -1)
    det = cand[:, :R] + rng.randn(B, R, 4)
    probs = rng.rand(B, N, C) * 0.3
    labels = rng.randint(-1, C, (B, R))
    args = [a.astype(np.float32) for a in (det, cand, probs)]
    want = jax.jit(jax.vmap(lambda d, l, c, p: J.score_voting(d, l, c, p)))(
        args[0], labels, args[1], args[2])
    got = P.score_voting(torch.from_numpy(args[0]), torch.from_numpy(labels),
                         torch.from_numpy(args[1]), torch.from_numpy(args[2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(np.asarray(want), args[0])


@pytest.mark.parametrize("nms_pre", [1000, 50])
def test_get_bboxes_matches_jax(nms_pre):
    M.check_get_bboxes("paa", nms_pre)


@pytest.mark.parametrize("arch,teacher_depth", [("paa", None),
                                                ("lad", 18)])
def test_family_step_matches_jax_grad_in_f64(arch, teacher_depth):
    M.check_family_step_f64(arch, GRAD_NAMES, teacher_depth=teacher_depth)


def test_eval_step_matches_jax():
    """PAA's registry eval step; LAD registers the same one."""
    from dskd_tpu_torch import registry

    M.check_eval_step("paa")
    assert (registry.get_family("lad")["eval_step"]
            is registry.get_family("paa")["eval_step"])


def test_lad_without_teacher_raises():
    from dskd_tpu_torch.utils.config import ExperimentConfig, ModelConfig
    from dskd_tpu_torch import registry

    cfg = ExperimentConfig(model=ModelConfig(arch="lad", num_classes=D.NC,
                                             depth=18))
    fn = registry.get_family("lad")["losses"](
        None, cfg, num_prev=0, has_teacher=False, use_dropout=False)
    model = M.port_model("lad", M.jax_variables("lad"))
    with pytest.raises(ValueError, match="teacher"):
        fn(model, D.torch_batch(M.batch_arrays("lad")), None, None)


def test_init_weights_scales_and_seed():
    D.check_init_weights("paa", ("bbox_head.cls_convs.0.conv.weight",
                                 "bbox_head.paa_reg.weight"),
                         "bbox_head.paa_cls", -np.log(99))
