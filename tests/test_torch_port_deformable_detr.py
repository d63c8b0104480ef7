"""The vanilla Deformable-DETR family (base, box refinement, two-stage) on
the port against dskd_tpu.models.deformable_detr on the CPU.

The tiny model of tests/test_deformable_detr.py: ResNet-18, 1 encoder and
2 decoder layers, 8 queries, 6 classes, a 64x64 canvas and B=2, with
valid sizes 64x50 and 48x64 (not square, so the padding masks and valid
ratios differ per axis); weights are a JAX init carried to the port by the
registry's ``from_jax``, with random regression-output kernels where a
case needs the refinement to move the boxes.

- the forward for (refine, two_stage) in {(F, F), (T, F), (T, T)}, f32,
  1e-4, and the two-stage one with ``DSKD_FORCE_MXU=1`` (JAX's Pallas
  kernels in interpret mode);
- a two-stage top-k whose class-0 scores all tie: the lowest tokens win,
  as ``lax.top_k`` picks them;
- ``deformable_detr_loss`` in f64, with the encoder losses, G <= Q and
  G > Q (1e-6 relative; the gradients in the outputs 1e-6);
- ``deformable_detr_get_bboxes`` with non-square images, clamps on both
  axes and ``rescale``;
- one generic family step's losses (1e-3 relative) and five named
  gradients (1e-3 relative L2), the two-stage case also with
  ``DSKD_FORCE_MXU=1``; the refined references and the top-k proposals are
  detached, which only the gradients show;
- the zero-init invariants of tests/test_deformable_detr.py on the port's
  own init, and its initializer scales;
- the registry's eval step against JAX's.
The two-task run is in test_torch_port_deformable_detr_incremental.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch import registry
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.models import deformable_detr as PD
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState
from dskd_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

B, HW, NC, Q = 2, 64, 6, 8
TINY = dict(num_classes=NC, num_query=Q, depth=18, num_encoder_layers=1,
            num_decoder_layers=2)
IMG_HW = np.array([[64, 50], [48, 64]], np.int32)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = [(False, False), (True, False), (True, True)]
LADDER = np.array([0.05 * 2 ** lvl for lvl in range(4)])


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, under DSKD_FORCE_MXU=1."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{"interpret": True, **k}))
    monkeypatch.setenv("DSKD_FORCE_MXU", "1")


def jax_model(refine, two_stage):
    from dskd_tpu.models.deformable_detr import DeformableDETR
    return DeformableDETR(dropout=0.0, remat=False, with_box_refine=refine,
                          as_two_stage=two_stage, **TINY)


@functools.lru_cache(maxsize=None)
def _jax_init(refine, two_stage):
    return jax.tree.map(np.asarray, jax.jit(jax_model(refine, two_stage).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)),
        jnp.asarray(IMG_HW[:1])))


def jax_variables(refine, two_stage, reg_scale=0.05, seed=0):
    """The JAX init; ``reg_scale`` > 0 gives each regression output a
    random kernel of that scale, so that refinement moves the boxes."""
    v = jax.tree.map(np.copy, _jax_init(refine, two_stage))
    rng = np.random.RandomState(seed)
    hp = v["params"]["bbox_head"]
    for k in sorted(hp):
        if k.endswith("_out") and reg_scale:
            hp[k]["kernel"] = (rng.randn(*hp[k]["kernel"].shape)
                               * reg_scale).astype(np.float32)
    return v


def model_cfg(mod, refine, two_stage):
    return mod.ModelConfig(arch="deformable_detr", dropout=0.0,
                           with_box_refine=refine, as_two_stage=two_stage,
                           **TINY)


def port_model(variables, refine, two_stage):
    spec = registry.get_family("deformable_detr")
    model = spec["build"](model_cfg(pconfig, refine, two_stage), "cpu")
    model.load_state_dict(spec["from_jax"](variables), strict=True)
    return model


def batch_arrays(seed=0, G=4, n_valid=(3, 4)):
    """numpy (images, img_hw, gt_bboxes, gt_labels, gt_valid)."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(B, HW, HW, 3) * 0.5).astype(np.float32)
    xy = rng.rand(B, G, 2) * 30
    wh = rng.rand(B, G, 2) * 16 + 4
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, NC, (B, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array(n_valid)[:, None]
    return images, IMG_HW, gt, labels, valid


def torch_batch(arrays):
    return Batch(*(torch.from_numpy(np.asarray(a)) for a in arrays))


def jax_batch(arrays):
    from dskd_tpu.data.batch import Batch as JBatch
    return JBatch(*(jnp.asarray(a) for a in arrays))


def _check_heads(got, want, tol=FWD_TOL):
    assert got._fields == want._fields
    for name in want._fields:
        w = getattr(want, name)
        g = getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name, **tol)


# --- the forward -------------------------------------------------------------

@pytest.mark.parametrize("refine,two_stage", VARIANTS)
def test_forward_matches_jax(refine, two_stage):
    v = jax_variables(refine, two_stage)
    images = batch_arrays()[0]
    want = jax.jit(jax_model(refine, two_stage).apply)(
        v, jnp.asarray(images), jnp.asarray(IMG_HW))
    got = port_model(v, refine, two_stage).eval()(
        torch.from_numpy(images), torch.from_numpy(IMG_HW))
    _check_heads(got.head, want.head)
    for g, w in zip(got.neck_feats, want.neck_feats):
        np.testing.assert_allclose(_np(g), np.asarray(w), **FWD_TOL)
    if refine:       # the refinement moved the boxes between the layers
        assert not np.allclose(_np(got.head.bbox_preds[1]),
                               _np(got.head.bbox_preds[0]), atol=1e-3)


def test_two_stage_forward_matches_jax_pallas(interpret):
    """The two-stage forward with JAX's MSDA through its Pallas kernels."""
    v = jax_variables(True, True)
    images = batch_arrays(seed=3)[0]
    want = jax_model(True, True).apply(v, jnp.asarray(images),
                                       jnp.asarray(IMG_HW))
    got = port_model(v, True, True).eval()(torch.from_numpy(images),
                                           torch.from_numpy(IMG_HW))
    _check_heads(got.head, want.head)


def test_two_stage_topk_ties_go_to_the_lowest_token():
    """A zero class-0 kernel ties every valid token's class-0 logit: both
    packages then start the decoder from the first Q valid tokens, in
    order. With zero regression outputs, layer 0's boxes are those
    tokens' proposals."""
    v = jax_variables(True, True, reg_scale=0.0)
    hp = v["params"]["bbox_head"]
    last = max(int(k[len("cls_branch"):]) for k in hp
               if k.startswith("cls_branch"))
    hp[f"cls_branch{last}"]["kernel"][:, 0] = 0.0
    images = batch_arrays(seed=5)[0]
    want = jax.jit(jax_model(True, True).apply)(v, jnp.asarray(images),
                                                jnp.asarray(IMG_HW))
    got = port_model(v, True, True).eval()(torch.from_numpy(images),
                                           torch.from_numpy(IMG_HW)).head
    _check_heads(got, want.head)
    for b in range(B):
        valid = got.enc_token_valid[b].nonzero()[:, 0]
        assert len(valid) > Q
        assert len(set(got.enc_cls_scores[b, valid, 0].tolist())) == 1
        torch.testing.assert_close(got.bbox_preds[0, b],
                                   got.enc_bbox_preds[b, valid[:Q]],
                                   rtol=0, atol=1e-5)


# --- the losses and the decode -----------------------------------------------

def _outputs(seed, G_shape_S=85):
    """Random head outputs in f64: (nl, B, Q, NC) logits, sigmoid boxes and
    the two-stage encoder outputs over S tokens."""
    rng = np.random.RandomState(seed)
    cls = rng.randn(2, B, Q, NC) * 2
    box = 1 / (1 + np.exp(-rng.randn(2, B, Q, 4)))
    enc_cls = rng.randn(B, G_shape_S, NC) * 2
    enc_box = 1 / (1 + np.exp(-rng.randn(B, G_shape_S, 4)))
    enc_box[:, ::7] = 1.0               # invalid proposals decode to 1.0
    enc_valid = np.ones((B, G_shape_S), bool)
    enc_valid[:, ::7] = False
    return cls, box, enc_cls, enc_box, enc_valid


@pytest.mark.parametrize("G", [4, 10])           # G <= Q and G > Q
@pytest.mark.parametrize("two_stage", [False, True])
def test_loss_matches_jax_in_f64(G, two_stage):
    from dskd_tpu.models import deformable_detr as JD

    cls, box, enc_cls, enc_box, enc_valid = _outputs(G + two_stage)
    if not two_stage:
        enc_cls = enc_box = enc_valid = None
    _, img_hw, gt, labels, valid = batch_arrays(seed=G, G=G,
                                                n_valid=(G - 1, G))
    gt = gt.astype(np.float64)
    diff = [cls, box] + ([enc_cls, enc_box] if two_stage else [])

    def jloss(*args):
        heads = list(args[:2]) + ([args[2], args[3], enc_valid] if two_stage
                                  else [None] * 3)
        losses = JD.deformable_detr_loss(
            JD.DDETRHeadOutputs(*heads), jnp.asarray(gt), jnp.asarray(labels),
            jnp.asarray(valid), jnp.asarray(img_hw),
            JD.DDETRLossConfig(num_classes=NC))
        return sum(losses.values()), losses

    with jax.enable_x64(True):
        (_, want), jgrads = jax.jit(jax.value_and_grad(
            jloss, argnums=tuple(range(len(diff))), has_aux=True))(
            *(jnp.asarray(a) for a in diff))
        want = {k: float(v) for k, v in want.items()}
        jgrads = [np.asarray(g) for g in jgrads]
    t = [torch.from_numpy(a).requires_grad_(True) for a in diff]
    heads = t[:2] + (t[2:] + [torch.from_numpy(enc_valid)] if two_stage
                     else [None] * 3)
    got = PD.deformable_detr_loss(
        PD.DDETRHeadOutputs(*heads), torch.from_numpy(gt),
        torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(img_hw), PD.DDETRLossConfig(num_classes=NC))
    keys = {p + k for p in ("", "d0.") for k in ("loss_cls", "loss_bbox",
                                                 "loss_iou")}
    if two_stage:
        keys |= {"enc.loss_cls", "enc.loss_bbox", "enc.loss_iou"}
    assert set(got) == set(want) == keys
    for k, w in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(float(got[k]), w, rtol=1e-6, atol=0,
                                   err_msg=k)
    sum(got.values()).backward()
    for tg, jg in zip(t, jgrads):
        np.testing.assert_allclose(tg.grad.numpy(), jg, rtol=1e-6,
                                   atol=1e-9)


def test_get_bboxes_matches_jax():
    from dskd_tpu.models import deformable_detr as JD

    cls, box, _, _, _ = _outputs(3)
    cls = cls.astype(np.float32)
    box = box.astype(np.float32)
    cls[-1, 0, 5, 1] = cls[-1, 0, 2, 4]          # a tie: the lower pair first
    cls[-1, :, :3, 0] = 8.0                      # three more ties, kept
    box[-1, :, :3] = [[0.9, 0.9, 0.5, 0.6]] * 3  # boxes past both edges
    img_hw = np.array([[64, 40], [36, 60]], np.int32)
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [2.0, 1.5, 2.0, 1.5]], np.float32)
    for kw in (dict(score_thr=0.2, max_per_img=8),
               dict(score_thr=0.0, max_per_img=20, rescale=True)):
        want = JD.deformable_detr_get_bboxes(
            JD.DDETRHeadOutputs(jnp.asarray(cls), jnp.asarray(box), None,
                                None, None),
            jnp.asarray(img_hw), scale_factor=jnp.asarray(sf), **kw)
        got = PD.deformable_detr_get_bboxes(
            PD.DDETRHeadOutputs(torch.from_numpy(cls), torch.from_numpy(box),
                                None, None, None),
            torch.from_numpy(img_hw), scale_factor=torch.from_numpy(sf), **kw)
        for k in ("labels", "valid"):
            np.testing.assert_array_equal(_np(getattr(got, k)),
                                          np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(_np(got.scores), np.asarray(want["scores"]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(_np(got.bboxes), np.asarray(want["bboxes"]),
                                   rtol=1e-5, atol=1e-5)
    # x clamps to the width and y to the height, not to min(h, w)
    xyxy = got.bboxes * torch.from_numpy(sf)[:, None]
    assert float(xyxy[1, :, 0::2].max()) == 60.0
    assert float(xyxy[1, :, 1::2].max()) <= 36.0


def test_eval_step_matches_jax():
    from dskd_tpu.models import deformable_detr as JD  # noqa: F401
    from dskd_tpu.registry import get_family as jget

    v = jax_variables(True, True)
    images = batch_arrays(seed=7)[0]
    sf = np.array([[0.5] * 4, [1.25] * 4], np.float32)
    kw = dict(score_thr=0.05, max_per_img=10)
    want = jget("deformable_detr")["eval_step"](jax_model(True, True), **kw)(
        v, jnp.asarray(images), jnp.asarray(IMG_HW), jnp.asarray(sf))
    got = registry.get_family("deformable_detr")["eval_step"](
        port_model(v, True, True).eval(), **kw)(
        torch.from_numpy(images), torch.from_numpy(IMG_HW),
        torch.from_numpy(sf))
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      np.asarray(getattr(want, k)))
    np.testing.assert_allclose(_np(got.scores), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got.bboxes), np.asarray(want.bboxes),
                               rtol=1e-4, atol=1e-3)


# --- one family step ---------------------------------------------------------

GRAD_NAMES = (
    "neck.convs.0.conv.weight",
    "bbox_head.transformer.encoder.layers.0.attentions.0.sampling_offsets."
    "weight",
    "bbox_head.transformer.decoder.layers.1.attentions.1.value_proj.weight",
    "bbox_head.cls_branches.1.weight",
    "bbox_head.reg_branches.0.0.weight")


def _step_cfg(mod, refine, two_stage):
    return mod.ExperimentConfig(
        model=model_cfg(mod, refine, two_stage),
        distill=mod.DistillFlags(cates_distill="", feats_distill=""))


def _family_step_against_jax(refine, two_stage, jit=True):
    from dskd_tpu.models import deformable_detr as JD  # noqa: F401
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu.train.step import parse_losses as jparse
    from dskd_tpu.utils import config as jconfig

    arrays = batch_arrays(seed=4)
    v = jax_variables(refine, two_stage)
    losses_fn = jget("deformable_detr")["losses"](
        jax_model(refine, two_stage), _step_cfg(jconfig, refine, two_stage),
        has_teacher=False, use_dropout=False)
    jb = jax_batch(arrays)

    def total(params):
        losses, _ = losses_fn({"params": params,
                               "batch_stats": v["batch_stats"]}, jb, None,
                              jax.random.PRNGKey(0))
        return jparse(losses), losses

    grad_fn = jax.value_and_grad(total, has_aux=True)
    (_, want), jgrads = (jax.jit(grad_fn) if jit else grad_fn)(v["params"])
    jgrads = registry.get_family("deformable_detr")["from_jax"](
        {"params": jgrads, "batch_stats": v["batch_stats"]})

    model = port_model(v, refine, two_stage)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(1e-4)), seed=0)
    seen = {}
    clip = state.optimizer.clip

    names = GRAD_NAMES + (("bbox_head.transformer.enc_output.weight",)
                          if two_stage else ())

    def recording_clip():
        # by module path: shared branches have one parameter, many names
        seen.update({n: model.get_parameter(n).grad.clone() for n in names})
        return clip()

    state.optimizer.clip = recording_clip
    step = make_family_train_step("deformable_detr", model,
                                  _step_cfg(pconfig, refine, two_stage),
                                  num_prev=0, has_teacher=False,
                                  use_dropout=False)
    state, got = step(state, torch_batch(arrays))
    assert state.step == 1
    assert set(got) == set(want) | {"loss"}
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    for n in names:
        ref = jgrads[n]
        assert float(ref.norm()) > 0, n
        rel = float((seen[n] - ref).norm() / ref.norm())
        assert rel <= 1e-3, (n, rel)


@pytest.mark.parametrize("refine,two_stage", [(False, False), (True, True)])
def test_family_step_losses_and_grads_match_jax(refine, two_stage):
    _family_step_against_jax(refine, two_stage)


def test_family_step_matches_jax_pallas(interpret):
    _family_step_against_jax(True, True)


def test_refined_references_are_detached():
    """Layer 1's class logits reach layer 0's regression branch only
    through layer 1's reference, the refined box, which is detached: no
    gradient arrives there."""
    v = jax_variables(True, False)
    model = port_model(v, True, False)
    images, img_hw = batch_arrays(seed=2)[:2]
    out = model(torch.from_numpy(images), torch.from_numpy(img_hw)).head
    out.cls_scores[1].sum().backward()
    for p in model.bbox_head.reg_branches[0].parameters():
        assert p.grad is None or not p.grad.any()


# --- the init ----------------------------------------------------------------

def _port_init(refine, two_stage, seed=0):
    spec = registry.get_family("deformable_detr")
    model = spec["build"](model_cfg(pconfig, refine, two_stage), "cpu")
    spec["init_weights"](model, seed)
    return model.eval()


def test_refine_init_decode_invariants():
    """Zero regression outputs: layer 1 repeats layer 0's boxes through the
    detached refined reference, and (w, h) start at sigmoid(-2)."""
    images, img_hw = batch_arrays()[:2]
    out = _port_init(True, False)(torch.from_numpy(images),
                                  torch.from_numpy(img_hw)).head
    bp = _np(out.bbox_preds)
    np.testing.assert_allclose(bp[0, ..., 2:], 1 / (1 + np.exp(2.0)),
                               rtol=1e-5)
    np.testing.assert_allclose(bp[1], bp[0], rtol=1e-5, atol=1e-6)


def test_two_stage_init_proposal_ladder():
    """Zero regression outputs: every layer's boxes are the top-k encoder
    proposals, whose (w, h) are on the 0.05 * 2^l ladder, as are the valid
    tokens' proposals."""
    images, img_hw = batch_arrays()[:2]
    out = _port_init(True, True)(torch.from_numpy(images),
                                 torch.from_numpy(img_hw)).head
    bp = _np(out.bbox_preds)
    np.testing.assert_allclose(bp[1], bp[0], rtol=1e-5, atol=1e-6)
    dist = np.abs(bp[0][..., 2:, None] - LADDER).min(-1)
    np.testing.assert_allclose(dist, 0.0, atol=1e-6)
    ev = _np(out.enc_token_valid)
    ewh = _np(out.enc_bbox_preds)[..., 2:][ev]
    np.testing.assert_allclose(np.abs(ewh[..., None] - LADDER).min(-1), 0.0,
                               atol=1e-6)
    # an invalid token's proposal is 1e6 in logit space: exactly 1.0
    assert (_np(out.enc_bbox_preds)[~ev] == 1.0).all()


@pytest.mark.parametrize("refine,two_stage", VARIANTS)
def test_init_scales_and_seed(refine, two_stage):
    a, b = _port_init(refine, two_stage, 3), _port_init(refine, two_stage, 3)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    sd = a.state_dict()
    tdst = "bbox_head.transformer"
    num_pred = 2 + int(two_stage)
    assert abs(float(sd[f"{tdst}.level_embeds"].std()) - 1) < 0.2
    if two_stage:
        assert "bbox_head.query_embedding.weight" not in sd
        assert f"{tdst}.reference_points.weight" not in sd
        w = sd[f"{tdst}.pos_trans.weight"]
        assert float(w.abs().max()) <= (6 / 1024) ** 0.5
        assert torch.equal(sd[f"{tdst}.enc_output_norm.weight"],
                           torch.ones(256))
    else:
        assert abs(float(sd["bbox_head.query_embedding.weight"].std())
                   - 1) < 0.2
        w = sd[f"{tdst}.reference_points.weight"]
        assert float(w.abs().max()) <= (6 / 258) ** 0.5
        assert float(w.abs().max()) > 0.5 * (6 / 258) ** 0.5
    prior = -np.log((1 - 0.01) / 0.01)
    for i in range(num_pred):
        cls_w = sd[f"bbox_head.cls_branches.{i}.weight"]
        assert float(cls_w.abs().max()) <= (6 / (256 + NC)) ** 0.5
        np.testing.assert_allclose(
            sd[f"bbox_head.cls_branches.{i}.bias"].numpy(), prior, rtol=1e-6)
        assert not sd[f"bbox_head.reg_branches.{i}.4.weight"].any()
        bias = sd[f"bbox_head.reg_branches.{i}.4.bias"]
        want = [0, 0, -2, -2] if i == 0 and not two_stage else [0] * 4
        if not refine:                    # one shared set: branch 0's
            want = [0, 0, -2, -2]
        assert bias.tolist() == want, (i, bias)
        same = torch.equal(cls_w, sd["bbox_head.cls_branches.0.weight"])
        assert same == (i == 0 or not refine), i
    off = sd[f"{tdst}.decoder.layers.0.attentions.1.sampling_offsets.bias"]
    assert not sd[f"{tdst}.decoder.layers.0.attentions.1.sampling_offsets."
                  "weight"].any()
    assert float(off.abs().max()) == 4.0     # the rotational grid, 4 points
    conv = sd["backbone.conv1.weight"]
    assert abs(float(conv.std()) * conv[0].numel() ** 0.5 - 1) < 0.2


def test_shared_branches_are_one_module():
    model = _port_init(False, False)
    head = model.bbox_head
    assert all(m is head.cls_branches[0] for m in head.cls_branches)
    assert all(m is head.reg_branches[0] for m in head.reg_branches)
    names = [n for n, _ in model.named_parameters()
             if n.startswith("bbox_head.cls_branches")]
    assert names == ["bbox_head.cls_branches.0.weight",
                     "bbox_head.cls_branches.0.bias"]
