"""The DETR-IL family on the port against dskd_tpu.models.detr on the CPU.

The tiny DETR: ResNet-18, 1 encoder and 2 decoder layers, 6 classes, width
256, a 64x64 canvas (a 2x2 C5 map) and B=2, with one image of 30x48 valid
pixels, so the key padding mask acts; weights are a JAX init carried to the
port by the registry's ``from_jax``.

- E1: both packages' ``hungarian_assign`` with the default solver agree by
  total cost, G <= Q and G > Q; ``solver`` is keyword-only.
- E2: the attention-weight dropout draws one (Q, K) mask shared by batch and
  heads; the DETR family step's loss depends on the generator with dropout
  on and not with dropout 0.
- The forward's four outputs (1e-4 abs/rel), ``detr_detection_loss`` in both
  matcher branches (every key 1e-5 rel, the gradients in the outputs
  1e-4), ``detr_get_bboxes`` (fields exact, boxes 1e-5),
  ``detr_compute_losses`` with "hard + soft" + "kldv" in f64 (1e-6 rel:
  the KLs of two untrained models are sums near zero), one family step's
  losses and four named gradients (1e-3 relative L2, dropout 0); the
  two-task run is in test_torch_port_detr_incremental.
- The registry lists the six archs the port builds, and an arch it does
  not build raises.
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch import registry
from dskd_tpu_torch.core.matching import hungarian_assign
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.models import detr as PD
from dskd_tpu_torch.models.transformer import MultiheadAttention
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState, frozen_copy
from dskd_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

TINY = dict(num_classes=6, depth=18, num_encoder_layers=1,
            num_decoder_layers=2)
B, HW = 2, 64
IMG_HW = np.array([[64, 64], [30, 48]], np.int32)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_model(num_query=12):
    from dskd_tpu.models.detr import DETR
    return DETR(num_query=num_query, dropout=0.0, **TINY)


@functools.lru_cache(maxsize=None)
def jax_apply():
    """The tiny JAX DETR's forward, jitted once for the module."""
    return jax.jit(jax_model().apply)


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    images = jnp.zeros((1, HW, HW, 3))
    return jax.tree.map(np.asarray, jax.jit(jax_model().init)(
        jax.random.PRNGKey(seed), images, jnp.asarray(IMG_HW[:1])))


def jax_variables(seed, cls_scale=1.0):
    """A JAX init of the tiny DETR (12 queries); ``cls_scale`` widens the
    class logits, so a teacher keeps confident detections whose top-k
    order is the same in both frameworks."""
    v = jax.tree.map(np.copy, _jax_init(seed))
    v["params"]["fc_cls"]["kernel"] = v["params"]["fc_cls"]["kernel"] * \
        cls_scale
    return v


def port_model(variables, num_query=12, dropout=0.0):
    model = PD.DETR("cpu", num_query=num_query, dropout=dropout, **TINY)
    model.load_state_dict(registry.get_family("detr")["from_jax"](variables),
                          strict=True)
    return model


def batch_arrays(seed=0, G=4, n_valid=(3, 4)):
    """numpy (images, img_hw, gt_bboxes, gt_labels, gt_valid)."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(B, HW, HW, 3) * 0.5).astype(np.float32)
    xy = rng.rand(B, G, 2) * 26
    wh = rng.rand(B, G, 2) * 16 + 4
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, TINY["num_classes"], (B, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array(n_valid)[:, None]
    return images, IMG_HW, gt, labels, valid


def jax_batch(arrays):
    from dskd_tpu.data.batch import Batch as JBatch
    return JBatch(*(jnp.asarray(a) for a in arrays))


def torch_batch(arrays):
    return Batch(*(torch.from_numpy(np.asarray(a)) for a in arrays))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# --- E1 ----------------------------------------------------------------------

@pytest.mark.parametrize("Q,G", [(12, 5), (6, 9)])   # G <= Q and G > Q
def test_hungarian_assign_default_solver_matches_jax(Q, G):
    from dskd_tpu.core.matching import hungarian_assign as jax_assign

    rng = np.random.RandomState(Q * G)
    N = 5
    cost = rng.rand(N, Q, G).astype(np.float32) * 4
    labels = rng.randint(0, 6, (N, G)).astype(np.int32)
    valid = np.arange(G)[None] < rng.randint(1, G + 1, (N, 1))
    want = jax.vmap(jax_assign)(jnp.asarray(cost), jnp.asarray(valid),
                                jnp.asarray(labels))
    got = hungarian_assign(torch.from_numpy(cost), torch.from_numpy(valid),
                           torch.from_numpy(labels))

    def totals(assigned):
        a = np.asarray(assigned)
        out = np.zeros(N)
        for i in range(N):
            qs = np.nonzero(a[i] >= 0)[0]
            out[i] = cost[i, qs, a[i, qs]].sum()
        return out

    np.testing.assert_array_equal(got.pos_mask.sum(1).numpy(),
                                  np.asarray(want.pos_mask).sum(1))
    np.testing.assert_allclose(totals(got.assigned_gt.numpy()),
                               totals(want.assigned_gt), rtol=1e-6)


def test_hungarian_assign_solver_is_keyword_only():
    param = inspect.signature(hungarian_assign).parameters["solver"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default == "jv"
    args = (torch.rand(1, 4, 2), torch.ones(1, 2, dtype=torch.bool),
            torch.zeros(1, 2, dtype=torch.int64))
    with pytest.raises(TypeError):
        hungarian_assign(*args, "auction")
    assert hungarian_assign(*args, solver="auction").pos_mask.sum() == 2


# --- E2 ----------------------------------------------------------------------

def test_attention_weight_dropout_is_one_mask_over_batch_and_heads(
        monkeypatch):
    """One-hot values and an identity output projection make the output
    the attention weights; the output dropout is switched off to read
    them. At p = 0.5 the zeroed (q, k) cells are the same in every batch
    element and head, kept cells are the eval-mode weights x 2, and the
    keep rate is within 3 sigma of 0.5."""
    from dskd_tpu_torch.models import transformer

    Bq, Q, K, C, H = 3, 32, 32, 256, 8
    Dh = C // H
    attn = MultiheadAttention("cpu", C, H, dropout=0.5)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        w = attn.attn.in_proj_weight
        w.copy_(torch.randn(w.shape, generator=g) * 0.05)
        w[2 * C:] = torch.eye(C)
        attn.attn.in_proj_bias.zero_()
        attn.attn.out_proj.weight.copy_(torch.eye(C))
        attn.attn.out_proj.bias.zero_()
    query = torch.randn(Bq, Q, C, generator=g)
    key = torch.randn(Bq, K, C, generator=g)
    value = torch.zeros(Bq, K, C)
    for h in range(H):
        value[:, torch.arange(K), h * Dh + torch.arange(K)] = 1.0

    def weights(training):
        attn.train(training)
        out = attn(query, key, value, generator=torch.Generator().manual_seed(
            1)) - query
        return out.reshape(Bq, Q, H, Dh)[..., :K].permute(0, 2, 1, 3)

    monkeypatch.setattr(transformer, "dropout",
                        lambda x, p, training, generator: x)
    clean = weights(False)                       # (B, H, Q, K)
    dropped = weights(True)
    kept = dropped != 0
    assert (clean > 0).all()
    assert (kept == kept[:1, :1]).all()          # one (Q, K) mask
    # atol: the weights are read back as (query + out) - query
    torch.testing.assert_close(dropped[kept], clean[kept] * 2.0,
                               rtol=1e-5, atol=1e-6)
    rate = kept[0, 0].float().mean().item()
    assert abs(rate - 0.5) <= 3 * (0.25 / (Q * K)) ** 0.5


def _tiny_cfg(mod, **train):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(arch="detr", num_query=12, dropout=0.0,
                              **TINY),
        train=mod.TrainConfig(**train),
        distill=mod.DistillFlags(cates_distill="hard + soft",
                                 feats_distill="kldv",
                                 teacher_score_thr=0.3,
                                 teacher_max_per_img=20))


@pytest.mark.parametrize("dropout", [0.1, 0.0])
def test_detr_family_step_dropout_on_and_off(dropout):
    """As tests/test_detr_dropout.py for JAX: with dropout on, two
    generators give two losses; with dropout 0, the generator does not
    matter."""
    cfg = _tiny_cfg(pconfig)
    v = jax_variables(0)
    batch = torch_batch(batch_arrays(seed=1))

    def loss(seed):
        model = port_model(v, dropout=dropout)
        state = TrainState.create(model, make_optimizer(
            model, step_lr_schedule(1e-4)), seed=seed)
        step = make_family_train_step("detr", model, cfg, num_prev=0,
                                      has_teacher=False,
                                      use_dropout=dropout > 0)
        _, losses = step(state, batch)
        return float(losses["loss"])

    l1, l2 = loss(1), loss(2)
    assert np.isfinite(l1) and np.isfinite(l2)
    if dropout:
        assert abs(l1 - l2) > 1e-6
    else:
        assert l1 == l2


# --- the model and its losses ------------------------------------------------

def test_forward_matches_jax():
    v = jax_variables(0)
    images = batch_arrays()[0]
    want = jax_apply()(v, jnp.asarray(images), jnp.asarray(IMG_HW))
    got = port_model(v).eval()(torch.from_numpy(images),
                               torch.from_numpy(IMG_HW))
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **FWD_TOL)
    # the padded row of image 2 changes its memory: the mask acts
    hw = torch.from_numpy(IMG_HW)
    model = port_model(v).eval()
    unmasked = model(torch.from_numpy(images), torch.full_like(hw, HW))
    assert not torch.allclose(unmasked.memory[1], got.memory[1])


def _outputs(seed, Q, nl=2):
    """Random head outputs (cls logits, sigmoid boxes) of a tiny DETR."""
    rng = np.random.RandomState(seed)
    cls = (rng.randn(nl, B, Q, 7) * 2).astype(np.float32)
    box = (1 / (1 + np.exp(-rng.randn(nl, B, Q, 4)))).astype(np.float32)
    hs = rng.randn(nl, B, Q, 8).astype(np.float32)
    memory = rng.randn(B, 4, 8).astype(np.float32)
    return cls, box, hs, memory


@pytest.mark.parametrize("Q,G", [(12, 4), (6, 8)])   # G <= Q and G > Q
def test_detection_loss_matches_jax(Q, G):
    from dskd_tpu.models import detr as JD

    arrays = _outputs(Q, Q)
    _, img_hw, gt, labels, valid = batch_arrays(seed=G, G=G,
                                                n_valid=(G - 1, G))
    cfg = PD.DETRLossConfig(num_classes=6)

    def jloss(cls, box):
        out = JD.DETROutputs(cls, box, jnp.asarray(arrays[2]),
                             jnp.asarray(arrays[3]))
        return JD.detr_detection_loss(
            out, jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid),
            jnp.asarray(img_hw), JD.DETRLossConfig(num_classes=6))

    want, jgrads = jax.jit(jax.value_and_grad(
        lambda c, b: (sum(jloss(c, b).values()), jloss(c, b)),
        argnums=(0, 1), has_aux=True))(jnp.asarray(arrays[0]),
                                       jnp.asarray(arrays[1]))
    want = want[1]
    t = [torch.from_numpy(a).requires_grad_(i < 2)
         for i, a in enumerate(arrays)]
    got = PD.detr_detection_loss(
        PD.DETROutputs(*t), torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(valid), torch.from_numpy(img_hw), cfg)
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(
        ["loss_cls", "loss_bbox", "loss_iou", "d0.loss_cls",
         "d0.loss_bbox", "d0.loss_iou"])
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=0, err_msg=k)
    sum(got.values()).backward()
    for tg, jg in zip(t[:2], jgrads):
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-6)


def test_get_bboxes_matches_jax():
    from dskd_tpu.models import detr as JD

    cls, box, hs, memory = _outputs(3, 12)
    cls[-1, 0, 5] = cls[-1, 0, 2]                # a tie: the lower id first
    img_hw = np.array([[64, 40], [36, 60]], np.int32)   # clamps on both axes
    box[-1, :, :3] = [[0.9, 0.9, 0.5, 0.6]] * 3
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [2.0, 1.5, 2.0, 1.5]], np.float32)
    for kw in (dict(score_thr=0.2, max_per_img=8),
               dict(score_thr=0.0, max_per_img=20, rescale=True)):
        want = JD.detr_get_bboxes(
            JD.DETROutputs(*(jnp.asarray(a) for a in (cls, box, hs,
                                                      memory))),
            jnp.asarray(img_hw), scale_factor=jnp.asarray(sf), **kw)
        got = PD.detr_get_bboxes(
            PD.DETROutputs(*(torch.from_numpy(a) for a in (cls, box, hs,
                                                           memory))),
            torch.from_numpy(img_hw), scale_factor=torch.from_numpy(sf),
            **kw)
        assert set(got._fields) == set(want)
        for k in ("labels", "keep_qid", "valid", "logits"):
            np.testing.assert_array_equal(_np(getattr(got, k)),
                                          np.asarray(want[k]), err_msg=k)
        # the softmax of the two frameworks differs in the last ulp
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want["scores"]), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(got.bboxes.numpy(),
                                   np.asarray(want["bboxes"]), rtol=1e-5,
                                   atol=1e-5)


def test_compute_losses_with_teacher_matches_jax_in_f64():
    """hard + soft + kldv on the JAX model's student and teacher outputs,
    in f64 in both packages."""
    from dskd_tpu.models import detr as JD

    arrays = batch_arrays(seed=2)
    images, img_hw = jnp.asarray(arrays[0]), jnp.asarray(IMG_HW)
    s_out = jax_apply()(jax_variables(0), images, img_hw)
    t_out = jax_apply()(jax_variables(1, cls_scale=2.0), images, img_hw)
    f64 = [[np.asarray(a, np.float64) for a in out]
           for out in (s_out, t_out)]
    gt64 = list(arrays)
    gt64[2] = gt64[2].astype(np.float64)
    dcfg = PD.DETRDistillConfig.from_flags(cates_distill="hard + soft",
                                           feats_distill="kldv")
    thr = dict(teacher_score_thr=0.35, teacher_max_per_img=10)
    with jax.enable_x64(True):
        jdcfg = JD.DETRDistillConfig.from_flags(
            cates_distill="hard + soft", feats_distill="kldv")
        want = jax.jit(lambda s, t, b: JD.detr_compute_losses(
            JD.DETROutputs(*s), b, JD.DETRLossConfig(num_classes=6),
            teacher_out=JD.DETROutputs(*t), distill_cfg=jdcfg, **thr))(
            [jnp.asarray(a) for a in f64[0]],
            [jnp.asarray(a) for a in f64[1]], jax_batch(gt64))
        want = {k: float(v) for k, v in want.items()}
    t_out = PD.DETROutputs(*(torch.from_numpy(a) for a in f64[1]))
    got = PD.detr_compute_losses(
        PD.DETROutputs(*(torch.from_numpy(a) for a in f64[0])),
        torch_batch(gt64), PD.DETRLossConfig(num_classes=6),
        teacher_out=t_out, distill_cfg=dcfg, **thr)
    kept = PD.detr_teacher_out(t_out, torch.from_numpy(IMG_HW), 0.35,
                               10)[0].valid
    assert 0 < int(kept.sum()) < kept.numel()
    assert sorted(got) == sorted(want)
    assert {"loss_kd", "loss_fd"} <= set(got)
    for k, v in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-6, atol=0,
                                   err_msg=k)


GRAD_NAMES = ("bbox_head.input_proj.weight",
              "bbox_head.transformer.decoder.layers.1.attentions.1.attn."
              "in_proj_weight",
              "bbox_head.fc_cls.weight",
              "bbox_head.query_embedding.weight")


def test_family_step_losses_and_grads_match_jax():
    """One generic step with a teacher, dropout 0: its losses and the
    gradients it clips (four named ones) against JAX's losses_fn."""
    from dskd_tpu.models import detr as JD  # noqa: F401  (registers detr)
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu.train.step import parse_losses as jparse
    from dskd_tpu.utils import config as jconfig

    arrays = batch_arrays(seed=4)
    v, tv = jax_variables(0), jax_variables(1, cls_scale=8.0)
    jcfg = _tiny_cfg(jconfig)
    losses_fn = jget("detr")["losses"](jax_model(), jcfg, has_teacher=True,
                                       use_dropout=False)
    jb = jax_batch(arrays)

    def total(params):
        losses, _ = losses_fn({"params": params,
                               "batch_stats": v["batch_stats"]}, jb, tv,
                              jax.random.PRNGKey(0))
        return jparse(losses), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        v["params"])
    jgrads = registry.get_family("detr")["from_jax"](
        {"params": jgrads, "batch_stats": v["batch_stats"]})

    cfg = _tiny_cfg(pconfig)
    model = port_model(v)
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
    step = make_family_train_step("detr", model, cfg, num_prev=3,
                                  has_teacher=True, use_dropout=False)
    state, got = step(state, torch_batch(arrays),
                      frozen_copy(port_model(tv)))
    assert state.step == 1
    assert set(got) == set(want) | {"loss"}
    assert {"loss_kd", "loss_fd", "d0.loss_cls"} <= set(got)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    for n in GRAD_NAMES:
        ref = jgrads[n]
        rel = float((seen[n] - ref).norm() / ref.norm())
        assert rel <= 1e-3, (n, rel)


def test_generic_step_refuses_bf16():
    cfg = _tiny_cfg(pconfig)
    model = port_model(jax_variables(0))
    with pytest.raises(ValueError, match="detr.*f32"):
        make_family_train_step("detr", model, cfg, 0, False,
                               use_dropout=False,
                               compute_dtype=torch.bfloat16)


def test_inference_detector_refuses_another_family():
    from dskd_tpu_torch.apis.inference import inference_detector, \
        init_detector

    cfg = _tiny_cfg(pconfig)
    model, cfg = init_detector(cfg, device="cpu")
    assert isinstance(model, PD.DETR)
    with pytest.raises(ValueError, match="'detr'"):
        inference_detector(model, cfg, np.zeros((32, 32, 3), np.uint8))


# --- the registry ------------------------------------------------------------

def test_registry_lists_the_ported_archs():
    assert registry.archs() == ("atss", "autoassign", "centernet",
                                "deformable_detr", "deformable_detr_il",
                                "detr", "fcos", "foveabox", "free_anchor",
                                "fsaf", "gfl", "gfl_deformable_detr", "lad",
                                "ld", "nasfcos", "paa", "pisa_retinanet",
                                "reppoints", "retinanet", "retinanet_fpg",
                                "retinanet_ghm", "retinanet_nasfpn",
                                "sabl_retina", "tood", "vfnet", "yolof",
                                "yolov3", "yolox", "yoloy")
    for arch in registry.archs():
        spec = registry.get_family(arch)
        for key in ("build", "init_weights", "from_jax", "eval_step"):
            assert callable(spec[key]), (arch, key)
        assert (spec["losses"] is None) != (spec["train_step"] is None)
    for arch in ("deformable_detr", "detr", "yolof", "yoloy", "atss",
                 "fcos", "gfl", "retinanet", "ld", "paa", "lad",
                 "pisa_retinanet", "retinanet_ghm", "retinanet_fpg",
                 "retinanet_nasfpn", "nasfcos", "vfnet", "reppoints",
                 "tood", "fsaf", "foveabox", "autoassign", "free_anchor",
                 "sabl_retina", "yolox", "yolov3", "centernet"):
        assert registry.get_family(arch)["losses"] is not None
    for arch in ("ssd", "no_such_arch"):
        with pytest.raises(ValueError, match=repr(arch)):
            registry.get_family(arch)


def test_detr_init_weights_scales_and_seed():
    """init_weights at JAX's initializer scales: lecun-normal heads,
    xavier attention, normal(1) queries, identity norms; the same seed
    gives the same weights."""
    spec = registry.get_family("detr")
    mcfg = pconfig.ModelConfig(arch="detr", num_query=12, **TINY)
    a, b = (spec["build"](mcfg, "cpu") for _ in range(2))
    spec["init_weights"](a, 3)
    spec["init_weights"](b, 3)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    sd = a.state_dict()
    assert abs(float(sd["bbox_head.query_embedding.weight"].std()) - 1) < .2
    fc = sd["bbox_head.fc_cls.weight"]
    assert abs(float(fc.std()) * 256 ** 0.5 - 1) < 0.2
    attn = sd["bbox_head.transformer.encoder.layers.0.attentions.0.attn."
              "in_proj_weight"]
    assert float(attn.abs().max()) <= (6 / 512) ** 0.5
    assert torch.equal(sd["bbox_head.transformer.decoder.post_norm.weight"],
                       torch.ones(256))
    assert not sd["bbox_head.fc_cls.bias"].any()
