"""The EfficientNet backbone on the port (``models/efficientnet.py``) with
its RetinaNet recipe (trained BatchNorm, drop path, a BatchNorm FPN, the
SepBN head, negatives below IoU 0.5) against dskd_tpu.models on the CPU,
cut the same way in both packages (tests/torch_port_zoo.py):

- the backbone's outputs in f64 (1e-8 relative, L2);
- one family step's losses and named gradients in f64 (1e-8), and the
  trained BatchNorms' running statistics against JAX's (1e-8);
- the recipe's assigner, its BatchNorm settings (momentum 0.99, eps 1e-3),
  ``frozen_stages=0``, and a train-mode BatchNorm over one value per
  channel against flax's (1e-6);
- the registry's eval step (f32: labels and valid exactly, scores 1e-5,
  boxes 1e-4) and the seeded init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_zoo as Z

torch.set_num_threads(1)

FAMILIES = (("retinanet", "effbt"),)

@pytest.fixture(autouse=True)
def _cut():
    with Z.cut():
        yield


@pytest.mark.parametrize("arch,spec,hw", [
    ("retinanet", "effbt", (64, 64))])
def test_backbone_outputs_match_jax_in_f64(arch, spec, hw):
    images, img_hw = Z.canvas(*hw)
    outs = Z.check_backbone_f64(arch, spec, images, img_hw,
                                Z.jax_backbone(spec), Z.port_backbone(spec))
    assert len(outs) == 3


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_family_step_matches_jax_grad_in_f64(arch, spec):
    Z.check_family_step_f64(arch, spec, Z.GRAD_NAMES[spec])


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_eval_step_matches_jax(arch, spec):
    Z.check_eval_step(arch, spec)


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_init_weights_seeded(arch, spec):
    Z.check_init_weights(arch, spec)


def test_effb_recipe_negatives_between_0_4_and_0_5_are_ignored():
    """The EfficientNet recipe's assigner (neg_iou_thr 0.5) in the port's
    losses: anchors whose best IoU lies in (0.4, 0.5] are ignored, as in
    JAX's recipe, so the step comparison above sees them."""
    from dskd_tpu_torch.core.max_iou_assigner import max_iou_assign
    from dskd_tpu_torch.models import retinanet as P
    from dskd_tpu_torch.utils import config as pconfig

    images, img_hw, gt, labels, valid = Z.batch_arrays(2)
    sizes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    anchors = P.retina_anchors(sizes, "cpu")
    a = max_iou_assign(anchors, *(torch.from_numpy(x) for x in (
        gt, labels, valid)), Z.NC, pos_iou_thr=0.5, neg_iou_thr=0.4,
        min_pos_iou=0.0)
    b = max_iou_assign(anchors, *(torch.from_numpy(x) for x in (
        gt, labels, valid)), Z.NC, pos_iou_thr=0.5, neg_iou_thr=0.5,
        min_pos_iou=0.0)
    moved = (a.assigned_gt == -2) != (b.assigned_gt == -2)
    assert bool(moved.any())
    cfg = pconfig.ExperimentConfig(model=Z.model_cfg(pconfig, "retinanet",
                                                     "effbt"))
    from dskd_tpu_torch import registry
    losses_fn = registry.get_family("retinanet")["losses"](
        None, cfg, num_prev=0, has_teacher=False, use_dropout=False)
    cells = [c.cell_contents for c in losses_fn.__closure__
             if isinstance(c.cell_contents, P.RetinaLossConfig)]
    assert cells and cells[0].neg_iou_thr == 0.5


def test_efficientnet_batchnorm_and_freezing():
    from dskd_tpu_torch.models.dilated_encoder import TrainableBatchNorm
    from dskd_tpu_torch.models.retinanet import RetinaNet
    model = RetinaNet("cpu", num_classes=Z.NC, backbone="effbt")
    bns = [m for m in model.backbone.modules()
           if isinstance(m, TrainableBatchNorm)]
    assert bns and all(m.momentum == 0.99 and m.eps == 1e-3 for m in bns)
    # frozen_stages=0 freezes nothing: every backbone weight trains
    assert model.backbone.frozen_stages == 0
    model.train()
    out = model(torch.randn(2, 64, 64, 3), None)
    sum(t.sum() for t in out.neck_feats).backward()
    assert float(model.backbone.stem_conv.weight.grad.abs().sum()) > 0
    # the FPN's BatchNorms and the SepBN head's
    assert hasattr(model.neck.fpn_convs[0], "bn")
    assert not hasattr(model.neck.lateral_convs[0], "bn")
    assert model.bbox_head.sepbn
    # one value per channel in training (P7 at B=1): flax's rule gives
    # variance 0 and the bias, where F.batch_norm refuses
    import flax.linen as fnn
    x = np.random.RandomState(0).randn(1, 1, 1, 6).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": np.full(6, 2.0, np.float32),
                    "bias": np.arange(6, dtype=np.float32)},
         "batch_stats": v["batch_stats"]}
    want, new = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = TrainableBatchNorm(6, "cpu")
    with torch.no_grad():
        port.weight.fill_(2.0)
        port.bias.copy_(torch.arange(6.0))
    got = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               rtol=1e-6)
