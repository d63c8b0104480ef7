"""The RegNetX and MobileNetV2 backbones on the port
(``models/{regnet,mobilenet_v2}.py``), and the parts the backbones share
(``nasfcos_fpn._resize_bilinear``, ``backbones.drop_path``), against
dskd_tpu.models on the CPU, cut the same way in both packages
(tests/torch_port_zoo.py), with RetinaNet on RegNetX; EfficientNet, PVT
and HRNet + HRFPN have files of their own
(tests/test_torch_port_backbones_zoo_{effb,pvt,hrnet}.py):

- RegNetX-3.2GF's stage plan (96/192/432/1008, group width 48) exactly;
- the backbones' outputs in f64 (1e-8 relative, L2);
  ``jax.image.resize``'s bilinear map (PVT's and HRFPN's resize) alone,
  shrinking, growing and both, in f64 (1e-12);
- one family step's losses and named gradients in f64 (1e-8);
- the port's drop path alone (keep rate, 1 / keep scaling) and the
  per-block linear rates of EfficientNet-B3 and PVT-tiny;
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

FAMILIES = (("retinanet", "regnetx_tiny"),)

@pytest.fixture(autouse=True)
def _cut():
    with Z.cut():
        yield


def test_regnetx_3_2gf_stage_plan_matches_jax():
    from dskd_tpu.models.regnet import RegNet
    from dskd_tpu_torch.models.regnet import stage_plan
    widths, depths, groups = stage_plan("regnetx_3.2gf")
    assert widths == RegNet.stage_widths("regnetx_3.2gf") == (96, 192, 432,
                                                               1008)
    assert set(groups) == {48} and depths == (2, 6, 15, 2)


@pytest.mark.parametrize("arch,spec,hw", [
    ("retinanet", "regnetx_tiny", (64, 64)),
    ("yolov3", "mobilenet_v2", (64, 64))])
def test_backbone_outputs_match_jax_in_f64(arch, spec, hw):
    images, img_hw = Z.canvas(*hw)
    outs = Z.check_backbone_f64(arch, spec, images, img_hw,
                                Z.jax_backbone(spec), Z.port_backbone(spec))
    assert len(outs) == (4 if spec.startswith("regnetx") else 3)


@pytest.mark.parametrize("src,dst", [((56, 56), (16, 16)),
                                     ((56, 56), (200, 336)),
                                     ((14, 14), (25, 9)),
                                     ((5, 6), (18, 22))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    from dskd_tpu_torch.models.nasfcos_fpn import _resize_bilinear
    x = np.random.RandomState(1).randn(*src, 7)
    with jax.enable_x64(True):
        want = np.asarray(jax.image.resize(jnp.asarray(x), dst + (7,),
                                           method="bilinear"))
    got = _resize_bilinear(torch.from_numpy(x).permute(2, 0, 1)[None], dst)
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_family_step_matches_jax_grad_in_f64(arch, spec):
    Z.check_family_step_f64(arch, spec, Z.GRAD_NAMES[spec])


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_eval_step_matches_jax(arch, spec):
    Z.check_eval_step(arch, spec)


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_init_weights_seeded(arch, spec):
    Z.check_init_weights(arch, spec)


def test_drop_path_keep_rate_and_scaling():
    from dskd_tpu_torch.models.backbones import drop_path
    x = torch.rand(20000, 3, 2, 2, dtype=torch.float64) + 0.5
    g = torch.Generator().manual_seed(0)
    y = drop_path(x, 0.3, g, True)
    kept = (y != 0).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all())          # whole samples
    assert abs(float(kept.double().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    assert torch.equal(drop_path(x, 0.3, g, False), x)
    assert torch.equal(drop_path(x, 0.3, None, True), x)
    assert torch.equal(drop_path(x, 0.0, g, True), x)


def test_stochastic_depth_rates_rise_linearly():
    from dskd_tpu_torch.models.efficientnet import EfficientNet
    from dskd_tpu_torch.models.pvt import PVT
    eff = EfficientNet("cpu", "b3", drop_path_rate=0.2)
    rates = [m.drop_path for n, m in eff.named_children()
             if n.startswith("stage")]
    np.testing.assert_allclose(rates, 0.2 * np.arange(len(rates))
                               / (len(rates) - 1), rtol=1e-12)
    assert len(rates) == 26
    pvt = PVT("cpu", "tiny")
    rates = [m.drop_path for n, m in pvt.named_children()
             if n.startswith("stage")]
    np.testing.assert_allclose(rates, 0.1 * np.arange(8) / 7, rtol=1e-12)


@pytest.mark.parametrize("arch,spec", [
    ("retinanet", "regnetx_tiny"), ("retinanet", "effbt"),
    ("retinanet", "pvt_micro"), ("fcos", "hrnet_w8"), ("yolox", ""),
    ("yolov3", ""), ("yolov3", "mobilenet_v2"), ("centernet", "")])
def test_optimizer_labels_match_jax(arch, spec):
    """The port's frozen / lr01 / base labels over each family's
    parameters hold as many values in each group as JAX's labels over its
    variables (frozen stem, stages and backbone BatchNorm affines)."""
    from dskd_tpu.train.optim import default_param_labels as jlabels
    from dskd_tpu_torch.train.optim import default_param_labels
    from dskd_tpu_torch.utils import config as pconfig
    from dskd_tpu_torch import registry

    fs = -1 if arch == "centernet" else 1
    v = Z.jax_variables(arch, spec)
    want = {}
    label = jlabels(fs)
    jax.tree_util.tree_map_with_path(
        lambda p, x: want.__setitem__(label(p, x), want.get(
            label(p, x), 0) + x.size), v["params"])
    model = registry.get_family(arch)["build"](
        Z.model_cfg(pconfig, arch, spec), "meta")
    got, plabel = {}, default_param_labels(fs)
    for n, p in model.named_parameters():
        got[plabel(n)] = got.get(plabel(n), 0) + p.numel()
    assert got == want
    # every backbone but PVT (no BatchNorm, no stem) freezes something
    assert bool(got.get("frozen")) == (spec != "pvt_micro")
