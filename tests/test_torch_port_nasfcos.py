"""NAS-FCOS on the port (``models/nasfcos_fpn.py``, FCOS's ``nasfcos``
arch) against dskd_tpu.models.nasfcos_fpn and dskd_tpu.models.fcos on the
CPU, on the same numpy-seeded inputs and weights: ``_resize_bilinear``
against ``jax.image.resize`` in f64 within 1e-12, growing and shrinking
(antialiased) at the 800x1344 canvas's sizes and the tiny canvas's; the
grouped 1x1 out conv against flax's ``feature_group_count`` (f64,
1e-12); the neck alone in f64 (1e-10); then the family at the tiny
configuration of tests/torch_port_dcn.py: the forward (1e-4 relative /
1e-5 absolute), the losses in f64 (1e-8), one family step in f64 (losses
and named gradients 1e-8) after which every BatchNorm buffer is unmoved,
as JAX's step keeps its ``batch_stats`` (JAX's FCOS runs the neck with
``deterministic=True``), the decode and the registry's eval step, and the
seeded init's scales."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dcn as X
import torch_port_dense as D
from dskd_tpu_torch.models import nasfcos_fpn as P

torch.set_num_threads(1)

FAM = "nasfcos"
F64_TOL = dict(rtol=1e-12, atol=1e-12)
GRAD_NAMES = ("neck.adapt_convs.0.conv.weight", "neck.adapt_convs.2.bn.bias",
              "neck.fpn.c02.input1_conv.conv.weight",
              "neck.fpn.c36.input2_conv.gn.weight",
              "neck.fpn.c61.out_conv.conv.weight",
              "neck.fpn.c22_1.out_conv.bn.weight",
              "neck.extra_downsamples.1.conv.weight",
              "bbox_head.cls_convs.3.conv.weight", "bbox_head.conv_cls.weight",
              "bbox_head.conv_reg.weight", "bbox_head.scales.0.scale")


@pytest.mark.parametrize("src,dst", [((100, 168), (50, 84)),
                                     ((13, 21), (7, 11)),
                                     ((25, 42), (100, 168)),
                                     ((24, 40), (25, 42)),
                                     ((9, 11), (5, 6)), ((3, 3), (9, 11))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    from dskd_tpu.models.nasfcos_fpn import _resize_bilinear as jresize

    x = np.random.RandomState(0).randn(2, *src, 3)
    with jax.enable_x64(True):
        want = np.asarray(jresize(jnp.asarray(x), dst))
    got = P._resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                             dst).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


def test_grouped_out_conv_pairs_neighbours():
    """flax's feature_group_count=C over the 2C-channel concat and torch's
    groups=C read the same pairs (2c, 2c + 1) once the kernel (1, 1, 2, C)
    is laid out (C, 2, 1, 1)."""
    import flax.linen as nn

    C = 8
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 4, 2 * C)
    conv = nn.Conv(C, (1, 1), feature_group_count=C, use_bias=False)
    with jax.enable_x64(True):
        k = rng.randn(1, 1, 2, C)
        want = np.asarray(conv.apply({"params": {"kernel": k}}, x))
    tconv = torch.nn.Conv2d(2 * C, C, 1, groups=C, bias=False).double()
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **F64_TOL)
    np.testing.assert_allclose(want[..., 3], x[..., 6] * k[0, 0, 0, 3]
                               + x[..., 7] * k[0, 0, 1, 3], **F64_TOL)


def test_neck_matches_jax_in_f64():
    """The neck alone on random C3-C5 of the tiny canvas (9x11, 5x6, 3x3),
    random BatchNorm statistics: every output level within 1e-10."""
    from dskd_tpu.models.nasfcos_fpn import NASFCOSFPN as JNeck
    from dskd_tpu_torch.utils.weights import _nasfcos, _Writer

    rng = np.random.RandomState(2)
    inputs = [rng.randn(2, h, w, c) for (h, w), c in
              (((9, 11), 128), ((5, 6), 256), ((3, 3), 512))]
    module = JNeck(out_channels=256, num_outs=5)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            [jnp.asarray(a, jnp.float32) for a in inputs])
    v = jax.tree_util.tree_map_with_path(
        lambda p, s: D._fill(p, s.shape, rng).astype(np.float32), shapes)
    with jax.enable_x64(True):
        want = module.apply(D.f64(v), inputs)
    w = _Writer()
    _nasfcos(w, v["params"], v["batch_stats"])
    neck = P.NASFCOSFPN([128, 256, 512], "cpu")
    neck.load_state_dict({k[len("neck."):]: t for k, t in w.out.items()},
                         strict=True)
    got = neck.double()([torch.from_numpy(a).permute(0, 3, 1, 2)
                         for a in inputs])
    assert len(got) == 5
    for lvl, (g, wt) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(wt), rtol=1e-10, atol=1e-10,
                                   err_msg=str(lvl))


def test_forward_matches_jax():
    want = X.assert_forward_matches(FAM, X.jax_variables(FAM),
                                    D.batch_arrays()[0])
    assert [tuple(c.shape[1:3]) for c in want.head.cls_scores] == [
        (9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]


def test_losses_match_jax_in_f64():
    X.check_losses_f64(FAM)


def test_family_step_matches_jax_grad_in_f64_and_bn_buffers_stay():
    model, before, new_bs = X.check_family_step_f64(FAM, GRAD_NAMES)
    assert new_bs is None            # JAX's step keeps its batch_stats
    bufs = {k: t for k, t in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))
            and k.startswith("neck.")}
    assert len(bufs) == 2 * (3 + 7)              # adapt and cell BNs
    for k, t in bufs.items():
        assert torch.equal(t, before[k]), k


def test_get_bboxes_matches_jax():
    X.check_get_bboxes(FAM)


def test_eval_step_matches_jax():
    X.check_eval_step(FAM)


def test_init_weights_scales_and_seed():
    """lecun-normal neck convs (flax's default), identity BatchNorms with
    zero mean and unit variance, normal(0.01) head convs, the class
    prior; one seed, one set of weights."""
    from dskd_tpu_torch import registry
    from dskd_tpu_torch.utils import config as pconfig

    spec = registry.get_family(FAM)
    a, b = (spec["build"](X.model_cfg(pconfig, FAM), "cpu")
            for _ in range(2))
    spec["init_weights"](a, 3)
    spec["init_weights"](b, 3)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    for name, mod in a.named_modules():
        if isinstance(mod, torch.nn.Conv2d) and name.startswith("neck."):
            fan_in = mod.weight[0].numel()
            std = float(mod.weight.detach().std())
            assert abs(std * fan_in ** 0.5 - 1) < 0.2, name
    sd = a.state_dict()
    for k, t in sd.items():
        if k.endswith(("bn.weight", "running_var", "gn.weight")):
            assert torch.equal(t, torch.ones_like(t)), k
        if k.endswith(("running_mean", "bn.bias", "gn.bias")):
            assert not t.any(), k
    assert abs(float(sd["bbox_head.cls_convs.0.conv.weight"].std())
               - 0.01) < 1e-3
    np.testing.assert_allclose(sd["bbox_head.conv_cls.bias"].numpy(),
                               -np.log(99), rtol=1e-6)
