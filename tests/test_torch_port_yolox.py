"""YOLOX's model on the port (``models/{csp_darknet,yolox}.py``) against
dskd_tpu on the CPU at YOLOX-s (CSPDarknet deepen 0.33, widen 0.5; PAFPN
and head at 128 channels), 10 classes, B=2 on 64x64
(tests/torch_port_zoo.py); its training path is in
tests/test_torch_port_yolox_train.py:

- Focus's space-to-depth order (row, column) (0, 0), (1, 0), (0, 1),
  (1, 1) through JAX's Focus and its weights (f64, 1e-12), and the SPP
  max pools' -inf padding on negative maps (exactly);
- CSPDarknet's outputs in f64 (1e-8 relative, L2);
- one family step's losses and named gradients in f64 (1e-8), without
  and with the L1 branch, and the BatchNorms' running statistics (1e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_zoo as Z

torch.set_num_threads(1)

ARCH = "yolox"
GRAD_NAMES = ("bbox_head.multi_level_conv_cls.0.weight",
              "bbox_head.multi_level_conv_reg.0.weight",
              "bbox_head.multi_level_conv_obj.1.weight",
              "neck.out_convs.0.conv.weight",
              "backbone.stem.conv.conv.weight",
              "backbone.stage4_spp.conv2.conv.weight",
              "backbone.stage2_csp.blocks.0.conv2.conv.weight")


def test_focus_patch_order_matches_jax():
    from dskd_tpu.models.csp_darknet import Focus as JFocus
    from dskd_tpu_torch.models.csp_darknet import Focus
    from dskd_tpu_torch.utils.weights import _Writer

    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 10, 3)
    jm = JFocus(5)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 6, 10, 3)))
    v = jax.tree.map(lambda s: rng.randn(*s.shape) * 0.3 + (
        1.5 if s.shape == (5,) else 0), shapes)
    with jax.enable_x64(True):
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
    w = _Writer()
    w.tree("", v["params"], v["batch_stats"])
    port = Focus(3, 5, "cpu").double().eval()
    port.load_state_dict(w.out, strict=True)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)


def test_spp_pools_pad_with_minus_inf():
    import flax.linen as fnn
    x = (-1.0 - np.random.RandomState(1).rand(2, 9, 7, 4)).astype(np.float32)
    for k in (5, 9, 13):
        want = np.asarray(fnn.max_pool(jnp.asarray(x), (k, k), strides=(1, 1),
                                       padding=((k // 2, k // 2),) * 2))
        got = torch.nn.functional.max_pool2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), k, 1, k // 2)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
        assert (want < 0).all()


def test_backbone_outputs_match_jax_in_f64():
    from dskd_tpu.models.csp_darknet import CSPDarknet as JCSP
    from dskd_tpu_torch.models.csp_darknet import CSPDarknet
    images, img_hw = Z.canvas(64, 96)
    outs = Z.check_backbone_f64(
        ARCH, "", images, img_hw,
        lambda: JCSP(deepen_factor=0.33, widen_factor=0.5),
        lambda: CSPDarknet("cpu", 0.33, 0.5))
    assert [o.shape[1] for o in outs] == [128, 256, 512]


@pytest.mark.parametrize("use_l1", [False, True])
def test_family_step_matches_jax_grad_in_f64(use_l1):
    kw = {"use_l1": True} if use_l1 else None
    got = Z.check_family_step_f64(ARCH, "", GRAD_NAMES, jax_kw=kw,
                                  port_kw=kw)
    assert ("loss_l1" in got) == use_l1
