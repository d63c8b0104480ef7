"""FPG and NAS-FPN RetinaNet on the port against dskd_tpu on the CPU, at
the tiny configuration of tests/torch_port_dense_more.py (FPG on 72x88,
whose odd C3-C5 maps make the across-down crop act; NAS-FPN on 64x64),
with FPG cut to 3 stacks and NAS-FPN to 2 in both packages
(``cut_stacks``; the JAX tests cut them so): the forward (1e-4), the
losses in f64 (1e-6 relative), one family step in f64 (losses 1e-6, named
gradients 1e-5 relative L2) and, for NAS-FPN, every running buffer after
it against JAX's new ``batch_stats`` (1e-6: flax keeps them in f32): the
SepBN head's move, the neck's stay, as JAX's RetinaNet runs NAS-FPN on its
running statistics; the registry's eval step; the seeded init at the full
9 and 7 stacks."""
import jax
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M

torch.set_num_threads(1)

@pytest.mark.parametrize("arch", ["retinanet_fpg", "retinanet_nasfpn"])
def test_forward_matches_jax(arch):
    images, img_hw = M.batch_arrays(arch)[:2]
    with M.cut_stacks():
        want = M.assert_forward_matches(arch, M.jax_variables(arch), images,
                                        img_hw)
    # JAX's wiring: C2-C5 in, so the first head level is at stride 4
    assert want.head.cls_scores[0].shape[1] == images.shape[1] // 4


@pytest.mark.parametrize("arch", ["retinanet_fpg", "retinanet_nasfpn"])
def test_losses_match_jax_in_f64(arch):
    with M.cut_stacks():
        M.check_losses_f64(arch)


@pytest.mark.parametrize("arch", ["retinanet_fpg", "retinanet_nasfpn"])
def test_family_step_matches_jax_grad_in_f64(arch):
    names = ("bbox_head.cls_convs.3.conv.weight",
             "bbox_head.retina_cls.weight", "bbox_head.retina_reg.weight",
             "neck.lateral_convs.0.weight" if arch == "retinanet_fpg" else
             "neck.lateral_convs.0.conv.weight",
             "neck.fpn_transitions.2.4.across_skip.conv.weight"
             if arch == "retinanet_fpg" else
             "neck.fpn_stages.1.gp_75_6.out_conv.conv.weight")
    with M.cut_stacks():
        model, before, new_bs = M.check_family_step_f64(arch, names)
        v = M.jax_variables(arch)
    if arch != "retinanet_nasfpn":
        return
    M.assert_buffers_match(model, arch, {"params": v["params"],
                                         "batch_stats": new_bs}, 1e-6)
    bufs = M.running_buffers(model.state_dict())
    moved = {k for k, t in bufs.items() if not torch.equal(t, before[k])}
    assert moved and all(k.startswith("bbox_head.") for k in moved)
    assert len(moved) == 2 * 2 * 4 * 5       # cls/reg x 4 convs x 5 levels


@pytest.mark.parametrize("arch", ["retinanet_fpg", "retinanet_nasfpn"])
def test_eval_step_matches_jax(arch):
    with M.cut_stacks():
        M.check_eval_step(arch)


@pytest.mark.parametrize("arch", ["retinanet_fpg", "retinanet_nasfpn"])
def test_init_weights_scales_and_seed(arch):
    """lecun-normal neck convs (flax's default in FPG and NAS-FPN),
    normal(0.01) head convs, the class prior, identity norms, one seed
    one set of weights."""
    from dskd_tpu_torch import registry
    from dskd_tpu_torch.utils import config as pconfig

    spec = registry.get_family(arch)
    a, b = (spec["build"](M.model_cfg(pconfig, arch), "cpu")
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
    assert abs(float(sd["bbox_head.cls_convs.0.conv.weight"].std())
               - 0.01) < 1e-3
    np.testing.assert_allclose(sd["bbox_head.retina_cls.bias"].numpy(),
                               -np.log(99), rtol=1e-6)
    for k, t in sd.items():
        if k.endswith(("gn.weight", "bn.weight", "running_var")) or (
                "_norms." in k and k.endswith(("weight", "running_var"))):
            assert torch.equal(t, torch.ones_like(t)), k
