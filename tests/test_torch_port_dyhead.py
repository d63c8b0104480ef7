"""DyHead and ATSS-DyHead on the port (``models/dyhead.py``,
``models/atss.py`` with ``dyhead_blocks``) against dskd_tpu.models.dyhead
and dskd_tpu.models.atss on the CPU, on the same numpy-seeded inputs and
weights: ``hard_sigmoid`` and ``_upsample_align_corners`` (f64, 1e-12;
the latter is ``F.interpolate(align_corners=True)``), DyReLU (f64,
1e-12), one and two DyHead blocks at width 32 on the odd maps 9x11, 5x6,
3x3, 2x2, 1x1 (f32 forward within 1e-4 relative / 1e-5 absolute; f64
gradients of the inputs and of every block parameter within 1e-8
relative L2, with the offset conv random and at its zero init, where
every sample sits on a pixel), then ATSS-DyHead at the tiny
configuration of tests/torch_port_dcn.py: the forward (random and zero
offsets), the losses in f64 (1e-8), one family step in f64 (losses and
named gradients, the offset conv's among them, 1e-8), the decode and the
registry's eval step, and the seeded init's scales."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dcn as X
import torch_port_dense as D
from dskd_tpu_torch.models import dyhead as P

torch.set_num_threads(1)

FAM = "atss_dyhead"
SIZES = ((9, 11), (5, 6), (3, 3), (2, 2), (1, 1))
WIDTH = 32
F64_TOL = dict(rtol=1e-12, atol=1e-14)
GRAD_NAMES = ("dyhead.dyhead_blocks.0.spatial_conv_offset.weight",
              "dyhead.dyhead_blocks.0.spatial_conv_offset.bias",
              "dyhead.dyhead_blocks.0.spatial_conv_mid.conv.weight",
              "dyhead.dyhead_blocks.0.spatial_conv_low.conv.weight",
              "dyhead.dyhead_blocks.0.spatial_conv_high.conv.weight",
              "dyhead.dyhead_blocks.0.spatial_conv_high.norm.weight",
              "dyhead.dyhead_blocks.0.scale_attn_module.1.weight",
              "dyhead.dyhead_blocks.0.task_attn_module.conv2.conv.weight",
              "bbox_head.atss_cls.weight", "bbox_head.atss_reg.weight",
              "bbox_head.atss_centerness.weight",
              "neck.lateral_convs.0.conv.weight", "bbox_head.scales.0.scale")


def test_hard_sigmoid_matches_jax():
    from dskd_tpu.models.dyhead import hard_sigmoid as jhs

    x = np.concatenate([np.random.RandomState(0).randn(200) * 4,
                        [-3.0, 3.0, 0.0, -3.5, 3.5]])
    with jax.enable_x64(True):
        want = np.asarray(jhs(jnp.asarray(x)))
    np.testing.assert_allclose(P.hard_sigmoid(torch.from_numpy(x)).numpy(),
                               want, **F64_TOL)


@pytest.mark.parametrize("src,dst", [((5, 6), (9, 11)), ((1, 1), (2, 2)),
                                     ((7, 11), (13, 21)), ((3, 3), (5, 6)),
                                     ((13, 21), (25, 42))])
def test_upsample_align_corners_matches_jax(src, dst):
    from dskd_tpu.models.dyhead import _upsample_align_corners as jup

    x = np.random.RandomState(1).randn(2, *src, 3)
    with jax.enable_x64(True):
        want = np.asarray(jup(jnp.asarray(x), dst))
    got = P._upsample_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    dst).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


def _jax_dyhead(blocks, seed, zero_offsets):
    from dskd_tpu.models.dyhead import DyHead

    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, h, w, WIDTH) for h, w in SIZES]
    module = DyHead(out_channels=WIDTH, num_blocks=blocks)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            tuple(jnp.asarray(f, jnp.float32)
                                  for f in feats))
    # f32 values, as the port's weights hold them
    v = jax.tree_util.tree_map_with_path(
        lambda p, s: D._fill(p, s.shape, rng).astype(np.float32), shapes)
    if zero_offsets:
        for blk in v["params"].values():
            for p in blk["spatial_conv_offset"].values():
                p[...] = 0.0
    return module, v, feats


def _port_dyhead(v, blocks, dtype):
    from dskd_tpu_torch.utils.weights import _Writer, _dyhead

    w = _Writer()
    _dyhead(w, v["params"])
    m = P.DyHead("cpu", channels=WIDTH, num_blocks=blocks)
    m.load_state_dict({k[len("dyhead."):]: t for k, t in w.out.items()},
                      strict=True)
    return m.to(dtype)


def _nchw(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("zero_offsets", [False, True],
                         ids=["offsets", "zero_offsets"])
@pytest.mark.parametrize("blocks", [1, 2])
def test_dyhead_forward_matches_jax(blocks, zero_offsets):
    module, v, feats = _jax_dyhead(blocks, 2, zero_offsets)
    feats = [f.astype(np.float32) for f in feats]
    want = jax.jit(module.apply)(v, tuple(feats))
    got = _port_dyhead(v, blocks, torch.float32)(
        [_nchw(f, torch.float32) for f in feats])
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape[2:]) == SIZES[lvl]
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=str(lvl))


@pytest.mark.parametrize("zero_offsets", [False, True],
                         ids=["offsets", "zero_offsets"])
def test_dyhead_grads_match_jax_in_f64(zero_offsets):
    """d sum(out x cot) of the inputs and of every parameter of one block
    (the offset conv's too) within 1e-8 relative L2."""
    module, v, feats = _jax_dyhead(1, 3, zero_offsets)
    rng = np.random.RandomState(4)
    cots = [rng.randn(*f.shape) for f in feats]

    def loss(params, xs):
        out = module.apply({"params": params}, xs)
        return sum((o * c).sum() for o, c in zip(out, cots))

    with jax.enable_x64(True):
        jg_params, jg_feats = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            D.f64(v)["params"], tuple(feats))
    m = _port_dyhead(v, 1, torch.float64)
    xs = [_nchw(f, torch.float64).requires_grad_() for f in feats]
    out = m(xs)
    sum((o * _nchw(c, torch.float64)).sum()
        for o, c in zip(out, cots)).backward()
    for lvl, (x, g) in enumerate(zip(xs, jg_feats)):
        want = torch.from_numpy(np.array(g)).permute(0, 3, 1, 2)
        assert float((x.grad - want).norm() / want.norm()) < X.F64_RTOL, lvl
    from dskd_tpu_torch.utils.weights import _Writer, _dyhead
    w = _Writer()
    _dyhead(w, jax.tree.map(np.asarray, {"params": jg_params})["params"])
    grads = {k[len("dyhead."):]: t for k, t in w.out.items()}
    for name, p in m.named_parameters():
        ref = grads[name].double()
        assert float(ref.norm()) > 0, name
        rel = float((p.grad - ref).norm() / ref.norm())
        assert rel < X.F64_RTOL, (name, rel)


def test_dyrelu_matches_jax():
    from dskd_tpu.models.dyhead import DyReLU as JDyReLU

    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 6, WIDTH)
    module = JDyReLU(WIDTH)
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: rng.randn(*a.shape) * 0.3,
                         module.init(jax.random.PRNGKey(0), x))
        want = np.asarray(module.apply(v, x))
    m = P.DyReLU(WIDTH, "cpu").double()
    with torch.no_grad():
        for c in ("conv1", "conv2"):
            conv = getattr(m, c).conv
            conv.weight.copy_(torch.from_numpy(
                v["params"][c]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(v["params"][c]["bias"]))
    got = m(_nchw(x, torch.float64)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **F64_TOL)


@pytest.mark.parametrize("zero_offsets", [False, True],
                         ids=["offsets", "zero_offsets"])
def test_forward_matches_jax(zero_offsets):
    X.assert_forward_matches(FAM, X.jax_variables(
        FAM, zero_offsets=zero_offsets), D.batch_arrays()[0])


def test_losses_match_jax_in_f64():
    X.check_losses_f64(FAM)


@pytest.mark.parametrize("zero_offsets", [False, True],
                         ids=["offsets", "zero_offsets"])
def test_family_step_matches_jax_grad_in_f64(zero_offsets):
    X.check_family_step_f64(FAM, GRAD_NAMES, zero_offsets=zero_offsets)


def test_get_bboxes_matches_jax():
    X.check_get_bboxes(FAM)


def test_eval_step_matches_jax():
    X.check_eval_step(FAM)


def test_init_weights_scales_and_seed():
    """The offset convs zero, each deformable kernel uniform within
    1/sqrt(fan_in) at variance 1/(3 fan_in), the attention convs
    normal(0.01), the head without towers; one seed, one set of
    weights."""
    from dskd_tpu_torch import registry
    from dskd_tpu_torch.utils import config as pconfig

    spec = registry.get_family("atss")
    a, b = (spec["build"](X.model_cfg(pconfig, FAM, 2), "cpu")
            for _ in range(2))
    spec["init_weights"](a, 3)
    spec["init_weights"](b, 3)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    sd = a.state_dict()
    assert not any(k.startswith(("bbox_head.cls_convs",
                                 "bbox_head.reg_convs")) for k in sd)
    for i in range(2):
        pre = f"dyhead.dyhead_blocks.{i}."
        for k in ("spatial_conv_offset.weight", "spatial_conv_offset.bias"):
            assert not sd[pre + k].any(), k
        for part in ("high", "mid", "low"):
            w = sd[f"{pre}spatial_conv_{part}.conv.weight"]
            fan_in = w[0].numel()
            assert float(w.abs().max()) <= fan_in ** -0.5
            assert abs(float(w.var()) * 3 * fan_in - 1) < 0.05
            assert torch.equal(sd[f"{pre}spatial_conv_{part}.norm.weight"],
                               torch.ones(256))
        for k in ("scale_attn_module.1.weight",
                  "task_attn_module.conv2.conv.weight"):
            assert abs(float(sd[pre + k].std()) - 0.01) < 2e-3, k
    np.testing.assert_allclose(sd["bbox_head.atss_cls.bias"].numpy(),
                               -np.log(99), rtol=1e-6)
