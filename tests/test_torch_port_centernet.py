"""CenterNet on the port (``models/{cornernet,centernet}.py``) against
dskd_tpu on the CPU: ResNet-18 at full depth, the three-deconv neck and
the head, 10 classes, B=2 on 64x64 (tests/torch_port_zoo.py).

- ``gaussian_radius`` and ``gaussian_splat_max`` in f64 (1e-12; the
  windows exactly);
- flax's ``ConvTranspose(4, strides=2, padding="SAME")`` against the
  port's ``nn.ConvTranspose2d(4, 2, 1)`` on ``from_jax``'s flipped kernel,
  with a kernel that is not symmetric, in f64 (1e-12);
- the forward in f64 (heatmap, size, offset and neck; 1e-8 relative, L2)
  and ``render_targets`` in f64 (1e-12; centre cells exactly);
- one family step's losses and named gradients in f64 (1e-8);
- the decode in f64 on heatmaps with plateaus and ties (labels, valid,
  flat indices exactly, scores and boxes 1e-12) and the registry's eval
  step (f32: labels and valid exactly, scores 1e-5, boxes 1e-4);
- the seeded init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_zoo as Z
from dskd_tpu_torch.models import centernet as PC
from dskd_tpu_torch.models import cornernet as PCN

torch.set_num_threads(1)

ARCH = "centernet"
GRAD_NAMES = ("bbox_head.heatmap_out.weight", "bbox_head.wh_out.weight",
              "bbox_head.offset_conv.weight", "neck.deconv2.weight",
              "neck.conv0.weight", "backbone.layer4.1.conv2.weight",
              "backbone.conv1.weight")


def _gt(seed=3, G=6):
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, G, 2) * 50
    wh = rng.rand(2, G, 2) * 40 + 2
    gt = np.concatenate([xy, np.minimum(xy + wh, 64)], -1)
    gt[0, 1] = gt[0, 0]                  # two GT on one centre
    labels = rng.randint(0, Z.NC, (2, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array([[5], [6]])
    return gt, labels, valid


def test_gaussian_radius_and_splat_match_jax_in_f64():
    from dskd_tpu.models.cornernet import gaussian_radius as jrad
    from dskd_tpu.models.cornernet import gaussian_splat_max as jsplat
    gt, labels, valid = _gt()
    hw = (16, 16)
    for b in range(2):
        g = gt[b] / 4
        h, w = g[:, 3] - g[:, 1], g[:, 2] - g[:, 0]
        ix = np.clip(np.floor((g[:, 0] + g[:, 2]) / 2), 0, 15).astype(
            np.int32)
        iy = np.clip(np.floor((g[:, 1] + g[:, 3]) / 2), 0, 15).astype(
            np.int32)
        weights = np.eye(Z.NC)[labels[b]] * valid[b][:, None]
        with jax.enable_x64(True):
            wr = np.asarray(jrad(jnp.asarray(h), jnp.asarray(w)))
            ws = np.asarray(jsplat(jnp.asarray(ix), jnp.asarray(iy),
                                   jnp.asarray(weights), jnp.asarray(wr),
                                   hw))
        t = torch.from_numpy
        gr = PCN.gaussian_radius(t(h), t(w))
        np.testing.assert_allclose(gr.numpy(), wr, rtol=1e-12, atol=0)
        gs = PCN.gaussian_splat_max(t(ix), t(iy), t(weights), gr, hw)
        np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-12, atol=1e-300)
        np.testing.assert_array_equal(gs.numpy() > 0, ws > 0)
        assert (ws == 1.0).sum() >= valid[b].sum() - 1


def test_deconv_matches_flax_conv_transpose_in_f64():
    import flax.linen as fnn
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 3)
    kernel = rng.randn(4, 4, 3, 6)        # not symmetric in any axis
    layer = fnn.ConvTranspose(6, (4, 4), strides=(2, 2), padding="SAME",
                              use_bias=False)
    with jax.enable_x64(True):
        want = np.asarray(layer.apply({"params": {"kernel": kernel}},
                                      jnp.asarray(x)))
    from dskd_tpu_torch.utils.weights import centernet_state_dict_from_jax
    flipped = centernet_state_dict_from_jax.__doc__
    assert "flipped" in flipped
    deconv = torch.nn.ConvTranspose2d(3, 6, 4, stride=2, padding=1,
                                      bias=False).double()
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(
            kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy()))
    got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 14, 6)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)
    # without the flip it is another function
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(
            kernel.transpose(2, 3, 0, 1).copy()))
    other = deconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(other.permute(0, 2, 3, 1).detach().numpy(), want)


def test_forward_matches_jax_in_f64():
    Z.check_forward_f64(ARCH)


def test_render_targets_match_jax_in_f64():
    from dskd_tpu.models.centernet import render_targets as jrender
    gt, labels, valid = _gt()
    with jax.enable_x64(True):
        want = jax.vmap(lambda b, lb, v: jrender(b, lb, v, Z.NC, (16, 16)))(
            jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid))
        want = [np.asarray(w) for w in want]
    got = PC.render_targets(*(torch.from_numpy(a) for a in (
        gt, labels, valid)), Z.NC, (16, 16))
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 3:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(D._np(g).astype(np.float64),
                                       w.astype(np.float64), rtol=1e-12,
                                       atol=1e-300, err_msg=str(k))


def test_family_step_matches_jax_grad_in_f64():
    Z.check_family_step_f64(ARCH, "", GRAD_NAMES)


def test_decode_matches_jax_in_f64_with_plateaus_and_ties():
    from dskd_tpu.models.centernet import centernet_get_bboxes as jdec
    v = Z.jax_variables(ARCH)
    images, img_hw = Z.batch_arrays(1)[:2]
    with jax.enable_x64(True):
        out = jax.jit(Z.jax_model(ARCH).apply)(
            D.f64(v), jnp.asarray(images, jnp.float64), jnp.asarray(img_hw))
        out = jax.tree.map(np.asarray, out)
    hm = out.heatmap.copy()
    hm[0, 3:5, 3:6, 2] = 4.0             # a plateau: every cell a maximum
    hm[1, 7, 7, :] = 3.0                 # ties across the classes
    hm[1, 2, 9, 4] = 3.0                 # and across cells
    out = out._replace(heatmap=hm)
    sf = np.array([[0.5] * 4, [2.0, 1.5, 2.0, 1.5]], np.float64)
    kw = dict(topk=30, score_thr=0.05, rescale=True)
    with jax.enable_x64(True):
        want = jax.jit(lambda o, hw, s: jdec(o, hw, scale_factor=s, **kw))(
            out, img_hw, sf)
        want = jax.tree.map(np.asarray, want)
    pout = PC.CenterNetOutputs(*(torch.from_numpy(np.array(a)) for a in (
        out.heatmap, out.wh, out.offset)), ())
    got = PC.centernet_get_bboxes(pout, torch.from_numpy(img_hw),
                                  scale_factor=torch.from_numpy(sf), **kw)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(D._np(getattr(got, k)), want[k],
                                      err_msg=k)
    np.testing.assert_allclose(got.scores.numpy(), want["scores"],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.bboxes.numpy(), want["bboxes"],
                               rtol=1e-12, atol=1e-12)
    # the plateau's six cells and the eleven ties all lead
    assert int((got.scores[0] == got.scores[0, 0]).sum()) == 6
    assert int((got.scores[1] == got.scores[1, 0]).sum()) == Z.NC + 1


def test_eval_step_matches_jax():
    Z.check_eval_step(ARCH)


def test_init_weights_seeded():
    sd = Z.check_init_weights(ARCH)
    np.testing.assert_allclose(sd["bbox_head.heatmap_out.bias"].numpy(),
                               PC.HEATMAP_BIAS)
    assert abs(float(sd["bbox_head.wh_out.weight"].std()) - 0.001) < 2e-4
    d = sd["neck.deconv0.weight"]            # (in, out, 4, 4), fan-in 16 x in
    assert abs(float(d.std()) * (16 * d.shape[0]) ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("bsz", [1, 3])
def test_splat_chunks_give_the_same_heatmap(bsz, monkeypatch):
    """gaussian_splat_max's max over chunks of GT equals the one-shot
    max exactly."""
    gt, labels, valid = _gt(seed=bsz)
    gt, labels, valid = (np.concatenate([a] * 2)[:bsz] for a in (
        gt, labels, valid))
    args = [torch.from_numpy(a) for a in (gt, labels, valid)]
    whole = PC.render_targets(*args, Z.NC, (16, 16))[0]
    monkeypatch.setattr(PCN, "_SPLAT_CHUNK", 1)
    chunked = PC.render_targets(*args, Z.NC, (16, 16))[0]
    assert torch.equal(whole, chunked) and bool(whole.any())
