"""YOLOv3 on the port (``core/coders.py yolo_encode / yolo_decode``,
``models/{yolov3,mobilenet_v2}.py``) against dskd_tpu on the CPU, 10
classes, B=2 on 64x64 (tests/torch_port_zoo.py), on the MobileNetV2
recipe cut as torch_port_zoo cuts it; Darknet-53 is in
tests/test_torch_port_yolov3_darknet.py:

- the YOLO coder, both ways, in f64 (1e-12);
- one family step's losses and named gradients in f64 (1e-8), and the
  trained BatchNorms' running statistics (1e-8);
- the losses where two GT claim one anchor (the later wins) and where GT
  centres fall on cell borders, in f64 (1e-8);
- the decode in f64 with tied scores (labels, valid and the kept
  positions exactly, scores and boxes 1e-12) and the registry's eval step
  (f32: labels and valid exactly, scores 1e-5, boxes 1e-4);
- the seeded init (normal(0.01) ``pred`` convs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_zoo as Z
from dskd_tpu_torch.models import yolov3 as PY

torch.set_num_threads(1)

ARCH = "yolov3"
GRAD_NAMES = ("pred1.weight", "pred2.weight", "head0_conv.weight",
              "neck3_4_conv.weight", "backbone.stage7_block0.project.weight",
              "backbone.stage3_block0.depthwise.weight")


@pytest.fixture(autouse=True)
def _cut():
    with Z.cut():
        yield


def test_yolo_coder_matches_jax_in_f64():
    from dskd_tpu.core.coders import yolo_decode as jdec
    from dskd_tpu.core.coders import yolo_encode as jenc
    from dskd_tpu_torch.core.coders import yolo_decode, yolo_encode
    rng = np.random.RandomState(0)
    xy = rng.rand(50, 2) * 200
    anchors = np.concatenate([xy, xy + rng.rand(50, 2) * 90 + 5], 1)
    gxy = rng.rand(50, 2) * 200
    gt = np.concatenate([gxy, gxy + rng.rand(50, 2) * 90 + 1e-3], 1)
    stride = rng.choice([8.0, 16.0, 32.0], 50)
    pred = np.concatenate([rng.rand(50, 2), rng.randn(50, 2)], 1)
    with jax.enable_x64(True):
        we = np.asarray(jenc(jnp.asarray(anchors), jnp.asarray(gt),
                             jnp.asarray(stride)))
        wd = np.asarray(jdec(jnp.asarray(anchors), jnp.asarray(pred),
                             jnp.asarray(stride)))
    t = torch.from_numpy
    np.testing.assert_allclose(
        yolo_encode(t(anchors), t(gt), t(stride)).numpy(), we, rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(
        yolo_decode(t(anchors), t(pred), t(stride)).numpy(), wd, rtol=1e-12,
        atol=1e-12)
    # the clamps bite: centres outside the cell, sizes far below anchors
    assert (we[:, :2] == 1 - 1e-6).any() or (we[:, :2] == 1e-6).any()


def test_family_step_matches_jax_grad_in_f64():
    Z.check_family_step_f64(ARCH, "mobilenet_v2", GRAD_NAMES)


def _head_f64(backbone, seed=1):
    v = Z.jax_variables(ARCH, backbone)
    images, img_hw = Z.batch_arrays(seed)[:2]
    with jax.enable_x64(True):
        out = jax.jit(Z.jax_model(ARCH, backbone).apply)(
            D.f64(v), jnp.asarray(images, jnp.float64), jnp.asarray(img_hw))
        return jax.tree.map(np.asarray, out)


def _port_out(out):
    return PY.YOLOV3Outputs(*(tuple(torch.from_numpy(np.array(p)) for p in f)
                              for f in out))


def test_losses_with_contested_anchors_match_jax_in_f64():
    """GT 1 repeats GT 0's box with another label (both claim one anchor:
    the later wins), GT 2 has its centre on a cell border."""
    from dskd_tpu.models.yolov3 import YOLOV3LossConfig as JCfg
    from dskd_tpu.models.yolov3 import yolov3_loss as jloss
    out = _head_f64("mobilenet_v2")
    gt = np.array([[[10, 12, 40, 44], [10, 12, 40, 44], [8, 8, 24, 24],
                    [30, 2, 62, 30]],
                   [[1, 1, 20, 20], [33, 17, 60, 47], [33, 17, 60, 47],
                    [0, 0, 0, 0]]], np.float64)
    labels = np.array([[1, 7, 3, 2], [4, 5, 9, 0]], np.int32)
    valid = np.array([[True] * 4, [True, True, True, False]])
    with jax.enable_x64(True):
        want = jax.jit(lambda o, g, lb, vd: jloss(o, g, lb, vd, JCfg(
            num_classes=Z.NC)))(out, gt, labels, valid)
        want = {k: float(x) for k, x in want.items()}
    got = PY.yolov3_loss(_port_out(out), *(torch.from_numpy(a) for a in (
        gt, labels, valid)), PY.YOLOV3LossConfig(num_classes=Z.NC))
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert np.isfinite(x) and x != 0, k
        np.testing.assert_allclose(float(got[k]), x, rtol=Z.F64_RTOL,
                                   err_msg=k)
    anchors, strides, cx, cy, _, _ = PY._flat(_port_out(out), "cpu")
    assigned, _ = PY.grid_assign(anchors, strides, cx, cy,
                                 torch.from_numpy(gt), torch.from_numpy(valid))
    # the contested anchors went to the later GT
    assert 1 in assigned[0].tolist() and 0 not in assigned[0].tolist()
    assert 2 in assigned[1].tolist()


def test_decode_matches_jax_in_f64_with_ties():
    from dskd_tpu.models.yolov3 import yolov3_get_bboxes as jdec
    out = _head_f64("mobilenet_v2")
    # ties: the class logits of every third prior repeated from its
    # neighbour's, and one level's objectness flat
    preds = []
    for lvl, p in enumerate(out.preds):
        p = p.reshape(*p.shape[:3], 3, -1).copy()
        p[..., 2, 5:] = p[..., 1, 5:]
        p[..., 2, 4] = p[..., 1, 4]
        if lvl == 2:
            p[..., 4] = 2.0
        preds.append(p.reshape(*p.shape[:3], -1))
    out = out._replace(preds=tuple(preds))
    img_hw = Z.IMG_HW
    sf = np.array([[0.5] * 4, [2.0, 1.5, 2.0, 1.5]], np.float64)
    kw = dict(score_thr=0.05, max_per_img=100, nms_pre=50, rescale=True)
    with jax.enable_x64(True):
        want = jax.jit(lambda o, hw, s: jdec(o, hw, scale_factor=s, **kw))(
            out, img_hw, sf)
        want = jax.tree.map(np.asarray, want)
    got = PY.yolov3_get_bboxes(_port_out(out), torch.from_numpy(img_hw),
                               scale_factor=torch.from_numpy(sf), **kw)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(D._np(getattr(got, k)), want[k],
                                      err_msg=k)
    np.testing.assert_allclose(got.scores.numpy(), want["scores"],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.bboxes.numpy(), want["bboxes"],
                               rtol=1e-12, atol=1e-12)
    scores = got.scores[got.valid]
    assert bool(got.valid.sum(1).gt(0).all())
    assert len(scores.unique()) < len(scores)       # tied survivors


def test_eval_step_matches_jax():
    Z.check_eval_step(ARCH, "mobilenet_v2")


@pytest.mark.parametrize("backbone", ["", "mobilenet_v2"])
def test_init_weights_seeded(backbone):
    sd = Z.check_init_weights(ARCH, backbone)
    assert abs(float(sd["pred0.weight"].std()) - 0.01) < 1e-3
    assert not sd["pred0.bias"].any()
