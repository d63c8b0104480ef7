"""The port's inference API against the JAX package's contract, and the
library yardsticks that ``chip_smoke.py`` times beside the kernels.

* ``load_image`` decodes a PNG to the same RGB pixels as the JAX package's,
  through OpenCV and, with OpenCV away, through PIL;
* ``inference_detector`` takes a path as one image, as JAX's does, and gives
  the detections of the decoded array (the tiny config of
  ``test_torch_port_nojax.py``);
* ``init_detector`` takes JAX's positional order: a checkpoint, by position
  or keyword, raises NotImplementedError, and ``variables=`` loads the
  weights of ``test_torch_port_slice.py``;
* the ``F.embedding_bag`` mappings of ``chip_smoke.py`` compute
  ``gather_weighted_plain`` and ``fused_msda_sample_plain``.
"""
import dataclasses
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from dskd_tpu.data.pipeline import load_image as jax_load_image
from dskd_tpu.utils.torch_weights import convert_mmdet_gfl_ddetr
from dskd_tpu_torch.apis.inference import inference_detector, init_detector
from dskd_tpu_torch.data.pipeline import load_image
from dskd_tpu_torch.models.detector import GFLDeformableDETR
from dskd_tpu_torch.models.gfl_detr_head import get_bboxes
from dskd_tpu_torch.ops.fused_sample import fused_msda_sample_plain
from dskd_tpu_torch.ops.mxu_gather import gather_weighted_plain
from dskd_tpu_torch.utils.config import load_config
from dskd_tpu_torch.utils.weights import state_dict_from_jax

from test_mmdet_convert import _synthetic_mmdet_state
from test_torch_port_slice import TINY

torch.set_num_threads(1)

FLAGSHIP = "configs/gfl_deformable_detr_40_40_il.py"


def _tiny_cfg():
    """The flagship config cut to the tiny model and canvas of
    test_torch_port_nojax.py."""
    flagship = load_config(FLAGSHIP)
    return dataclasses.replace(
        flagship, model=dataclasses.replace(flagship.model, **TINY),
        data=dataclasses.replace(flagship.data, bucket=(128, 128),
                                 img_scale=(128, 128)))


@pytest.fixture
def png(tmp_path):
    """(path, RGB uint8 array) of a PNG written by OpenCV, which stores the
    array it is given as BGR."""
    rgb = np.random.RandomState(0).randint(0, 256, (100, 128, 3)).astype(
        np.uint8)
    path = str(tmp_path / "img.png")
    assert cv2.imwrite(path, rgb[..., ::-1])
    return path, rgb


@pytest.mark.parametrize("route", ["cv2", "pil"])
def test_load_image_matches_jax(png, monkeypatch, route):
    path, rgb = png
    want = jax_load_image(path)
    if route == "pil":
        monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    got = load_image(path)
    assert got.dtype == np.uint8 and got.shape == (100, 128, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rgb)


@pytest.mark.parametrize("route", ["cv2", "pil"])
def test_load_image_missing_file(tmp_path, monkeypatch, route):
    if route == "pil":
        monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(FileNotFoundError):
        load_image(str(tmp_path / "missing.png"))


def test_load_image_needs_a_decoder(png, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="cv2"):
        load_image(png[0])


def test_inference_detector_takes_paths(png):
    path, rgb = png
    model, cfg = init_detector(_tiny_cfg(), device="cpu", seed=0)
    # one image, and a batch of two (batched sums round otherwise)
    for got, want in ((inference_detector(model, cfg, path),
                       inference_detector(model, cfg, rgb)),
                      (inference_detector(model, cfg, [path, rgb])[0],
                       inference_detector(model, cfg, [rgb, rgb])[0])):
        assert len(got) == len(want) == cfg.model.num_classes
        assert sum(len(r) for r in want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_init_detector_refuses_checkpoint(how):
    ckpt = "x/task_1_epoch_2.pth"
    with pytest.raises(NotImplementedError, match="not ported"):
        if how == "positional":
            init_detector(_tiny_cfg(), ckpt, device="cpu")
        else:
            init_detector(_tiny_cfg(), checkpoint=ckpt, task=1,
                          device="cpu")


def test_init_detector_loads_jax_variables():
    """variables= (keyword-only) loads the JAX weights of
    test_torch_port_slice.py: the same detections as the port's model
    loaded there, and the task argument is accepted and unused."""
    params, stats = convert_mmdet_gfl_ddetr(_synthetic_mmdet_state(seed=11),
                                            depth=18)
    variables = {"params": params, "batch_stats": stats}
    model, cfg = init_detector(_tiny_cfg(), None, 1, variables=variables,
                               device="cpu")
    ref = GFLDeformableDETR("cpu", **TINY).eval()
    ref.load_state_dict(state_dict_from_jax(variables), strict=True)
    rng = np.random.RandomState(7)
    images = torch.from_numpy((rng.randn(2, 128, 128, 3) * 0.4).astype(
        np.float32))
    img_hw = torch.tensor([[128, 100], [96, 128]], dtype=torch.int32)
    sf = torch.tensor([[0.5] * 4, [0.75] * 4])
    dets = []
    with torch.inference_mode():
        for m in (model, ref):
            out = m(images, img_hw).head
            dets.append(get_bboxes(out.cls_scores[-1], out.bbox_preds[-1],
                                   img_hw, sf, reg_max=16, score_thr=0.0,
                                   max_per_img=100, rescale=True))
    for name in ("bboxes", "scores", "labels", "valid", "keep_qid"):
        assert torch.equal(getattr(dets[0], name), getattr(dets[1], name))
    assert bool(dets[0].valid.any())


def test_embedding_bag_computes_gather_weighted():
    """B1's library yardstick, indices outside [0, S) included (f32: the
    sums differ in order only)."""
    rng = np.random.RandomState(1)
    B, S, H, D, Q, P = 2, 50, 8, 32, 37, 4
    table = torch.from_numpy(rng.randn(B, S, H, 4 * D).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-3, S + 3, (B, Q, H, P)).astype(
        np.int32))
    w = torch.from_numpy(rng.rand(B, Q, H, P, 4).astype(np.float32))
    got = chip_smoke.embedding_bag(chip_smoke.gather_weighted_bags(
        table, idx, w), (B, Q, H, 4 * D))
    torch.testing.assert_close(got, gather_weighted_plain(table, idx, w),
                               rtol=1e-5, atol=1e-5)


def test_embedding_bag_computes_fused_sample():
    """B4's library yardstick on a level sliced out of the value tensor,
    taps outside the level included."""
    rng = np.random.RandomState(2)
    B, H, D, Q, P, (h, w), start = 2, 8, 32, 37, 4, (6, 7), 10
    value = torch.from_numpy(rng.randn(B, start + h * w + 5, H, D).astype(
        np.float32))
    c00 = torch.from_numpy(rng.randint(-w - 2, h * w + 2, (B, Q, H, P))
                           .astype(np.int32))
    wts = torch.from_numpy(rng.rand(B, Q, H, P, 4).astype(np.float32))
    got = chip_smoke.embedding_bag(chip_smoke.fused_sample_bags(
        value, start, (h, w), c00, wts), (B, Q, H, D))
    want = fused_msda_sample_plain(value[:, start:start + h * w], c00, wts, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
