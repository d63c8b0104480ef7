"""The port's on-device test-time preprocessing (F.interpolate bilinear)
against dskd_tpu.data.pipeline.preprocess (OpenCV) on the CPU."""
import numpy as np
import pytest
import torch

from dskd_tpu.data.pipeline import PipelineConfig
from dskd_tpu.data.pipeline import preprocess as jax_preprocess
from dskd_tpu_torch.data.pipeline import preprocess

torch.set_num_threads(1)


@pytest.mark.parametrize("h0,w0,dtype", [(100, 150, "uint8"),
                                         (200, 120, "uint8"),
                                         (64, 96, "uint8"),
                                         (128, 128, "uint8"),
                                         (90, 70, "float32")])
def test_preprocess_matches_opencv(h0, w0, dtype):
    rng = np.random.RandomState(h0 + w0)
    img = rng.randint(0, 256, (h0, w0, 3)).astype(dtype)
    cfg = PipelineConfig(img_scale=(128, 128), flip_ratio=0.0, max_gt=1,
                         bucket=(128, 128))
    want = jax_preprocess(img, np.zeros((0, 4), np.float32),
                          np.zeros((0,), np.int32), cfg, None, train=False)
    got = {k: v.numpy() for k, v in preprocess(img, cfg, "cpu").items()}
    np.testing.assert_array_equal(got["img_hw"], want["img_hw"])
    np.testing.assert_allclose(got["scale_factor"], want["scale_factor"],
                               rtol=1e-7)
    nh, nw = want["img_hw"]
    # back to grey levels: OpenCV's uint8 fixed-point bilinear is within
    # one level of the exact map (float input: rounding noise only)
    diff = np.abs((got["image"] - want["image"]) * cfg.std)[:nh, :nw]
    assert diff.max() <= (1.0 if dtype == "uint8" else 1e-3) + 1e-4
    # the padding is exactly zero on both sides
    assert not got["image"][nh:].any() and not got["image"][:, nw:].any()
    assert got["image"].shape == want["image"].shape
