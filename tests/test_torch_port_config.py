"""The port's own configuration (dskd_tpu_torch/utils/config.py and the
``PipelineConfig`` / ``rescale_size`` of dskd_tpu_torch/data/pipeline.py)
against the JAX package's: the same fields and defaults, every config file
of the repository loaded to the same values, and ``load_config`` refusing a
config file's other imports of the JAX package."""
import dataclasses
import glob
import os

import numpy as np
import pytest

from dskd_tpu_torch.data import pipeline as port_pipeline
from dskd_tpu_torch.utils import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("ModelConfig", "DataConfig", "TrainConfig", "DistillFlags",
           "ExperimentConfig")


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


def test_config_classes_match_jax():
    from dskd_tpu.utils import config as jax_config

    for name in CLASSES:
        ours, theirs = getattr(port_config, name), getattr(jax_config, name)
        assert _fields(ours) == _fields(theirs), name
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs()), \
            name
    assert dataclasses.asdict(port_config.dskd_flagship_config(
        (40, 20))) == dataclasses.asdict(jax_config.dskd_flagship_config(
            (40, 20)))


def test_pipeline_config_matches_jax():
    from dskd_tpu.data import pipeline as jax_pipeline

    ours, theirs = port_pipeline.PipelineConfig, jax_pipeline.PipelineConfig
    assert _fields(ours) == _fields(theirs)
    a, b = dataclasses.asdict(ours()), dataclasses.asdict(theirs())
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for h, w, scale in ((480, 640, (640, 640)), (427, 640, (1333, 800)),
                        (100, 37, (128, 96))):
        assert port_pipeline.rescale_size(h, w, scale) == \
            jax_pipeline.rescale_size(h, w, scale)


def test_every_config_file_loads_as_in_jax(monkeypatch):
    """Each config file of the repository that imports only the JAX
    package's config module loads through the port to the values the JAX
    package's ``load_config`` gives; the others are refused."""
    from dskd_tpu.utils.config import load_config as jax_load_config

    monkeypatch.setenv("DSKD_DATASETS", "/datasets")
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*.py")))
    refused = []
    for path in paths:
        try:
            ours = port_config.load_config(path)
        except ImportError as e:
            assert "dskd_tpu." in str(e), path
            refused.append(os.path.basename(path))
            continue
        assert dataclasses.asdict(ours) == dataclasses.asdict(
            jax_load_config(path)), path
        assert ours.data.train_ann.startswith("/datasets/"), path
    assert len(paths) > 90 and len(refused) < 5, refused


@pytest.mark.parametrize("line", [
    "from dskd_tpu.data.deepfashion import DEEPFASHION_CLASSES",
    "import dskd_tpu.utils.config",
    "from dskd_tpu import utils",
    "import dskd_tpu"])
def test_load_config_refuses_other_jax_package_imports(tmp_path, line):
    path = tmp_path / "cfg.py"
    path.write_text(f"{line}\n"
                    "from dskd_tpu.utils.config import ExperimentConfig\n"
                    "def get_config():\n"
                    "    return ExperimentConfig()\n")
    with pytest.raises(ImportError, match="imports 'dskd_tpu"):
        port_config.load_config(str(path))


def test_load_config_resolves_the_config_module(tmp_path):
    path = tmp_path / "cfg.py"
    path.write_text("import dataclasses\n"
                    "from dskd_tpu.utils.config import (ExperimentConfig,\n"
                    "                                   ModelConfig)\n"
                    "def get_config():\n"
                    "    from dskd_tpu.utils.config import TrainConfig\n"
                    "    return ExperimentConfig(\n"
                    "        model=ModelConfig(depth=18),\n"
                    "        train=TrainConfig(base_lr=1e-3))\n")
    cfg = port_config.load_config(str(path))
    assert isinstance(cfg, port_config.ExperimentConfig)
    assert cfg.model.depth == 18 and cfg.train.base_lr == 1e-3


@pytest.mark.parametrize("name,arch", [
    ("tood_r50_1x", "tood"), ("fsaf_r50_1x", "fsaf"),
    ("foveabox_r50_1x", "foveabox"), ("autoassign_r50_1x", "autoassign"),
    ("retinanet_free_anchor_r50_1x", "free_anchor"),
    ("sabl_retinanet_r50_1x", "sabl_retina")])
def test_head_family_configs_build(name, arch):
    """TOOD's, FSAF's, FoveaBox's, AutoAssign's, FreeAnchor's and SABL's
    configs load unedited through the port and build through
    ``init_detector`` at full width and depth, on the CPU with seeded
    weights and on the meta device, where a forward at the config's
    800x1344 canvas gives P3-P7 of 100x168 down to 7x11."""
    import torch
    from dskd_tpu_torch import registry
    from dskd_tpu_torch.apis.inference import init_detector

    cfg = port_config.load_config(os.path.join(ROOT, "configs",
                                               f"{name}.py"))
    assert cfg.model.arch == arch and arch in registry.archs()
    assert cfg.model.depth == 50 and tuple(cfg.data.bucket) == (800, 1344)
    model, _ = init_detector(cfg, device="cpu", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    assert 30e6 < n_params < 45e6, n_params
    meta, _ = init_detector(cfg, device="meta", seed=0)
    with torch.no_grad():
        out = meta(torch.empty(1, 800, 1344, 3, device="meta"),
                   torch.empty(1, 2, dtype=torch.int32, device="meta"))
    assert [tuple(c.shape[1:3]) for c in out.head.cls_scores] == [
        (100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]


# config -> (arch, the canvas of its forward on the meta device, the
# strides (or sizes) of its outputs)
ZOO_CONFIGS = {
    "retinanet_regnetx_3_2gf_1x": ("retinanet", (800, 1344),
                                   (8, 16, 32, 64, 128)),
    "retinanet_effb3_1x": ("retinanet", (896, 896), (8, 16, 32, 64, 128)),
    "retinanet_pvt_t_1x": ("retinanet", (800, 1344), (8, 16, 32, 64, 128)),
    # JAX's HRFPN has no stride: stride 4, then average pools (floored)
    "fcos_hrnetv2p_w18_1x": ("fcos", (800, 1344), ((200, 336), (100, 168),
                                                   (50, 84), (25, 42),
                                                   (12, 21))),
    "yolox_s_300e": ("yolox", (640, 640), (8, 16, 32)),
    "yolov3_d53_coco": ("yolov3", (608, 608), (32, 16, 8)),
    "yolov3_mobilenetv2_416": ("yolov3", (416, 416), (32, 16, 8)),
    "centernet_r18_140e": ("centernet", (512, 512), (4,))}


@pytest.mark.parametrize("name", sorted(ZOO_CONFIGS))
def test_zoo_configs_build(name):
    """The RegNetX, EfficientNet, PVT and HRNet configs and YOLOX's,
    YOLOv3's and CenterNet's load unedited through the port and build
    through ``init_detector`` at full width and depth on the meta device,
    where a forward at the config's canvas gives the family's strides;
    the YOLOv3-MobileNetV2 recipe's photometric distortion, expand and
    min-IoU crop raise NotImplementedError in its data pipeline, naming
    the first."""
    import torch
    from dskd_tpu_torch import registry
    from dskd_tpu_torch.apis.inference import init_detector
    from dskd_tpu_torch.data.pipeline import check_ported
    from dskd_tpu_torch.train.incremental import pipeline_config

    arch, (h, w), strides = ZOO_CONFIGS[name]
    cfg = port_config.load_config(os.path.join(ROOT, "configs",
                                               f"{name}.py"))
    assert cfg.model.arch == arch and arch in registry.archs()
    assert tuple(cfg.data.bucket) == (h, w)
    meta, _ = init_detector(cfg, device="meta", seed=0)
    with torch.no_grad():
        out = meta(torch.empty(1, h, w, 3, device="meta"),
                   torch.empty(1, 2, dtype=torch.int32, device="meta"))
    maps = (out.heatmap[None] if arch == "centernet" else
            out.preds if arch == "yolov3" else out.head.cls_scores)
    assert [tuple(m.shape[1:3]) for m in maps] == [
        s if isinstance(s, tuple) else (-(-h // s), -(-w // s))
        for s in strides]
    if name == "yolov3_mobilenetv2_416":
        with pytest.raises(NotImplementedError,
                           match="photo_metric_distortion"):
            check_ported(pipeline_config(cfg))
    else:
        check_ported(pipeline_config(cfg))
