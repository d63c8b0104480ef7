"""dskd_tpu_torch runs its serving and training slices without importing JAX
or Flax: a fresh interpreter imports the port, runs init_detector +
inference_detector and one incremental train step on a tiny configuration,
and reports which modules it loaded."""
import json
import os
import subprocess
import sys

_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dskd_tpu.utils.config import DataConfig, ExperimentConfig, ModelConfig
from dskd_tpu_torch.apis.inference import init_detector, inference_detector

cfg = ExperimentConfig(
    model=ModelConfig(num_classes=7, num_query=12, depth=18,
                      num_encoder_layers=1, num_decoder_layers=2),
    data=DataConfig(bucket=(128, 128), img_scale=(128, 128)))
model, cfg = init_detector(cfg, device="cpu", seed=0)
rng = np.random.RandomState(0)
imgs = [rng.randint(0, 256, (100, 128, 3)).astype(np.uint8),
        rng.randint(0, 256, (128, 90, 3)).astype(np.uint8)]
res = inference_detector(model, cfg, imgs)

from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.distill.losses import DistillConfig
from dskd_tpu_torch.models.gfl_detr_loss import DetLossConfig
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState, frozen_copy
from dskd_tpu_torch.train.step import make_train_step
state = TrainState.create(model, make_optimizer(model, step_lr_schedule(
    2e-4)), seed=0)
step = make_train_step(DetLossConfig(num_classes=7), DistillConfig.from_flags(
    cates_distill="hard + teacher-first",
    feats_distill="corr + fg_info + decode_v1", num_prev=3))
batch = Batch(torch.randn(2, 128, 128, 3), torch.tensor([[128, 100],
                                                         [96, 128]]),
              torch.tensor([[[10., 10., 60., 50.]] * 2] * 2),
              torch.tensor([[1, 2]] * 2), torch.tensor([[True, False]] * 2))
state, losses = step(state, batch, frozen_copy(model))
print(json.dumps({
    "trained": bool(torch.isfinite(losses["loss"])),
    "n_images": len(res), "n_classes": len(res[0]),
    "shapes_ok": all(r.ndim == 2 and r.shape[1] == 5 for per in res
                     for r in per),
    "finite": all(bool(np.isfinite(r).all()) for per in res for r in per),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax"))}))
"""


def test_port_slice_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    assert report["n_images"] == 2 and report["n_classes"] == 7
    assert report["shapes_ok"] and report["finite"] and report["trained"]
