"""Inference API (port of dskd_tpu/apis/inference.py ``init_detector`` and
``inference_detector``).

``init_detector(config, checkpoint=None, task=None)`` takes JAX's arguments
in JAX's order and builds the config's detector (its family registry's
``build`` and weights) on the card (or on the device the caller names,
``device="cpu"`` in the tests) with the weights of a
``task_{t}_epoch_{e}`` checkpoint of the port's training loop, or
JAX-layout ``variables``, or seeded random weights; it returns
``(model, cfg)``, where JAX returns ``(model, variables, cfg)``: the
weights live in the ``nn.Module``. ``inference_detector`` takes one image
or a sequence of them, each a path (decoded by ``data.pipeline.load_image``)
or an RGB array, through the test pipeline on the model's device and
returns, per image, the reference's ``bbox2result`` format: one (n, 5)
[x1 y1 x2 y2 score] numpy array per class.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.pipeline import PipelineConfig, load_image, preprocess
from ..models.detector import GFLDeformableDETR
from ..models.gfl_detr_head import get_bboxes
from ..registry import get_family
from ..train.checkpoint import load_weights
from ..utils.config import ExperimentConfig, load_config


def init_detector(config: Union[str, ExperimentConfig],
                  checkpoint: Optional[str] = None,
                  task: Optional[int] = None, *,
                  variables: Optional[Dict[str, Any]] = None,
                  device="cuda", seed: int = 0):
    """Build the detector of ``cfg.model.arch`` on ``device`` through the
    family registry; returns (model, cfg).

    ``checkpoint``: a ``.../task_{t}_epoch_{e}`` directory written by the
    port's ``train.checkpoint.save_checkpoint``, whose weights replace the
    others; an mmdet ``.pth`` file raises NotImplementedError. ``task`` is
    accepted and unused, as in the JAX package. ``variables``: the JAX
    package's ``{"params", "batch_stats"}`` tree (the family's
    ``from_jax``), or None for seeded random weights (its
    ``init_weights``).
    """
    cfg = load_config(config) if isinstance(config, str) else config
    spec = get_family(cfg.model.arch)
    model = spec["build"](cfg.model, torch.device(device))
    if variables is None:
        spec["init_weights"](model, seed)
    else:
        model.load_state_dict(spec["from_jax"](variables), strict=True)
    if checkpoint:
        load_weights(model, checkpoint)
    return model.eval(), cfg


def prepare_batch(cfg: ExperimentConfig, imgs: Sequence, device="cuda"):
    """Raw RGB images -> (images (B, H, W, 3), img_hw (B, 2),
    scale_factor (B, 4)) on ``device``."""
    pipe = PipelineConfig(img_scale=cfg.data.img_scale, flip_ratio=0.0,
                          max_gt=1, bucket=cfg.data.bucket)
    outs = [preprocess(im, pipe, device) for im in imgs]
    return tuple(torch.stack([o[k] for o in outs])
                 for k in ("image", "img_hw", "scale_factor"))


@torch.inference_mode()
def inference_detector(model: GFLDeformableDETR, cfg: ExperimentConfig,
                       imgs: Union[str, np.ndarray, Sequence],
                       score_thr: float = 0.0) -> List:
    """Run inference on image paths or RGB arrays; returns per-image lists
    of per-class (n, 5) arrays (one list when given one image). It decodes
    the GFL-Deformable-DETR head, as JAX's does for every arch; a model of
    another family raises, where JAX's would decode it as that head."""
    if not isinstance(model, GFLDeformableDETR):
        raise ValueError(f"inference_detector decodes the flagship's GFL "
                         f"head only; arch {cfg.model.arch!r} has another "
                         f"head (use its family's eval_step)")
    single = isinstance(imgs, (str, np.ndarray))
    if single:
        imgs = [imgs]
    imgs = [load_image(im) if isinstance(im, str) else im for im in imgs]
    device = next(model.parameters()).device
    images, img_hw, sf = prepare_batch(cfg, imgs, device)
    out = model(images, img_hw)
    det = get_bboxes(out.head.cls_scores[-1], out.head.bbox_preds[-1],
                     img_hw, scale_factor=sf, reg_max=cfg.model.reg_max,
                     score_thr=score_thr, max_per_img=cfg.test_max_per_img,
                     rescale=True)
    boxes, scores, labels, valid = (t.cpu().numpy() for t in (
        det.bboxes, det.scores, det.labels, det.valid))
    results = []
    for i in range(len(imgs)):
        per_class = []
        for c in range(cfg.model.num_classes):
            m = valid[i] & (labels[i] == c)
            per_class.append(
                np.concatenate([boxes[i][m], scores[i][m, None]], -1)
                if m.any() else np.zeros((0, 5), np.float32))
        results.append(per_class)
    return results[0] if single else results
